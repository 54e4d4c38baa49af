"""The work counter (``launch/cost.py``), the kernels' meta branches and the
dry-run, against the reference's HLO analyzer where both count the same.

Mirrors ``tests/test_hlo_analysis.py``: every iteration of a Python loop is
counted (the reference's scan trip count), a matmul counts 2mnk exactly,
a slice write counts the slice and not the buffer, and a gathered layer on
a mesh counts collective bytes; the ``test_dryrun_smoke_tiny_mesh``
counterpart runs reduced Mixtral's train step over a (4, 2) meta mesh. The
reduced StarCoder2-3B prefill's products equal the reference's
``analyze_hlo`` dot FLOPs exactly where both compute them the same way;
the attention differs by the formulas in the test. The moved cost
formulas give ``PERF.md`` §6's bound inputs and bounds exactly (bounds to
the 4 digits §6 prints). Counts are exact: no tolerance.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro.launch.hlo_analysis import analyze_hlo
from repro._unused.serve.serve_step import make_prefill_step as j_make_prefill_step
from repro._unused.models import lm as j_lm
from repro_torch import device as device_rule
from repro_torch.configs.base import get_config
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.trellis import CCSDS_27
from repro_torch.kernels import acs, fused, traceback
from repro_torch.kernels.ops import pbvd_decode_blocks
from repro_torch.launch import cost
from repro_torch.launch.cost import WorkCounter
from repro_torch.launch.mesh import DecodeMesh
from repro_torch.sharding.place import place
from repro_torch.sharding.rules import NamedSharding, PartitionSpec, axis_rules, on_position
from repro_torch._unused import flash_attention as fa
from repro_torch._unused.models import attention, lm
from repro_torch._unused.serve.serve_step import make_prefill_step
from repro_torch._unused.train.optimizer import AdamWConfig
from repro_torch._unused.train.train_step import make_mesh_train_step, place_train_state


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_python_loop_counts_every_iteration():
    x, w = _meta(128, 128), _meta(128, 128)
    with WorkCounter() as c:
        for _ in range(10):
            x = x @ w
    assert c.flops == 2 * 128**3 * 10
    assert c.total().flops == {"f32": 2 * 128**3 * 10}


@pytest.mark.parametrize("dtype,kind", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
def test_matmul_counts_2mnk(dtype, kind):
    a, b = _meta(64, 256, dtype=dtype), _meta(256, 32, dtype=dtype)
    with WorkCounter() as c:
        a @ b
    assert dict(c.total().flops) == {kind: 2 * 64 * 256 * 32}
    assert c.bytes == (64 * 256 + 256 * 32 + 64 * 32) * a.element_size()


def test_slice_write_in_loop_counts_the_slice():
    N = 1024
    buf, xs = torch.zeros((64, N)), torch.randn(64, N)
    with WorkCounter() as c:
        for i in range(64):
            buf[i] = xs[i]
    assert torch.equal(buf, xs)
    assert c.bytes == 64 * 2 * N * 4  # each row read once and written once
    assert c.bytes < 64 * (64 * N * 4) / 2  # the whole buffer per iteration: the over-count


def test_scatter_counts_the_update():
    buf, idx, upd = _meta(4096, 64), torch.zeros(8, dtype=torch.long, device="meta"), _meta(8, 64)
    with WorkCounter() as c:
        buf.index_put_((idx,), upd, accumulate=True)
    assert c.bytes == 2 * 8 * 64 * 4 + 8 * 8


@pytest.mark.parametrize("dev", ["cpu", "meta"])
def test_gathered_placed_layer_counts_collective_bytes(dev):
    mesh = DecodeMesh([dev] * 8, (4, 2), ("data", "model"))
    w = torch.randn(16, 8, device=dev).requires_grad_(True)
    placed = place(w.detach(), NamedSharding(mesh, PartitionSpec("data", "model")), copy=True)
    for pos in placed.positions():
        placed.tiles[pos].requires_grad_(True)
    tile = 4 * 4 * 4  # a (4, 4) float32 tile
    with axis_rules(mesh), WorkCounter() as c:
        with on_position((1, 0)):
            full = placed.full()
            full.sum().backward()
    busy = c.tallies[(1, 0)]
    assert busy.collective_bytes == {"all-gather": 7 * tile, "reduce-scatter": 7 * tile}
    assert dict(busy.collective_counts) == {"all-gather": 1, "reduce-scatter": 1}
    if dev == "cpu":
        assert torch.equal(full.detach(), w.detach())


def test_counter_stands_meta_for_the_card():
    x = _meta(2, 8)
    assert not attention._use_flash(x) and device_rule.dispatch_type(x) == "meta"
    with WorkCounter():
        assert attention._use_flash(x) and device_rule.dispatch_type(x) == "cuda"
    with WorkCounter(target="cpu"):
        assert not attention._use_flash(x)
    assert device_rule.dispatch_type(x) == "meta"


def test_dryrun_smoke_tiny_mesh():
    """Reduced Mixtral's mesh train step over a (4, 2) meta mesh: FLOPs and
    collectives counted, the busiest position a data shard's first."""
    cfg = get_config("mixtral-8x22b").reduced()
    mesh = DecodeMesh(["meta"] * 8, (4, 2), ("data", "model"))
    opt_cfg = AdamWConfig()
    params, opt = place_train_state(lm.init_params(cfg, device="meta"), cfg, opt_cfg, mesh)
    step = make_mesh_train_step(cfg, opt_cfg, mesh)
    batch = {k: _meta(8, 64, dtype=torch.int32) for k in ("tokens", "labels")}
    with WorkCounter() as c:
        step(params, opt, batch)
    pos, busy = c.busiest()
    assert busy.as_dict()["flops"] > 0 and sum(busy.collective_bytes.values()) > 0
    assert pos[1] == 0 and len(c.tallies) == 8
    assert set(busy.collective_bytes) >= {"all-gather", "reduce-scatter"}


def test_prefill_products_equal_the_reference_hlo():
    """Reduced StarCoder2-3B prefill, 2 × 256 tokens, bf16 compute. The
    dense products and the logits are the same products in both (the
    reference's ``analyze_hlo`` of its meshless jitted prefill). Attention
    differs: the reference's streaming softmax multiplies every query head
    with every key of its kv chunks (T padded to its 1024-key chunk), QK
    and PV, 4·B·Hkv·G·S·Tp·dh; the port on the card runs the flash kernel
    over the causal, windowed band, 4·dh·B·Hkv·G·(band pairs)."""
    B, S = 2, 256
    jc, c = j_get_config("starcoder2-3b").reduced(), get_config("starcoder2-3b").reduced()
    sds = jax.eval_shape(lambda k: j_lm.init_params(k, jc), jax.random.PRNGKey(0))
    hlo = jax.jit(j_make_prefill_step(jc)).lower(
        sds, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}).compile().as_text()
    ref_flops = analyze_hlo(hlo).flops
    with WorkCounter() as wc:
        make_prefill_step(c)(lm.init_params(c, device="meta"),
                             {"tokens": _meta(B, S, dtype=torch.int64)})
    tot = wc.total()
    flash = tot.kernels["flash_attention"]
    products = tot.flops["bf16"] - flash["ops"]
    Hkv, G, dh = c.n_kv_heads, c.n_heads // c.n_kv_heads, c.head_dim
    Tp = -(-S // 1024) * 1024
    ref_attention = c.n_layers * 4 * B * Hkv * G * S * Tp * dh
    band = sum(min(p + 1, c.sliding_window) for p in range(S))
    assert flash["launches"] == c.n_layers
    assert flash["ops"] == c.n_layers * 4 * dh * B * Hkv * G * band
    assert products + ref_attention == ref_flops
    assert (products, ref_attention, flash["ops"]) == (62_914_560, 134_217_728, 7_356_416)


def _kernel_calls():
    code = get_code_spec("ccsds").code
    T, B = 100, 40
    g = torch.Generator().manual_seed(0)
    y8 = torch.randint(-127, 128, (T, 2, B), generator=g).to(torch.int8)
    yf = torch.randn((T, 2, B), generator=g)
    sp = torch.randint(-2**31, 2**31 - 1, (T, 2, B), generator=g, dtype=torch.int32)
    q = torch.randn(1, 64, 2, 2, 16, generator=g)
    k, v = torch.randn(1, 64, 2, 16, generator=g), torch.randn(1, 64, 2, 16, generator=g)
    kw = dict(decode_start=8, n_decode=64)
    return [
        ("acs i8", lambda y: acs.acs_forward(y, code), y8),
        ("acs f32 radix 4", lambda y: acs.acs_forward(y, code, radix=4), yf),
        ("acs matrix i8", lambda y: acs.acs_forward(y, code, "i16", impl="matrix", k=2), y8),
        ("acs matrix f32", lambda y: acs.acs_forward(y, code, impl="matrix", k=2), yf),
        ("traceback", lambda s: traceback.traceback(s, code, 8, 64, 0), sp),
        ("traceback_prefix", lambda s: traceback.traceback_prefix(s, code, 8, 64, 0, 16), sp),
        ("fused", lambda y: fused.pbvd_fused(y, code, **kw), y8),
        ("fused prefix matrix", lambda y: fused.pbvd_fused(y, code, tb_mode="prefix", impl="matrix",
                                                          metric_mode="i16", **kw), y8),
        ("flash f32", lambda q_: fa.flash_attention(q_, k.to(q_.device), v.to(q_.device),
                                                    window=16), q),
        ("flash bf16", lambda q_: fa.flash_attention(
            q_, k.to(q_.device, torch.bfloat16), v.to(q_.device, torch.bfloat16)),
         q.to(torch.bfloat16)),
    ]


@pytest.mark.parametrize("label,call,x", _kernel_calls(), ids=lambda v: v if isinstance(v, str)
                         else "")
def test_meta_branch_gives_the_cpu_branch_shapes_and_dtypes(label, call, x):
    counts = (acs.launches, acs.matrix_launches, traceback.launches, traceback.prefix_launches,
              fused.launches, fa.launches)
    cpu = call(x)
    with WorkCounter() as c:
        meta = call(x.to("meta"))
    cpu, meta = (cpu, meta) if isinstance(cpu, tuple) else ((cpu,), (meta,))
    for a, b in zip(cpu, meta):
        assert b.device.type == "meta" and b.shape == a.shape
        # the kernels keep int32 metrics in the narrow modes (acs.acs_forward's docstring)
        assert b.dtype == (torch.int32 if a.dtype in (torch.int16, torch.int8) else a.dtype)
    assert sum(k["launches"] for k in c.total().kernels.values()) == 1
    assert counts == (acs.launches, acs.matrix_launches, traceback.launches,
                      traceback.prefix_launches, fused.launches, fa.launches)


def test_meta_decode_counts_k1_and_k2_at_the_main_shapes():
    """The main path's 8,192 blocks of int8 CCSDS symbols: the bound inputs
    of PERF.md §6 rows 1 and 4."""
    with WorkCounter() as c:
        bits = pbvd_decode_blocks(_meta(596, 2, 8192, dtype=torch.int8), CCSDS_27,
                                  decode_start=42, n_decode=512, backend="cuda")
    assert bits.shape == (512, 8192) and bits.dtype == torch.int32
    k = c.total().kernels
    assert (k["acs_forward (K1)"]["bytes"], k["acs_forward (K1)"]["ops"]) == (50_921_472,
                                                                           1_259_667_456)
    assert k["traceback (K2)"]["bytes"] == 34_930_688
    assert k["acs_forward (K1)"]["launches"] == k["traceback (K2)"]["launches"] == 1


def test_one_source_for_the_bounds():
    """chip_smoke.py's bounds come from launch/cost.py, and give PERF.md §6's
    bound inputs and bounds (ms to the 4 digits printed there)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for name in ("k1_cost", "k2_cost", "fused_cost", "k1_matrix_cost", "k2_prefix_cost",
                 "flash_cost", "bound", "INT32_OPS_PER_S", "BF16_FLOPS_PER_S",
                 "F32_FLOPS_PER_S", "HBM_BYTES_PER_S"):
        assert getattr(smoke, name) is getattr(cost, name), name
    T, B, L, D = 596, 8192, 42, 512
    k1 = cost.k1_cost(CCSDS_27, T, B, 1)
    k2 = cost.k2_cost(T, B, L, D)
    f = cost.fused_cost(CCSDS_27, T, B, 1, L, D)
    fl = cost.flash_cost(2, 8192, 8192, 2, 12, 128, True, 4096, 2)
    assert k1 == (50_921_472, 1_259_667_456) and k2[0] == 34_930_688 and f[0] == 10_321_920
    assert f[1] == k1[1] + 6 * B * (T - L)
    assert f"{fl[1]:.4e}" == "6.1853e+11"
    ms = {"K1": cost.bound(*k1, cost.INT32_OPS_PER_S), "K2": cost.bound(*k2, cost.INT32_OPS_PER_S),
          "fused": cost.bound(*f, cost.INT32_OPS_PER_S),
          "flash": cost.bound(*fl, cost.BF16_FLOPS_PER_S),
          "flash f32": cost.bound(fl[0] * 2, fl[1], cost.F32_FLOPS_PER_S)}
    assert {k: (round(v[0], 4), v[1]) for k, v in ms.items()} == {
        "K1": (0.0753, "operations"), "K2": (0.0104, "bytes"), "fused": (0.0769, "operations"),
        "flash": (0.6254, "operations"), "flash f32": (9.2317, "operations")}
    mat = cost.k1_matrix_cost(CCSDS_27, T, B, 1, 2)
    pre = cost.k2_prefix_cost(CCSDS_27, T, B, L, D, 64)
    assert round(cost.bound(*mat, cost.INT32_OPS_PER_S)[0], 4) == 0.0969
    assert round(cost.bound(*pre, cost.INT32_OPS_PER_S)[0], 4) == 0.1100


def test_flash_band_keys_equal_the_loop():
    for S, T, causal, window in [(300, 200, False, 70), (129, 129, True, 9), (256, 512, True, None),
                                 (64, 64, False, None)]:
        keys = 0
        for p in range(S):
            lo = max(0, p - window + 1) if window else 0
            hi = min(T, p + 1) if causal else T
            keys += max(0, hi - lo)
        assert cost.flash_cost(1, S, T, 1, 1, 16, causal, window, 4)[1] == 4 * 16 * keys


def test_branch_metric_table_equals_the_reference():
    from repro.core.codespec import available_code_specs, get_code_spec as j_spec
    from repro.kernels import ref as j_ref
    from repro_torch.kernels import ref

    names = available_code_specs()
    assert len(names) == 9 and "branch_metric_table" in ref.__all__
    rng = np.random.default_rng(0)
    for name in names:
        R = j_spec(name).code.R
        for y in (rng.normal(size=(7, 5, R)).astype(np.float32),
                  rng.integers(-127, 128, (7, 5, R)).astype(np.float32)):
            got = ref.branch_metric_table(torch.as_tensor(y), get_code_spec(name).code)
            want = np.asarray(j_ref.branch_metric_table(jnp.asarray(y), j_spec(name).code))
            assert got.shape == want.shape == (7, 5, 1 << R)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
            if float(np.abs(y - np.round(y)).max()) == 0.0:  # integer symbols: exact
                assert np.array_equal(got.numpy(), want)
