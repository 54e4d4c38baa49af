"""The port's Mamba-1 and RWKV-6 mixers, the RWKV channel mix and the cards
that use them (Jamba-v0.1, RWKV6-3B) against the JAX package, on the CPU.

Weights are made by the JAX initializers and carried across by name (the
module's ``load_state_dict``, or ``convert_lm_params`` for a whole model);
inputs come from a numpy seed. Tolerances:

* the chunked scans in float32: ``_mamba_scan_chunked`` runs a log-depth
  scan inside each chunk where the reference runs ``associative_scan``, the
  same products in another order, so outputs and states agree to float32
  roundoff, atol/rtol 1e-5; the chunked WKV takes the same steps as the
  reference's, atol/rtol 1e-5;
* the mixers and blocks in float32 compute, prefill and cached decode:
  atol/rtol 1e-5; the cards' logits in float32 compute: atol 1e-4, as
  ``test_torch_lm.py`` holds StarCoder2; in bf16 compute: atol 5e-2 (RWKV6
  as a card, Jamba layer by layer; the whole Jamba card no farther from the
  float32 logits than the reference's bf16 logits);
* the port's own chunked prefill against its own token-by-token
  recurrence (another summation order, over outputs up to ~90): atol/rtol
  1e-4.

The WKV repair: where the per-step log-decay is large (−20), the
reference's chunked WKV overflows (``exp`` of a positive exponent above the
diagonal) and returns NaN; the port's is finite and equals its own
recurrence there.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerDesc as JLayerDesc
from repro.configs.base import get_config as j_get_config
from repro._unused.models import blocks as j_blocks
from repro._unused.models import layers as j_layers
from repro._unused.models import lm as j_lm
from repro._unused.models import ssm as j_ssm
from repro._unused.serve import serve_step as j_serve
from repro_torch.configs.base import LayerDesc, get_config
from repro_torch.interop import _leaves, convert_lm_params
from repro_torch._unused.models import blocks, layers, lm, ssm
from repro_torch._unused.serve import serve_step

B = 2
MAMBA = LayerDesc(mixer="mamba", ffn="dense")
RWKV6 = LayerDesc(mixer="rwkv6", ffn="dense")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(np.array(v)) for k, v in _leaves(tree)}, strict=True)
    return module


def _cfgs(name, **kw):
    """(JAX config, port config) of a card's ``reduced()`` preset."""
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _x(seed, S, d=64, scale=1.0):
    return (np.random.default_rng(seed).normal(size=(B, S, d)) * scale).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _tree_close(got, want, tol=1e-5):
    for g, w in zip(got, want):
        _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)), tol)


# ---- Mamba ----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mamba32():
    jcfg, cfg = _cfgs("jamba-v0.1-52b", compute_dtype="float32")
    p = _np(j_ssm.mamba_init(jax.random.PRNGKey(11), jcfg))
    return jcfg, cfg, p, _load(ssm.mamba_init(cfg, device="cpu"), p)


@pytest.mark.parametrize("S", [1, 63, 64, 70, 130])
def test_mamba_prefill_matches_jax(mamba32, S):
    """Chunk edges: one step, one short of a chunk, one chunk, a padded
    second chunk, two chunks and a padded third."""
    jcfg, cfg, p, module = mamba32
    x = _x(20 + S, S)
    want, _ = jax.jit(lambda p_, x_: j_ssm.mamba_apply(p_, x_, jcfg))(p, jnp.asarray(x))
    got, cache = ssm.mamba_apply(module, torch.as_tensor(x), cfg)
    assert cache is None and got.shape == (B, S, 64)
    _close(got.numpy(), want)


@pytest.mark.parametrize("S", [1, 63, 64, 70, 130])
def test_mamba_scan_chunked_matches_jax(S):
    """The scan alone from a non-zero state: outputs and the last state."""
    rng = np.random.default_rng(S)
    di, N = 32, 16
    dt = rng.uniform(1e-3, 0.3, (B, S, di)).astype(np.float32)
    xm, Bc, Cc = (rng.normal(size=shape).astype(np.float32)
                  for shape in ((B, S, di), (B, S, N), (B, S, N)))
    A = -np.exp(rng.normal(size=(di, N))).astype(np.float32)
    h0 = rng.normal(size=(B, di, N)).astype(np.float32)
    want_y, want_h = jax.jit(lambda *a: j_ssm._mamba_scan_chunked(*a, 64))(dt, A, Bc, Cc, xm, h0)
    got_y, got_h = ssm._mamba_scan_chunked(*(torch.as_tensor(a) for a in (dt, A, Bc, Cc, xm, h0)),
                                           64)
    _close(got_y.numpy(), want_y)
    _close(got_h.numpy(), want_h)


def test_first_order_scan_is_the_recurrence():
    rng = np.random.default_rng(3)
    a = torch.as_tensor(rng.uniform(0.5, 1.0, (2, 37, 3)), dtype=torch.float64)
    b = torch.as_tensor(rng.normal(size=(2, 37, 3)))
    Acum, Bcum = ssm._first_order_scan(a, b)
    h, prod = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
    for t in range(37):
        h, prod = a[:, t] * h + b[:, t], prod * a[:, t]
        torch.testing.assert_close(Bcum[:, t], h, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(Acum[:, t], prod, rtol=1e-12, atol=1e-12)


def test_mamba_decode_matches_jax_and_the_prefill(mamba32):
    """70 cached steps (past one chunk): each step's output and cache equal
    to the reference's cached step; the outputs equal to the port's prefill,
    and the final state to the prefill's chunked scan."""
    jcfg, cfg, p, module = mamba32
    n = 70
    x = _x(31, n)
    di, N, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    jcache = j_ssm.MambaCache(jnp.zeros((B, dc - 1, di)), jnp.zeros((B, di, N)))
    cache = blocks.block_cache_init(cfg, MAMBA, B, n, torch.float32, device="cpu")["mixer"]
    assert cache.conv.shape == (B, dc - 1, di) and cache.h.shape == (B, di, N)
    jstep = jax.jit(lambda p_, x_, c_: j_ssm.mamba_apply(p_, x_, jcfg, cache=c_))
    outs = []
    for t in range(n):
        want, jcache = jstep(p, jnp.asarray(x[:, t:t + 1]), jcache)
        got, cache = ssm.mamba_apply(module, torch.as_tensor(x[:, t:t + 1]), cfg, cache=cache)
        _close(got.numpy(), want)
        _tree_close(cache, jcache)
        outs.append(got)
    full, _ = ssm.mamba_apply(module, torch.as_tensor(x), cfg)
    _close(torch.cat(outs, 1).numpy(), full.numpy(), 1e-4)
    # the chunked scan's last state is the decoded state
    seen = {}
    scan = ssm._mamba_scan_chunked

    def spy(*a):
        y, h = scan(*a)
        seen["h"] = h
        return y, h

    ssm._mamba_scan_chunked = spy
    try:
        ssm.mamba_apply(module, torch.as_tensor(x), cfg)
    finally:
        ssm._mamba_scan_chunked = scan
    _close(seen["h"].numpy(), cache.h.numpy(), 1e-4)


def test_mamba_bf16_matches_jax():
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    assert cfg.compute_dtype == "bfloat16"
    p = _np(j_ssm.mamba_init(jax.random.PRNGKey(12), jcfg))
    module = _load(ssm.mamba_init(cfg, device="cpu"), p)
    x = _x(41, 70)
    want, _ = jax.jit(lambda p_, x_: j_ssm.mamba_apply(p_, x_, jcfg))(
        p, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = ssm.mamba_apply(module, torch.as_tensor(x).bfloat16(), cfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=5e-2)


def test_mamba_init_follows_the_reference_recipe():
    _, cfg = _cfgs("jamba-v0.1-52b")
    m = ssm.mamba_init(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    di, N, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    dt = torch.nn.functional.softplus(m.dt_bias)
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())
    torch.testing.assert_close(m.A_log, torch.log(torch.arange(1.0, N + 1)).expand(di, N))
    assert bool((m.D == 1).all()) and bool((m.conv_b == 0).all())
    assert m.conv_w.shape == (dc, di) and m.dt_proj.b is None and m.in_proj.w.shape == (64, 2 * di)
    assert abs(float(m.conv_w.std()) - 1 / math.sqrt(dc)) < 0.1
    assert ssm.mamba_init(cfg, device="meta").A_log.device.type == "meta"


# ---- RWKV-6 -----------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rwkv32():
    jcfg, cfg = _cfgs("rwkv6-3b", compute_dtype="float32")
    p = _np(j_ssm.rwkv_init(jax.random.PRNGKey(13), jcfg))
    p["u"] = np.random.default_rng(13).normal(size=p["u"].shape).astype(np.float32) * 0.5
    return jcfg, cfg, p, _load(ssm.rwkv_init(cfg, device="cpu"), p)


@pytest.mark.parametrize("S", [1, 31, 32, 40])
def test_rwkv_prefill_matches_jax(rwkv32, S):
    jcfg, cfg, p, module = rwkv32
    x = _x(50 + S, S)
    want, _ = jax.jit(lambda p_, x_: j_ssm.rwkv_apply(p_, x_, jcfg))(p, jnp.asarray(x))
    got, cache = ssm.rwkv_apply(module, torch.as_tensor(x), cfg)
    assert cache is None
    _close(got.numpy(), want)


def test_rwkv_decode_matches_jax_and_the_prefill(rwkv32):
    """40 cached steps (past one chunk): each output and cache equal to the
    reference's; ``x_tm`` is the step's input, ``x_cm`` untouched by the
    time mix; the outputs equal to the port's prefill."""
    jcfg, cfg, p, module = rwkv32
    n = 40
    x = _x(61, n)
    H, dh = 64 // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    jcache = j_ssm.RwkvCache(jnp.zeros((B, 1, 64)), jnp.zeros((B, 1, 64)),
                             jnp.zeros((B, H, dh, dh)))
    cache = blocks.block_cache_init(cfg, RWKV6, B, n, torch.float32, device="cpu")["mixer"]
    assert cache.s.shape == (B, H, dh, dh) and cache.s.dtype == torch.float32
    jstep = jax.jit(lambda p_, x_, c_: j_ssm.rwkv_apply(p_, x_, jcfg, cache=c_))
    outs = []
    for t in range(n):
        want, jcache = jstep(p, jnp.asarray(x[:, t:t + 1]), jcache)
        got, cache = ssm.rwkv_apply(module, torch.as_tensor(x[:, t:t + 1]), cfg, cache=cache)
        _close(got.numpy(), want)
        _tree_close(cache, jcache)
        np.testing.assert_array_equal(cache.x_tm.numpy(), x[:, t:t + 1])
        outs.append(got)
    assert not bool(cache.x_cm.any())
    full, _ = ssm.rwkv_apply(module, torch.as_tensor(x), cfg)
    _close(torch.cat(outs, 1).numpy(), full.numpy(), 1e-4)


def test_rwkv_bf16_matches_jax(rwkv32):
    jcfg, cfg, p, module = rwkv32
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    x = _x(71, 40)
    want, _ = jax.jit(lambda p_, x_: j_ssm.rwkv_apply(p_, x_, jcfg))(
        p, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = ssm.rwkv_apply(module, torch.as_tensor(x).bfloat16(), cfg)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=5e-2)


def _wkv_inputs(S, logw_value, *, seed=0, H=1, dh=4):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(1, H, S, dh)).astype(np.float32) for _ in range(3))
    if logw_value is None:  # the init's decay: w0 = -6, a small LoRA
        logw = -np.exp(-6.0 + 0.01 * rng.normal(size=(1, H, S, dh))).astype(np.float32)
    else:
        logw = np.full((1, H, S, dh), logw_value, np.float32)
    u = rng.normal(size=(H, dh)).astype(np.float32)
    s0 = rng.normal(size=(1, H, dh, dh)).astype(np.float32)
    return r, k, v, logw, u, s0


def _wkv_recurrence(r, k, v, logw, u, s0):
    """The token-by-token recurrence of the port's decode step."""
    s, outs = s0, []
    for t in range(r.shape[2]):
        ri, ki, vi = r[:, :, t], k[:, :, t], v[:, :, t]
        kv = torch.einsum("bhd,bhe->bhde", ki, vi)
        outs.append(torch.einsum("bhd,bhde->bhe", ri, s + u[None, :, :, None] * kv))
        s = s * torch.exp(logw[:, :, t])[..., None] + kv
    return torch.stack(outs, 2), s


@pytest.mark.parametrize("S", [1, 31, 32, 40, 70])
def test_rwkv_chunked_matches_jax_at_the_init_decay(S):
    args = _wkv_inputs(S, None, seed=S, H=2, dh=8)
    want_o, want_s = jax.jit(lambda *a: j_ssm._rwkv_chunked(*a, 32))(*args)
    got_o, got_s = ssm._rwkv_chunked(*(torch.as_tensor(a) for a in args), 32)
    _close(got_o.numpy(), want_o)
    _close(got_s.numpy(), want_s)
    rec_o, rec_s = _wkv_recurrence(*(torch.as_tensor(a) for a in args))
    _close(got_o.numpy(), rec_o.numpy(), 1e-4)
    _close(got_s.numpy(), rec_s.numpy(), 1e-4)


@pytest.mark.parametrize("logw", [-0.01, -1.0, -5.0, -20.0])
def test_rwkv_chunked_stays_finite_at_strong_decay(logw):
    """B = H = 1, S = 40, dh = 4, a constant per-step log-decay: the port's
    chunked WKV equals its recurrence; the reference's equals it too while
    it is finite, and holds NaN at −5 and −20 (its exponent above the
    diagonal reaches 31 · 5 > 88)."""
    args = _wkv_inputs(40, logw, seed=1)
    got_o, got_s = ssm._rwkv_chunked(*(torch.as_tensor(a) for a in args), 32)
    rec_o, rec_s = _wkv_recurrence(*(torch.as_tensor(a) for a in args))
    assert bool(torch.isfinite(got_o).all()) and bool(torch.isfinite(got_s).all())
    _close(got_o.numpy(), rec_o.numpy(), 1e-4)
    _close(got_s.numpy(), rec_s.numpy(), 1e-4)
    want_o, _ = jax.jit(lambda *a: j_ssm._rwkv_chunked(*a, 32))(*args)
    if logw >= -1.0:
        _close(got_o.numpy(), want_o)
    else:
        assert np.isnan(np.asarray(want_o)).any()


def test_rwkv_prefill_equals_its_decode_at_strong_decay(rwkv32):
    """The whole mixer with w0 = log 20 and no LoRA (log w = −20 per step):
    the port's prefill is finite and equals its cached steps; the
    reference's prefill holds NaN."""
    jcfg, cfg, p, _ = rwkv32
    p = {**p, "w0": np.full_like(p["w0"], math.log(20.0)),
         "w_lora_b": {"w": np.zeros_like(p["w_lora_b"]["w"])}}
    module = _load(ssm.rwkv_init(cfg, device="cpu"), p)
    x = _x(81, 40)
    full, _ = ssm.rwkv_apply(module, torch.as_tensor(x), cfg)
    assert bool(torch.isfinite(full).all())
    cache = blocks.block_cache_init(cfg, RWKV6, B, 40, torch.float32, device="cpu")["mixer"]
    outs = []
    for t in range(40):
        o, cache = ssm.rwkv_apply(module, torch.as_tensor(x[:, t:t + 1]), cfg, cache=cache)
        outs.append(o)
    _close(torch.cat(outs, 1).numpy(), full.numpy(), 1e-4)
    want, _ = jax.jit(lambda p_, x_: j_ssm.rwkv_apply(p_, x_, jcfg))(p, jnp.asarray(x))
    assert np.isnan(np.asarray(want)).any()


def test_rwkv_init_follows_the_reference_recipe():
    _, cfg = _cfgs("rwkv6-3b")
    m = ssm.rwkv_init(cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    H, dh = 64 // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert m.mu.shape == (5, 64) and bool((m.mu == 0.5).all())
    assert bool((m.w0 == -6).all()) and bool((m.u == 0).all()) and m.u.shape == (H, dh)
    assert bool((m.ln_scale == 1).all()) and bool((m.ln_bias == 0).all())
    assert m.wr.w.shape == (64, H, dh) and m.w_lora_a.w.shape == (64, cfg.rwkv_decay_lora)
    assert float(m.w_lora_b.w.abs().max()) < 0.1  # scale 0.01


# ---- the channel mix ------------------------------------------------------------------
@pytest.mark.parametrize("shifted", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_jax(shifted, dtype):
    jcfg, cfg = _cfgs("rwkv6-3b", compute_dtype=dtype)
    p = _np(j_layers.ffn_init(jax.random.PRNGKey(14), jcfg, jcfg.d_ff))
    p["mu"] = np.random.default_rng(14).uniform(0, 1, p["mu"].shape).astype(np.float32)
    module = _load(layers.ffn_init(cfg, cfg.d_ff, device="cpu"), p)
    assert isinstance(module, layers.ChannelMix)
    x, xp = _x(90, 16), _x(91, 16)
    jx, tx = jnp.asarray(x).astype(dtype), torch.as_tensor(x).to(getattr(torch, dtype))
    jxp = jnp.asarray(xp).astype(dtype) if shifted else None
    txp = torch.as_tensor(xp).to(tx.dtype) if shifted else None
    want = j_layers.ffn_apply(p, jx, jcfg, x_prev=jxp)
    got = layers.ffn_apply(module, tx, cfg, x_prev=txp)
    tol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol, rtol=tol)


# ---- blocks -------------------------------------------------------------------------------
BLOCKS = [("jamba-v0.1-52b", MAMBA), ("jamba-v0.1-52b", LayerDesc(mixer="mamba", ffn="moe")),
          ("rwkv6-3b", RWKV6)]


@pytest.mark.parametrize("desc", [MAMBA, LayerDesc(mixer="mamba", ffn="moe"),
                                  LayerDesc(mixer="gqa", ffn="dense"),
                                  LayerDesc(mixer="gqa", ffn="moe")])
def test_jamba_block_bf16_matches_jax(desc):
    """Each of Jamba's four layer kinds in bf16 compute on the same input:
    atol 5e-2. (The whole reduced card is held in float32 only: over its 8
    layers bf16 rounding moves both frameworks' logits by 0.3–1.4 from
    their float32 values, and a router whose 2nd and 3rd expert lie 1.5e-4
    apart picks by the last bf16 bit.)"""
    jcfg, cfg = _cfgs("jamba-v0.1-52b")
    jdesc = JLayerDesc(mixer=desc.mixer, ffn=desc.ffn)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(16), jcfg, jdesc))
    block = _load(blocks.block_init(cfg, desc, device="cpu"), p)
    x, pos = _x(120, 70), np.arange(70)
    want, _ = jax.jit(lambda p_, x_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=jnp.asarray(pos)))(p, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = blocks.block_apply(block, torch.as_tensor(x).bfloat16(), cfg, desc,
                                positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=5e-2)


@pytest.mark.parametrize("name,desc", BLOCKS)
def test_block_with_cache_matches_jax(name, desc):
    """Prefill of 40 positions, then 6 cached steps from a zero cache: the
    reference's outputs and caches (RWKV: ``x_tm`` and ``x_cm`` are the
    step's normed inputs)."""
    jcfg, cfg = _cfgs(name, compute_dtype="float32", capacity_factor=2.0)
    jdesc = JLayerDesc(mixer=desc.mixer, ffn=desc.ffn)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(15), jcfg, jdesc))
    block = _load(blocks.block_init(cfg, desc, device="cpu"), p)
    x = _x(100, 40)
    pos = np.arange(40)
    want, _ = jax.jit(lambda p_, x_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=jnp.asarray(pos)))(p, jnp.asarray(x))
    got, nc = blocks.block_apply(block, torch.as_tensor(x), cfg, desc,
                                 positions=torch.as_tensor(pos))
    assert nc is None
    _close(got.numpy(), want)
    jcache = j_blocks.block_cache_init(jcfg, jdesc, B, 6, jnp.float32)
    cache = blocks.block_cache_init(cfg, desc, B, 6, torch.float32, device="cpu")
    jstep = jax.jit(lambda p_, x_, pos_, c_, n_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=pos_, cache=c_, cache_len=n_))
    for t in range(6):
        xt, pt = x[:, t:t + 1], np.array([t])
        want, jnc = jstep(p, jnp.asarray(xt), jnp.asarray(pt), jcache, jnp.int32(t))
        got, nc = blocks.block_apply(block, torch.as_tensor(xt), cfg, desc,
                                     positions=torch.as_tensor(pt), cache=cache, cache_len=t)
        _close(got.numpy(), want)
        _tree_close(nc["mixer"], jnc["mixer"])
        jcache, cache = {**jcache, **jnc}, {**cache, **nc}


def test_rwkv_block_channel_mix_shift():
    """The channel mix's token shift inside a block: the prefill shifts the
    normed input by one position; a decode step reads ``x_cm`` and leaves
    its normed input there."""
    _, cfg = _cfgs("rwkv6-3b", compute_dtype="float32")
    block = blocks.block_init(cfg, RWKV6, gen=torch.Generator().manual_seed(1), device="cpu")
    x = torch.as_tensor(_x(110, 1))
    cache = blocks.block_cache_init(cfg, RWKV6, B, 1, torch.float32, device="cpu")
    h, nc = blocks.block_apply(block, x, cfg, RWKV6, positions=torch.zeros(1, dtype=torch.long),
                               cache=cache, cache_len=0)
    out, _ = ssm.rwkv_apply(block.mixer, layers.norm_apply(block.norm1, x, cfg), cfg,
                            cache=cache["mixer"])
    xn = layers.norm_apply(block.norm2, x + out, cfg)
    torch.testing.assert_close(nc["mixer"].x_cm, xn)
    torch.testing.assert_close(nc["mixer"].x_tm, layers.norm_apply(block.norm1, x, cfg))
    torch.testing.assert_close(h, x + out + layers.ffn_apply(block.ffn, xn, cfg,
                                                             x_prev=torch.zeros_like(xn)))


def test_block_cache_dtypes():
    _, jamba = _cfgs("jamba-v0.1-52b")
    _, rwkv = _cfgs("rwkv6-3b")
    c = blocks.block_cache_init(jamba, MAMBA, 3, 9, torch.bfloat16, device="cpu")["mixer"]
    assert c.conv.dtype == torch.bfloat16 and c.h.dtype == torch.float32
    assert c.conv.shape == (3, 3, 128) and c.h.shape == (3, 128, 16)
    c = blocks.block_cache_init(rwkv, RWKV6, 3, 9, torch.bfloat16, device="cpu")["mixer"]
    assert c.x_tm.dtype == c.x_cm.dtype == torch.bfloat16 and c.s.dtype == torch.float32
    assert c.x_tm.shape == (3, 1, 64) and c.s.shape == (3, 4, 16, 16)


# ---- the cards ------------------------------------------------------------------------------
CARDS = ["jamba-v0.1-52b", "rwkv6-3b"]


def _j_init(seed, jcfg):
    """The reference's ``init_params``, compiled (eagerly it takes seconds)."""
    return jax.jit(j_lm.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)


def _j_greedy(params, jcfg, prompt, n_new):
    """The reference's ``greedy_generate`` loop over its compiled decode step."""
    S0 = prompt.shape[1]
    step = jax.jit(j_serve.make_decode_step(jcfg, S0 + n_new))
    cache = j_lm.init_cache(jcfg, prompt.shape[0], S0 + n_new)
    for t in range(S0):
        nxt, cache = step(params, jnp.asarray(prompt[:, t:t + 1]), cache, jnp.int32(t))
    out = []
    for t in range(n_new):
        out.append(nxt)
        nxt, cache = step(params, nxt[:, None], cache, jnp.int32(S0 + t))
    return np.stack([np.asarray(o) for o in out], 1)


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(8).integers(0, 512, (B, 70)).astype(np.int32)


@pytest.fixture(scope="module", params=CARDS)
def card32(request):
    jcfg, cfg = _cfgs(request.param, compute_dtype="float32", capacity_factor=2.0)
    params = _j_init(len(request.param), jcfg)
    return jcfg, cfg, params, convert_lm_params(_np(params), cfg, device="cpu")


def test_card_reduced_logits_match_jax(card32, tokens):
    jcfg, cfg, params, model = card32
    assert lm.count_params(model) == j_lm.count_params(params) == lm.param_count(cfg)
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert got.shape == want.shape == (B, 70, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_rwkv_card_reduced_bf16_logits_match_jax(tokens):
    jcfg, cfg = _cfgs("rwkv6-3b")
    assert cfg.compute_dtype == "bfloat16"
    params = _j_init(8, jcfg)
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    model = convert_lm_params(_np(params), cfg, device="cpu")
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


def test_jamba_card_reduced_bf16_is_as_close_as_jax(tokens):
    """bf16 compute over the 8 layers: the port's logits lie no farther from
    the reference's float32 logits than the reference's own bf16 logits do
    (mean absolute deviation, within a tenth; the port's is about 0.042,
    the reference's 0.056). Each layer kind is held at atol 5e-2 above."""
    want, params = {}, None
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs("jamba-v0.1-52b", compute_dtype=dtype)
        params = _j_init(14, jcfg) if params is None else params  # init ignores the dtype
        want[dtype] = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
            params, jnp.asarray(tokens)))
    model = convert_lm_params(_np(params), cfg, device="cpu")
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg).numpy()
    ours = np.abs(got - want["float32"]).mean()
    theirs = np.abs(want["bfloat16"] - want["float32"]).mean()
    assert 0 < ours <= 1.1 * theirs


def test_card_reduced_decode_and_greedy_match_jax(card32, tokens):
    """66 cached steps (past two RWKV chunks and a Mamba chunk): the
    reference's cached logits at every step and the port's full forward
    (capacity_factor 2: C = S, no token dropped); greedy tokens equal to
    the reference's (bf16 cache, the default, in both)."""
    jcfg, cfg, params, model = card32
    n = 66
    jstep = jax.jit(lambda p, t, c, n_: j_lm.apply_decode(p, t, c, n_, jcfg))
    jcache = j_lm.init_cache(jcfg, B, n, dtype=jnp.float32)
    cache = lm.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    full = lm.apply_train(model, {"tokens": torch.as_tensor(tokens[:, :n])}, cfg).numpy()
    for t in range(n):
        jl, jcache = jstep(params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
        pl, cache = lm.apply_decode(model, torch.as_tensor(tokens[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, t], atol=1e-4)
    prompt = tokens[:, :4]
    want = _j_greedy(params, jcfg, prompt, 8)
    got = serve_step.greedy_generate(model, cfg, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", CARDS)
def test_card_full_size_count_from_shapes(name):
    """On the meta device: the count from the shapes is ``lm.param_count``;
    the estimate is the reference's."""
    cfg = get_config(name)
    assert lm.count_params(lm.init_params(cfg, device="meta")) == lm.param_count(cfg)
    assert cfg.n_params_estimate == j_get_config(name).n_params_estimate
    assert cfg.n_active_params_estimate == j_get_config(name).n_active_params_estimate
    assert (cfg.dt_rank, cfg.mamba_d_inner) == (j_get_config(name).dt_rank,
                                                j_get_config(name).mamba_d_inner)
