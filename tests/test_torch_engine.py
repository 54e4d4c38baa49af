"""The port's decode path end to end against the JAX reference, on the CPU.

Golden vectors of every registered spec replay through the port's ``"ref"``
and ``"cuda"`` backends (on CPU tensors ``"cuda"`` runs the kernels' plain
versions); noisy streams decode bit-equal to the JAX ``backend="ref"``
engine; ``decode_batch`` equals per-stream ``decode``; the device rule, the
registry's knob errors and the import boundary hold. The narrow metric
modes, radix 4 and the ``"fused"`` backend are held against the reference in
``test_torch_metric_modes.py`` and ``test_torch_fused.py``.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.engine import DecoderEngine, DeviceUnavailableError
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.kernels import registry
from repro_torch.kernels.ops import available_backends, pbvd_decode_blocks
from repro_torch.launch.faults import SymbolError

ROOT = Path(__file__).resolve().parent.parent
GOLDEN_DIR = ROOT / "tests" / "golden"


def _golden(name):
    with np.load(GOLDEN_DIR / (name.replace("/", "_") + ".npz"), allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(str(data["meta"]))
    return data


def test_port_declares_ref_and_cuda_backends():
    assert available_backends() == ["cuda", "fused", "ref"]
    for be in available_backends():
        starts = ("zero",) if be == "fused" else ("zero", "argmin")
        assert registry.backend_start_policies(be) == starts
        assert registry.backend_metric_modes(be) == ("f32", "i16", "i8")
        assert registry.backend_tb_modes(be) == ("serial", "prefix")
        assert registry.backend_tb_chunk_sensitive(be) == (be != "ref")
        assert registry.backend_preferred_tb_mode(be) == "serial"
        assert registry.backend_acs_radix(be) == (2, 4)
        assert registry.backend_acs_impl(be) == ("butterfly", "matrix")


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("name", available_code_specs())
def test_golden_bits_f32_replay(name, backend):
    g = _golden(name)
    meta = g["meta"]
    cfg = PBVDConfig(spec=get_code_spec(name), D=meta["D"], L=meta["L"], q=meta["q"],
                     backend=backend)
    bits = DecoderEngine(cfg, device="cpu").decode(g["y"], meta["n_bits"])
    assert bits.dtype == torch.int32 and bits.device.type == "cpu"
    np.testing.assert_array_equal(bits.numpy(), g["bits_f32"])


def _noisy_stream(name: str, n_bits: int, seed: int):
    """A transmission made with numpy: BPSK of the encoded payload plus noise
    (the punctured wire format for punctured specs)."""
    from repro_torch.core.encoder import encode_np, terminate

    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return (1.0 - 2.0 * tx + rng.normal(scale=0.8, size=tx.shape)).astype(np.float32)


@pytest.mark.parametrize(
    "name,q,start_policy",
    [("ccsds", 8, "zero"), ("ccsds", None, "zero"), ("ccsds", 8, "argmin"),
     ("ccsds-3/4", 8, "zero"), ("lte-1/3", None, "argmin"), ("is95-k9", 8, "argmin")],
)
def test_decode_bit_equal_to_jax_ref_engine(name, q, start_policy):
    y = _noisy_stream(name, 300, seed=len(name) + (q or 0))
    geo = dict(D=32, L=20, q=q, start_policy=start_policy, backend="ref")
    want = JEngine(JConfig(spec=j_get_code_spec(name), **geo)).decode(jnp.asarray(y), 300)
    for backend in ("ref", "cuda"):
        cfg = PBVDConfig(spec=get_code_spec(name), **{**geo, "backend": backend})
        got = DecoderEngine(cfg, device="cpu").decode(torch.as_tensor(y), 300)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=backend)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("fleet", ["uniform", "ragged", "punctured"])
def test_decode_batch_equals_per_stream_decode(fleet, backend):
    name = "ccsds-2/3" if fleet == "punctured" else "ccsds"
    cfg = PBVDConfig(spec=get_code_spec(name), D=24, L=12, backend=backend)
    engine = DecoderEngine(cfg, device="cpu")
    if fleet == "ragged":
        ys = [_noisy_stream(name, n, seed=n) for n in (50, 24, 97, 3)]
        n_bits = [50, None, 90, 3]
    else:
        ys = [_noisy_stream(name, 120, seed=s) for s in range(4)]
        n_bits = [120] * 4 if fleet == "uniform" else None
    got = engine.decode_batch(ys, n_bits)
    assert len(got) == len(ys)
    for i, y in enumerate(ys):
        want = engine.decode(y, None if n_bits is None else n_bits[i])
        assert torch.equal(got[i], want), i
    assert engine.decode_batch([]) == []
    with pytest.raises(ValueError, match="n_bits_list"):
        engine.decode_batch(ys, [None])


def test_default_device_is_cuda_and_refuses_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        DecoderEngine(PBVDConfig())
    with pytest.raises(DeviceUnavailableError):
        DecoderEngine(PBVDConfig(), device="cuda:0")
    assert DecoderEngine(PBVDConfig(), device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize(
    "knob,value",
    [("metric_mode", "i16"), ("metric_mode", "i8"), ("tb_mode", "prefix"),
     ("acs_radix", 4), ("acs_impl", "matrix"), ("start_policy", "oracle")],
)
@pytest.mark.parametrize("backend", ["ref", "cuda", "fused"])
def test_unported_knobs_raise_knob_error(backend, knob, value):
    blocks = torch.zeros((8, 2, 1), dtype=torch.int8)
    ccsds = get_code_spec("ccsds").code
    if knob != "start_policy":  # ported: now accepted everywhere
        assert getattr(PBVDConfig(backend=backend, **{knob: value}), knob) == value
        bits = pbvd_decode_blocks(blocks, ccsds, decode_start=2, n_decode=4, backend=backend,
                                  **{knob: value})
        assert bits.shape == (4, 1) and bits.dtype == torch.int32
        return
    allowed = ("zero",) if backend == "fused" else ("zero", "argmin")
    with pytest.raises(ValueError) as info:
        PBVDConfig(backend=backend, **{knob: value})
    assert str(info.value) == str(registry.knob_error(backend, knob, value, allowed))
    with pytest.raises(ValueError, match=f"does not support {knob}="):
        pbvd_decode_blocks(blocks, ccsds, decode_start=2, n_decode=4, backend=backend,
                           **{knob: value})


def test_unknown_backend_and_bad_symbols():
    with pytest.raises(KeyError, match="unknown decode backend"):
        PBVDConfig(backend="pallas")
    engine = DecoderEngine(PBVDConfig(D=16, L=6), device="cpu")
    y = np.ones((40, 2), dtype=np.float32)
    y[7, 1] = np.nan
    with pytest.raises(SymbolError, match="non-finite"):
        engine.decode(y)
    with pytest.raises(SymbolError, match="stream 1"):
        engine.decode_batch([np.ones((40, 2), np.float32), y])
    with pytest.raises(SymbolError, match="unpunctured"):
        engine.decode(np.ones(40, np.float32))
    with pytest.raises(SymbolError, match="rank"):
        engine.decode(np.ones((40, 3), np.float32))


def test_inputs_convert_like_the_reference():
    """float64 symbols decode as float32, int64 as int32, numpy as tensors."""
    y = _noisy_stream("ccsds", 64, seed=1).astype(np.float64)
    engine = DecoderEngine(PBVDConfig(D=16, L=6, q=None, backend="ref"), device="cpu")
    a = engine.decode(y)
    assert torch.equal(a, engine.decode(torch.as_tensor(y, dtype=torch.float32)))
    z = np.round(y * 20).astype(np.int64)
    assert torch.equal(engine.decode(z), engine.decode(z.astype(np.int32)))


def test_port_imports_neither_jax_nor_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for m in mods:
    importlib.import_module(m)
# and drive the prefix walk and the matrix ACS through their plain versions
import torch
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
for be in ("ref", "cuda", "fused"):
    cfg = PBVDConfig(D=32, L=8, backend=be, tb_mode="prefix", tb_chunk=5, acs_impl="matrix")
    DecoderEngine(cfg, device="cpu").decode(torch.ones((70, 2)))
# and the LM serving path: prefill (flash's plain version) and greedy decode
from repro_torch.configs.base import get_config
from repro_torch._unused.models import attention, lm
from repro_torch._unused.serve.serve_step import greedy_generate, make_prefill_step
lcfg = get_config("starcoder2-3b").reduced()
params = lm.init_params(lcfg, device="cpu")
toks = torch.zeros((1, 16), dtype=torch.long)
with attention.flash_enabled("on"):
    make_prefill_step(lcfg)(params, {"tokens": toks})
assert greedy_generate(params, lcfg, toks[:, :4], 3).shape == (1, 3)
# and one training step
from repro_torch._unused.train.optimizer import AdamWConfig, adamw_init
from repro_torch._unused.train.train_step import make_train_step
opt = adamw_init(dict(params.named_parameters()), AdamWConfig())
make_train_step(lcfg, AdamWConfig())(params.requires_grad_(True), opt,
                                      {"tokens": toks, "labels": toks})
assert "repro_torch.kernels.traceback" in mods and "repro_torch.kernels.fused" in mods
assert "repro_torch._unused.flash_attention" in mods and "repro_torch.launch.serve" in mods
assert "repro_torch._unused.train.checkpoint" in mods and "repro_torch.launch.train" in mods
bad = sorted(m for m in sys.modules
             if m in ("jax", "jaxlib", "repro") or m.startswith(("jax.", "jaxlib.", "repro.")))
print(len(mods), bad)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         check=True).stdout.split(None, 1)
    assert int(out[0]) >= 28
    assert out[1].strip() == "[]"
