"""The port's host-side model against the JAX reference, on the CPU.

Code tables, depuncturing, quantization, framing, encoder, channel helpers,
saturation-budget helpers and config conversion: the same inputs, made from
a seed with numpy, go through ``repro`` and ``repro_torch``; integer and
table results must be equal, float helpers equal to the last bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import codespec as j_codespec
from repro.core import encoder as j_encoder
from repro.core import quantize as j_quantize
from repro.core.channel import bpsk as j_bpsk, ebn0_to_sigma as j_sigma
from repro.core.pbvd import PBVDConfig as JConfig, frame_stream as j_frame_stream
from repro.core.pbvd import throughput_model as j_throughput_model
from repro_torch.core import codespec, encoder, quantize
from repro_torch.core.channel import awgn, bpsk, ebn0_to_sigma, transmit
from repro_torch.core.pbvd import PBVDConfig, frame_stream, throughput_model
from repro_torch.interop import config_fields, convert_config
from repro_torch.launch.faults import DecodeError, StreamError, SymbolError

SPECS = j_codespec.available_code_specs()
PUNCTURED = [n for n in SPECS if j_codespec.get_code_spec(n).is_punctured]
CODES = {
    "ccsds": j_codespec.get_code_spec("ccsds").code,
    "is95-k9": j_codespec.get_code_spec("is95-k9").code,
    "lte-1/3": j_codespec.get_code_spec("lte-1/3").code,
}


def _assert_tables_equal(jt, tt):
    assert jt.keys() == tt.keys()
    for key in jt:
        np.testing.assert_array_equal(jt[key], tt[key], err_msg=key)


def test_registry_holds_the_same_specs():
    assert codespec.available_code_specs() == SPECS
    assert len(SPECS) == 9


@pytest.mark.parametrize("name", SPECS)
def test_code_tables_equal(name):
    j, t = j_codespec.get_code_spec(name), codespec.get_code_spec(name)
    assert (t.name, t.puncture, t.code.polys) == (j.name, j.puncture, j.code.polys)
    jc, tc = j.code, t.code
    assert (tc.R, tc.K, tc.v, tc.n_states, tc.x_mask, tc.l_mask, tc.n_folded) == (
        jc.R, jc.K, jc.v, jc.n_states, jc.x_mask, jc.l_mask, jc.n_folded)
    for attr in ("poly_ints", "alpha", "butterfly_codewords", "codeword_signs",
                 "folded_codeword_signs", "fold_index", "fold_sign"):
        np.testing.assert_array_equal(getattr(jc, attr), getattr(tc, attr), err_msg=attr)
    _assert_tables_equal(jc.acs_tables, tc.acs_tables)
    _assert_tables_equal(jc.folded_acs_tables, tc.folded_acs_tables)
    _assert_tables_equal(jc.radix4_acs_tables, tc.radix4_acs_tables)
    np.testing.assert_array_equal(j.kept_slots_period, t.kept_slots_period)


@pytest.mark.parametrize("name", PUNCTURED)
@pytest.mark.parametrize("n_sym", [1, 7, 30])
def test_depuncture_equal(name, n_sym):
    rng = np.random.default_rng(n_sym)
    y = rng.normal(size=n_sym).astype(np.float32)
    j, t = j_codespec.get_code_spec(name), codespec.get_code_spec(name)
    for n_stages in (None, t.n_stages_for(n_sym) + 3):
        want = np.asarray(j.depuncture_stream(jnp.asarray(y), n_stages))
        got = t.depuncture_stream(torch.as_tensor(y), n_stages).numpy()
        np.testing.assert_array_equal(got, want)
    coded = rng.integers(0, 2, (11, 2))
    np.testing.assert_array_equal(
        t.puncture_stream(torch.as_tensor(coded)).numpy(), j.puncture_stream(coded)
    )


QUANT_VALUES = np.array(
    [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 126.5, -126.5, 127.49, 127.5, -127.5,
     200.0, -200.0, 0.0, -0.0, 1e-3, 7.5, -7.5, 4.5],
    dtype=np.float32,
)


@pytest.mark.parametrize("q", [3, 8, 12])
@pytest.mark.parametrize("scale", [None, 1.0, 0.25])
def test_quantize_soft_bit_equal(q, scale):
    rng = np.random.default_rng(q)
    y = np.concatenate([QUANT_VALUES, rng.normal(scale=3.0, size=200).astype(np.float32)])
    want = np.asarray(j_quantize.quantize_soft(jnp.asarray(y), q, scale))
    got = quantize.quantize_soft(torch.as_tensor(y), q, scale)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        quantize.dequantize_soft(got, q, scale).numpy(),
        np.asarray(j_quantize.dequantize_soft(jnp.asarray(want), q, scale)),
    )


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_nonfinite_symbols_raise_symbol_error(bad):
    y = torch.tensor([0.5, bad, 1.0])
    with pytest.raises(SymbolError, match="non-finite") as info:
        quantize.quantize_soft(y)
    assert isinstance(info.value, (StreamError, DecodeError, ValueError))
    with pytest.raises(SymbolError):
        quantize.quantize_soft(y.numpy())


def test_quantize_soft_rejects_bad_width():
    with pytest.raises(ValueError, match="q must be"):
        quantize.quantize_soft(torch.zeros(3), q=17)


@pytest.mark.parametrize("name", list(CODES))
def test_budget_helpers_equal(name):
    code = CODES[name]
    for qmax in (1, 3, 127):
        for interval in (1, 4):
            assert quantize.pm_spread_bound(code, qmax, interval) == \
                j_quantize.pm_spread_bound(code, qmax, interval)
    for mode in ("i16", "i8"):
        assert quantize.metric_dtype_max(mode) == j_quantize.metric_dtype_max(mode)
        assert quantize.metric_mode_qmax(code, mode) == j_quantize.metric_mode_qmax(code, mode)
        for radix in (2, 4):
            try:
                want = j_quantize.norm_interval(code, mode, radix)
            except ValueError:
                with pytest.raises(ValueError):
                    quantize.norm_interval(code, mode, radix)
            else:
                assert quantize.norm_interval(code, mode, radix) == want
    assert quantize.norm_interval(code, "f32") == 0
    for R, q in ((2, 8), (3, None), (2, 4)):
        assert quantize.u1_bytes(R, q) == j_quantize.u1_bytes(R, q)
    assert quantize.u2_bytes(True) == j_quantize.u2_bytes(True)


@pytest.mark.parametrize(
    "D,L,n_sym,n_blocks",
    [(8, 3, 24, 3), (8, 3, 20, 3), (16, 0, 40, 3), (5, 4, 60, 2), (32, 10, 1, 1)],
)
@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_frame_stream_equal(D, L, n_sym, n_blocks, dtype):
    rng = np.random.default_rng(n_sym)
    y = (rng.normal(size=(n_sym, 2)) * 40).astype(dtype)
    want = np.asarray(j_frame_stream(jnp.asarray(y), D, L, n_blocks))
    got = frame_stream(torch.as_tensor(y), D, L, n_blocks)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    # leading dimensions frame independent streams
    both = frame_stream(torch.as_tensor(np.stack([y, y[::-1].copy()])), D, L, n_blocks)
    np.testing.assert_array_equal(both[0].numpy(), want)


@pytest.mark.parametrize("name", list(CODES))
@pytest.mark.parametrize("init_state", [0, 5])
def test_encode_equals_encode_np(name, init_state):
    code = CODES[name]
    rng = np.random.default_rng(init_state)
    bits = j_encoder.terminate(rng.integers(0, 2, 150), code)
    want = j_encoder.encode_np(bits, code, init_state)
    np.testing.assert_array_equal(encoder.encode_np(bits, code, init_state), want)
    np.testing.assert_array_equal(encoder.terminate(bits[:-code.v], code), bits)
    got = encoder.encode(torch.as_tensor(bits), code, init_state)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    batch = encoder.encode(torch.as_tensor(np.stack([bits, bits])), code, init_state)
    np.testing.assert_array_equal(batch[1].numpy(), want)
    for n in (0, 3, 40):
        assert encoder.encoder_state(bits[:n], code, init_state) == \
            j_encoder.encoder_state(bits[:n], code, init_state)


def test_channel_helpers():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (50, 2))
    np.testing.assert_array_equal(
        bpsk(torch.as_tensor(bits)).numpy(), np.asarray(j_bpsk(jnp.asarray(bits)))
    )
    for ebn0, rate in ((4.0, 0.5), (2.5, 1 / 3), (6.0, 0.75)):
        assert ebn0_to_sigma(ebn0, rate) == j_sigma(ebn0, rate)
    sym = bpsk(torch.as_tensor(bits))
    a = awgn(torch.Generator().manual_seed(3), sym, 0.7)
    b = transmit(torch.Generator().manual_seed(3), torch.as_tensor(bits), 4.0, 0.5)
    assert a.dtype == torch.float32 and a.shape == sym.shape
    assert torch.equal(a, awgn(torch.Generator().manual_seed(3), sym, 0.7))
    assert b.shape == sym.shape and not torch.equal(b, sym)


def test_throughput_model_equal():
    kw = dict(D=512, L=42, R=2, q=8, packed_out=True, s_kernel_mbps=1800.0)
    assert throughput_model(**kw) == j_throughput_model(**kw)


@pytest.mark.parametrize("name", SPECS)
def test_convert_config_round_trips(name):
    jcfg = JConfig(spec=j_codespec.get_code_spec(name), D=96, L=30, q=6,
                   start_policy="argmin", backend="ref")
    fields = dict(
        polys=np.array(jcfg.spec.code.polys),
        puncture=None if jcfg.spec.puncture is None else np.array(jcfg.spec.puncture),
        D=jcfg.D, L=jcfg.L, q=jcfg.q, start_policy=jcfg.start_policy,
        metric_mode=jcfg.metric_mode, acs_radix=jcfg.acs_radix, backend=jcfg.backend,
        tb_mode=jcfg.tb_mode, tb_chunk=jcfg.tb_chunk, acs_impl=jcfg.acs_impl, acs_k=jcfg.acs_k,
    )
    cfg = convert_config(fields)
    assert cfg.codespec.name == name and cfg.backend == "ref" and cfg.acs_radix == 2
    assert (cfg.D, cfg.L, cfg.q, cfg.T, cfg.start_policy) == (96, 30, 6, jcfg.T, "argmin")
    _assert_tables_equal(jcfg.code.acs_tables, cfg.code.acs_tables)
    _assert_tables_equal(jcfg.code.folded_acs_tables, cfg.code.folded_acs_tables)
    back = config_fields(cfg)
    assert back.keys() == fields.keys()
    for key, val in fields.items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(back[key], val)
        else:
            assert back[key] == val, key
    assert convert_config(back) == cfg


def test_convert_config_custom_code_and_missing_fields():
    fields = dict(polys=np.array([[1, 0, 1], [1, 1, 1]]), puncture=None, D=16, L=6,
                  q=None, start_policy="zero", metric_mode="f32")
    cfg = convert_config(fields)
    assert cfg.codespec.name == "custom" and cfg.code.K == 3 and cfg.backend == "cuda"
    with pytest.raises(KeyError, match="missing"):
        convert_config({"D": 16})


def test_config_matches_reference_defaults():
    j, t = JConfig(), PBVDConfig()
    assert (t.D, t.L, t.T, t.q, t.start_policy, t.metric_mode, t.tb_mode, t.tb_chunk,
            t.acs_radix, t.acs_impl, t.acs_k) == (j.D, j.L, j.T, j.q, j.start_policy,
                                                  j.metric_mode, j.tb_mode, j.tb_chunk,
                                                  j.acs_radix, j.acs_impl, j.acs_k)
    assert t.code.polys == j.code.polys and t.backend == "cuda"
    assert t.codespec.name == j.codespec.name
