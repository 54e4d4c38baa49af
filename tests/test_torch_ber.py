"""The port's BER harness (paper Fig. 4) against the JAX package, on the CPU.

The same numpy payload and unit-variance noise go through both channels:
JAX ``encode_jax`` (and ``puncture_stream`` for a punctured spec), BPSK and
``sigma · noise`` into the JAX ``backend="ref"`` engine, and the port's
vectorized ``encode`` into its ``"ref"`` engine. The decoded bits and the
error counts must be equal, soft (q = 8) and hard (sign). ``uncoded_ber``
agrees with the reference's to 1e-15. The port's own Monte-Carlo
(``simulate_ber`` / ``hard_decision_ber``, its draws from a
``torch.Generator``) at 2^13 bits must sit inside the smoke band of
``tests/test_ber_regression.py::test_ber_4db_smoke``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ber as j_ber
from repro.core.channel import bpsk as j_bpsk, ebn0_to_sigma
from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.encoder import encode_jax
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro_torch.core import ber
from repro_torch.core.channel import bpsk
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig

N_BITS = 4096
GEOMETRY = dict(D=512, L=42, backend="ref")


def _channel_inputs(spec_name: str, seed: int):
    rng = np.random.default_rng(seed)
    spec = get_code_spec(spec_name)
    bits = rng.integers(0, 2, N_BITS).astype(np.int32)
    n_sym = spec.n_symbols_for(N_BITS + spec.code.v) if spec.is_punctured else None
    shape = (n_sym,) if n_sym is not None else (N_BITS + spec.code.v, spec.code.R)
    return bits, rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("spec_name,ebn0,q", [
    ("ccsds", 2.0, 8), ("ccsds", 3.0, None), ("ccsds-3/4", 2.5, 8), ("ccsds-3/4", 4.5, None),
])
def test_decoded_bits_equal_jax_ref(spec_name, ebn0, q):
    """q = None is the hard-decision curve: the signs of the symbols."""
    bits, noise = _channel_inputs(spec_name, seed=int(ebn0 * 10))
    jspec, spec = j_get_code_spec(spec_name), get_code_spec(spec_name)
    v = spec.code.v
    sigma = ebn0_to_sigma(ebn0, spec.rate)
    assert spec.rate == jspec.rate

    jcoded = encode_jax(jnp.asarray(np.concatenate([bits, np.zeros(v, np.int32)])), jspec.code)
    jtx = jspec.puncture_stream(jcoded) if jspec.is_punctured else jcoded
    jy = j_bpsk(jtx) + sigma * jnp.asarray(noise)
    coded = encode(torch.as_tensor(np.concatenate([bits, np.zeros(v, np.int32)])), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    y = bpsk(tx) + sigma * torch.as_tensor(noise)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    if q is None:
        jy, y = jnp.sign(jy), torch.sign(y)

    want = np.asarray(JEngine(JConfig(spec=jspec, q=q, **GEOMETRY)).decode(jy, N_BITS + v))
    got = DecoderEngine(PBVDConfig(spec=spec, q=q, **GEOMETRY), device="cpu").decode(y, N_BITS + v)
    np.testing.assert_array_equal(got.numpy(), want)
    errors = int((got[:N_BITS] != torch.as_tensor(bits)).sum())
    assert errors == int(np.sum(want[:N_BITS] != bits))
    assert errors > 0  # the comparison covers decoding errors, not only clean bits


@pytest.mark.parametrize("ebn0", [-2.0, 0.0, 2.5, 4.0, 7.3, 12.0])
def test_uncoded_ber_equals_jax(ebn0):
    assert abs(ber.uncoded_ber(ebn0) - j_ber.uncoded_ber(ebn0)) <= 1e-15


@pytest.mark.parametrize("spec_name", ["ccsds", "ccsds-3/4"])
def test_draw_trial_punctures_before_the_channel(spec_name):
    """At a very high Eb/N0 the received signs are the reference's BPSK of
    the (punctured) coded payload plus flush bits; Eb/N0 uses the
    punctured rate, so the noise has the reference's sigma."""
    spec, jspec = get_code_spec(spec_name), j_get_code_spec(spec_name)
    gen = torch.Generator().manual_seed(1)
    bits, y = ber.draw_trial(gen, 60.0, spec, 1000, "cpu")
    assert bits.dtype == torch.int32 and bits.shape == (1000,)
    b = np.concatenate([bits.numpy(), np.zeros(spec.code.v, np.int32)])
    jcoded = encode_jax(jnp.asarray(b), jspec.code)
    want = np.asarray(j_bpsk(jspec.puncture_stream(jcoded) if jspec.is_punctured else jcoded))
    assert y.shape == want.shape and y.dtype == torch.float32
    np.testing.assert_array_equal(torch.sign(y).numpy(), want)
    sigma = float((y - torch.tensor(want)).std())
    assert sigma == pytest.approx(ebn0_to_sigma(60.0, jspec.rate), rel=0.2)


def test_simulate_ber_inside_the_smoke_band():
    """The band of ``test_ber_4db_smoke``: soft ≤ 1.3e-3, hard in
    [2e-4, 1.2e-2], soft < hard."""
    cfg = PBVDConfig(q=8, **GEOMETRY)
    soft = ber.simulate_ber(torch.Generator().manual_seed(0), 4.0, cfg, n_bits=1 << 13,
                            device="cpu")
    hard = ber.hard_decision_ber(torch.Generator().manual_seed(0), 4.0, cfg, n_bits=1 << 13,
                                 device="cpu")
    assert soft <= 1.3e-3, f"soft-decision BER regressed: {soft:.2e}"
    assert 2e-4 <= hard <= 1.2e-2, f"hard-decision BER out of band: {hard:.2e}"
    assert soft < hard < ber.uncoded_ber(4.0)


def test_simulate_ber_trials_and_punctured_rate():
    """Two trials draw fresh payloads from one generator; the punctured rate
    decodes worse than 1/2 at the same Eb/N0 and better than uncoded."""
    gen = torch.Generator().manual_seed(3)
    half = ber.simulate_ber(gen, 3.0, PBVDConfig(q=8, **GEOMETRY), n_bits=4096, n_trials=2,
                            device="cpu")
    gen = torch.Generator().manual_seed(3)
    cfg34 = PBVDConfig(spec=get_code_spec("ccsds-3/4"), q=8, **GEOMETRY)
    p34 = ber.simulate_ber(gen, 3.0, cfg34, n_bits=4096, n_trials=2, device="cpu")
    assert half < p34 < ber.uncoded_ber(3.0)
    a = ber.simulate_ber(torch.Generator().manual_seed(9), 2.0, cfg34, n_bits=2048, device="cpu")
    b = ber.simulate_ber(torch.Generator().manual_seed(9), 2.0, cfg34, n_bits=2048, device="cpu")
    assert a == b  # the generator alone fixes the run


def test_simulate_ber_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    from repro_torch.device import DeviceUnavailableError

    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        ber.simulate_ber(torch.Generator(), 4.0, PBVDConfig(), n_bits=64)
