"""The port's packing helpers and ``decode_stream`` against the reference, on the CPU.

``pack_words``/``unpack_words`` for q in {2, 3, 4, 5, 8, 16} and
``pack_bits``/``unpack_bits`` on numpy inputs made from a seed, equal to
``repro.core.quantize``'s word for word: lengths that are not a multiple of
the per-word count, leading axes, and full-scale values that set bit 31, the
int32 sign bit. ``decode_stream`` equals ``DecoderEngine.decode``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import quantize as jq
from repro.core.pbvd import PBVDConfig as JConfig
from repro.core.pbvd import decode_stream as j_decode_stream
from repro_torch.core import quantize as tq
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig, decode_stream


def _values(rng, q: int, shape) -> np.ndarray:
    qmax = (1 << (q - 1)) - 1
    return rng.integers(-qmax - 1, qmax + 1, shape).astype(np.int32)


@pytest.mark.parametrize("q", [2, 3, 4, 5, 8, 16])
def test_pack_words_equals_reference(q):
    per = 32 // q
    rng = np.random.default_rng(q)
    # an exact multiple of the per-word count, and leading axes with a pad
    for shape in ((4 * per,), (2, 3, 2 * per + 1)):
        vals = _values(rng, q, shape)
        vals[..., per - 1] = -1  # the word's top field negative: bit 31 where q·per = 32
        want = np.asarray(jq.pack_words(jnp.asarray(vals), q))
        got = tq.pack_words(torch.as_tensor(vals), q)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
        if q * per == 32:
            assert (got.numpy()[..., 0] < 0).all()  # bit 31 survived the sum
        n = shape[-1]
        np.testing.assert_array_equal(tq.unpack_words(got, q, per_axis_len=n).numpy(), vals)
        full = tq.unpack_words(got, q)
        assert full.dtype == torch.int32
        np.testing.assert_array_equal(full.numpy(),
                                      np.asarray(jq.unpack_words(jnp.asarray(want), q)))
        assert (full.numpy()[..., n:] == 0).all()  # the pad decodes as zeros


@pytest.mark.parametrize("q", [2, 3, 4, 5, 8, 16])
def test_unpack_words_of_arbitrary_words_equals_reference(q):
    """Any int32 word, the sign bit included, sign-extends each field as the
    reference does."""
    rng = np.random.default_rng(q)
    words = rng.integers(-2 ** 31, 2 ** 31, (4, 9), dtype=np.int64).astype(np.int32)
    words[0, 0], words[0, 1] = -2 ** 31, -1
    want = np.asarray(jq.unpack_words(jnp.asarray(words), q, per_axis_len=31))
    got = tq.unpack_words(torch.as_tensor(words), q, per_axis_len=31)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(64,), (2, 5, 16)])
def test_pack_bits_equals_reference(shape):
    rng = np.random.default_rng(sum(shape))
    bits = rng.integers(0, 2, shape).astype(np.int32)
    bits[..., 7] = 1  # the top bit of the first byte
    want = np.asarray(jq.pack_bits(jnp.asarray(bits)))
    got = tq.pack_bits(torch.as_tensor(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    n = shape[-1] - 3
    np.testing.assert_array_equal(tq.unpack_bits(got, n).numpy(),
                                  np.asarray(jq.unpack_bits(jnp.asarray(want), n)))
    np.testing.assert_array_equal(tq.unpack_bits(got).numpy(), bits)
    with pytest.raises(ValueError, match="multiple of 8"):
        tq.pack_bits(torch.as_tensor(bits[..., :-1]))


def test_decode_stream_equals_engine_and_reference():
    rng = np.random.default_rng(3)
    y = (1.0 - 2.0 * rng.integers(0, 2, (200, 2)) + rng.normal(scale=0.6, size=(200, 2)))
    y = y.astype(np.float32)
    cfg = PBVDConfig(D=64, L=16, q=8, backend="ref")
    got = decode_stream(y, 180, cfg, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (180,)
    assert torch.equal(got, DecoderEngine(cfg, device="cpu").decode(y, 180))
    want = j_decode_stream(jnp.asarray(y), 180, JConfig(D=64, L=16, q=8, backend="ref"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
