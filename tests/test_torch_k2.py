"""K2's staged walk (``csrc/traceback.cu``) modelled in numpy, on the CPU.

The CUDA kernel cannot run here, so its geometry is modelled lane by lane:
one warp walks 32 consecutive parallel blocks; the W words of each stage of
a chunk of ``stage_chunk(W)`` stages are copied into a ring of
``STAGE_SLOTS`` slots, with ``STAGE_SLOTS - 1`` chunks in flight (a copy
lands when the walk waits for it) while the lanes walk the current chunk
from its slot. Both routes of the kernel are modelled: cp.async (chunks
cut from stage T - 1 down, each lane its own words, lanes past B exit) and
TMA (chunks cut from ``decode_start + 1`` up, a box of 32 lanes at once,
rows past T and lanes past B read as zeros). The model asserts that a lane
only reads a slot that holds the chunk it walks, that no slot is refilled
before it was walked, that no stage at or below ``decode_start`` is copied
and that nothing is stored for lanes past B. Its bits must equal JAX
``traceback_ref`` (and the port's plain version) on seeded numpy words for
N = 4, 64, 256 and 1024 states, ragged batches, ``decode_start`` 0 and > 0
and zero, argmin-like and random start states, and, in one small case,
JAX ``traceback_pallas(interpret=True)``. ``chip_smoke.py`` holds the
kernel itself against the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.trellis import ConvCode as JConvCode
from repro.kernels import ref as j_ref
from repro.kernels.traceback import traceback_pallas
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import traceback

# N = 4, 64, 256, 1024 states: W = 1, 2, 8, 32 words per stage
POLYS = {
    4: ((1, 1, 1), (1, 0, 1)),
    64: ((1, 1, 1, 1, 0, 0, 1), (1, 0, 1, 1, 0, 1, 1)),
    256: ((1, 0, 1, 1, 1, 0, 0, 0, 1), (1, 1, 1, 1, 0, 1, 0, 1, 1)),
    1024: ((1, 0, 0, 1, 1, 0, 1, 0, 1, 1, 1), (1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1)),
}


def staged_walk_model(sp: np.ndarray, log2n: int, decode_start: int, n_decode: int,
                      start: np.ndarray, copy: str = "cp.async") -> tuple[np.ndarray, set]:
    """The kernel's walk: (bits (n_decode, B), the stages any lane copied).

    ``copy="cp.async"``: chunks are cut from stage T - 1 down, each lane
    copies its own words and lanes past B exit. ``copy="tma"``: chunks are
    cut from ``decode_start + 1`` up and a box of 32 lanes, W words and a
    chunk of stages lands at once; rows at or above T and lanes past B read
    as zeros (nothing is copied for them), and lanes past B walk but store
    nothing.
    """
    T, W, B = sp.shape
    C, n_slots = traceback.stage_chunk(W), traceback.STAGE_SLOTS
    n_mask, half_mask = (1 << log2n) - 1, ((1 << log2n) - 1) >> 1
    emit_end, lo = decode_start + n_decode, decode_start + 1
    n_chunks = -(-(T - lo) // C)
    n_warps = -(-B // 32)
    out = np.full((n_decode, n_warps * 32), -1, dtype=np.int64)  # -1: never stored
    copied = set()

    def stages(c):  # the stages of chunk c, in the order the walk reads them (top first)
        if copy == "tma":
            s_lo = lo + (n_chunks - 1 - c) * C
            return [(j, s_lo + j) for j in range(C - 1, -1, -1) if s_lo + j < T]
        s_hi = T - 1 - c * C
        return [(j, s_hi - j) for j in range(min(C, s_hi - decode_start))]

    for warp in range(n_warps):
        lanes = warp * 32 + np.arange(32)
        if copy == "cp.async":
            lanes = lanes[lanes < B]  # lanes past B exit at once
        valid = lanes < B
        ring = np.zeros((n_slots, C, W, len(lanes)), dtype=np.int64)
        holds = [None] * n_slots  # the chunk each slot holds once landed
        walked = set()
        in_flight = []

        def issue(c):
            if c < n_chunks:
                slot = c % n_slots
                assert holds[slot] is None or holds[slot] in walked, "slot refilled unwalked"
                in_flight.append(c)

        def land(c):
            slot = c % n_slots
            ring[slot] = 0  # out-of-bounds rows and lanes read as zeros
            for j, s in stages(c):
                assert decode_start < s < T
                copied.add(s)
                ring[slot, j][:, valid] = sp[s][:, lanes[valid]].astype(np.uint32)  # the slab
            holds[slot] = c

        for c in range(n_slots - 1):
            issue(c)
        state = np.where(valid, start[np.minimum(lanes, B - 1)], 0).astype(np.int64) & n_mask
        for c in range(n_chunks):
            issue(c + n_slots - 1)
            while in_flight and in_flight[0] <= c:  # the wait for chunk c
                land(in_flight.pop(0))
            slot = c % n_slots
            assert holds[slot] == c
            for j, s in stages(c):
                if s < emit_end:
                    out[s - decode_start, lanes[valid]] = (state >> (log2n - 1))[valid]
                word = ring[slot, j, state >> 5, np.arange(len(lanes))]
                state = ((state & half_mask) << 1) | ((word >> (state & 31)) & 1)
            walked.add(c)
        out[0, lanes[valid]] = (state >> (log2n - 1))[valid]  # stage decode_start
    assert (out[:, B:] == -1).all()  # nothing stored for lanes past B
    return out[:, :B], copied


@pytest.mark.parametrize("W", [1, 2, 4, 8, 16, 32])
def test_stage_chunk_keeps_a_slot_at_8_kb(W):
    C = traceback.stage_chunk(W)
    assert C * W * 32 * 4 == 8192 and C >= 2
    assert traceback.STAGE_SLOTS * 8192 <= 48 * 1024  # static shared memory of one warp's CTA


def test_stage_chunk_refuses_other_widths():
    with pytest.raises(ValueError, match="W in 1, 2, 4"):
        traceback.stage_chunk(3)


@pytest.mark.parametrize("policy", ["zero", "argmin", "random"])
@pytest.mark.parametrize("copy,T,B,decode_start,n_decode", [
    ("cp.async", 300, 37, 0, 200), ("cp.async", 150, 64, 21, 100), ("cp.async", 70, 5, 9, 61),
    ("tma", 300, 36, 0, 200), ("tma", 151, 64, 21, 100), ("tma", 1, 4, 0, 1)])
@pytest.mark.parametrize("N", list(POLYS))
def test_staged_walk_model_equals_reference(N, copy, T, B, decode_start, n_decode, policy):
    code, jcode = ConvCode(polys=POLYS[N]), JConvCode(polys=POLYS[N])
    W = max(1, N // 32)
    rng = np.random.default_rng(N * 7 + T + B + len(policy))
    sp = rng.integers(-(2 ** 31), 2 ** 31, (T, W, B), dtype=np.int64).astype(np.int32)
    if policy == "zero":
        start = np.zeros(B, np.int32)
    elif policy == "argmin":  # a few tied minima: the low states
        start = rng.integers(0, min(N, 4), B).astype(np.int32)
    else:
        start = rng.integers(0, N, B).astype(np.int32)
    got, copied = staged_walk_model(sp, code.v, decode_start, n_decode, start, copy)
    assert copied == set(range(decode_start + 1, T))  # each walked stage, none below
    want = np.asarray(j_ref.traceback_ref(jnp.asarray(sp), jcode, decode_start, n_decode,
                                          jnp.asarray(start)))
    np.testing.assert_array_equal(got, want)
    plain = traceback.traceback(torch.as_tensor(sp), code, decode_start, n_decode,
                                torch.as_tensor(start))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_staged_walk_model_equals_pallas_interpret():
    code, jcode = ConvCode(polys=POLYS[64]), JConvCode(polys=POLYS[64])
    T, W, B, ds, nd = 80, 2, 128, 11, 64
    rng = np.random.default_rng(1616)
    sp = rng.integers(-(2 ** 31), 2 ** 31, (T, W, B), dtype=np.int64).astype(np.int32)
    start = rng.integers(0, 64, B).astype(np.int32)
    got, _ = staged_walk_model(sp, code.v, ds, nd, start)
    assert np.array_equal(got, staged_walk_model(sp, code.v, ds, nd, start, "tma")[0])
    want = traceback_pallas(jnp.asarray(sp), jnp.asarray(start), jcode, decode_start=ds,
                            n_decode=nd, interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
