"""The traceback kernels (``csrc/traceback.cu``): wrappers, plain versions,
counts.

K2 replaces ``repro.kernels.traceback._traceback_kernel`` (driven by
``traceback_pallas``); K2-prefix replaces ``_traceback_prefix_kernel``
(driven by ``traceback_prefix_pallas``), the chunked parallel-prefix walk.
K2 is a staged walk: one warp walks 32 parallel blocks, and the stage
slabs of a chunk of :func:`stage_chunk` stages are copied into a ring of
``STAGE_SLOTS`` shared-memory slots ahead of the walk. K2-prefix puts
lanes on parallel blocks (a CTA of the G blocks of :func:`prefix_plan`:
as many as fit, up to 32, and fewer for a batch too small to fill the
card's SMs), 32 chains of one (block, chunk) per thread
stepping through words loaded once per row, the lane bodies of
``csrc/traceback_core.cuh`` that it shares with the fused kernel's prefix
tail. :func:`traceback` and :func:`traceback_prefix` take the plain
PyTorch versions :func:`traceback_plain` (``ref.traceback_ref``) and
:func:`traceback_prefix_plain` (``ref.traceback_prefix_chunked_ref``) for a
CPU tensor; for a CUDA tensor they launch their kernel or raise; for a
meta tensor they launch nothing, return the kernel's output shape and
report its work to the work counter (``launch/cost.py``). What
bounds each kernel on the card is noted in the CUDA source.

``launches`` counts K2's launches and ``prefix_launches`` K2-prefix's, and
nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.trellis import ConvCode
from repro_torch.launch import cost
from . import _build
from .acs import _MAX_STATES
from .ref import (
    DEFAULT_TB_CHUNK,
    prefix_chunk_geometry,
    traceback_prefix_chunked_ref as traceback_prefix_plain,
    traceback_ref as traceback_plain,
)

__all__ = [
    "DEFAULT_TB_CHUNK",
    "prefix_chunk_geometry",
    "prefix_plan",
    "prefix_smem_plan",
    "traceback",
    "traceback_plain",
    "traceback_prefix",
    "traceback_prefix_plain",
    "launches",
    "prefix_launches",
    "SMEM_PER_CTA",
    "STAGE_SLOTS",
    "stage_chunk",
]

#: launches of K2 since the count was last set to 0
launches = 0
#: launches of K2-prefix since the count was last set to 0
prefix_launches = 0

#: dynamic shared memory one CTA may use on the H100, in bytes
SMEM_PER_CTA = 232448
#: K2's ring of shared-memory slots (``csrc/traceback.cu``: kSlots), each of
#: ``STAGE_SLOT_WORDS`` int32 words (kSlotWords: 8 KB)
STAGE_SLOTS = 4
STAGE_SLOT_WORDS = 64 * 32
#: K2's routes for staging the words, by the C interface's code
_COPY = {"auto": 0, "cp.async": 1, "tma": 2}


def stage_chunk(W: int) -> int:
    """Stages per slot of K2's staged walk at W words per stage: a slot holds
    the W rows of 32 words of each of its stages (``kChunk = 64 / W``)."""
    if W not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"K2 is built for W in 1, 2, 4, ..., 32 words per stage, got {W}")
    return STAGE_SLOT_WORDS // (32 * W)


def _lib() -> ctypes.CDLL:
    lib = _build.load("traceback")
    fn = lib.pbvd_traceback_copy
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        fn = lib.pbvd_traceback_prefix
        fn.argtypes = [p, p] + [i] * 12 + [p, p]
        fn.restype = ctypes.c_int
    return lib


def prefix_smem_plan(n_states: int, n_act: int, nc_e: int) -> tuple[int, int]:
    """(parallel blocks per CTA, shared bytes per CTA) of K2-prefix.

    A parallel block holds its ``n_act`` composed maps of N int32 entries
    and ``nc_e`` entry states. The body puts lanes on blocks, so G is the
    size class of its CTA: the largest power of two up to 32 whose G blocks
    fit, down to 1; scratch that does not fit at G = 1 raises
    ``ValueError`` (no fallback to the serial walk).
    """
    per_block = 4 * (n_act * n_states + nc_e)
    if per_block > SMEM_PER_CTA:
        raise ValueError(
            f"the prefix traceback's scratch of {n_act} composed maps at N={n_states} states "
            f"needs {per_block} bytes of shared memory per parallel block, above the "
            f"{SMEM_PER_CTA} bytes a CTA may use; use a larger tb_chunk"
        )
    G = 32
    while G * per_block > SMEM_PER_CTA:
        G //= 2
    return G, G * per_block


def prefix_plan(
    n_states: int, T: int, decode_start: int, n_decode: int, tb_chunk: int,
    n_blocks: int | None = None, n_sms: int = 1,
) -> tuple[tuple[int, int, int, int, int], int]:
    """(chunk geometry, parallel blocks per CTA) of a K2-prefix launch:
    :func:`prefix_chunk_geometry` and :func:`prefix_smem_plan`, with their
    ``ValueError`` s. With ``n_blocks`` given, a batch too small to give
    each of the card's ``n_sms`` SMs a CTA of the planned size is spread
    over them: G drops to the largest power of two up to n_blocks / n_sms
    (at least 1), since a CTA's composition work runs on one SM."""
    geometry = prefix_chunk_geometry(T, decode_start, n_decode, tb_chunk)
    _, _, n_chunks, c_lo, c_hi = geometry
    G, _ = prefix_smem_plan(n_states, n_chunks - c_lo, c_hi - c_lo + 1)
    if n_blocks is not None:
        while G > 1 and G * n_sms > n_blocks:
            G //= 2
    return geometry, G


def traceback(
    sp: torch.Tensor,
    code: ConvCode,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Serial traceback/decode. sp: (T, W, B) → bits (n_decode, B) int32.

    The signature and result of :func:`traceback_plain`. ``start_state`` is
    an int or a (B,) tensor of states in [0, N); on a CUDA tensor ``sp``
    must be contiguous int32. The kernel stages the survivor words by TMA
    where B % 4 == 0 (the faster route on the H100, ``PERF.md``), else by
    ``cp.async``.
    """
    return _staged_walk(sp, code, decode_start, n_decode, start_state, "auto")


def _staged_walk(sp, code, decode_start, n_decode, start_state, copy: str) -> torch.Tensor:
    """:func:`traceback` with the route named: ``"auto"``, ``"tma"`` (B % 4
    == 0) or ``"cp.async"``; ``chip_smoke.py`` checks and times both."""
    global launches
    if sp.device.type == "cpu":
        return traceback_plain(sp, code, decode_start, n_decode, start_state)
    if sp.device.type == "meta":
        T, _, B = sp.shape
        cost.kernel("traceback (K2)", *cost.k2_cost(T, B, decode_start, n_decode), "int")
        return torch.empty((n_decode, B), dtype=torch.int32, device="meta")
    if sp.device.type != "cuda":
        raise ValueError(f"traceback runs on CPU or CUDA tensors, got {sp.device}")
    if sp.dim() != 3 or sp.dtype != torch.int32 or not sp.is_contiguous():
        raise ValueError(
            f"sp must be a contiguous int32 (T, W, B) tensor, got {sp.dtype} {tuple(sp.shape)}"
        )
    T, W, B = sp.shape
    if W != -(-code.n_states // 32):
        raise ValueError(f"sp has {W} words per stage, code needs {-(-code.n_states // 32)}")
    if code.n_states > _MAX_STATES:
        raise ValueError(f"K2 takes n_states <= {_MAX_STATES}, got {code.n_states}")
    if not 0 <= decode_start <= T - n_decode:
        raise ValueError(
            f"decode region [{decode_start}, {decode_start + n_decode}) outside [0, {T})"
        )
    if copy not in _COPY or (copy == "tma" and B % 4):
        raise ValueError(f"copy must be one of {tuple(_COPY)} ('tma' needs B % 4 == 0), got "
                         f"{copy!r} at B={B}")
    start = torch.as_tensor(start_state, dtype=torch.int32, device=sp.device)
    start = start.broadcast_to((B,)).contiguous()
    bits = torch.empty((n_decode, B), dtype=torch.int32, device=sp.device)
    if n_decode == 0 or B == 0:
        return bits
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        rc = _lib().pbvd_traceback_copy(
            sp.data_ptr(), start.data_ptr(), T, W, B, code.v,
            decode_start, n_decode, _COPY[copy], bits.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"pbvd_traceback launch failed (error {rc})")
    launches += 1
    return bits


def traceback_prefix(
    sp: torch.Tensor,
    code: ConvCode,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int = 0,
    tb_chunk: int = DEFAULT_TB_CHUNK,
) -> torch.Tensor:
    """Chunked parallel-prefix traceback. sp: (T, W, B) → bits (n_decode, B)
    int32, equal to :func:`traceback`'s for every ``tb_chunk``.

    The signature and result of :func:`traceback_prefix_plain`. On a CUDA
    tensor ``sp`` must be contiguous int32.
    """
    global prefix_launches
    if sp.device.type == "cpu":
        return traceback_prefix_plain(sp, code, decode_start, n_decode, start_state, tb_chunk)
    if sp.device.type == "meta":
        T, _, B = sp.shape
        cost.kernel("traceback_prefix (K2-prefix)",
                    *cost.k2_prefix_cost(code, T, B, decode_start, n_decode, tb_chunk), "int")
        return torch.empty((n_decode, B), dtype=torch.int32, device="meta")
    if sp.device.type != "cuda":
        raise ValueError(f"traceback_prefix runs on CPU or CUDA tensors, got {sp.device}")
    if sp.dim() != 3 or sp.dtype != torch.int32 or not sp.is_contiguous():
        raise ValueError(
            f"sp must be a contiguous int32 (T, W, B) tensor, got {sp.dtype} {tuple(sp.shape)}"
        )
    T, W, B = sp.shape
    if W != -(-code.n_states // 32):
        raise ValueError(f"sp has {W} words per stage, code needs {-(-code.n_states // 32)}")
    if code.n_states > _MAX_STATES:
        raise ValueError(f"K2-prefix takes n_states <= {_MAX_STATES}, got {code.n_states}")
    n_sms = torch.cuda.get_device_properties(sp.device).multi_processor_count
    (C, P, n_chunks, c_lo, c_hi), G = prefix_plan(code.n_states, T, decode_start, n_decode,
                                                   tb_chunk, B, n_sms)
    start = torch.as_tensor(start_state, dtype=torch.int32, device=sp.device)
    start = start.broadcast_to((B,)).contiguous()
    bits = torch.empty((n_decode, B), dtype=torch.int32, device=sp.device)
    if n_decode == 0 or B == 0:
        return bits
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        rc = _lib().pbvd_traceback_prefix(
            sp.data_ptr(), start.data_ptr(), T, W, B, code.v, decode_start, n_decode,
            C, P, n_chunks, c_lo, c_hi, G, bits.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"pbvd_traceback_prefix launch failed (error {rc})")
    prefix_launches += 1
    return bits
