"""The fused single-kernel decoder (``csrc/fused.cu``): wrapper, plain
version, count.

Replaces ``repro.kernels.fused._fused_kernel`` (driven by
``pbvd_fused_pallas`` with ``tb_mode="serial"``), radix-2 and radix-4
phases, in the metric modes ``f32``/``i16``/``i8``. :func:`pbvd_fused`
takes the plain PyTorch version :func:`pbvd_fused_plain`
(``repro_torch.kernels.ref.pbvd_fused_ref``) for a CPU tensor; for a CUDA
tensor it launches the CUDA kernel or raises. What bounds the kernel on the
card and what its design does about it is noted in the CUDA source.

The survivor history lives in shared memory, ``T·ceil(N/32)·4`` bytes per
parallel block. :func:`smem_plan` picks the parallel blocks per CTA and
refuses, with ``ValueError``, a history that does not fit the card's
232,448 bytes even at one block per CTA; nothing falls back to the
two-kernel path.

``launches`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from . import _build
from .acs import _DTYPE_CODE, _MAX_R, _labels_on
from .ref import _acc_dtype_for, pbvd_fused_ref as pbvd_fused_plain

__all__ = ["pbvd_fused", "pbvd_fused_plain", "smem_plan", "launches", "SMEM_PER_CTA"]

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

#: dynamic shared memory one CTA may use on the H100, in bytes
SMEM_PER_CTA = 232448


def smem_plan(T: int, n_states: int) -> tuple[int, int]:
    """(parallel blocks per CTA, shared bytes per CTA) of the fused kernel.

    A CTA of G blocks holds two path-metric planes and the min-reduction
    slots (``csrc/acs_core.cuh::forward_smem_slots``) plus G survivor
    histories of T stages × ceil(N/32) words, 4 bytes each. G starts at
    max(1, 128/N) and drops to 1 when that does not fit; a history that does
    not fit at G = 1 raises ``ValueError`` naming T, N and the bytes.
    """
    N = n_states
    W = -(-N // 32)

    def need(G: int) -> int:
        return 4 * (2 * G * N + G * max(1, N // 32) + G * T * W)

    G = max(1, 128 // N)
    if need(G) > SMEM_PER_CTA:
        G = 1
    if need(G) > SMEM_PER_CTA:
        raise ValueError(
            f"the fused kernel's survivor history of T={T} stages at N={N} states needs "
            f"{need(1)} bytes of shared memory per parallel block, above the "
            f"{SMEM_PER_CTA} bytes a CTA may use; use a shorter block (D, L)"
        )
    return G, need(G)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused")
    fn = lib.pbvd_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def pbvd_fused(
    y: torch.Tensor,
    code: ConvCode,
    *,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int | None = None,
    metric_mode: str = "f32",
    radix: int = 2,
) -> torch.Tensor:
    """One-kernel decode. y (T, R, B) → packed bits (n_decode/32, B) int32.

    The signature and result of :func:`pbvd_fused_plain`: ``n_decode`` a
    multiple of 32, ``start_state`` an int or a (B,) tensor of states in
    [0, N) (zeros by default). On a CUDA tensor ``y`` must be contiguous,
    int8/int16/int32 or float32; the narrow metric modes need integer
    symbols.
    """
    global launches
    if y.device.type == "cpu":
        return pbvd_fused_plain(y, code, decode_start=decode_start, n_decode=n_decode,
                                start_state=start_state, metric_mode=metric_mode, radix=radix)
    if y.device.type != "cuda":
        raise ValueError(f"pbvd_fused runs on CPU or CUDA tensors, got {y.device}")
    if y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (T, R, B) tensor, got {tuple(y.shape)}")
    T, R, B = y.shape
    if R != code.R or R > _MAX_R:
        raise ValueError(f"symbol rank {R} != code R {code.R} (at most {_MAX_R})")
    if n_decode % 32 or n_decode <= 0:
        raise ValueError(f"n_decode must be a positive multiple of 32, got {n_decode}")
    if not 0 <= decode_start < T:
        raise ValueError(f"decode_start {decode_start} outside [0, {T})")
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if radix == 4 and code.n_states < 4:
        raise ValueError(f"radix-4 ACS needs K >= 3 (got K={code.K})")
    _acc_dtype_for(y.dtype, metric_mode)  # raises for other modes/dtypes
    norm_every = norm_interval(code, metric_mode, radix)
    qmax = metric_mode_qmax(code, metric_mode) if norm_every else 0
    G, _ = smem_plan(T, code.n_states)
    start = torch.as_tensor(0 if start_state is None else start_state, dtype=torch.int32,
                            device=y.device)
    start = start.broadcast_to((B,)).contiguous()
    bits = torch.empty((n_decode // 32, B), dtype=torch.int32, device=y.device)
    if B == 0:
        return bits
    labels = _labels_on(code, y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = _lib().pbvd_fused(
            y.data_ptr(), _DTYPE_CODE[y.dtype], T, R, B, code.v, labels.data_ptr(),
            start.data_ptr(), decode_start, n_decode, norm_every, qmax, radix, G,
            bits.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"pbvd_fused launch failed (error {rc})")
    launches += 1
    return bits
