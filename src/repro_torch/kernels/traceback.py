"""K2, the serial traceback kernel (``csrc/traceback.cu``): wrapper, plain
version, count.

Replaces ``repro.kernels.traceback._traceback_kernel`` (driven by
``traceback_pallas``). :func:`traceback` takes the plain PyTorch version
:func:`traceback_plain` (``repro_torch.kernels.ref.traceback_ref``) for a
CPU tensor; for a CUDA tensor it launches the CUDA kernel or raises. What
bounds the kernel on the card is noted in the CUDA source.

``launches`` counts the kernel's launches, and nothing else.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.trellis import ConvCode
from . import _build
from .ref import traceback_ref as traceback_plain

__all__ = ["traceback", "traceback_plain", "launches"]

#: launches of the CUDA kernel since the count was last set to 0
launches = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("traceback")
    fn = lib.pbvd_traceback
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


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
    must be contiguous int32.
    """
    global launches
    if sp.device.type == "cpu":
        return traceback_plain(sp, code, decode_start, n_decode, start_state)
    if sp.device.type != "cuda":
        raise ValueError(f"traceback runs on CPU or CUDA tensors, got {sp.device}")
    if sp.dim() != 3 or sp.dtype != torch.int32 or not sp.is_contiguous():
        raise ValueError(
            f"sp must be a contiguous int32 (T, W, B) tensor, got {sp.dtype} {tuple(sp.shape)}"
        )
    T, W, B = sp.shape
    if W != -(-code.n_states // 32):
        raise ValueError(f"sp has {W} words per stage, code needs {-(-code.n_states // 32)}")
    if not 0 <= decode_start <= T - n_decode:
        raise ValueError(
            f"decode region [{decode_start}, {decode_start + n_decode}) outside [0, {T})"
        )
    start = torch.as_tensor(start_state, dtype=torch.int32, device=sp.device)
    start = start.broadcast_to((B,)).contiguous()
    bits = torch.empty((n_decode, B), dtype=torch.int32, device=sp.device)
    if n_decode == 0 or B == 0:
        return bits
    with torch.cuda.device(sp.device):
        stream = torch.cuda.current_stream(sp.device).cuda_stream
        rc = _lib().pbvd_traceback(
            sp.data_ptr(), start.data_ptr(), T, W, B, code.v,
            decode_start, n_decode, bits.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"pbvd_traceback launch failed (error {rc})")
    launches += 1
    return bits
