"""Decode backends and the eager-checking dispatcher of the port.

The counterpart of ``repro.kernels.ops``. Three backends register here,
each with the metric modes ``"f32"``/``"i16"``/``"i8"`` and radix 2 and 4:

* ``"ref"`` — the plain PyTorch path (``kernels/ref.py``), on whatever
  device the symbols are;
* ``"cuda"`` — the two-kernel path, the counterpart of the reference's
  ``"pallas"``: K1 (``kernels/acs.py``) then K2 (``kernels/traceback.py``).
  On CPU tensors the wrappers run their plain versions, so ``"cuda"`` on the
  CPU equals ``"ref"``;
* ``"fused"`` — the single-kernel path (``kernels/fused.py``): forward ACS
  and the serial walk in one kernel, bit-packed output words; zero start
  only, as in the reference.

None pads the lane axis (the kernels mask the ragged edge) nor the stage
axis (the CUDA ACS loops run the true T stages). So the argmin start is
taken over the true stage-T metrics, as the reference's ``"ref"`` backend
does; the reference's ``"pallas"`` backend takes it after its zero pad
stages and may start from another of several tied states.
"""

from __future__ import annotations

from typing import Literal

import torch

from repro_torch.core.quantize import norm_interval
from repro_torch.core.trellis import ConvCode
from . import acs as _acs
from . import fused as _fused
from . import ref as _ref
from . import traceback as _traceback
from .registry import (
    FramedBlocks,
    available_backends,
    backend_acs_impl,
    backend_acs_radix,
    backend_metric_modes,
    backend_start_policies,
    backend_tb_modes,
    get_backend,
    knob_error,
    register_backend,
    resolve_tb_mode,
)

# the registry accessors are re-exported: importing them from here also
# registers this module's backends
__all__ = [
    "pbvd_decode_blocks",
    "available_backends",
    "backend_start_policies",
    "backend_metric_modes",
    "backend_tb_modes",
    "backend_acs_radix",
    "backend_acs_impl",
    "knob_error",
]


def _start_states(pm: torch.Tensor, start_policy: str) -> torch.Tensor | int:
    if start_policy == "argmin":
        return torch.argmin(pm, dim=0).to(torch.int32)  # first minimal state
    return 0


def _two_phase(blocks: FramedBlocks, code: ConvCode, forward, walk, start_policy, metric_mode,
               acs_radix):
    sp, pm = forward(blocks.y, code, metric_mode=metric_mode, radix=acs_radix)
    start = _start_states(pm, start_policy)
    bits = walk(sp, code, blocks.decode_start, blocks.n_decode, start)
    return bits[:, : blocks.n_real_blocks]


_MODES = ("f32", "i16", "i8")
_RADIXES = (2, 4)


@register_backend("ref", metric_modes=_MODES, acs_radix=_RADIXES)
def _decode_ref(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
) -> torch.Tensor:
    """Plain PyTorch path (the oracle)."""
    return _two_phase(
        blocks, code, _ref.acs_forward_ref, _ref.traceback_ref, start_policy, metric_mode,
        acs_radix,
    )


@register_backend("cuda", metric_modes=_MODES, acs_radix=_RADIXES)
def _decode_cuda(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
) -> torch.Tensor:
    """Two-kernel path: K1 forward ACS, then K2 serial traceback."""
    return _two_phase(
        blocks, code, _acs.acs_forward, _traceback.traceback, start_policy, metric_mode,
        acs_radix,
    )


@register_backend("fused", start_policies=("zero",), metric_modes=_MODES, acs_radix=_RADIXES)
def _decode_fused(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
) -> torch.Tensor:
    """Single-kernel path (ACS + on-chip serial walk, bit-packed output),
    unpacked here to the common ``(n_decode, n_real)`` bits."""
    if start_policy != "zero":
        # direct backend callers bypass the dispatcher's eager check; fail
        # loudly rather than silently decoding from state 0
        raise ValueError("fused backend tracebacks from state 0 (start_policies=('zero',))")
    nd = -(-blocks.n_decode // 32) * 32  # the kernel emits 32-bit words
    packed = _fused.pbvd_fused(
        blocks.y, code, decode_start=blocks.decode_start, n_decode=nd,
        metric_mode=metric_mode, radix=acs_radix,
    )
    # unpack only what is kept: the real lanes, and the live rows of the
    # ragged last word
    packed = packed[:, : blocks.n_real_blocks]
    n_full, rem = divmod(blocks.n_decode, 32)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    parts = []
    if n_full:
        parts.append(((packed[:n_full, None, :] >> shifts[None, :, None]) & 1)
                     .reshape(n_full * 32, -1))
    if rem:
        parts.append((packed[n_full, None, :] >> shifts[:rem, None]) & 1)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def pbvd_decode_blocks(
    y_blocks: torch.Tensor,
    code: ConvCode,
    *,
    decode_start: int,
    n_decode: int,
    start_policy: Literal["zero", "argmin"] = "zero",
    backend: str = "cuda",
    frame_counts: tuple[int, ...] | None = None,
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
) -> torch.Tensor:
    """Decode framed parallel blocks via the named backend.

    y_blocks: (T, R, B) soft symbols (float32, or int8/int16/int32 for the
        exact quantized path), framed [trunc M | decode D | traceback L]. The
        lane axis may pack several frames (``frame_counts``, see
        :class:`FramedBlocks`).
    Returns (n_decode, n_real_blocks) int32 decoded bits.

    Backend and knobs are validated before anything runs: an unknown
    backend raises ``KeyError``; an unsupported start policy, metric mode,
    tb mode, radix or impl raises :func:`knob_error`'s ``ValueError``, and
    so do radix 4 on a code with K < 3 and a narrow metric mode whose
    saturation budget cannot take the radix (``norm_interval``).
    """
    supported = backend_start_policies(backend)  # KeyError for unknown backend
    if start_policy not in supported:
        raise knob_error(backend, "start_policy", start_policy, supported)
    supported_modes = backend_metric_modes(backend)
    if metric_mode not in supported_modes:
        raise knob_error(backend, "metric_mode", metric_mode, supported_modes)
    tb_mode = resolve_tb_mode(backend, tb_mode)  # "auto" → declared mode
    supported_tb = backend_tb_modes(backend)
    if tb_mode not in supported_tb:
        raise knob_error(backend, "tb_mode", tb_mode, supported_tb)
    supported_impl = backend_acs_impl(backend)
    if acs_impl not in supported_impl:
        raise knob_error(backend, "acs_impl", acs_impl, supported_impl)
    supported_radix = backend_acs_radix(backend)
    if acs_radix not in supported_radix:
        raise knob_error(backend, "acs_radix", acs_radix, supported_radix)
    if acs_radix == 4 and code.n_states < 4:
        raise ValueError(f"acs_radix=4 needs K >= 3 (got K={code.K})")
    # narrow modes: the normalization cadence must exist at this radix —
    # norm_interval raises before anything launches when the budget cannot
    # absorb the fused double-stage accumulation
    norm_interval(code, metric_mode, acs_radix)
    return get_backend(backend)(
        FramedBlocks(y_blocks, decode_start, n_decode, frame_counts),
        code,
        start_policy=start_policy,
        metric_mode=metric_mode,
        tb_mode=tb_mode,
        acs_radix=acs_radix,
        acs_impl=acs_impl,
    )
