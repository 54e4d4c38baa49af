"""Decode backends and the eager-checking dispatcher of the port.

The counterpart of ``repro.kernels.ops``. Three backends register here,
each with the metric modes ``"f32"``/``"i16"``/``"i8"``, radix 2 and 4, the
serial and prefix tracebacks and the butterfly and matrix ACS:

* ``"ref"`` — the plain PyTorch path (``kernels/ref.py``), on whatever
  device the symbols are; its prefix traceback is the full-depth log-depth
  scan, so it ignores ``tb_chunk``;
* ``"cuda"`` — the two-kernel path, the counterpart of the reference's
  ``"pallas"``: K1 or K1-matrix (``kernels/acs.py``) then K2 or K2-prefix
  (``kernels/traceback.py``). On CPU tensors the wrappers run their plain
  versions, so ``"cuda"`` on the CPU equals ``"ref"``;
* ``"fused"`` — the single-kernel path (``kernels/fused.py``): forward ACS
  and the walk in one kernel, bit-packed output words; zero start only, as
  in the reference.

None pads the lane axis (the kernels mask the ragged edge) nor the stage
axis (the CUDA ACS loops run the true T stages, the matrix loop T // k
steps and then T mod k radix-2 stages, as the reference's ``"ref"``). So
the argmin start is taken over the true stage-T metrics, as the
reference's ``"ref"`` backend does; the reference's ``"pallas"`` backend
takes it after its zero pad stages and may start from another of several
tied states.
"""

from __future__ import annotations

import functools
from typing import Literal

import torch

from repro_torch.core.quantize import norm_interval
from repro_torch.core.trellis import ConvCode
from . import acs as _acs
from . import fused as _fused
from . import ref as _ref
from . import traceback as _traceback
from .ref import DEFAULT_TB_CHUNK
from .registry import (
    DEFAULT_ACS_K,
    FramedBlocks,
    available_backends,
    backend_acs_impl,
    backend_acs_radix,
    backend_limits,
    backend_metric_modes,
    backend_start_policies,
    backend_tb_chunk_sensitive,
    backend_tb_modes,
    check_code_limits,
    get_backend,
    knob_error,
    register_backend,
    resolve_tb_mode,
)

# the registry accessors are re-exported: importing them from here also
# registers this module's backends
__all__ = [
    "DEFAULT_ACS_K",
    "DEFAULT_TB_CHUNK",
    "pbvd_decode_blocks",
    "available_backends",
    "backend_start_policies",
    "backend_metric_modes",
    "backend_tb_modes",
    "backend_tb_chunk_sensitive",
    "backend_acs_radix",
    "backend_acs_impl",
    "backend_limits",
    "knob_error",
    "SHARD_DISPATCH",
    "check_mesh_launch",
]


#: Lane-axis dispatch strategies for a mesh-bound engine. Both split the
#: lanes into equal slices, one per lane shard (``sharding/smap.py``):
#: ``"constraint"`` launches each shard with only its real lanes (the kernels
#: mask a ragged edge; a shard with none is not launched), ``"shard_map"``
#: decodes every lane of every slice, pad lanes included, and trims the pad
#: lanes once, after the shards are joined, as the reference's ``shard_map``
#: must (per-shard output shapes are uniform there).
SHARD_DISPATCH = ("constraint", "shard_map")


def check_mesh_launch(mesh, block_axes, backend: str, *, dispatch: str = "constraint") -> int:
    """Eagerly validate a mesh × backend decode combination; return n_shards.

    Every failure here is a clear ``ValueError`` (or ``KeyError`` for an
    unknown backend) raised before anything is framed: unknown dispatch
    mode, empty/duplicate ``block_axes``, axes the mesh does not have, a
    backend name the registry does not know, and a mesh that spans
    processes but leaves a rank without a position (every rank joins every
    decode, so each must hold a device; ``DecodeMesh`` already refuses
    ranks whose devices differ in type). Called by ``DecoderEngine`` at
    construction, so a bad mesh binding fails when the engine is built —
    never inside a batched launch mid-stream. Every rank sees the same
    global mesh, so every rank refuses alike.
    """
    get_backend(backend)  # KeyError names the unknown backend
    if dispatch not in SHARD_DISPATCH:
        raise ValueError(
            f"unknown shard dispatch {dispatch!r}; supported: {SHARD_DISPATCH}"
        )
    axes = tuple(block_axes)
    if not axes:
        raise ValueError("block_axes must name at least one mesh axis")
    if len(set(axes)) != len(axes):
        raise ValueError(f"block_axes {axes} repeats a mesh axis")
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(
            f"block_axes {missing} not in mesh axes {tuple(mesh.axis_names)}"
        )
    if getattr(mesh, "spans_processes", False):  # a mesh without owners never spans
        held = {int(r) for r in mesh.owners.flat}
        idle = [r for r in range(mesh.process_count) if r not in held]
        if idle:
            raise ValueError(
                f"the mesh spans {mesh.process_count} processes but rank(s) {idle} hold "
                f"no position of it; every rank joins each decode, so each must hold "
                f"a device of the mesh"
            )
    n_shards = 1
    for a in axes:
        n_shards *= int(mesh.shape[a])
    if n_shards < 1:
        raise ValueError(f"mesh shards the lane axis {n_shards} ways: empty mesh?")
    return n_shards


def _start_states(pm: torch.Tensor, start_policy: str) -> torch.Tensor | int:
    if start_policy == "argmin":
        return torch.argmin(pm, dim=0).to(torch.int32)  # first minimal state
    return 0


def _two_phase(blocks: FramedBlocks, code: ConvCode, forward, walk, *, start_policy,
               metric_mode, acs_radix, acs_impl, acs_k):
    sp, pm = forward(blocks.y, code, metric_mode, acs_radix, acs_impl, acs_k)
    start = _start_states(pm, start_policy)
    bits = walk(sp, code, blocks.decode_start, blocks.n_decode, start)
    return bits[:, : blocks.n_real_blocks]


_KNOBS = dict(metric_modes=("f32", "i16", "i8"), tb_modes=("serial", "prefix"),
              acs_radix=(2, 4), acs_impl=("butterfly", "matrix"))
# the CUDA kernels' size limits: the code rank and acs_k their template
# instances cover, and 1 <= log2 N <= 10 in every C interface
_CUDA_LIMITS = dict(max_rank=_acs._MAX_R, max_matrix_k=_acs._MAX_MATRIX_K,
                    max_states=_acs._MAX_STATES)


@register_backend("ref", tb_chunk_sensitive=False, **_KNOBS)
def _decode_ref(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
    acs_k: int = DEFAULT_ACS_K,
) -> torch.Tensor:
    """Plain PyTorch path (the oracle). ``tb_mode="prefix"`` runs the
    log-depth scan over the whole history, so ``tb_chunk`` is ignored."""

    def forward(y, code, mode, radix, impl, k):
        return _ref.acs_forward_ref(y, code, mode, radix, impl, matrix_k=k)

    walk = _ref.traceback_prefix_ref if tb_mode == "prefix" else _ref.traceback_ref
    return _two_phase(blocks, code, forward, walk, start_policy=start_policy,
                      metric_mode=metric_mode, acs_radix=acs_radix, acs_impl=acs_impl,
                      acs_k=acs_k)


@register_backend("cuda", **_KNOBS, **_CUDA_LIMITS)
def _decode_cuda(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
    acs_k: int = DEFAULT_ACS_K,
) -> torch.Tensor:
    """Two-kernel path: K1 (or K1-matrix), then K2 (or K2-prefix)."""
    if tb_mode == "prefix":
        if blocks.y.is_cuda:  # refuse a prefix scratch that does not fit before K1 launches
            _traceback.prefix_plan(code.n_states, blocks.y.shape[0], blocks.decode_start,
                                   blocks.n_decode, tb_chunk)
        walk = functools.partial(_traceback.traceback_prefix, tb_chunk=tb_chunk)
    else:
        walk = _traceback.traceback
    return _two_phase(blocks, code, _acs.acs_forward, walk, start_policy=start_policy,
                      metric_mode=metric_mode, acs_radix=acs_radix, acs_impl=acs_impl,
                      acs_k=acs_k)


@register_backend("fused", start_policies=("zero",), **_KNOBS, **_CUDA_LIMITS)
def _decode_fused(
    blocks: FramedBlocks,
    code: ConvCode,
    *,
    start_policy: str = "zero",
    metric_mode: str = "f32",
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
    acs_k: int = DEFAULT_ACS_K,
) -> torch.Tensor:
    """Single-kernel path (ACS + on-chip walk, bit-packed output),
    unpacked here to the common ``(n_decode, n_real)`` bits."""
    if start_policy != "zero":
        # direct backend callers bypass the dispatcher's eager check; fail
        # loudly rather than silently decoding from state 0
        raise ValueError("fused backend tracebacks from state 0 (start_policies=('zero',))")
    nd = -(-blocks.n_decode // 32) * 32  # the kernel emits 32-bit words
    packed = _fused.pbvd_fused(
        blocks.y, code, decode_start=blocks.decode_start, n_decode=nd,
        metric_mode=metric_mode, radix=acs_radix, tb_mode=tb_mode, tb_chunk=tb_chunk,
        impl=acs_impl, k=acs_k,
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
    tb_chunk: int = DEFAULT_TB_CHUNK,
    acs_radix: int = 2,
    acs_impl: str = "butterfly",
    acs_k: int = DEFAULT_ACS_K,
) -> torch.Tensor:
    """Decode framed parallel blocks via the named backend.

    y_blocks: (T, R, B) soft symbols (float32, or int8/int16/int32 for the
        exact quantized path), framed [trunc M | decode D | traceback L]. The
        lane axis may pack several frames (``frame_counts``, see
        :class:`FramedBlocks`).
    ``tb_mode`` is ``"serial"``, ``"prefix"`` (chunks of ``tb_chunk``
    stages) or ``"auto"`` (the backend's declared mode); ``acs_impl`` is
    ``"butterfly"`` (at ``acs_radix``) or ``"matrix"`` (``acs_k`` stages per
    step; ``acs_radix`` is then ignored, as in the reference).
    Returns (n_decode, n_real_blocks) int32 decoded bits.

    Backend and knobs are validated before anything runs: an unknown
    backend raises ``KeyError``; an unsupported start policy, metric mode,
    tb mode, radix or impl raises :func:`knob_error`'s ``ValueError``, and
    so do ``tb_chunk < 1``, an ``acs_k`` outside ``validate_matrix_k``'s
    bounds, radix 4 on a code with K < 3 and a narrow metric mode whose
    saturation budget cannot take the radix or k (``norm_interval``), and
    a code or ``acs_k`` beyond the backend's kernel limits
    (:func:`check_code_limits`: on ``"cuda"`` and ``"fused"`` R <= 4,
    ``acs_k`` <= 4 under matrix, N <= 1024). On CUDA tensors a kernel's
    shared-memory plan that does not fit (the fused kernel's history and
    scratch, K2-prefix's composed maps) raises ``ValueError`` before the
    backend launches anything.
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
    if tb_chunk < 1:
        raise ValueError(f"tb_chunk must be >= 1, got {tb_chunk}")
    supported_impl = backend_acs_impl(backend)
    if acs_impl not in supported_impl:
        raise knob_error(backend, "acs_impl", acs_impl, supported_impl)
    if acs_impl == "matrix":
        # the fusion depth's structural bounds, then the narrow modes' budget
        # for k unnormalized stages per step; the radix is inert here
        code.validate_matrix_k(acs_k)
        norm_interval(code, metric_mode, stages_per_step=acs_k)
        acs_radix = 2  # inert here, and then not refused by the plain version's radix check
    else:
        supported_radix = backend_acs_radix(backend)
        if acs_radix not in supported_radix:
            raise knob_error(backend, "acs_radix", acs_radix, supported_radix)
        if acs_radix == 4 and code.n_states < 4:
            raise ValueError(f"acs_radix=4 needs K >= 3 (got K={code.K})")
        # narrow modes: the normalization cadence must exist at this radix
        norm_interval(code, metric_mode, acs_radix)
    check_code_limits(backend, code, acs_impl, acs_k)
    return get_backend(backend)(
        FramedBlocks(y_blocks, decode_start, n_decode, frame_counts),
        code,
        start_policy=start_policy,
        metric_mode=metric_mode,
        tb_mode=tb_mode,
        tb_chunk=tb_chunk,
        acs_radix=acs_radix,
        acs_impl=acs_impl,
        acs_k=acs_k,
    )
