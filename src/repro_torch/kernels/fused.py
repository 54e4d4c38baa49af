"""The fused single-kernel decoder (``csrc/fused.cu``): wrapper, plain
version, count.

Replaces ``repro.kernels.fused._fused_kernel`` (driven by
``pbvd_fused_pallas`` with ``tb_mode="serial"``) and
``_fused_prefix_kernel`` (``tb_mode="prefix"``), with each of their ACS
phases: radix 2 (``_acs_phase``), radix 4 (``_acs_phase_r4_dbuf``) and the
k-stage matrix steps (``_acs_phase_mat_dbuf``), in the metric modes
``f32``/``i16``/``i8``. :func:`pbvd_fused` takes the plain PyTorch version
:func:`pbvd_fused_plain` (``repro_torch.kernels.ref.pbvd_fused_ref``) for a
CPU tensor; for a CUDA tensor it launches the CUDA kernel or raises; for a
meta tensor it launches nothing, returns the kernel's output shape and
reports its work to the work counter (``launch/cost.py``). Float
symbols with ``impl="matrix"`` run the radix-2 body, as the reference
lowers them. What bounds the kernel on the card and what its design does
about it is noted in the CUDA source.

The ACS phase runs K1's bodies (:func:`kernel_body`): for the mother codes
of ``acs.WARP_CODES``, the warp body, or with ``impl="matrix"`` the matrix
warp body of K1-matrix (the TPU kernel's ``_acs_phase_mat_dbuf``) at its
one S per (code, k), each with its compile-time tables checked before the
launch, and then either walk: the serial walk, or the prefix walk on the
warp's lanes (``csrc/traceback_core.cuh``'s lane bodies, shared with
K2-prefix); the runtime-table bodies (butterfly or matrix) with either walk
for any other code.
The survivor history lives in shared memory, ``T·ceil(N/32)·4`` bytes per
parallel block, stage-major with the block fastest, and in prefix mode the
walk's scratch beside it.
:func:`smem_plan` picks the parallel blocks per CTA and refuses, with
``ValueError``, what does not fit the card's 232,448 bytes even at one
block per CTA; nothing falls back to the two-kernel path or the serial walk.

``launches`` counts the kernel's launches, and nothing else;
``matrix_launches``, ``prefix_launches`` and ``table_launches`` count those
of them that ran a matrix ACS body (either), the prefix tail and the
runtime-table butterfly body, and ``matrix_table_launches`` those of the
matrix launches that ran the runtime-table matrix body.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from repro_torch.launch import cost
from . import _build
from .acs import (
    _DTYPE_CODE,
    _MAX_MATRIX_K,
    _MAX_R,
    _MAX_STATES,
    _labels_on,
    _matrix_table_on,
    check_warp_labels,
    check_warp_matrix_table,
    matrix_states_arg,
    warp_code_id,
    warp_states_arg,
)
from .ref import (
    DEFAULT_TB_CHUNK,
    _acc_dtype_for,
    pbvd_fused_ref as pbvd_fused_plain,
    prefix_chunk_geometry,
)
from .traceback import SMEM_PER_CTA

__all__ = [
    "kernel_body",
    "pbvd_fused",
    "pbvd_fused_plain",
    "smem_plan",
    "launches",
    "matrix_launches",
    "matrix_table_launches",
    "prefix_launches",
    "residency",
    "table_launches",
    "SMEM_PER_CTA",
    "SMEM_PER_SM",
]

#: launches of the CUDA kernel since the counts were last set to 0
launches = 0
#: those of them that ran a matrix ACS body / the prefix tail / the
#: runtime-table butterfly body
matrix_launches = 0
prefix_launches = 0
table_launches = 0
#: the matrix launches that ran the runtime-table matrix body
matrix_table_launches = 0

#: shared memory of an H100 SM; each resident CTA also reserves 1 KB of it
SMEM_PER_SM = 233472
_MAX_CTAS_PER_SM = 32


def kernel_body(code: ConvCode, tb_mode: str = "serial") -> str:
    """The fused kernel's ACS body for ``code``: ``"warp"`` (the butterfly
    warp body, or the matrix warp body under ``impl="matrix"``) for a mother
    code of ``acs.WARP_CODES``, with either walk, else ``"table"``.
    ``tb_mode`` picks the tail (the serial walk or the prefix walk on the
    body's lanes), not the body."""
    if tb_mode not in ("serial", "prefix"):
        raise ValueError(f"unknown tb_mode {tb_mode!r}")
    return "warp" if warp_code_id(code) else "table"


def residency(G: int, smem: int, lanes: int) -> tuple[int, int]:
    """(CTAs, warps) that one SM of the card holds at ``smem`` bytes per CTA
    of ``G`` parallel blocks of the warp body, ``lanes`` threads each.
    Shared memory and the 32-CTA cap only; registers are not counted."""
    ctas = min(_MAX_CTAS_PER_SM, SMEM_PER_SM // (smem + 1024))
    return ctas, ctas * -(-G * lanes // 32)


def smem_plan(
    T: int,
    n_states: int,
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    *,
    decode_start: int = 0,
    n_decode: int | None = None,
    matrix_k: int = 0,
    R: int = 2,
    lanes: int | None = None,
) -> tuple[int, int]:
    """(parallel blocks per CTA, shared bytes per CTA) of the fused kernel.

    Per parallel block, in 4-byte words: the survivor history of T stages ×
    ceil(N/32) words, laid out ``[t][w][g]``; for the table bodies
    (``lanes`` None) also two path-metric planes and the min-reduction
    slots (``csrc/acs_core.cuh::forward_smem_slots``), with ``matrix_k`` >
    0 also the 2^(kR-1) folded rows and k decision planes of ceil(N/32)
    words (``matrix_smem_slots``; the matrix warp body keeps them in
    registers); and in prefix mode the walk's scratch:
    the ``n_act`` composed maps of N entries, ``nc_e`` entry states and the
    ``n_decode/32`` words of the decode window (geometry of
    :func:`prefix_chunk_geometry` over the bits that exist). The table
    bodies take G = max(1, 128/N) and drop to 1 when that does not fit. The
    warp bodies (``lanes`` = N/S threads per block) take the power of two
    G <= 32/lanes (one warp) that keeps the most blocks resident on an SM
    (:func:`residency`), the larger on a tie. What does not fit at G = 1
    raises ``ValueError`` naming T, N and the bytes; in prefix mode a
    geometry is refused exactly where the table bodies' count does not fit
    at G = 1, with their message, whichever body runs it.
    """
    N = n_states
    W = -(-N // 32)
    per_block = T * W
    if lanes is None:
        per_block += 2 * N + max(1, N // 32)
    if matrix_k and lanes is None:
        per_block += (1 << (matrix_k * R - 1)) + matrix_k * W
    scratch = ""
    if tb_mode == "prefix":
        n_decode = T - decode_start if n_decode is None else n_decode
        n_window = min(n_decode, T - decode_start)
        C, _, n_chunks, c_lo, c_hi = prefix_chunk_geometry(T, decode_start, n_window, tb_chunk)
        per_block += (n_chunks - c_lo) * N + (c_hi - c_lo + 1) + -(-n_decode // 32)
        scratch = f" with the prefix scratch of tb_chunk={C}"

    def need(G: int) -> int:
        return 4 * G * per_block

    if lanes is None:
        G = max(1, 128 // N)
        if need(G) > SMEM_PER_CTA:
            G = 1
    else:
        if scratch:  # the prefix walk is refused where the table bodies refuse it
            smem_plan(T, N, tb_mode, tb_chunk, decode_start=decode_start, n_decode=n_decode,
                      matrix_k=matrix_k, R=R)
        fits = [1 << e for e in range((32 // lanes).bit_length())
                if need(1 << e) <= SMEM_PER_CTA]
        G = max(fits or [1], key=lambda g: (g * residency(g, need(g), lanes)[0], g))
    if need(G) > SMEM_PER_CTA:
        raise ValueError(
            f"the fused kernel's survivor history of T={T} stages at N={N} states{scratch} "
            f"needs {need(1)} bytes of shared memory per parallel block, above the "
            f"{SMEM_PER_CTA} bytes a CTA may use; use a shorter block (D, L)"
            + (" or a larger tb_chunk" if scratch else "")
        )
    return G, need(G)


def _lib() -> ctypes.CDLL:
    lib = _build.load("fused")
    fn = lib.pbvd_fused
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, p, p] + [i] * 15 + [p, p]
        fn.restype = ctypes.c_int
        lib.pbvd_fused_code_labels.argtypes = [i, p]
        lib.pbvd_fused_code_labels.restype = i
        lib.pbvd_fused_code_matrix_table.argtypes = [i, i, p]
        lib.pbvd_fused_code_matrix_table.restype = i
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
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    impl: str = "butterfly",
    k: int = 2,
    states_per_thread: int | None = None,
) -> torch.Tensor:
    """One-kernel decode. y (T, R, B) → packed bits (n_decode/32, B) int32.

    The signature and result of :func:`pbvd_fused_plain`: ``n_decode`` a
    multiple of 32, ``start_state`` an int or a (B,) tensor of states in
    [0, N) (zeros by default), ``tb_mode`` ``"serial"`` or ``"prefix"``
    (chunks of ``tb_chunk`` stages), ``impl`` ``"butterfly"`` (at
    ``radix``) or ``"matrix"`` (``k`` stages per step; ``radix`` ignored).
    On a CUDA tensor ``y`` must be contiguous, int8/int16/int32 or float32;
    the narrow metric modes need integer symbols. ``states_per_thread``
    picks one of the warp body's S variants, as ``acs.acs_forward``'s
    (either walk).
    """
    global launches, matrix_launches, matrix_table_launches, prefix_launches, table_launches
    if y.device.type == "cpu":
        return pbvd_fused_plain(y, code, decode_start=decode_start, n_decode=n_decode,
                                start_state=start_state, metric_mode=metric_mode, radix=radix,
                                tb_mode=tb_mode, tb_chunk=tb_chunk, impl=impl, k=k)
    if y.device.type == "meta":
        T, _, B = y.shape
        if impl == "matrix" and _acc_dtype_for(y.dtype, metric_mode) == torch.float32:
            impl = "butterfly"  # the float lowering, as on the card
        cost.kernel("pbvd_fused", *cost.fused_work(
            code, T, B, y.element_size(), decode_start, n_decode, impl, k, tb_mode, tb_chunk),
            "int")
        return torch.empty((n_decode // 32, B), dtype=torch.int32, device="meta")
    if y.device.type != "cuda":
        raise ValueError(f"pbvd_fused runs on CPU or CUDA tensors, got {y.device}")
    if y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (T, R, B) tensor, got {tuple(y.shape)}")
    T, R, B = y.shape
    if R != code.R or R > _MAX_R:
        raise ValueError(f"symbol rank {R} != code R {code.R} (at most {_MAX_R})")
    if code.n_states > _MAX_STATES:
        raise ValueError(f"the fused kernel takes n_states <= {_MAX_STATES}, got {code.n_states}")
    if n_decode % 32 or n_decode <= 0:
        raise ValueError(f"n_decode must be a positive multiple of 32, got {n_decode}")
    if not 0 <= decode_start < T:
        raise ValueError(f"decode_start {decode_start} outside [0, {T})")
    if tb_mode not in ("serial", "prefix"):
        raise ValueError(f"unknown tb_mode {tb_mode!r}")
    if impl not in ("butterfly", "matrix"):
        raise ValueError(f"impl must be 'butterfly' or 'matrix', got {impl!r}")
    if impl == "matrix":
        code.validate_matrix_k(k)
        if k > _MAX_MATRIX_K:
            raise ValueError(f"the CUDA matrix ACS takes acs_k <= {_MAX_MATRIX_K}, got {k}")
    semantic = _acc_dtype_for(y.dtype, metric_mode)  # raises for other modes/dtypes
    if impl == "matrix" and semantic == torch.float32:
        impl, radix = "butterfly", 2  # the float lowering, as the reference's
    if impl == "butterfly":
        if radix not in (2, 4):
            raise ValueError(f"radix must be 2 or 4, got {radix}")
        if radix == 4 and code.n_states < 4:
            raise ValueError(f"radix-4 ACS needs K >= 3 (got K={code.K})")
        norm_every = norm_interval(code, metric_mode, radix)
        k_launch = 0
    else:
        norm_every = norm_interval(code, metric_mode, stages_per_step=k)
        k_launch = k
    qmax = metric_mode_qmax(code, metric_mode) if norm_every else 0
    geometry = (1, 0, 1, 0, 0)  # C, P, n_chunks, c_lo, c_hi: unused when serial
    if tb_mode == "prefix":
        n_window = min(n_decode, T - decode_start)
        geometry = prefix_chunk_geometry(T, decode_start, n_window, tb_chunk)
    cid = S = 0
    if kernel_body(code, tb_mode) == "warp":
        if k_launch:
            cid = check_warp_matrix_table(_lib(), "pbvd_fused_code_matrix_table", code, k_launch)
            S = matrix_states_arg(code, k_launch, states_per_thread)
        else:
            cid = check_warp_labels(_lib(), "pbvd_fused_code_labels", code)
            S = warp_states_arg(code, states_per_thread)
    if states_per_thread is not None and not cid:
        raise ValueError(f"the runtime-table bodies take no states_per_thread "
                         f"(K={code.K} R={code.R}, impl={impl!r}, tb_mode={tb_mode!r})")
    G, _ = smem_plan(T, code.n_states, tb_mode, tb_chunk, decode_start=decode_start,
                     n_decode=n_decode, matrix_k=k_launch, R=R,
                     lanes=code.n_states // S if cid else None)
    start = torch.as_tensor(0 if start_state is None else start_state, dtype=torch.int32,
                            device=y.device)
    start = start.broadcast_to((B,)).contiguous()
    bits = torch.empty((n_decode // 32, B), dtype=torch.int32, device=y.device)
    if B == 0:
        return bits
    labels = _labels_on(code, y.device)
    table = _matrix_table_on(code, k_launch, y.device).data_ptr() if k_launch else None
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = _lib().pbvd_fused(
            y.data_ptr(), _DTYPE_CODE[y.dtype], T, R, B, code.v, labels.data_ptr(), table,
            start.data_ptr(), decode_start, n_decode, norm_every, qmax, radix, k_launch,
            int(tb_mode == "prefix"), *geometry, cid, S, G, bits.data_ptr(), stream,
        )
    if rc:
        raise RuntimeError(f"pbvd_fused launch failed (error {rc})")
    launches += 1
    matrix_launches += bool(k_launch)
    matrix_table_launches += bool(k_launch) and not cid
    prefix_launches += tb_mode == "prefix"
    table_launches += not (cid or k_launch)
    return bits
