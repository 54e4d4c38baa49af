"""K1, the forward ACS kernels (``csrc/acs.cu``): wrapper, plain version,
counts.

K1 replaces ``repro.kernels.acs._acs_kernel`` (radix-2 and radix-4
branches, driven by ``acs_forward_pallas``) and K1-matrix its
``_acs_matrix_kernel`` (``impl="matrix"``, the k-stage (min,+) steps), in
the metric modes ``f32``/``i16``/``i8``. :func:`acs_forward` takes the
plain PyTorch version :func:`acs_forward_plain`
(``repro_torch.kernels.ref.acs_forward_ref``) for a CPU tensor; for a CUDA
tensor it launches a CUDA kernel or raises; for a meta tensor it launches
nothing, returns outputs of the kernel's shapes and dtypes and reports the
kernel's work to the work counter (``launch/cost.py``). Float symbols with
``impl="matrix"`` run the radix-2 butterfly kernel, as the reference lowers
them (IEEE addition is not associative). What bounds the kernels on the
card and what their design does about it is noted in the CUDA source. In
the narrow modes the kernels keep int32 metrics, as the TPU kernels do, and
return them as int32; the plain version stores int16/int8. The values are
equal (the saturation budget keeps them inside the narrow dtype), so
comparisons cast to int32.

The butterfly has two bodies, chosen by the code (:func:`kernel_body`):
the warp body for the mother codes in :data:`WARP_CODES` (CCSDS, IS-95,
LTE), whose trellis tables are fixed at compile time, and the
runtime-table body for any other code. Before a warp-body launch the
wrapper holds the labels that the instantiation derived at compile time
against :func:`kernel_labels` and raises on a difference.

K1-matrix has two bodies too, chosen the same way: the matrix warp body
for the mother codes, at one S per (code, k) (:func:`matrix_states`), whose
(index, sign) table of the k-stage labels is fixed at compile time and held
against :func:`kernel_matrix_table` before a launch, and the runtime-table
matrix body for any other code. Both compute K1's function, whose bound on
the H100 80GB HBM3 (700 W) is 0.0753 ms at the main shapes (T = 596, B =
8192); there the matrix warp body takes about 0.31 ms at k = 2 (0.34 at k =
3, 0.44 at k = 4) where the runtime-table body took 1.92 ms (PERF.md).

``launches`` counts K1's (butterfly) launches, ``table_launches`` those of
them that ran the runtime-table body, ``matrix_launches`` K1-matrix's (either
body) and ``matrix_table_launches`` those of them that ran the runtime-table
matrix body, and nothing else: set them to 0, run, read them.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from repro_torch.core.codespec import IS95_29, LTE_37
from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import CCSDS_27, ConvCode
from repro_torch.launch import cost
from . import _build
from .ref import _acc_dtype_for, acs_forward_ref as acs_forward_plain

__all__ = [
    "acs_forward",
    "acs_forward_plain",
    "kernel_body",
    "kernel_labels",
    "kernel_matrix_table",
    "launches",
    "matrix_launches",
    "matrix_states",
    "matrix_table_launches",
    "table_launches",
    "warp_code_id",
    "warp_states",
    "WARP_CODES",
]

#: launches of K1 (the butterfly kernel, either body) since the count was last set to 0
launches = 0
#: those of them that ran the runtime-table body
table_launches = 0
#: launches of K1-matrix since the count was last set to 0
matrix_launches = 0
#: those of them that ran the runtime-table matrix body
matrix_table_launches = 0

_DTYPE_CODE = {torch.int8: 0, torch.int16: 1, torch.int32: 2, torch.float32: 3}
_MAX_R = 4
_MAX_MATRIX_K = 4  # the kernels' template instances: every k of the R >= 2 codes
_MAX_STATES = 1024  # 1 <= log2 N <= 10 in every C interface

#: the mother codes with a warp-body instantiation (``csrc/acs_core.cuh``),
#: by the C interfaces' code id (0 is the runtime-table body)
WARP_CODES = {1: CCSDS_27, 2: IS95_29, 3: LTE_37}
#: the S variants (path metrics per lane) built for each, the default first:
#: the fastest on the H100 for CCSDS and IS-95; LTE's 16 and 32 are within
#: run-to-run noise (PERF.md)
_WARP_STATES = {1: (32, 64, 16), 2: (64, 32), 3: (16, 32, 64)}
#: the one S of the matrix warp body per code id and k
#: (``csrc/acs_core.cuh::matrix_warp_states``): k = 4 halves S, because
#: its 2^(kR-1) folded rows share the registers with the metrics; IS-95
#: takes 32 at every k (64 spilled)
_MATRIX_STATES = {1: {1: 32, 2: 32, 3: 32, 4: 16}, 2: {1: 32, 2: 32, 3: 32, 4: 32},
                  3: {1: 16, 2: 16}}


def kernel_labels(code: ConvCode) -> np.ndarray:
    """(N, 2) int32: the R-bit labels of each target state's even and odd
    predecessor branches (α/γ for the top half, β/θ for the bottom half)."""
    tabs = code.acs_tables
    even = np.concatenate([tabs["cw_top_even"], tabs["cw_bot_even"]])
    odd = np.concatenate([tabs["cw_top_odd"], tabs["cw_bot_odd"]])
    return np.stack([even, odd], axis=1).astype(np.int32)


def kernel_matrix_table(code: ConvCode, k: int) -> np.ndarray:
    """(2^k, 2^k, N/2^k) int32, indexed [c, j, u]: how target ``c·U + u``
    gets the k-stage metric of its predecessor ``2^k·u + j``, as
    ``2·fold_idx + (fold_sgn < 0)`` of ``code.matrix_acs_tables(k)``: the
    folded combined row to read and whether to negate it. The rows
    themselves follow ``code.folded_matrix_codeword_signs(k)``: row f adds
    symbol r of the stacked window where bit kR-1-r of f is 1 and subtracts
    it where it is 0."""
    t = code.matrix_acs_tables(k)
    return (2 * t["fold_idx"] + (t["fold_sgn"] < 0)).astype(np.int32)


def warp_code_id(code: ConvCode) -> int:
    """The code id of ``code``'s warp-body instantiation, 0 if it has none."""
    for cid, mother in WARP_CODES.items():
        if code.polys == mother.polys:
            return cid
    return 0


def kernel_body(code: ConvCode) -> str:
    """``"warp"`` for a mother code in :data:`WARP_CODES`, else ``"table"``:
    the body of K1 and of K1-matrix."""
    return "warp" if warp_code_id(code) else "table"


def warp_states(code: ConvCode) -> tuple[int, ...]:
    """The S variants built for ``code``'s warp body, the default first."""
    cid = warp_code_id(code)
    if not cid:
        raise ValueError(f"K={code.K} R={code.R} {code.polys} runs the runtime-table body")
    return _WARP_STATES[cid]


def warp_states_arg(code: ConvCode, states_per_thread: int | None) -> int:
    """The S to launch: the default, or ``states_per_thread`` if it is built
    for ``code``'s warp body (``ValueError`` otherwise)."""
    built = warp_states(code)
    S = built[0] if states_per_thread is None else states_per_thread
    if S not in built:
        raise ValueError(f"the warp body of K={code.K} R={code.R} is built for S in {built}, "
                         f"got states_per_thread={states_per_thread}")
    return S


def matrix_states(code: ConvCode, k: int) -> int:
    """The S of the matrix warp body built for ``code`` at ``k``
    (``ValueError`` for a code of the runtime-table body or a k outside
    ``validate_matrix_k`` and the limit of 4)."""
    cid = warp_code_id(code)
    if not cid:
        raise ValueError(f"K={code.K} R={code.R} {code.polys} runs the runtime-table matrix body")
    code.validate_matrix_k(k)
    if k not in _MATRIX_STATES[cid]:
        raise ValueError(f"the CUDA matrix ACS takes acs_k <= {_MAX_MATRIX_K}, got {k}")
    return _MATRIX_STATES[cid][k]


def check_warp_matrix_table(lib: ctypes.CDLL, fn: str, code: ConvCode, k: int) -> int:
    """The matrix warp body's code id for ``code`` (0: the table body), after
    holding the k-stage table its instantiation in ``lib`` derived at compile
    time (``fn``) against :func:`kernel_matrix_table`; ``RuntimeError`` on a
    difference, before anything launches."""
    cid = warp_code_id(code)
    if cid and (lib._name, fn, cid, k) not in _checked:
        want = kernel_matrix_table(code, k)
        out = (ctypes.c_int * want.size)()
        n = getattr(lib, fn)(cid, k, out)
        got = np.frombuffer(out, dtype=np.int32).reshape(want.shape)
        if n != want.size or not np.array_equal(got, want):
            raise RuntimeError(f"{fn}: the compile-time matrix table of code id {cid} at k={k} "
                               f"differs from kernel_matrix_table of {code.polys}")
        _checked.add((lib._name, fn, cid, k))
    return cid


def matrix_states_arg(code: ConvCode, k: int, states_per_thread: int | None) -> int:
    """The S to launch the matrix warp body at: its one S for (code, k), which
    ``states_per_thread`` may name (``ValueError`` for another)."""
    S = matrix_states(code, k)
    if states_per_thread not in (None, S):
        raise ValueError(f"the matrix warp body of K={code.K} R={code.R} at k={k} is built for "
                         f"S={S}, got states_per_thread={states_per_thread}")
    return S


def check_warp_labels(lib: ctypes.CDLL, fn: str, code: ConvCode) -> int:
    """The warp body's code id for ``code`` (0: the table body), after
    holding the labels its instantiation in ``lib`` derived at compile time
    (``fn``) against :func:`kernel_labels`; ``RuntimeError`` on a
    difference, before anything launches."""
    cid = warp_code_id(code)
    if cid and (lib._name, cid) not in _checked:
        out = (ctypes.c_int * (2 * code.n_states))()
        n = getattr(lib, fn)(cid, out)
        got = np.frombuffer(out, dtype=np.int32).reshape(-1, 2)
        if n != code.n_states or not np.array_equal(got, kernel_labels(code)):
            raise RuntimeError(f"{fn}: the compile-time labels of code id {cid} differ from "
                               f"kernel_labels of {code.polys}")
        _checked.add((lib._name, cid))
    return cid


_checked: set = set()


@lru_cache(maxsize=None)
def _labels_on(code: ConvCode, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kernel_labels(code), device=device)


@lru_cache(maxsize=None)
def _matrix_table_on(code: ConvCode, k: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(kernel_matrix_table(code, k), device=device)


def _lib() -> ctypes.CDLL:
    lib = _build.load("acs")
    fn = lib.pbvd_acs_forward
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, i, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
        lib.pbvd_acs_code_labels.argtypes = [i, p]
        lib.pbvd_acs_code_labels.restype = i
        lib.pbvd_acs_code_matrix_table.argtypes = [i, i, p]
        lib.pbvd_acs_code_matrix_table.restype = i
        fn = lib.pbvd_acs_forward_matrix
        fn.argtypes = [p, i, i, i, i, i, p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _meta_forward(y, code: ConvCode, metric_mode: str, impl: str, k: int):
    """The kernels' outputs on meta, launching nothing: survivor words
    (T, W, B) int32 and metrics (N, B) int32 (float32 for float symbols),
    with K1's or K1-matrix's work reported to the work counter."""
    T, R, B = y.shape
    float_syms = _acc_dtype_for(y.dtype, metric_mode) == torch.float32
    if impl == "matrix" and float_syms:
        impl = "butterfly"  # the float lowering, as on the card
    name = "acs_forward_matrix (K1-matrix)" if impl == "matrix" else "acs_forward (K1)"
    cost.kernel(name, *cost.acs_work(code, T, B, y.element_size(), impl, k), "int")
    sp = torch.empty((T, -(-code.n_states // 32), B), dtype=torch.int32, device="meta")
    pm = torch.empty((code.n_states, B), dtype=torch.float32 if float_syms else torch.int32,
                     device="meta")
    return sp, pm


def acs_forward(
    y: torch.Tensor,
    code: ConvCode,
    metric_mode: str = "f32",
    radix: int = 2,
    impl: str = "butterfly",
    k: int = 2,
    *,
    states_per_thread: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over parallel blocks. y: (T, R, B) → (sp (T, W, B), pm (N, B)).

    The signature and result of :func:`acs_forward_plain` (``k`` is its
    ``matrix_k``), except that the kernels' metrics are int32 in the narrow
    modes. On a CUDA tensor ``y`` must be contiguous, int8/int16/int32 or
    float32; the kernels write int32 survivor words and int32 (float32 for
    float symbols) metrics. ``states_per_thread`` picks one of the warp
    body's S variants (:func:`warp_states`, default the first), to hold
    them against each other; the runtime-table body takes none, and the
    matrix warp body only its one (:func:`matrix_states`).
    """
    global launches, matrix_launches, matrix_table_launches, table_launches
    if y.device.type == "cpu":
        return acs_forward_plain(y, code, metric_mode=metric_mode, radix=radix, impl=impl,
                                 matrix_k=k)
    if y.device.type == "meta":
        return _meta_forward(y, code, metric_mode, impl, k)
    if y.device.type != "cuda":
        raise ValueError(f"acs_forward runs on CPU or CUDA tensors, got {y.device}")
    if impl not in ("butterfly", "matrix"):
        raise ValueError(f"impl must be 'butterfly' or 'matrix', got {impl!r}")
    if impl == "matrix":
        code.validate_matrix_k(k)
        if k > _MAX_MATRIX_K:
            raise ValueError(f"the CUDA matrix ACS takes acs_k <= {_MAX_MATRIX_K}, got {k}")
    semantic = _acc_dtype_for(y.dtype, metric_mode)  # raises for other modes/dtypes
    acc_dtype = torch.float32 if semantic == torch.float32 else torch.int32
    if impl == "matrix" and acc_dtype == torch.float32:
        impl, radix = "butterfly", 2  # the float lowering, as the reference's
    if impl == "butterfly":
        if radix not in (2, 4):
            raise ValueError(f"the CUDA ACS kernel implements radix 2 and 4, got radix={radix}")
        if radix == 4 and code.n_states < 4:
            raise ValueError(f"radix-4 ACS needs K >= 3 (got K={code.K})")
        norm_every = norm_interval(code, metric_mode, radix)
    else:
        norm_every = norm_interval(code, metric_mode, stages_per_step=k)
    qmax = metric_mode_qmax(code, metric_mode) if norm_every else 0
    if y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"y must be a contiguous (T, R, B) tensor, got {tuple(y.shape)}")
    T, R, B = y.shape
    if R != code.R or R > _MAX_R:
        raise ValueError(f"symbol rank {R} != code R {code.R} (at most {_MAX_R})")
    N = code.n_states
    if N > _MAX_STATES:
        raise ValueError(f"the CUDA ACS kernels take n_states <= {_MAX_STATES}, got {N}")
    sp = torch.empty((T, -(-N // 32), B), dtype=torch.int32, device=y.device)
    pm = torch.empty((N, B), dtype=acc_dtype, device=y.device)
    if T == 0 or B == 0:
        return sp, pm.zero_()
    labels = _labels_on(code, y.device)
    cid, S = 0, 0
    if impl == "butterfly":
        cid = check_warp_labels(_lib(), "pbvd_acs_code_labels", code)
        if cid:
            S = warp_states_arg(code, states_per_thread)
    else:
        cid = check_warp_matrix_table(_lib(), "pbvd_acs_code_matrix_table", code, k)
        if cid:
            S = matrix_states_arg(code, k, states_per_thread)
    if not cid and states_per_thread is not None:
        raise ValueError(f"K={code.K} R={code.R} {code.polys} runs the runtime-table body, "
                         f"which takes no states_per_thread")
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        if impl == "matrix":
            rc = _lib().pbvd_acs_forward_matrix(
                y.data_ptr(), _DTYPE_CODE[y.dtype], T, R, B, code.v, labels.data_ptr(),
                _matrix_table_on(code, k, y.device).data_ptr(), k, norm_every, qmax, cid, S,
                sp.data_ptr(), pm.data_ptr(), stream,
            )
        else:
            rc = _lib().pbvd_acs_forward(
                y.data_ptr(), _DTYPE_CODE[y.dtype], T, R, B, code.v, labels.data_ptr(),
                norm_every, qmax, radix, cid, S, sp.data_ptr(), pm.data_ptr(), stream,
            )
    if rc:
        name = "pbvd_acs_forward_matrix" if impl == "matrix" else "pbvd_acs_forward"
        raise RuntimeError(f"{name} launch failed (error {rc})")
    if impl == "matrix":
        matrix_launches += 1
        matrix_table_launches += not cid
    else:
        launches += 1
        table_launches += not cid
    return sp, pm
