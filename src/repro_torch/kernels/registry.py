"""Backend registry for the port's PBVD decode kernels.

The counterpart of ``repro.kernels.registry``. Every backend is a function
with the common contract

    backend(blocks: FramedBlocks, code: ConvCode, *,
            start_policy, metric_mode, tb_mode, tb_chunk, acs_radix,
            acs_impl, acs_k)
        -> (n_decode, B_real) int32 bits

registered under a name via ``@register_backend("name")``. Backends declare
the knob values they implement; the dispatcher and ``PBVDConfig`` reject
any other value eagerly with :func:`knob_error`.

The knob contracts below hold what the port implements: the metric modes
``"f32"``, ``"i16"`` and ``"i8"``, the serial and prefix tracebacks, the
radix-2 and radix-4 butterflies and the k-stage (min,+) matrix ACS.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Protocol

__all__ = [
    "FramedBlocks",
    "DecodeBackend",
    "METRIC_MODES",
    "TB_MODES",
    "ACS_RADIX",
    "ACS_IMPL",
    "DEFAULT_ACS_K",
    "register_backend",
    "get_backend",
    "available_backends",
    "backend_start_policies",
    "backend_metric_modes",
    "backend_tb_modes",
    "backend_tb_chunk_sensitive",
    "backend_acs_radix",
    "backend_acs_impl",
    "backend_preferred_tb_mode",
    "resolve_tb_mode",
    "knob_error",
    "backend_limits",
    "check_code_limits",
]


METRIC_MODES: dict[str, dict[str, Any]] = {
    "f32": dict(
        pm_dtype="float32/int32",
        symbols="float32, or any pre-quantized int (exact int32 accumulation)",
        normalization="none (unbounded accumulation)",
        saturation_budget="int32 headroom: 2^31 / (R·2^q) stages per block",
    ),
    "i16": dict(
        pm_dtype="int16",
        symbols="int8 (q ≤ 8; widest q with the k=1 budget ≤ 32767)",
        normalization="min-subtract every norm_interval(code, 'i16') stages "
        "(per lane; ~100+ for the registered codes)",
        saturation_budget="(2·v+k)·R·qmax ≤ 32767 — hard-decision bit-exact "
        "to f32 on the same symbols",
    ),
    "i8": dict(
        pm_dtype="int8",
        symbols="coarse int (widest q with the k=1 budget ≤ 127; q=3 for "
        "the registered codes)",
        normalization="min-subtract every norm_interval(code, 'i8') stages "
        "(per lane; ~8-9 for the registered codes)",
        saturation_budget="(2·v+k)·R·qmax ≤ 127 — exact vs f32 on the same "
        "coarse symbols; vs q=8 the difference is the quantizer's (≈0.2–0.3 dB "
        "at 3-bit soft decisions)",
    ),
}

# Both traceback modes are bit-exact for every survivor history; the choice
# trades the walk's dependent chain against work and scratch. ``tb_chunk``
# sizes the prefix chunks; a backend registered with
# ``tb_chunk_sensitive=False`` (``"ref"``'s full-depth scan) ignores it.
TB_MODES: dict[str, dict[str, Any]] = {
    "serial": dict(
        serial_steps="T - decode_start (early exit below the decode region)",
        scratch="none beyond the survivor history",
        when="the paper's walk; what tb_mode='auto' resolves to on every backend",
    ),
    "prefix": dict(
        serial_steps="ceil(T/tb_chunk) composed-map walk",
        scratch="composed maps (n_active·N·4 B per block) + entry states + "
        "(fused) the decode window's bits",
        when="the walk's O(T) chain becomes O(T/C), with the composition and "
        "the expansion parallel over chunks × states",
    ),
}

ACS_RADIX: dict[int, dict[str, Any]] = {
    2: dict(
        serial_steps="T butterfly stages",
        metrics_per_step="2^(R-1) folded branch metrics",
        when="the default: tiny codes (K < 3), narrow modes whose budget "
        "cannot absorb two unnormalized stages",
    ),
    4: dict(
        serial_steps="ceil(T/2) stage-fused steps (+1 radix-2 step, odd T)",
        metrics_per_step="2^(2R-1) folded combined two-stage metrics",
        when="halves the forward serial chain and amortizes normalization/"
        "emission over two bits; the decoded bits equal radix 2's",
    ),
}

ACS_IMPL: dict[str, dict[str, Any]] = {
    "butterfly": dict(
        serial_steps="T compare-select steps",
        metrics_per_step="2^(R-1) folded branch metrics",
        when="the paper's formulation",
    ),
    "matrix": dict(
        serial_steps="T // acs_k (min,+) steps + T mod acs_k radix-2 stages",
        metrics_per_step="2^(kR-1) folded combined k-stage metrics",
        when="a k-fold shorter forward chain; integer symbols only (float "
        "lowers to the radix-2 butterfly); 1 <= k <= v and k·R <= 8, and the "
        "narrow modes' budget must absorb k unnormalized stages",
    ),
}

#: matrix-ACS fusion depth unless the caller says otherwise
DEFAULT_ACS_K = 2


def knob_error(backend: str, knob: str, value: Any, allowed) -> ValueError:
    """The uniform eager knob-validation error (the reference's shape)."""
    return ValueError(
        f"backend {backend!r} does not support {knob}={value!r}; "
        f"supported {knob} values: {tuple(allowed)}"
    )


@dataclasses.dataclass(frozen=True)
class FramedBlocks:
    """The framed parallel-block batch every backend consumes.

    ``y``: (T, R, B) soft symbols (float32, or int8/int16 for the exact
    quantized path), framed [truncation M | decode D | traceback L].
    ``decode_start``/``n_decode``: the decode region within the T stages.
    ``frame_counts``: when the lane axis packs several frames (independent
    streams), the number of real blocks each frame contributed, in lane
    order; ``None`` means a single frame spanning every lane. Lanes beyond
    ``sum(frame_counts)`` are padding and must be trimmed by the backend.
    """

    y: Any  # torch.Tensor
    decode_start: int
    n_decode: int
    frame_counts: tuple[int, ...] | None = None

    def __post_init__(self):
        if self.frame_counts is not None:
            if any(k <= 0 for k in self.frame_counts):
                raise ValueError(
                    f"frame_counts must be positive, got {self.frame_counts}"
                )
            if sum(self.frame_counts) > self.y.shape[2]:
                raise ValueError(
                    f"frame_counts {self.frame_counts} sum to "
                    f"{sum(self.frame_counts)} > lane axis {self.y.shape[2]}"
                )

    @property
    def n_real_blocks(self) -> int:
        """Real (non-pad) lanes; what every backend must return."""
        if self.frame_counts is None:
            return int(self.y.shape[2])
        return sum(self.frame_counts)


class DecodeBackend(Protocol):
    def __call__(
        self,
        blocks: FramedBlocks,
        code: Any,
        *,
        start_policy: str,
        metric_mode: str,
        tb_mode: str,
        tb_chunk: int,
        acs_radix: int,
        acs_impl: str,
        acs_k: int,
    ) -> Any: ...


_BACKENDS: dict[str, DecodeBackend] = {}


def register_backend(
    name: str,
    *,
    start_policies: tuple[str, ...] = ("zero", "argmin"),
    metric_modes: tuple[str, ...] = ("f32",),
    tb_modes: tuple[str, ...] = ("serial",),
    tb_chunk_sensitive: bool = True,
    preferred_tb_mode: str = "serial",
    acs_radix: tuple[int, ...] = (2,),
    acs_impl: tuple[str, ...] = ("butterfly",),
    max_rank: int | None = None,
    max_matrix_k: int | None = None,
    max_states: int | None = None,
) -> Callable[[DecodeBackend], DecodeBackend]:
    """Decorator: register a decode backend under ``name``.

    Each keyword declares the values of one knob the backend implements; the
    declared values must exist in the matching contract above.
    ``preferred_tb_mode`` is what ``tb_mode="auto"`` resolves to;
    ``tb_chunk_sensitive=False`` declares that the backend's prefix
    traceback ignores ``tb_chunk``; nothing in the port branches on it (it
    has no compile cache to key, as the reference's jit has), and it is
    kept for parity with the reference's registry. ``max_rank``,
    ``max_matrix_k`` and ``max_states`` declare the size limits of the
    backend's kernels (the code rank R, ``acs_k`` under
    ``acs_impl="matrix"``, the number of trellis states); ``None`` means
    the reference's own limits only. :func:`check_code_limits` refuses the
    rest.
    """
    for knob, declared, contract in (
        ("metric modes", metric_modes, METRIC_MODES),
        ("tb modes", tb_modes, TB_MODES),
        ("acs radixes", acs_radix, ACS_RADIX),
        ("acs impls", acs_impl, ACS_IMPL),
    ):
        unknown = set(declared) - contract.keys()
        if unknown:
            raise ValueError(f"unknown {knob} {sorted(unknown)}")
    if preferred_tb_mode not in tb_modes:
        raise ValueError(
            f"preferred_tb_mode {preferred_tb_mode!r} not in tb_modes {tb_modes}"
        )

    def deco(fn: DecodeBackend) -> DecodeBackend:
        if name in _BACKENDS:
            raise ValueError(f"backend {name!r} already registered")
        _BACKENDS[name] = fn
        fn.backend_name = name  # type: ignore[attr-defined]
        fn.start_policies = tuple(start_policies)  # type: ignore[attr-defined]
        fn.metric_modes = tuple(metric_modes)  # type: ignore[attr-defined]
        fn.tb_modes = tuple(tb_modes)  # type: ignore[attr-defined]
        fn.tb_chunk_sensitive = bool(tb_chunk_sensitive)  # type: ignore[attr-defined]
        fn.preferred_tb_mode = str(preferred_tb_mode)  # type: ignore[attr-defined]
        fn.acs_radix = tuple(acs_radix)  # type: ignore[attr-defined]
        fn.acs_impl = tuple(acs_impl)  # type: ignore[attr-defined]
        fn.limits = dict(rank=max_rank, matrix_k=max_matrix_k,  # type: ignore[attr-defined]
                         states=max_states)
        return fn

    return deco


def get_backend(name: str) -> DecodeBackend:
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown decode backend {name!r}; available: {available_backends()}"
        ) from None


def backend_start_policies(name: str) -> tuple[str, ...]:
    """Start policies the named backend supports."""
    return get_backend(name).start_policies


def backend_metric_modes(name: str) -> tuple[str, ...]:
    """Metric modes the named backend supports (see :data:`METRIC_MODES`)."""
    return get_backend(name).metric_modes


def backend_tb_modes(name: str) -> tuple[str, ...]:
    """Traceback modes the named backend supports (see :data:`TB_MODES`)."""
    return get_backend(name).tb_modes


def backend_tb_chunk_sensitive(name: str) -> bool:
    """Whether the named backend's prefix traceback depends on ``tb_chunk``."""
    return get_backend(name).tb_chunk_sensitive


def backend_acs_radix(name: str) -> tuple[int, ...]:
    """Forward-ACS radixes the named backend supports (see :data:`ACS_RADIX`)."""
    return get_backend(name).acs_radix


def backend_acs_impl(name: str) -> tuple[str, ...]:
    """Forward-ACS formulations the named backend supports (see :data:`ACS_IMPL`)."""
    return get_backend(name).acs_impl


def backend_preferred_tb_mode(name: str) -> str:
    """The named backend's declared traceback mode for ``tb_mode="auto"``."""
    return get_backend(name).preferred_tb_mode


def resolve_tb_mode(name: str, tb_mode: str) -> str:
    """Resolve ``"auto"`` to the backend's preferred mode; pass others through."""
    return backend_preferred_tb_mode(name) if tb_mode == "auto" else tb_mode


def backend_limits(name: str) -> dict[str, int | None]:
    """The named backend's kernel size limits: ``rank`` (code R),
    ``matrix_k`` (``acs_k`` under matrix) and ``states`` (N); ``None``
    where only the reference's own limits hold."""
    return dict(get_backend(name).limits)


def check_code_limits(name: str, code: Any, acs_impl: str, acs_k: int) -> None:
    """Raise ``ValueError`` naming the backend, the knob and the limit when
    ``code`` (or ``acs_k`` under ``acs_impl="matrix"``) exceeds what the
    named backend's kernels take. Called after the reference's own checks,
    so that what both refuse keeps the reference's message."""
    limits = get_backend(name).limits
    for knob, value, limit in (
        ("code rank R", code.R, limits["rank"]),
        ("acs_k", acs_k if acs_impl == "matrix" else None, limits["matrix_k"]),
        ("n_states", code.n_states, limits["states"]),
    ):
        if value is not None and limit is not None and value > limit:
            raise ValueError(
                f"backend {name!r} does not support {knob}={value}: its kernels take "
                f"{knob} <= {limit}"
            )


def available_backends() -> list[str]:
    return sorted(_BACKENDS)
