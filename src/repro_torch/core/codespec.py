"""Code specifications: convolutional codes + puncturing, as first-class configs.

The port's copy of ``repro.core.codespec``: the same specs and tables, with
depuncturing written in torch.

A ``CodeSpec`` extends a mother :class:`~repro_torch.core.trellis.ConvCode` with an
optional puncturing matrix, turning "new code / new rate" into a table entry
instead of a new decode pipeline (DESIGN.md §4).

Puncturing convention (standard DVB/3GPP form): ``puncture[r][t]`` is 1 if
output stream ``r`` of stage ``t mod period`` is transmitted. The transmitted
stream is read stage-major (for each stage, streams ``0..R-1`` in order,
skipping punctured slots). On receive, punctured positions are refilled with
**zero** soft symbols — zeros are BM-neutral for the correlation metric
``BM(c) = Σ_r y_r (2 c_r - 1)`` (they add the same constant 0 to every
codeword's metric), so depunctured streams flow through the existing framing
and kernels unchanged.

The registry at the bottom exposes named specs (``get_code_spec``), including
the paper's CCSDS (2,1,7) mother code with the standard rate-2/3, 3/4 and 5/6
punctured variants, the K=9 IS-95/NASA-style code, and the LTE-style
rate-1/3 K=7 code.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np
import torch

from .trellis import CCSDS_27, ConvCode

__all__ = [
    "CodeSpec",
    "PUNCTURE_PATTERNS",
    "IS95_29",
    "LTE_37",
    "register_code_spec",
    "get_code_spec",
    "available_code_specs",
]


# Standard puncturing patterns for a rate-1/2 mother code (rows = streams,
# columns = stage within period). DVB-S convention.
PUNCTURE_PATTERNS: dict[str, tuple[tuple[int, ...], ...]] = {
    "2/3": ((1, 0), (1, 1)),
    "3/4": ((1, 0, 1), (1, 1, 0)),
    "5/6": ((1, 0, 1, 0, 1), (1, 1, 0, 1, 0)),
}


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """A decodable code: mother ConvCode + optional puncturing matrix.

    Hashable/frozen so it can key per-code caches alongside the ConvCode it
    wraps.
    """

    name: str
    code: ConvCode
    puncture: tuple[tuple[int, ...], ...] | None = None

    def __post_init__(self):
        if self.puncture is not None:
            if len(self.puncture) != self.code.R:
                raise ValueError(
                    f"puncture matrix has {len(self.puncture)} rows, code has R={self.code.R}"
                )
            periods = {len(row) for row in self.puncture}
            if len(periods) != 1:
                raise ValueError(f"puncture rows must share a period, got {periods}")
            if not all(b in (0, 1) for row in self.puncture for b in row):
                raise ValueError("puncture matrix must be binary")
            if sum(b for row in self.puncture for b in row) == 0:
                raise ValueError("puncture matrix keeps no symbols")

    # ---- shape parameters ---------------------------------------------------------
    @property
    def is_punctured(self) -> bool:
        return self.puncture is not None

    @property
    def period(self) -> int:
        """Puncture period in stages (1 when unpunctured)."""
        return len(self.puncture[0]) if self.puncture is not None else 1

    @cached_property
    def kept_slots_period(self) -> np.ndarray:
        """Flattened slot indices (stage-major, slot = t·R + r) kept per period."""
        R = self.code.R
        if self.puncture is None:
            return np.arange(R, dtype=np.int64)
        return np.array(
            [t * R + r for t in range(self.period) for r in range(R) if self.puncture[r][t]],
            dtype=np.int64,
        )

    @property
    def kept_per_period(self) -> int:
        return len(self.kept_slots_period)

    @property
    def rate(self) -> float:
        """Effective code rate (input bits / transmitted symbols)."""
        return self.period / self.kept_per_period

    # ---- stream transforms ---------------------------------------------------------
    def kept_slot_indices(self, offset: int, n: int) -> np.ndarray:
        """Absolute full-rate slot indices of kept symbols [offset, offset+n).

        Symbol ``k`` of the punctured stream occupies slot
        ``(k // m)·p·R + kept_slots_period[k % m]`` of the full-rate stream
        flattened stage-major (p = period, m = kept per period).
        """
        m = self.kept_per_period
        slots_per_period = self.period * self.code.R
        k = np.arange(offset, offset + n, dtype=np.int64)
        return (k // m) * slots_per_period + self.kept_slots_period[k % m]

    def n_stages_for(self, n_symbols: int) -> int:
        """Full-rate stages spanned by the first ``n_symbols`` punctured symbols."""
        if n_symbols <= 0:
            return 0
        last_slot = int(self.kept_slot_indices(n_symbols - 1, 1)[0])
        return last_slot // self.code.R + 1

    def n_symbols_for(self, n_stages: int) -> int:
        """Punctured symbols transmitted for ``n_stages`` full-rate stages."""
        if self.puncture is None:
            return n_stages * self.code.R
        m = self.kept_per_period
        full, rem = divmod(n_stages, self.period)
        count = full * m
        if rem:
            count += int(np.sum(self.kept_slots_period < rem * self.code.R))
        return count

    def puncture_stream(self, coded):
        """(T, R) coded symbols → (n_kept,) transmitted stream (numpy or torch)."""
        T, R = coded.shape
        if R != self.code.R:
            raise ValueError(f"stream rank {R} != code R {self.code.R}")
        idx = self.kept_slot_indices(0, self.n_symbols_for(T))
        if isinstance(coded, torch.Tensor):
            idx = torch.as_tensor(idx, device=coded.device)
        return coded.reshape(-1)[idx]

    def depuncture_stream(self, y: torch.Tensor, n_stages: int | None = None) -> torch.Tensor:
        """(n,) punctured soft symbols → (n_stages, R) with BM-neutral zeros.

        The scatter indices are static numpy (the reference's), moved to
        ``y``'s device; the data path is one indexed write.
        """
        n = y.shape[0]
        if n_stages is None:
            n_stages = self.n_stages_for(n)
        idx = self.kept_slot_indices(0, n)
        idx = idx[idx < n_stages * self.code.R]
        flat = torch.zeros((n_stages * self.code.R,), dtype=y.dtype, device=y.device)
        flat[torch.as_tensor(idx, device=y.device)] = y[: len(idx)]
        return flat.reshape(n_stages, self.code.R)


# ---------------------------------------------------------------------------
# First-class codes beyond the paper's CCSDS (2,1,7)
# ---------------------------------------------------------------------------
def _from_octal(K: int, *polys_octal: int) -> ConvCode:
    """Build a ConvCode from octal generator polynomials, MSB = input tap."""
    rows = []
    for g in polys_octal:
        rows.append(tuple((g >> (K - 1 - i)) & 1 for i in range(K)))
    return ConvCode(polys=tuple(rows))


# K=9 rate-1/2 code (IS-95 / NASA deep-space family): g = 753, 561 (octal).
IS95_29 = _from_octal(9, 0o753, 0o561)

# K=7 rate-1/3 LTE-style code: g = 133, 171, 165 (octal).
LTE_37 = _from_octal(7, 0o133, 0o171, 0o165)


# ---------------------------------------------------------------------------
# Named registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, CodeSpec] = {}


def register_code_spec(spec: CodeSpec, *, overwrite: bool = False) -> CodeSpec:
    if spec.name in _REGISTRY and not overwrite:
        raise ValueError(f"code spec {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_code_spec(name: str) -> CodeSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown code spec {name!r}; available: {available_code_specs()}"
        ) from None


def available_code_specs() -> list[str]:
    return sorted(_REGISTRY)


def _register_family(base_name: str, code: ConvCode) -> None:
    register_code_spec(CodeSpec(name=base_name, code=code))
    if code.R == 2:  # standard punctured rates are defined from a 1/2 mother
        for rate, pattern in PUNCTURE_PATTERNS.items():
            register_code_spec(
                CodeSpec(name=f"{base_name}-{rate}", code=code, puncture=pattern)
            )


_register_family("ccsds", CCSDS_27)
_register_family("is95-k9", IS95_29)
register_code_spec(CodeSpec(name="lte-1/3", code=LTE_37))
