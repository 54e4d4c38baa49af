"""Failure taxonomy + deterministic fault injection for the serving stack.

The counterpart of ``repro.launch.faults``. PBVD blocks are independent, so
a poisoned stream can be carved out of a coalesced launch and the survivors
relaunched bit-exact; this module names the failures that make that
possible:

* :class:`DecodeError` — root of the serving failure hierarchy.

  * :class:`StreamError` — the *stream* is at fault (non-finite soft
    symbols, shape-invalid chunks, a lane-group that reproducibly kills the
    launch); quarantining the stream fixes the batch. :class:`SymbolError`
    (also a ``ValueError``) is the engine-boundary validation error, and
    :class:`IntegrityError` the re-encode sentinel's verdict.
  * :class:`DispatchError` — the *launch* is at fault; retrying is the
    right response. :class:`MeshLost` is device loss with a casualty count.
  * :class:`CapacityError` — the *service* is out of room (admission
    budget or slab pages); :class:`ShedError` is an admission dropped past
    the shed deadline.

:class:`FaultInjector` injects each failure class at the admission / slab /
dispatch / mesh / stream-poison / decode-corrupt boundaries under a seeded
schedule, and :class:`RetryPolicy` bounds the retry/backoff loop around
dispatch. Both are host-side bookkeeping, reproducible under fake clocks,
and draw the same random numbers as the reference for the same seed.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from collections.abc import Iterable, Mapping

import numpy as np
import torch

__all__ = [
    "DecodeError",
    "StreamError",
    "SymbolError",
    "DispatchError",
    "IntegrityError",
    "MeshLost",
    "CapacityError",
    "ShedError",
    "nonfinite_error",
    "check_finite_symbols",
    "RetryPolicy",
    "FaultInjector",
    "FAULT_SITES",
]


class DecodeError(RuntimeError):
    """Root of the serving failure taxonomy."""


class StreamError(DecodeError):
    """The stream is at fault; quarantining it heals the batch.

    ``stream`` (optional) names the offending stream for log lines; the
    underlying exception, when one exists, rides along as ``__cause__``.
    """

    def __init__(self, message: str, *, stream: object | None = None):
        super().__init__(message)
        self.stream = stream


class SymbolError(StreamError, ValueError):
    """Shape- or value-invalid symbols at the engine boundary.

    Also a ``ValueError``, as in the reference, so callers that catch the
    engine's validation errors as ``ValueError`` keep working.
    """

    def __init__(self, message: str, *, stream: object | None = None):
        StreamError.__init__(self, message, stream=stream)


class IntegrityError(StreamError):
    """Delivered bits failed the re-encode integrity screen.

    Raised by :class:`repro_torch.launch.journal.IntegritySentinel`: the
    delivered block, re-encoded with the stream's code, agrees with the
    received hard decisions on fewer symbols than the bound allows — silent
    corruption between the kernel and the delivery queue, not channel
    noise. ``agreement`` is the measured fraction, ``bound`` the threshold.
    """

    def __init__(
        self,
        message: str,
        *,
        stream: object | None = None,
        agreement: float | None = None,
        bound: float | None = None,
    ):
        super().__init__(message, stream=stream)
        self.agreement = agreement
        self.bound = bound


class DispatchError(DecodeError):
    """The launch is at fault; retry."""


class MeshLost(DispatchError):
    """Device loss mid-dispatch; carries the casualty count."""

    def __init__(self, message: str, *, lost_chips: int = 1):
        super().__init__(message)
        self.lost_chips = int(lost_chips)


class CapacityError(DecodeError):
    """The service is out of room; wait, shed, or resize."""


class ShedError(CapacityError):
    """Capacity stayed exhausted past the shed deadline; admission dropped."""


def nonfinite_error(where: str, n_bad: int, n_total: int) -> SymbolError:
    """Uniform engine-boundary rejection for NaN/Inf soft symbols."""
    return SymbolError(
        f"{where} does not accept non-finite soft symbols: {n_bad} of "
        f"{n_total} values are NaN/Inf; supported symbol values: finite "
        f"floats (or pre-quantized integers).  A single non-finite symbol "
        f"corrupts the path metrics of every stream coalesced into the "
        f"same launch, so it is refused at the boundary."
    )


def check_finite_symbols(y, where: str) -> None:
    """Raise :func:`nonfinite_error` if a float symbol array holds NaN/Inf.

    Tensors are checked with ``torch.isfinite`` on their own device (one
    scalar comes back to the host); other array-likes go through numpy.
    Integer arrays (pre-quantized symbols) pass through untouched.
    """
    if isinstance(y, torch.Tensor):
        if not y.is_floating_point():
            return
        n_bad = int((~torch.isfinite(y)).sum())
        n_total = y.numel()
    else:
        arr = np.asarray(y)
        if not np.issubdtype(arr.dtype, np.floating):
            return
        n_bad = int((~np.isfinite(arr)).sum())
        n_total = arr.size
    if n_bad:
        raise nonfinite_error(where, n_bad, n_total)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retry with exponential backoff for dispatch failures.

    ``delay_s(attempt)`` is a pure function of the attempt index, so the
    retry schedule is deterministic under an injected fake clock: the
    service arms ``retry_at = clock() + delay_s(k)`` and refuses to
    re-dispatch until the clock passes it — no sleeping in the dispatch path.
    """

    max_retries: int = 3
    backoff_s: float = 0.002
    multiplier: float = 2.0
    max_backoff_s: float = 0.25

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0.0 or self.max_backoff_s < 0.0:
            raise ValueError("backoff_s and max_backoff_s must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {self.multiplier}")

    def delay_s(self, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-indexed), in seconds."""
        if attempt < 0:
            raise ValueError(f"attempt must be >= 0, got {attempt}")
        return float(min(self.backoff_s * self.multiplier**attempt, self.max_backoff_s))


FAULT_SITES = (
    "admission",
    "slab",
    "dispatch",
    "mesh",
    "stream_poison",
    # new sites append at the END: per-site rng streams are seeded by the
    # site's index in this tuple, so reordering would silently reshuffle
    # every rate-based chaos schedule
    "decode_corrupt",
)


class FaultInjector:
    """Deterministic fault injection at the serving-stack boundaries.

    Two scheduling modes, combinable per site:

    * ``schedule={"dispatch": {2, 9}}`` — fire on exactly the 2nd and 9th
      *consultation* of the ``dispatch`` site (0-indexed), whatever the
      event loop's interleaving;
    * ``rates={"slab": 0.05}`` — fire i.i.d. with probability 0.05 per
      consultation, from a per-site ``np.random.default_rng([seed, site
      index])`` stream (the reference's streams, draw for draw).

    Sites (``FAULT_SITES``): ``"admission"`` (a validation failure poisons
    the sending stream), ``"slab"`` (a synthetic ``SlabExhausted`` on a page
    reservation), ``"dispatch"`` (a transient launch failure, absorbed by
    retry), ``"mesh"`` (device loss, ``MeshLost(lost_chips=...)``),
    ``"stream_poison"`` (the Nth opened stream's symbols kill any launch
    that holds them; isolated by bisection) and ``"decode_corrupt"`` (one
    bit of a freshly delivered block flips after the kernel ran; consulted
    once per stream with a delivery per dispatch, caught only by the
    re-encode sentinel).

    ``counts[site]`` is how often a site was consulted, ``fired[site]`` how
    often it injected.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        schedule: Mapping[str, Iterable[int]] | None = None,
        rates: Mapping[str, float] | None = None,
        mesh_lost_chips: int = 1,
    ):
        self.seed = int(seed)
        self.schedule = {k: frozenset(int(i) for i in v) for k, v in (schedule or {}).items()}
        self.rates = {k: float(v) for k, v in (rates or {}).items()}
        for site in (*self.schedule, *self.rates):
            if site not in FAULT_SITES:
                raise ValueError(
                    f"unknown fault site {site!r}; supported sites: {FAULT_SITES}"
                )
        for site, rate in self.rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], got {rate}")
        self.mesh_lost_chips = int(mesh_lost_chips)
        self.counts: Counter[str] = Counter()
        self.fired: Counter[str] = Counter()
        self._rngs = {
            site: np.random.default_rng([self.seed, i])
            for i, site in enumerate(FAULT_SITES)
        }

    def fire(self, site: str) -> bool:
        """Consult ``site``; True means the caller must inject the fault."""
        if site not in FAULT_SITES:
            raise ValueError(
                f"unknown fault site {site!r}; supported sites: {FAULT_SITES}"
            )
        idx = self.counts[site]
        self.counts[site] += 1
        hit = idx in self.schedule.get(site, ())
        rate = self.rates.get(site, 0.0)
        if not hit and rate > 0.0:
            hit = bool(self._rngs[site].random() < rate)
        if hit:
            self.fired[site] += 1
        return hit
