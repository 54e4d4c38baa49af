"""The engine-boundary part of the failure taxonomy (``repro.launch.faults``).

Only what the decode path, the streaming sessions and the session pool
raise is here: the root :class:`DecodeError`, the per-stream
:class:`StreamError` (the pool's quarantine records), the symbol validation
error :class:`SymbolError` and the non-finite symbol check, which takes
tensors and the sessions' host numpy chunks alike. The rest of the serving
taxonomy (dispatch, capacity, retry and fault injection) comes with the port
of the async service.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DecodeError",
    "StreamError",
    "SymbolError",
    "nonfinite_error",
    "check_finite_symbols",
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
