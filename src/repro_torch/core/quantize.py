"""q-bit fixed-point quantization and the metric budget (paper §IV-C).

The port's counterpart of ``repro.core.quantize``: soft symbols are
quantized to q-bit signed integers (int8 for q ≤ 8) before framing, so the
forward ACS kernel reads one byte per symbol. The packing helpers are the
paper's storage schemes: ⌊32/q⌋ q-bit symbols per int32 word and eight
decoded bits per byte. The saturation-budget helpers are copied as they
are; they are plain integer arithmetic on the code.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "quantize_soft",
    "dequantize_soft",
    "pack_words",
    "unpack_words",
    "pack_bits",
    "unpack_bits",
    "u1_bytes",
    "u2_bytes",
    "pm_spread_bound",
    "max_symbol_bits",
    "metric_dtype_max",
    "metric_mode_qmax",
    "norm_interval",
]


def quantize_soft(y: torch.Tensor, q: int = 8, scale: float | None = None) -> torch.Tensor:
    """Quantize soft symbols to q-bit signed fixed point, stored in int8/int16.

    ``scale`` defaults to mapping |y| = 4σ-ish dynamic range; for unit-energy
    BPSK ±1 with noise, scale = (2^(q-1)-1) / 4.0 keeps clipping negligible.

    Clipping is SYMMETRIC at ±(2^(q-1)-1): the folded branch-metric path
    negates quantized symbols, and the two's-complement minimum (-2^(q-1))
    has no negation in q bits. Rounding is half-to-even (``torch.round``),
    as ``jnp.round`` is. Non-finite inputs are refused before anything is
    computed.
    """
    if q < 2 or q > 16:
        raise ValueError("q must be in [2, 16]")
    from repro_torch.launch.faults import check_finite_symbols

    check_finite_symbols(y, "quantize_soft")
    qmax = (1 << (q - 1)) - 1
    if scale is None:
        scale = qmax / 4.0
    z = torch.clamp(torch.round(y * scale), -qmax, qmax)
    return z.to(torch.int8 if q <= 8 else torch.int16)


def dequantize_soft(z: torch.Tensor, q: int = 8, scale: float | None = None) -> torch.Tensor:
    qmax = (1 << (q - 1)) - 1
    if scale is None:
        scale = qmax / 4.0
    return z.to(torch.float32) / scale


def pack_words(z: torch.Tensor, q: int = 8) -> torch.Tensor:
    """Pack q-bit values along the last axis into int32 words (⌊32/q⌋ per word).

    A last-dim length that is not a multiple of ⌊32/q⌋ is zero-padded into the
    final word; ``unpack_words(..., per_axis_len=n)`` trims the pad again.
    Where ⌊32/q⌋·q = 32 the last value lands on bit 31, the int32 sign bit:
    the words are summed in int64 and wrapped to int32 explicitly.
    """
    per = 32 // q
    n = z.shape[-1]
    if n % per:
        z = F.pad(z, (0, (-n) % per))
    zi = z.to(torch.int64) & ((1 << q) - 1)
    zi = zi.reshape(*z.shape[:-1], z.shape[-1] // per, per)
    shifts = torch.arange(per, dtype=torch.int64, device=z.device) * q
    w = (zi << shifts).sum(dim=-1)  # disjoint bit ranges: the sum is the OR
    return (w - ((w >> 31) << 32)).to(torch.int32)


def unpack_words(w: torch.Tensor, q: int = 8, per_axis_len: int | None = None) -> torch.Tensor:
    """Inverse of pack_words; returns sign-extended int32 values."""
    per = 32 // q
    shifts = torch.arange(per, dtype=torch.int64, device=w.device) * q
    vals = (w.to(torch.int64)[..., None] >> shifts) & ((1 << q) - 1)
    sign_bit = 1 << (q - 1)
    vals = torch.where(vals >= sign_bit, vals - (1 << q), vals)
    out = vals.reshape(*w.shape[:-1], w.shape[-1] * per)
    if per_axis_len is not None:
        out = out[..., :per_axis_len]
    return out.to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack bits (..., T) with T % 8 == 0 into uint8 bytes (..., T/8). LSB-first."""
    t = bits.shape[-1]
    if t % 8:
        raise ValueError(f"bit length {t} not a multiple of 8")
    b = bits.to(torch.uint8).reshape(*bits.shape[:-1], t // 8, 8)
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.uint8, device=bits.device)
    return (b * weights).sum(dim=-1).to(torch.uint8)


def unpack_bits(bytes_: torch.Tensor, n_bits: int | None = None) -> torch.Tensor:
    """Inverse of pack_bits: (..., nb) uint8 → (..., 8·nb) int32 bits, trimmed
    to ``n_bits``."""
    shifts = torch.arange(8, dtype=torch.uint8, device=bytes_.device)
    bits = (bytes_[..., None] >> shifts) & 1
    out = bits.reshape(*bytes_.shape[:-1], bytes_.shape[-1] * 8).to(torch.int32)
    if n_bits is not None:
        out = out[..., :n_bits]
    return out


def u1_bytes(R: int, q: int | None) -> float:
    """Bytes per input symbol (paper's U₁). q=None → float32 unpacked."""
    if q is None:
        return 4.0 * R
    return 4.0 * R / (32 // q)


def u2_bytes(packed: bool) -> float:
    """Bytes per decoded bit (paper's U₂)."""
    return 1.0 / 8.0 if packed else 4.0


# ---------------------------------------------------------------------------
# Saturation budget for the narrow (int16/int8) path-metric pipeline
# ---------------------------------------------------------------------------
def pm_spread_bound(code, qmax: int, interval: int = 1) -> int:
    """Worst-case transient path-metric magnitude under min-subtract
    normalization applied every ``interval`` stages:

        max |PM| ≤ (2·v + interval) · R · qmax

    (the classical merge bound on the spread, plus the drift of the
    per-lane minimum between normalizations).
    """
    return (2 * code.v + interval) * code.R * qmax


def max_symbol_bits(code, pm_dtype_max: int, q_cap: int = 8) -> int:
    """Largest quantizer width q ≤ ``q_cap`` whose worst case fits the
    metric dtype at the tightest cadence (at least 2 bits, else raise)."""
    for q in range(q_cap, 1, -1):
        if pm_spread_bound(code, (1 << (q - 1)) - 1) <= pm_dtype_max:
            return q
    raise ValueError(
        f"no quantizer width ≥ 2 bits fits pm dtype max {pm_dtype_max} "
        f"for K={code.K}, R={code.R}"
    )


def metric_dtype_max(metric_mode: str) -> int:
    """Path-metric dtype max of a NARROW metric mode (single source of truth)."""
    try:
        return {"i16": 32767, "i8": 127}[metric_mode]
    except KeyError:
        raise ValueError(
            f"metric_mode {metric_mode!r} has no narrow metric dtype "
            f"(expected 'i16' or 'i8')"
        ) from None


def metric_mode_qmax(code, metric_mode: str) -> int:
    """The symbol bound a narrow metric mode assumes of its integer inputs."""
    return (1 << (max_symbol_bits(code, metric_dtype_max(metric_mode)) - 1)) - 1


def norm_interval(
    code, metric_mode: str, acs_radix: int = 2, stages_per_step: int | None = None
) -> int:
    """Static min-subtract cadence (ACS *steps*) of a narrow metric mode.

    ``"f32"`` never normalizes (0). A narrow mode normalizes every k-th step
    with the largest k that keeps ``pm_spread_bound(code, qmax,
    k·stages_per_step) ≤ dtype_max``; a configuration whose budget cannot
    fit even k=1 raises ``ValueError`` at config time.
    """
    if metric_mode == "f32":
        return 0  # no normalization
    origin = f"acs_k={stages_per_step}"
    if stages_per_step is None:
        if acs_radix not in (2, 4):
            raise ValueError(f"acs_radix must be 2 or 4, got {acs_radix}")
        origin = f"acs_radix={acs_radix}"
        stages_per_step = 1 if acs_radix == 2 else 2
    if not isinstance(stages_per_step, int) or stages_per_step < 1:
        raise ValueError(f"stages_per_step must be a positive int, got {stages_per_step!r}")
    dtype_max = metric_dtype_max(metric_mode)
    qmax = metric_mode_qmax(code, metric_mode)
    if pm_spread_bound(code, qmax, stages_per_step) > dtype_max:
        raise ValueError(
            f"metric_mode={metric_mode!r} cannot accumulate "
            f"{stages_per_step} unnormalized trellis stage(s) per ACS step "
            f"({origin}) for K={code.K}, R={code.R}: even the tightest "
            f"normalization cadence has worst-case path metric "
            f"{pm_spread_bound(code, qmax, stages_per_step)} "
            f"> dtype max {dtype_max}"
        )
    return max(1, (dtype_max // (code.R * qmax) - 2 * code.v) // stages_per_step)
