"""BPSK modulation + AWGN channel, matching the paper's Fig. 4 setup.

The counterpart of ``repro.core.channel``; noise comes from a
``torch.Generator`` (on the symbols' device) in place of a JAX key, so the
draws differ from the reference's for the same seed.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["bpsk", "awgn", "ebn0_to_sigma", "transmit"]


def bpsk(bits: torch.Tensor) -> torch.Tensor:
    """Map bit b ∈ {0,1} → symbol s ∈ {+1,-1} (0 → +1)."""
    return 1.0 - 2.0 * bits.to(torch.float32)


def ebn0_to_sigma(ebn0_db: float, rate: float) -> float:
    """Noise std for unit-energy BPSK at the given Eb/N0 (dB) and code rate.

    Es/N0 = rate * Eb/N0;  sigma^2 = 1 / (2 * Es/N0).
    """
    esn0 = rate * 10.0 ** (ebn0_db / 10.0)
    return float(np.sqrt(1.0 / (2.0 * esn0)))


def awgn(generator: torch.Generator, symbols: torch.Tensor, sigma: float) -> torch.Tensor:
    noise = torch.randn(
        symbols.shape, generator=generator, dtype=torch.float32, device=symbols.device
    )
    return symbols + sigma * noise


def transmit(
    generator: torch.Generator, coded_bits: torch.Tensor, ebn0_db: float, rate: float
) -> torch.Tensor:
    """bits (..., T, R) → noisy soft symbols (..., T, R), float32."""
    sigma = ebn0_to_sigma(ebn0_db, rate)
    return awgn(generator, bpsk(coded_bits), sigma)
