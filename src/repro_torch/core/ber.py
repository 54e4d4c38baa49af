"""BER simulation harness (paper Fig. 4 reproduction).

The counterpart of ``repro.core.ber``. Monte-Carlo: random payload →
convolutional encode → puncture (punctured specs) → BPSK+AWGN → (optional
q-bit quantization inside the engine) → PBVD decode → bit error rate. Every
step runs on the engine's device; the encoder is the vectorized
:func:`~repro_torch.core.encoder.encode`.

Randomness comes from one ``torch.Generator`` on the engine's device, in
place of a JAX key: each trial draws its payload, then its noise, from it
(the reference splits its key three ways per trial instead), so the draws
differ from the reference's for the same seed, as those of
:mod:`repro_torch.core.channel` do.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .channel import transmit
from .codespec import CodeSpec
from .encoder import encode
from .engine import DecoderEngine
from .pbvd import PBVDConfig

__all__ = ["draw_trial", "hard_decision_ber", "simulate_ber", "uncoded_ber"]


def uncoded_ber(ebn0_db: float) -> float:
    """Theoretical uncoded BPSK BER: Q(sqrt(2 Eb/N0))."""
    ebn0 = 10.0 ** (ebn0_db / 10.0)
    return 0.5 * math.erfc(math.sqrt(ebn0))


def draw_trial(generator: torch.Generator, ebn0_db: float, spec: CodeSpec, n_bits: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """One trial's channel: (payload (n_bits,) int32, received symbols).

    The payload is Bernoulli(1/2) from ``generator``; ``v`` zero flush bits
    end the stream so that it is self-contained. A punctured spec's stream
    is punctured before the channel, so Eb/N0 uses the effective rate, and
    the symbols are then 1-D; otherwise they are (n_bits + v, R).
    """
    code = spec.code
    bits = torch.empty(n_bits, device=device).bernoulli_(0.5, generator=generator)
    bits = bits.to(torch.int32)
    coded = encode(torch.cat([bits, bits.new_zeros(code.v)]), code)  # (T, R)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return bits, transmit(generator, tx, ebn0_db, spec.rate)


def _ber(generator, ebn0_db, cfg: PBVDConfig, n_bits: int, n_trials: int, device, hard: bool):
    engine = DecoderEngine(cfg, device=device)
    v = cfg.code.v
    errors = 0
    for _ in range(n_trials):
        bits, y = draw_trial(generator, ebn0_db, engine.spec, n_bits, engine.device)
        if hard:
            y = torch.sign(y)
        dec = engine.decode(y, n_bits + v)[:n_bits]
        errors += int((dec != bits).sum())  # summed on the device, read once per trial
    return errors / (n_bits * n_trials)


def simulate_ber(
    generator: torch.Generator,
    ebn0_db: float,
    cfg: PBVDConfig,
    *,
    n_bits: int = 1 << 15,
    n_trials: int = 1,
    device=None,
) -> float:
    """Monte-Carlo BER of the PBVD decoder at the given Eb/N0.

    ``device`` is the engine's (``None``: ``"cuda"``); ``generator`` must
    live there. Punctured specs are exercised end to end: the coded stream
    is punctured before the channel and the engine depunctures with
    BM-neutral zeros on receive. The decode length is ``n_bits + v`` (the
    flush bits), of which the first ``n_bits`` are compared.
    """
    return _ber(generator, ebn0_db, cfg, n_bits, n_trials, device, hard=False)


def hard_decision_ber(
    generator: torch.Generator,
    ebn0_db: float,
    cfg: PBVDConfig,
    *,
    n_bits: int = 1 << 15,
    n_trials: int = 1,
    device=None,
) -> float:
    """The hard-decision (sign-only) Viterbi BER: the upper curve of Fig. 4.

    As :func:`simulate_ber` with ``cfg.q`` set to ``None`` and the received
    symbols replaced by their signs before the decode.
    """
    cfg = dataclasses.replace(cfg, q=None)
    return _ber(generator, ebn0_db, cfg, n_bits, n_trials, device, hard=True)
