"""Convolutional encoder for (R, 1, K) codes — numpy reference + torch version.

The counterpart of ``repro.core.encoder``. ``encode_np`` is the per-bit
oracle; :func:`encode` is the vectorized torch encoder that makes long test
streams on the device (its loops run over the v memory taps and the R
outputs, never over time).
"""

from __future__ import annotations

import numpy as np
import torch

from .trellis import ConvCode

__all__ = ["encode", "encode_np", "encoder_state", "terminate"]


def terminate(bits: np.ndarray, code: ConvCode) -> np.ndarray:
    """Append K-1 zero flush bits so the encoder returns to state 0."""
    return np.concatenate([np.asarray(bits, dtype=np.int64), np.zeros(code.v, dtype=np.int64)])


def encode_np(bits: np.ndarray, code: ConvCode, init_state: int = 0) -> np.ndarray:
    """Encode a bit sequence. Returns (len(bits), R) output bits.

    Stage t consumes input bit ``bits[t]`` at state ``s_t`` and emits
    ``c(s_t, bits[t])``; ``s_{t+1} = (bits[t] << (v-1)) | (s_t >> 1)``.
    """
    bits = np.asarray(bits, dtype=np.int64)
    out = np.zeros((len(bits), code.R), dtype=np.int64)
    s = int(init_state)
    for t, x in enumerate(bits):
        out[t] = code.output_bits(s, int(x))
        s = (int(x) << (code.v - 1)) | (s >> 1)
    return out


def encoder_state(bits: np.ndarray, code: ConvCode, init_state: int = 0) -> int:
    """Encoder state after consuming ``bits`` from ``init_state``.

    The shift register holds the last ``v`` input bits, so only
    ``bits[-v:]`` can influence the result.
    """
    bits = np.asarray(bits, dtype=np.int64)
    if len(bits) > code.v:
        bits = bits[-code.v :]
    s = int(init_state)
    for x in bits:
        s = (int(x) << (code.v - 1)) | (s >> 1)
    return s


def encode(bits: torch.Tensor, code: ConvCode, init_state: int = 0) -> torch.Tensor:
    """Vectorized encoder. bits: (..., T) integer → (..., T, R) int32 output bits.

    The state before stage t holds the inputs t-1 … t-v in bits v-1 … 0, so
    output r is the input tap times ``bits[t]`` XOR, for every memory tap
    i = 1 … v set in polynomial r, ``bits[t-i]``; inputs before stage 0
    come from ``init_state``.
    """
    v = code.v
    bits = bits.to(torch.int32)
    # the v virtual inputs before stage 0, oldest first: bit 0 … v-1 of init_state
    pre = torch.tensor([(init_state >> i) & 1 for i in range(v)], dtype=torch.int32,
                       device=bits.device)
    pre = pre.expand(*bits.shape[:-1], v)
    ext = torch.cat([pre, bits], dim=-1)  # ext[..., v + t] = bits[..., t]
    T = bits.shape[-1]
    outs = []
    for r in range(code.R):
        poly = int(code.poly_ints[r])
        acc = bits * ((poly >> v) & 1)
        for i in range(1, v + 1):
            if (poly >> (v - i)) & 1:  # tap on state bit v-i, i.e. input t-i
                acc = acc ^ ext[..., v - i : v - i + T]
        outs.append(acc)
    return torch.stack(outs, dim=-1)
