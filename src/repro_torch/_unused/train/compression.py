"""Gradient compression with error feedback: int8 block quantization.

The counterpart of ``repro._unused.train.compression``, bit for bit: blocks
of 256 elements of the flattened leaf share a float32 scale max|x|/127
(at least 1e-12); values round half to even and clip to ±127. Leaves under
256 elements pass through unchanged. ``compress_decompress_tree`` is the
quantize→dequantize round trip, the wire format simulated where the
reference applies it: on the whole gradient of each leaf, after the
single-device step's backward and, over a mesh, after the data shards'
gradients are summed (``train_step.make_mesh_train_step``; one process
moves no bytes between shards, so nothing is sent in int8);
``ef_compress`` adds the residual back into the next gradient (error
feedback). Trees are dicts of tensors.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

__all__ = ["BLOCK", "quantize_int8", "dequantize_int8", "compress_decompress_tree",
           "ErrorFeedbackState", "ef_init", "ef_compress"]

BLOCK = 256  # quantization block (last-dim groups share a scale)


def quantize_int8(g: torch.Tensor):
    """Per-block symmetric int8 quantization. Returns (q (n_blocks, 256)
    int8, scales (n_blocks, 1) float32)."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK).float()
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    return (q.float() * scale).reshape(-1)[:n].reshape(shape).to(dtype)


def _roundtrip(g: torch.Tensor) -> torch.Tensor:
    if g.numel() < BLOCK:  # tiny leaves (norm scales): not worth compressing
        return g
    q, s = quantize_int8(g)
    return dequantize_int8(q, s, g.shape, g.dtype)


def compress_decompress_tree(grads: Mapping[str, torch.Tensor]) -> dict:
    """Quantize→dequantize every gradient leaf (wire-format simulation)."""
    return {k: _roundtrip(g) for k, g in grads.items()}


class ErrorFeedbackState(NamedTuple):
    residual: dict  # same keys as grads, float32


def ef_init(grads_like: Mapping[str, torch.Tensor]) -> ErrorFeedbackState:
    return ErrorFeedbackState({k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                               for k, g in grads_like.items()})


def ef_compress(grads: Mapping[str, torch.Tensor], state: ErrorFeedbackState):
    """Error-feedback compression: g' = Q(g + r); r' = (g + r) - g'."""
    new_g, new_r = {}, {}
    for k, g in grads.items():
        corrected = g.float() + state.residual[k]
        q = _roundtrip(corrected)
        new_g[k], new_r[k] = q.to(g.dtype), corrected - q
    return new_g, ErrorFeedbackState(new_r)
