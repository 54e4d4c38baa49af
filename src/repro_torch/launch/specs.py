"""Meta-tensor input specs for every (architecture × shape) dry-run cell.

The counterpart of ``repro.launch.specs``. Meta tensors take the place of
``jax.ShapeDtypeStruct``: nothing is allocated. The parameters are
``lm.init_params(cfg, device="meta")``, the decode cache ``lm.init_cache``
on meta, the inputs empty meta tensors. The dry-run
(``launch/dryrun.py``) runs the exact train, prefill or decode step the
port executes on them.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeSpec, get_config, list_archs
from repro_torch._unused.models import lm

__all__ = ["Cell", "make_cell", "iter_cells", "SKIPS", "LONG_OK", "ENCODER_CTX", "input_specs"]

ENCODER_CTX = 4096  # enc-dec: encoder context length for decode shapes

# long_500k runs only for sub-quadratic-attention archs (DESIGN.md §7)
LONG_OK = {"mixtral-8x22b", "jamba-v0.1-52b", "rwkv6-3b"}

SKIPS: dict[tuple[str, str], str] = {}
for _a in [
    "seamless-m4t-medium", "qwen2.5-32b", "minitron-8b", "command-r-35b",
    "starcoder2-3b", "pixtral-12b", "deepseek-v2-236b",
]:
    SKIPS[(_a, "long_500k")] = ("full-attention arch: 500k KV cache is the quadratic regime "
                                "this shape excludes")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: ShapeSpec
    kind: str  # train | prefill | decode
    cfg: ModelConfig

    def __str__(self):
        return f"{self.arch}×{self.shape.name}"


def make_cell(arch: str, shape_name: str) -> Cell:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    return Cell(arch=arch, shape=shape, kind=shape.kind, cfg=cfg)


def iter_cells(include_skips: bool = False):
    for arch in list_archs():
        for shape_name in SHAPES:
            if (arch, shape_name) in SKIPS and not include_skips:
                continue
            yield make_cell(arch, shape_name)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device="meta")


def _serving_cast(params: lm.LM) -> lm.LM:
    """Serving checkpoints hold bf16 weights at rest (float32 masters are a
    training-time artifact): every float32 leaf of rank >= 2 becomes bf16,
    which halves every weight read. The rank is the reference's, whose
    layers are stacked on a leading axis: a layer's leaf of rank >= 1 here
    (a norm's scale too)."""
    for prefix, module in params.named_modules():
        stacked = prefix.startswith(("groups.", "encoder."))
        for name, p in module._parameters.items():
            if (p is not None and p.dtype == torch.float32
                    and p.dim() + stacked >= 2):
                module._parameters[name] = torch.nn.Parameter(
                    _meta(p.shape, torch.bfloat16), requires_grad=False)
    return params


def input_specs(cell: Cell) -> dict[str, Any]:
    """``{"params", "batch"}`` (train, prefill) or ``{"params", "tokens",
    "cache", "cache_len"}`` (decode), every tensor on meta. The serving
    kinds hold bf16 weights at rest unless ``REPRO_SERVE_F32=1``. The
    decode cache is laid out as the meshless ``init_cache`` lays it; the
    dry-run lays it over its mesh."""
    cfg, shape = cell.cfg, cell.shape
    B, S = shape.global_batch, shape.seq_len
    specs: dict[str, Any] = {"params": lm.init_params(cfg, device="meta")}
    if cell.kind in ("prefill", "decode") and os.environ.get("REPRO_SERVE_F32") != "1":
        specs["params"] = _serving_cast(specs["params"])

    if cell.kind in ("train", "prefill"):
        batch = {"tokens": _meta((B, S), torch.int32)}
        if cell.kind == "train":
            batch["labels"] = _meta((B, S), torch.int32)
        if cfg.frontend == "vision_patches":
            batch["patch_embeds"] = _meta((B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if cfg.encdec:
            batch["frames"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        specs["batch"] = batch
    else:  # decode: one token against a seq_len cache
        specs["tokens"] = _meta((B, 1), torch.int32)
        cross = ENCODER_CTX if cfg.encdec else 0
        specs["cache"] = lm.init_cache(cfg, B, S, dtype=torch.bfloat16, cross_len=cross,
                                       device="meta")
        specs["cache_len"] = S - 1
    return specs
