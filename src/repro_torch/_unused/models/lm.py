"""Model assembly for decoder-only LMs: parameters, the full-sequence
forward, decode caches and the cached single-token step.

The counterpart of ``repro._unused.models.lm`` without the enc-dec and VLM
variants (ROADMAP A.6.5). The parameters are an :class:`LM` module whose
names follow the reference's pytree: ``embed.table``, ``final_norm.scale``,
``lm_head.w`` (untied models only) and ``groups[gi][r]["l{i}"]``, where the
reference stacks a group's ``repeat`` layers on a leading scan axis and the
port keeps one ``ModuleList`` entry per layer. Logits are the compute-dtype
product cast to float32, over the vocab padded by ``round_vocab``.

The entry points run on the card unless the caller passes a CPU device:
``device=None`` means ``"cuda"``, and without a GPU they raise
``DeviceUnavailableError``. The port runs inference only, under
``torch.no_grad`` (parameters have ``requires_grad=False``).
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import WAITING_SLICES, ModelConfig
from repro_torch.device import resolve_device
from .blocks import block_apply, block_cache_init, block_init
from .layers import Dense, Embed, Norm, cdtype, embed_init, norm_apply, norm_init, pdtype, round_vocab

__all__ = [
    "LM",
    "init_params",
    "apply_train",
    "init_cache",
    "apply_decode",
    "count_params",
    "param_count",
]


class LM(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (untied only) and ``groups``."""

    def __init__(self, embed: Embed, final_norm: Norm, groups: nn.ModuleList,
                 lm_head: Dense | None = None):
        super().__init__()
        self.embed, self.final_norm, self.lm_head, self.groups = embed, final_norm, lm_head, groups


def _check(cfg: ModelConfig) -> None:
    if cfg.encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: enc-dec and modality frontends wait for their slice "
            f"({WAITING_SLICES['encdec']})"
        )


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> LM:
    """Random parameters: dense ``w`` ~ N(0, 1/in_dim), the embedding
    N(0, 0.02²), biases 0 and norms 1, and the Mamba and RWKV leaves by the
    reference's recipes (``ssm.mamba_init``, ``ssm.rwkv_init``), in
    ``param_dtype`` on ``device``.
    ``generator`` (on that device; else one seeded with 0) draws them; on
    the ``meta`` device only the shapes are made."""
    _check(cfg)
    dev = resolve_device(device, user="the LM")
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(gen=gen, device=dev)
    embed = embed_init(cfg, **kw)
    lm_head = None
    if not cfg.tie_embeddings:
        w = torch.empty((cfg.d_model, round_vocab(cfg.vocab)), dtype=pdtype(cfg), device=dev)
        if dev.type != "meta":
            w.normal_(generator=gen).mul_(1.0 / cfg.d_model ** 0.5)
        lm_head = Dense(nn.Parameter(w, requires_grad=False))
    groups = nn.ModuleList(
        nn.ModuleList(
            nn.ModuleDict({f"l{i}": block_init(cfg, desc, **kw) for i, desc in enumerate(pattern)})
            for _ in range(repeat)
        )
        for pattern, repeat in cfg.layer_list
    )
    return LM(embed, norm_init(cfg.d_model, cfg, device=dev), groups, lm_head)


def count_params(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def param_count(cfg: ModelConfig) -> int:
    """What ``count_params`` gives for ``init_params(cfg)``, from the shapes:
    ``n_params_estimate`` plus the leaves the estimate leaves out, namely
    the norms (two per block, one per parallel block, and the final one;
    a LayerNorm holds a bias too; MLA's ``q_norm`` and ``kv_norm``), the QKV
    biases, the rows that pad the vocab to ``round_vocab``, Mamba's
    ``conv_b``, RWKV's ``mu``, ``w0``, ``u``, ``ln_scale`` and ``ln_bias``
    and the channel mix's ``mu``; less the gate LoRA (``rwkv_gate_lora ·
    2d``) that the estimate counts and ``rwkv_init`` does not build."""
    d = cfg.d_model
    per_norm = 2 if cfg.norm_type == "layernorm" else 1
    norms = (cfg.n_layers * (1 if cfg.parallel_block else 2) + 1) * per_norm * d
    biases = cfg.n_layers * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim if cfg.qkv_bias else 0
    pad = (round_vocab(cfg.vocab) - cfg.vocab) * d * (1 if cfg.tie_embeddings else 2)
    extra = 0
    for pattern, repeat in cfg.layer_list:
        for desc in pattern:
            if desc.mixer == "mla":
                extra += repeat * per_norm * (cfg.q_lora_rank + cfg.kv_lora_rank)
            elif desc.mixer == "mamba":
                extra += repeat * cfg.mamba_d_inner
            elif desc.mixer == "rwkv6":  # mu (5, d), w0, u, ln_scale, ln_bias; no gate LoRA
                extra += repeat * (9 * d - 2 * cfg.rwkv_gate_lora * d)
            if desc.ffn == "dense" and cfg.ffn_act == "rwkv_cm":
                extra += repeat * 2 * d  # the channel mix's mu (2, d)
    return cfg.n_params_estimate + norms + biases + pad + extra


def _embed_input(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token embedding → (B, S, d) in the compute dtype (rows are gathered
    before the cast; the cast is elementwise, so the values are the
    reference's)."""
    return params.embed.table[batch["tokens"]].to(cdtype(cfg))


def _run_groups(groups: nn.ModuleList, x, cfg: ModelConfig, *, positions, causal=True):
    for (pattern, _repeat), layers in zip(cfg.layer_list, groups):
        for layer in layers:
            for i, desc in enumerate(pattern):
                x, _ = block_apply(layer[f"l{i}"], x, cfg, desc, positions=positions, causal=causal)
    return x


def _logits(params: LM, x, cfg: ModelConfig) -> torch.Tensor:
    x = norm_apply(params.final_norm, x, cfg)
    if cfg.tie_embeddings:
        w = params.embed.table.to(cdtype(cfg)).T
    else:
        w = params.lm_head.w.to(cdtype(cfg))
    return (x @ w).float()


@torch.no_grad()
def apply_train(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward → logits (B, S, vocab_padded) f32."""
    _check(cfg)
    x = _embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_groups(params.groups, x, cfg, positions=positions, causal=True)
    return _logits(params, x, cfg)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               device=None) -> dict:
    """``{"groups": [[{"l{i}": block cache} per layer] per group]}``."""
    _check(cfg)
    dev = resolve_device(device, user="the LM")
    return {"groups": [
        [{f"l{i}": block_cache_init(cfg, desc, batch, s_max, dtype, device=dev)
          for i, desc in enumerate(pattern)} for _ in range(repeat)]
        for pattern, repeat in cfg.layer_list
    ]}


@torch.no_grad()
def apply_decode(params: LM, tokens: torch.Tensor, cache: dict, cache_len, cfg: ModelConfig):
    """One decode step. tokens (B, 1) → (logits (B, 1, V), cache). The KV
    and MLA caches are written in place; the Mamba and RWKV states are
    replaced in the returned cache."""
    _check(cfg)
    cache_len = int(cache_len)
    x = _embed_input(params, {"tokens": tokens}, cfg)
    positions = torch.full((1,), cache_len, device=x.device)
    new_groups = []
    for (pattern, _repeat), layers, c_g in zip(cfg.layer_list, params.groups, cache["groups"]):
        new_g = []
        for layer, c_layer in zip(layers, c_g):
            new_c = {}
            for i, desc in enumerate(pattern):
                x, nc = block_apply(layer[f"l{i}"], x, cfg, desc, positions=positions,
                                    cache=c_layer[f"l{i}"], cache_len=cache_len)
                new_c[f"l{i}"] = {**c_layer[f"l{i}"], **(nc or {})}
            new_g.append(new_c)
        new_groups.append(new_g)
    return _logits(params, x, cfg), {"groups": new_groups}
