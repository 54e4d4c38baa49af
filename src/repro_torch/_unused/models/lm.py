"""Model assembly: decoder-only LMs, the enc-dec (Seamless) variant, the VLM
embedding stub, per-layer remat, and decode caches.

The counterpart of ``repro._unused.models.lm``. The parameters are an
:class:`LM` module whose names follow the reference's pytree:
``embed.table``, ``final_norm.scale``, ``lm_head.w`` (untied models only),
``groups[gi][r]["l{i}"]`` and, for enc-dec, ``encoder[r]["l0"]`` and
``enc_norm``, where the reference stacks a group's ``repeat`` layers on a
leading scan axis and the port keeps one ``ModuleList`` entry per layer.
Logits are the compute-dtype product cast to float32, over the vocab padded
by ``round_vocab``. The audio frontend is a stub, as in the reference: the
encoder takes precomputed frame embeddings (``batch["frames"]``); the
vision stub puts ``batch["patch_embeds"]`` in the first ``n_patches``
positions.

The entry points run on the card unless the caller passes a CPU device:
``device=None`` means ``"cuda"``, and without a GPU they raise
``DeviceUnavailableError``. Parameters are made with
``requires_grad=False``; a trainer switches them on
(``params.requires_grad_(True)``). :func:`apply_train` and :func:`encode`
carry a gradient: with grad enabled and a parameter or input that
requires one, each layer runs under ``torch.utils.checkpoint``
(non-reentrant), the counterpart of the
reference's remat: by default the whole layer is recomputed in the
backward; with ``REPRO_REMAT=dots`` (read at each forward, as the
reference reads it) the outputs of the products with no batch dimension
(``aten.mm``/``addmm``: the dense layers, not ``bmm`` or attention) are
saved and the rest recomputed (``create_selective_checkpoint_contexts``).
:func:`apply_decode` and :func:`prefill_cross` serve, under
``torch.no_grad``.

:func:`param_axes` and :func:`cache_axes` give every parameter and cache
leaf its logical axes (``sharding.rules``), keyed by the port's names; a
stacked layer of the reference (``(None, *axes)``) is one entry per layer
here. Under a rule context with ``ctx_parallel``, :func:`init_cache` lays
the GQA and MLA caches as sequence tiles on the ``model`` devices, and
:func:`apply_decode` attends over them tile by tile. A layer may also be an
object with ``gather()`` (the mesh train step's tiles): it is gathered into
a module inside the layer's remat, so that the backward gathers it again.

Tensor parallelism: under a rule context whose ``model`` axis has more than
one position, the layers split their work over it (``blocks.py``), the
embedding lookup is vocab-parallel (each position looks up the rows of the
table it holds, zeros elsewhere, then one sum) and so are the logits
(``vocab_shards=True`` returns each position's columns of them, on its
device; otherwise they are joined). :func:`init_cache` then lays the
caches of the mixers that split (``blocks.split_mixers``) per position:
GQA's as ``kv_heads`` tiles, MLA's latent cache as a replica per
position, Mamba's ``conv`` and ``h`` as ``mlp`` tiles and RWKV's state as
``heads`` tiles. :func:`place_params` is the serving layout: the weights
of the split layers laid over the mesh once, per :func:`param_axes` under
the rules with ``fsdp`` whole (Mamba's ``in_proj`` as a (d, 2, d_inner)
view, so that each position's tile holds its columns of both halves), so
that each data shard serves from its own replica and gathers nothing per
step.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import os

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerDesc, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.sharding.place import (join_model_parts, model_parts, model_tile, place,
                                        place_zeros, zip_tree)
from repro_torch.sharding.rules import (DEFAULT_RULES, SINGLE_POD_RULES, LogicalRules,
                                        NamedSharding, axis_rules, context_state, current_rules,
                                        model_size, model_split, restored_context, shard)
from .attention import GQA, MLA, KVCache
from .blocks import (block_apply, block_axes, block_cache_axes, block_cache_init, block_init,
                     split_mixers)
from .layers import (FFN, ChannelMix, Dense, Embed, Norm, cdtype, dense_tp, embed_axes,
                     embed_init, norm_apply, norm_axes, norm_init, pdtype, round_vocab)
from .moe import MoE
from .ssm import RWKV, Mamba

__all__ = [
    "LM",
    "init_params",
    "param_axes",
    "cache_axes",
    "apply_train",
    "encode",
    "init_cache",
    "prefill_cross",
    "apply_decode",
    "count_params",
    "param_count",
    "module_view",
    "tp_leaf_names",
    "place_params",
    "place_module",
    "in_proj_layout",
    "is_in_proj",
]

#: the encoder's one layer kind
ENC_PATTERN = (LayerDesc(mixer="gqa", ffn="dense"),)


class LM(nn.Module):
    """``embed``, ``final_norm``, ``lm_head`` (untied only), ``groups`` and,
    for enc-dec, ``encoder`` and ``enc_norm``."""

    def __init__(self, embed: Embed, final_norm: Norm, groups: nn.ModuleList,
                 lm_head: Dense | None = None, encoder: nn.ModuleList | None = None,
                 enc_norm: Norm | None = None):
        super().__init__()
        self.embed, self.final_norm, self.lm_head, self.groups = embed, final_norm, lm_head, groups
        self.encoder, self.enc_norm = encoder, enc_norm


def init_params(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                device=None) -> LM:
    """Random parameters: dense ``w`` ~ N(0, 1/in_dim), the embedding
    N(0, 0.02²), biases 0 and norms 1, and the Mamba and RWKV leaves by the
    reference's recipes (``ssm.mamba_init``, ``ssm.rwkv_init``), in
    ``param_dtype`` on ``device``.
    ``generator`` (on that device; else one seeded with 0) draws them; on
    the ``meta`` device only the shapes are made."""
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
            nn.ModuleDict({f"l{i}": block_init(cfg, desc, cross=cfg.encdec, **kw)
                           for i, desc in enumerate(pattern)})
            for _ in range(repeat)
        )
        for pattern, repeat in cfg.layer_list
    )
    encoder = enc_norm = None
    if cfg.encdec:
        encoder = nn.ModuleList(nn.ModuleDict({"l0": block_init(cfg, ENC_PATTERN[0], **kw)})
                                for _ in range(cfg.n_encoder_layers))
        enc_norm = norm_init(cfg.d_model, cfg, device=dev)
    return LM(embed, norm_init(cfg.d_model, cfg, device=dev), groups, lm_head, encoder, enc_norm)


def _flat(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def param_axes(cfg: ModelConfig) -> dict[str, tuple]:
    """The logical axes of every parameter of :func:`init_params`, keyed as
    ``named_parameters()``: the reference's ``param_axes`` with each
    stacked group (``(None, *axes)``) spelled out per layer."""
    top: dict = {"embed": embed_axes(), "final_norm": norm_axes(cfg)}
    if not cfg.tie_embeddings:
        top["lm_head"] = {"w": ("fsdp", "vocab")}
    if cfg.encdec:
        top["enc_norm"] = norm_axes(cfg)
    axes = dict(_flat(top))
    for gi, (pattern, repeat) in enumerate(cfg.layer_list):
        one = {f"l{i}": block_axes(cfg, d, cross=cfg.encdec) for i, d in enumerate(pattern)}
        for r in range(repeat):
            axes.update(_flat(one, f"groups.{gi}.{r}."))
    for r in range(cfg.n_encoder_layers if cfg.encdec else 0):
        axes.update(_flat({"l0": block_axes(cfg, ENC_PATTERN[0])}, f"encoder.{r}."))
    return axes


def count_params(params: LM) -> int:
    return sum(p.numel() for p in params.parameters())


def param_count(cfg: ModelConfig) -> int:
    """What ``count_params`` gives for ``init_params(cfg)``, from the shapes:
    ``n_params_estimate`` plus the leaves the estimate leaves out, namely
    the norms (two per block, one per parallel block, and the final one;
    enc-dec: two per encoder block, ``enc_norm`` and each decoder block's
    ``norm_x``; a LayerNorm holds a bias too; MLA's ``q_norm`` and
    ``kv_norm``), the QKV biases (enc-dec: the encoder's and the
    cross-attention's too), the rows that pad the vocab to ``round_vocab``, Mamba's
    ``conv_b``, RWKV's ``mu``, ``w0``, ``u``, ``ln_scale`` and ``ln_bias``
    and the channel mix's ``mu``; less the gate LoRA (``rwkv_gate_lora ·
    2d``) that the estimate counts and ``rwkv_init`` does not build."""
    d = cfg.d_model
    per_norm = 2 if cfg.norm_type == "layernorm" else 1
    n_norms = cfg.n_layers * (1 if cfg.parallel_block else 2) + 1
    n_attn = cfg.n_layers
    if cfg.encdec:
        n_norms += 2 * cfg.n_encoder_layers + 1 + cfg.n_layers
        n_attn += cfg.n_encoder_layers + cfg.n_layers
    norms = n_norms * per_norm * d
    biases = n_attn * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim if cfg.qkv_bias else 0
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


def _embed_tokens(params: LM, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The table's rows of ``tokens`` in the compute dtype (rows are gathered
    before the cast; the cast is elementwise, so the values are the
    reference's). Under a ``model`` axis that splits the vocab, each
    position looks up the tokens in the rows it holds and puts zeros
    elsewhere; one sum joins them (exact: one term is not zero)."""
    table = params.embed.table
    if model_size() == 1:
        return table[tokens].to(cdtype(cfg))
    axes = embed_axes()["table"]
    n = model_split(axes, table.shape)[1]

    def lookup(m, tok, coords):
        rows = model_tile(table, axes, m, coords)
        local = tok - m * rows.shape[0]
        hit = (local >= 0) & (local < rows.shape[0])
        emb = rows[local.clamp(0, rows.shape[0] - 1)].to(cdtype(cfg))
        return torch.where(hit[..., None], emb, torch.zeros((), dtype=emb.dtype,
                                                             device=emb.device))

    return model_parts(tokens, lookup, n)


def _embed_input(params: LM, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Token / frontend-stub embedding → (B, S, d) in the compute dtype
    (:func:`_embed_tokens`). The vision stub's ``patch_embeds`` (B, P, d)
    replace the first P = ``n_patches`` positions."""
    emb = _embed_tokens(params, batch["tokens"], cfg)
    if cfg.frontend == "vision_patches":
        P = cfg.n_patches
        emb = torch.cat([batch["patch_embeds"].to(emb.dtype), emb[:, P:]], dim=1)
    return shard(emb, ("batch", "seq", "embed"))


def _layers(layer: nn.ModuleDict, pattern, x, cfg, positions, causal, xa):
    if hasattr(layer, "gather"):  # tiles on a mesh: the whole layer, on x's device
        layer = layer.gather()
    for i, desc in enumerate(pattern):
        x, _ = block_apply(layer[f"l{i}"], x, cfg, desc, positions=positions, causal=causal,
                           xa=xa)
    return x


#: the products ``REPRO_REMAT=dots`` saves: no batch dimension (the reference's
#: ``dots_with_no_batch_dims_saveable``)
_SAVED_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}


def _remat_dots() -> bool:
    """The layer remat policy: ``REPRO_REMAT=dots`` saves the products'
    outputs (recomputing only the rest in the backward's re-forward: more
    memory, fewer recompute FLOPs); the default recomputes everything."""
    return os.environ.get("REPRO_REMAT", "full") == "dots"


def _dots_policy(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


@contextlib.contextmanager
def _entered(contexts):
    with contextlib.ExitStack() as stack:
        for cm in contexts:
            stack.enter_context(cm)
        yield


def _remat_contexts(state, dots: bool):
    """``checkpoint``'s (forward, recompute) contexts: the selective policy's
    pair under ``dots``, and the forward's rule context entered again for
    the recompute."""
    forward, recompute = [], []
    if state != (None, None):
        recompute.append(restored_context(state))
    if dots:
        f, r = create_selective_checkpoint_contexts(_dots_policy)
        forward.append(f)
        recompute.append(r)
    return _entered(forward), _entered(recompute)


def _remat(layer: nn.ModuleDict, pattern, x, cfg, positions, causal=True, xa=None,
           dots: bool = False):
    """One scan step of the reference (the layers of one repeat of a
    pattern), recomputed in the backward when a gradient is being taken:
    grad mode is on and the input, the context or a parameter of the layer
    requires one (serving, whose parameters do not, never checkpoints).
    With ``dots`` the products' outputs are kept and not recomputed. The
    forward draws no random numbers, so no RNG state is kept; a rule context
    or shard position of the forward is entered again for the recompute,
    which may run in the autograd engine's thread."""
    args = (layer, pattern, x, cfg, positions, causal, xa)
    if torch.is_grad_enabled() and (
            x.requires_grad or (xa is not None and xa.requires_grad)
            or any(p.requires_grad for p in layer.parameters())):
        state = context_state()
        kw = {} if state == (None, None) and not dots else {
            "context_fn": functools.partial(_remat_contexts, state, dots)}
        return checkpoint(_layers, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    return _layers(*args)


def _run_groups(groups: nn.ModuleList, x, cfg: ModelConfig, *, positions, causal=True, xa=None):
    dots = _remat_dots()
    for (pattern, _repeat), layers in zip(cfg.layer_list, groups):
        for layer in layers:
            x = _remat(layer, pattern, x, cfg, positions, causal, xa, dots)
    return x


def _logits(params: LM, x, cfg: ModelConfig, vocab_shards: bool = False):
    """The final norm, then the logits (B, S, Vp) float32. Under a ``model``
    axis that splits the vocab, each position multiplies by its columns of
    the head (its rows of the tied table); ``vocab_shards`` returns those
    column blocks, in vocab order, each on its position's device, else
    they are joined on the first. Without a split: one block."""
    x = norm_apply(params.final_norm, x, cfg)
    if model_size() == 1:
        if cfg.tie_embeddings:
            w = params.embed.table.to(cdtype(cfg)).T
        else:
            w = params.lm_head.w.to(cdtype(cfg))
        out = shard((x @ w).float(), ("batch", "seq", "vocab"))
        return [out] if vocab_shards else out
    leaf, axes = ((params.embed.table, embed_axes()["table"]) if cfg.tie_embeddings
                  else (params.lm_head.w, ("fsdp", "vocab")))
    n = model_split(axes, leaf.shape)[1]

    def block(m, xm, coords):
        w = model_tile(leaf, axes, m, coords).to(cdtype(cfg))
        return (xm @ (w.T if cfg.tie_embeddings else w)).float()

    parts = model_parts(x, block, n, join=None)
    return parts if vocab_shards else join_model_parts(parts, -1)


def encode(params: LM, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Encoder stack over precomputed frame embeddings (the audio stub):
    (B, Sx, d) → (B, Sx, d) in the compute dtype; non-causal self-attention."""
    x = frames.to(cdtype(cfg))
    positions = torch.arange(x.shape[1], device=x.device)
    dots = _remat_dots()
    for layer in params.encoder:
        x = _remat(layer, ENC_PATTERN, x, cfg, positions, causal=False, dots=dots)
    return norm_apply(params.enc_norm, x, cfg)


def apply_train(params: LM, batch: dict, cfg: ModelConfig, *, vocab_shards: bool = False):
    """Full-sequence forward → logits (B, S, vocab_padded) f32 (with
    ``vocab_shards``: the list of their vocab-parallel column blocks,
    :func:`_logits`). Enc-dec cards take ``batch["frames"]``, the VLM stub
    ``batch["patch_embeds"]``."""
    xa = encode(params, batch["frames"], cfg) if cfg.encdec else None
    x = _embed_input(params, batch, cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _run_groups(params.groups, x, cfg, positions=positions, causal=True, xa=xa)
    return _logits(params, x, cfg, vocab_shards)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=torch.bfloat16, *,
               cross_len: int = 0, device=None, ctx_parallel: bool = False) -> dict:
    """``{"groups": [[{"l{i}": block cache} per layer] per group]}``; an
    enc-dec card with ``cross_len`` also gets each decoder block's
    ``"cross"`` K/V, which :func:`prefill_cross` fills. Under a rule context
    with ``ctx_parallel``, every leaf whose :func:`cache_axes` sequence axis
    the rules map to a mesh axis (``seq_ctx`` → ``model``, where it divides
    the length) is laid as zero tiles on the mesh's devices. Under rules
    that split a mixer over ``model`` (``blocks.split_mixers``), that
    mixer's cache is laid per position, each tile written and read by its
    position only: GQA's as ``kv_heads`` tiles (a replica per position
    where the rules keep ``kv_heads`` whole; not with ``ctx_parallel``),
    MLA's latent and rope-key cache as a replica per position (where it is
    not in sequence tiles), Mamba's ``conv`` and ``h`` as ``mlp`` tiles,
    RWKV's ``s`` as ``heads`` tiles (its ``x_tm`` and ``x_cm`` stay whole).
    The rest stay on ``device``."""
    dev = resolve_device(device, user="the LM")
    cross_len = cross_len if cfg.encdec else 0
    split = split_mixers(cfg) - ({"gqa"} if ctx_parallel else set())
    rules = current_rules() if ctx_parallel or split else None

    def build(device_):
        return {"groups": [
            [{f"l{i}": block_cache_init(cfg, desc, batch, s_max, dtype, cross_len=cross_len,
                                        device=device_)
              for i, desc in enumerate(pattern)} for _ in range(repeat)]
            for pattern, repeat in cfg.layer_list
        ]}

    if rules is None:
        return build(dev)

    def leaf(mixer, t, axes):
        spec = rules.spec(axes, shape=tuple(t.shape))
        if ctx_parallel and "seq_ctx" in axes and spec[axes.index("seq_ctx")] is not None:
            tiled = True
        else:
            tiled = mixer in split and (mixer == "mla" or
                                        bool({"kv_heads", "mlp", "heads"} & set(axes)))
        if tiled:
            return place_zeros(t.shape, t.dtype, NamedSharding(rules.mesh, spec))
        return torch.zeros(t.shape, dtype=t.dtype, device=dev)

    tree = build("meta")
    axes = cache_axes(cfg, ctx_parallel=ctx_parallel, cross=bool(cross_len))
    for (pattern, _), layers, layers_axes in zip(cfg.layer_list, tree["groups"], axes["groups"]):
        for layer, layer_axes in zip(layers, layers_axes):
            for i, desc in enumerate(pattern):
                c, a = layer[f"l{i}"], layer_axes[f"l{i}"]
                c["mixer"] = zip_tree(functools.partial(leaf, desc.mixer), c["mixer"], a["mixer"])
                if "cross" in c:  # the cross K/V stay whole (lm.prefill_cross writes them)
                    c["cross"] = KVCache(*(torch.zeros(t.shape, dtype=t.dtype, device=dev)
                                           for t in c["cross"]))
    return tree


def cache_axes(cfg: ModelConfig, *, ctx_parallel: bool = False, cross: bool = False) -> dict:
    """The logical axes of :func:`init_cache`'s leaves, in its structure."""
    return {"groups": [
        [{f"l{i}": block_cache_axes(cfg, d, ctx_parallel=ctx_parallel, cross=cross and cfg.encdec)
          for i, d in enumerate(pattern)} for _ in range(repeat)]
        for pattern, repeat in cfg.layer_list
    ]}


@torch.no_grad()
def prefill_cross(params: LM, enc_out: torch.Tensor, cfg: ModelConfig, cache: dict) -> dict:
    """Each decoder block's cross-attention K/V of the encoder output, in
    the cache's dtype → a new cache with the ``"cross"`` entries replaced."""
    groups = []
    for layers, c_g in zip(params.groups, cache["groups"]):
        new_g = []
        for layer, c_layer in zip(layers, c_g):
            new_c = {}
            for key, c in c_layer.items():
                cross, cc = layer[key].cross, c["cross"]
                k, v = (dense_tp(w, enc_out, cfg, "fsdp", ("kv_heads", "head_dim")).to(t.dtype)
                        for w, t in ((cross.wk, cc.k), (cross.wv, cc.v)))
                new_c[key] = {**c, "cross": KVCache(k, v)}
            new_g.append(new_c)
        groups.append(new_g)
    return {"groups": groups}


@torch.no_grad()
def apply_decode(params: LM, tokens: torch.Tensor, cache: dict, cache_len, cfg: ModelConfig, *,
                 ctx_parallel: bool = False, vocab_shards: bool = False):
    """One decode step. tokens (B, 1) → (logits (B, 1, V), cache) (with
    ``vocab_shards``: the list of the logits' vocab-parallel column
    blocks). The KV and MLA caches are written in place (with
    ``ctx_parallel``, the masked write into sequence tiles; under a split of
    the heads, each position into its ``kv_heads`` tile or its replica of
    the latent cache); the Mamba and RWKV states are replaced in the
    returned cache, except the tiles of a split mixer (Mamba's ``conv`` and
    ``h``, RWKV's ``s``), which each position writes in place; the cross
    K/V entries are kept as they are."""
    cache_len = int(cache_len)
    x = shard(_embed_tokens(params, tokens, cfg), ("batch", None, "embed"))
    positions = torch.full((1,), cache_len, device=x.device)
    new_groups = []
    for (pattern, _repeat), layers, c_g in zip(cfg.layer_list, params.groups, cache["groups"]):
        new_g = []
        for layer, c_layer in zip(layers, c_g):
            new_c = {}
            for i, desc in enumerate(pattern):
                x, nc = block_apply(layer[f"l{i}"], x, cfg, desc, positions=positions,
                                    cache=c_layer[f"l{i}"], cache_len=cache_len,
                                    ctx_parallel=ctx_parallel)
                new_c[f"l{i}"] = {**c_layer[f"l{i}"], **(nc or {})}
            new_g.append(new_c)
        new_groups.append(new_g)
    return _logits(params, x, cfg, vocab_shards), {"groups": new_groups}


# ---- the serving layout ------------------------------------------------------------------
def module_view(module: nn.Module, leaves: dict, prefix: str = "") -> nn.Module:
    """A shallow copy of ``module`` whose parameters are
    ``leaves[prefix + name]`` (tensors, :class:`~repro_torch.sharding.place.Placed`
    tiles, ``None``)."""
    view = copy.copy(module)
    view._parameters = {k: None if p is None else leaves[f"{prefix}{k}"]
                        for k, p in module._parameters.items()}
    view._modules = {k: None if m is None else module_view(m, leaves, f"{prefix}{k}.")
                     for k, m in module._modules.items()}
    return view


def tp_leaf_names(params: nn.Module, cfg: ModelConfig) -> set[str]:
    """The parameters of ``params`` (an :class:`LM` or one of its modules)
    that the split layers read per model position (the
    rest are read whole, on a data shard's first position): every leaf of
    a GQA mixer or cross-attention and of a dense FFN, the channel mix's
    ``wk`` and ``wv``, a MoE's experts and shared experts (not its router),
    the embedding table and the untied head; under rules that split them
    (``blocks.split_mixers``), also MLA's ``wuq``, ``wuk``,
    ``wuv`` and ``wo``, every leaf of Mamba, and RWKV-6's ``wr``, ``wk``,
    ``wv``, ``wg``, ``u``, groupnorm and ``wo`` (the token-shift mixes and
    the decay LoRA stay whole)."""
    split = split_mixers(cfg)
    out = set()
    for name, mod in params.named_modules():
        pre = f"{name}." if name else ""
        if isinstance(mod, (GQA, FFN)) or (isinstance(mod, Mamba) and "mamba" in split):
            out |= {pre + k for k, _ in mod.named_parameters()}
        elif isinstance(mod, ChannelMix):
            out |= {pre + "wk.w", pre + "wv.w"}
        elif isinstance(mod, MoE):
            out |= {pre + k for k, _ in mod.named_parameters() if not k.startswith("router.")}
        elif isinstance(mod, Embed):
            out.add(pre + "table")
        elif isinstance(mod, MLA) and "mla" in split:
            out |= {pre + k for k in ("wuq.w", "wuk.w", "wuv.w", "wo.w")}
        elif isinstance(mod, RWKV) and "rwkv6" in split:
            out |= {pre + k for k in ("wr.w", "wk.w", "wv.w", "wg.w", "u", "ln_scale", "ln_bias",
                                      "wo.w")}
    if getattr(params, "lm_head", None) is not None:
        out.add("lm_head.w")
    return out


def place_params(params: LM, cfg: ModelConfig, mesh, rules=None) -> LM:
    """The serving layout of ``params`` on ``mesh``: each leaf of
    :func:`tp_leaf_names` laid once by :func:`param_axes` under ``rules``
    (``None``: the mesh's default rules) with ``fsdp`` whole, so that every
    data shard holds a replica and its model positions their slices (on a
    device list that repeats one device, views of ``params``); Mamba's
    ``in_proj`` as its (d, 2, d_inner) view split along d_inner
    (:func:`in_proj_layout`); the other leaves stay as they are.
    ``params`` itself where the mesh has no ``model`` axis of more than one
    position. Run the steps on it under ``axis_rules(mesh, rules)``."""
    return place_module(params, param_axes(cfg), cfg, mesh, rules)


def place_module(module: nn.Module, axes: dict[str, tuple], cfg: ModelConfig, mesh,
                 rules=None) -> nn.Module:
    """:func:`place_params` for any module of the LM (a block, a mixer):
    ``axes`` are the logical axes of its parameters, keyed by their names
    in it (``dict(_flat(block_axes(cfg, desc)))`` for a block)."""
    if "model" not in mesh.axis_names or int(mesh.shape["model"]) == 1:
        return module
    if rules is None:
        rules = DEFAULT_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    r = LogicalRules(mesh, dict(rules, fsdp=None))
    with axis_rules(mesh, rules):
        tp = tp_leaf_names(module, cfg)
    leaves = {}
    for name, t in module.named_parameters(remove_duplicate=False):
        if name not in tp:
            leaves[name] = t
            continue
        t, leaf_axes = in_proj_layout(name, t, axes[name])
        leaves[name] = place(t, NamedSharding(mesh, r.spec(leaf_axes, shape=tuple(t.shape))))
    return module_view(module, leaves)


def is_in_proj(name: str) -> bool:
    """Whether the parameter ``name`` is a Mamba ``in_proj.w``."""
    return name == "in_proj.w" or name.endswith(".in_proj.w")


def in_proj_layout(name: str, t: torch.Tensor, axes: tuple):
    """(``t``, its logical ``axes``) as the layouts over a mesh lay the
    parameter ``name``: Mamba's ``in_proj.w`` (d, 2·d_inner) as its
    (d, 2, d_inner) view with the axes (``fsdp``, None, ``mlp``), so that a
    tile split along d_inner holds its columns of both halves
    (``ssm._in_proj_halves``); any other leaf as it is. Checkpoints keep
    the reference's (d, 2·d_inner) (``launch/train.py``)."""
    if not is_in_proj(name):
        return t, axes
    return t.view(t.shape[0], 2, t.shape[1] // 2), (axes[0], None, axes[1])
