"""Training step: causal-LM loss, gradients, AdamW update.

The counterpart of ``repro._unused.train.train_step``. On one device the
step takes the :class:`~repro_torch._unused.models.lm.LM` module, whose
parameters the trainer has switched to ``requires_grad=True`` once
(:class:`~repro_torch.launch.train.TrainLoop` does so where it builds them),
the optimizer state and a batch of ``tokens`` and ``labels`` (and
``frames`` or ``patch_embeds`` as the card needs). It casts the float32
masters of rank ≥ 2 to the compute dtype as the reference does (a view of
the module whose leaves are the casts, so the gradient flows back to the
masters), takes the loss's gradient with ``torch.autograd.grad`` (the model
recomputes each layer in the backward, and the flash kernel's backward is
the plain streaming softmax's), optionally round-trips it through int8
compression, and updates the parameters and moments in place.

:func:`make_mesh_train_step` is the step over a mesh of device lists, in
one process: the parameters and AdamW moments are
:class:`~repro_torch.sharding.place.Placed` per ``lm.param_axes`` and the
rules (``fsdp`` → ``data``: each data device holds its slice). Each data
shard computes the loss of its batch rows on its first device: the top
leaves are gathered there at the start, each layer inside its remat (so
the backward gathers it again), and the backward sends each slice's
gradient back to its tile, where the data shards' gradients add up. The
shard losses are weighted by the global batch's token count (its
``loss_mask`` where it has one), so that their sum is ``loss_fn`` of the
whole batch. Over a ``model`` axis of more than one position the step is
tensor-parallel (the reference's "TP over ``model``"): the leaves that the
split layers read per position (``lm.tp_leaf_names``) are gathered only
along ``fsdp``, onto each model position of the data shard, inside the
layer's remat (``Placed.model_tile``), and the position computes its
slice of the heads, MLP columns, experts and vocabulary with them; the
other leaves are gathered whole onto the shard's first position. The
loss is vocab-parallel (:func:`loss_fn`). Each tile's gradient is the sum
of what its holders received (the replicas along the mesh axes its spec
leaves out). With ``compress_grads`` the int8 round trip runs on each
summed gradient leaf, as the reference's does on its global gradients.
Then one AdamW update runs per tile.

Counted on meta tensors (the dry-run, ``launch/cost.py``), the data shards
do the same work at their own positions, so the step runs the first two
and counts each later shard as the second one's count moved to that
shard's positions (:func:`_shard_replay`): the second, because a later
shard's backward adds into gradients that an earlier shard's made, as
every shard after the first does. The count is that of running them all.
"""

from __future__ import annotations

import contextlib
import functools
import types

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import cost as _cost
from repro_torch.sharding.place import Placed, model_reduce, place, place_zeros
from repro_torch.sharding.rules import (DEFAULT_RULES, SINGLE_POD_RULES, LogicalRules,
                                        axis_rules, batch_shards, mesh_position, model_positions,
                                        model_size, on_position, on_shard, tree_shardings)
from repro_torch._unused.models import lm
from .optimizer import AdamWConfig, OptState, adamw_update, adamw_update_tiles

__all__ = ["loss_fn", "cast_params_for_compute", "make_train_step", "make_mesh_train_step",
           "place_train_state"]


def loss_fn(params, batch: dict, cfg: ModelConfig, *, denom=None) -> torch.Tensor:
    """Next-token cross-entropy over the (padded) vocab, mean over tokens
    (over ``loss_mask`` where the batch has one). ``denom`` replaces the
    batch's own token count (a data shard's loss weighted by the global
    batch's). Over logits split by vocab (a ``model`` axis), the
    log-sum-exp is vocab-parallel: the max over the positions' column
    blocks, then the sum of their ``exp(logit - max)``, and the label's
    logit from the block that holds it (zeros from the others, summed)."""
    shards = lm.apply_train(params, batch, cfg, vocab_shards=True)  # (B,S,Vp/n) f32 each
    if len(shards) == 1:
        logits = shards[0]
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    else:
        lse, ll = _vocab_parallel_lse(shards, batch["labels"].long())
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0) if mask is not None else float(nll.numel())
    return nll.sum() / denom


def _vocab_parallel_lse(shards: list[torch.Tensor], labels: torch.Tensor):
    """(log-sum-exp, the label's logit), each (B, S) on the first block's
    device, of logits split into column blocks over the model positions:
    each position's max and sum of exps and its share of the label's logit,
    reduced over the positions (``model_reduce``)."""
    positions = model_positions()[:len(shards)]
    maxes, offset, lls = [], 0, []
    for s, pos in zip(shards, positions):
        with on_position(pos):
            maxes.append(s.detach().amax(-1))
            local = labels.to(s.device) - offset
            hit = (local >= 0) & (local < s.shape[-1])
            got = s.gather(-1, local.clamp(0, s.shape[-1] - 1)[..., None])[..., 0]
            lls.append(torch.where(hit, got, torch.zeros((), dtype=s.dtype, device=s.device)))
        offset += s.shape[-1]
    top = model_reduce(maxes, positions, torch.maximum)
    sums = []
    for s, pos in zip(shards, positions):
        with on_position(pos):
            sums.append(torch.exp(s - top.to(s.device)[..., None]).sum(-1))
    lse = top + torch.log(model_reduce(sums, positions))
    return lse, model_reduce(lls, positions)


def _compute_cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A float32 leaf of rank ≥ 2 in the compute dtype; other leaves as they are."""
    return t.to(dtype) if t.dtype == torch.float32 and t.dim() >= 2 else t


def cast_params_for_compute(params: nn.Module, cfg: ModelConfig) -> nn.Module:
    """Mixed precision: a view of ``params`` whose float32 leaves of rank
    ≥ 2 are cast to the compute dtype (differentiable casts: gradients flow
    back to the float32 masters); ``params`` itself when the compute dtype is
    float32."""
    cd = getattr(torch, cfg.compute_dtype)
    if cd == torch.float32:
        return params
    return lm.module_view(params, {k: _compute_cast(p, cd)
                          for k, p in params.named_parameters(remove_duplicate=False)})


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, compress_grads: bool = False):
    """The train step (params, opt_state, batch) → (params, opt_state,
    metrics); params and moments are updated in place. ``metrics``: ``loss``,
    ``grad_norm`` and ``lr``, as tensors."""

    def step(params: nn.Module, opt_state: OptState, batch: dict):
        leaves = dict(params.named_parameters())
        with torch.enable_grad():
            pc = cast_params_for_compute(params, cfg)
            loss = loss_fn(pc, batch, cfg)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        del pc  # the compute-dtype casts, before the update's temporaries
        if compress_grads:
            from .compression import compress_decompress_tree

            grads = compress_decompress_tree(grads)
        _, new_opt, metrics = adamw_update(leaves, grads, opt_state, opt_cfg)
        return params, new_opt, dict(metrics, loss=loss.detach())

    return step


def place_train_state(params: nn.Module, cfg: ModelConfig, opt_cfg: AdamWConfig, mesh,
                      rules=None):
    """``params`` (the full module) laid over ``mesh`` per
    ``lm.param_axes(cfg)`` and ``rules`` (``None``: the mesh's default
    rules; Mamba's ``in_proj`` as ``lm.in_proj_layout`` views it): (``{name:
    Placed}`` with every tile a leaf of its own that requires grad, the
    AdamW state with its moments placed alike)."""
    if rules is None:
        rules = DEFAULT_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    r = LogicalRules(mesh, rules)
    named, axes = {}, lm.param_axes(cfg)
    for k, p in params.named_parameters():
        named[k], axes[k] = lm.in_proj_layout(k, p.detach(), axes[k])
    shardings = tree_shardings(named, axes, r)
    placed = {k: place(t, shardings[k], copy=True) for k, t in named.items()}
    for p in placed.values():
        for pos in p.positions():
            p.tiles[pos].requires_grad_(True)
    dt = getattr(torch, opt_cfg.state_dtype)

    def zeros():
        return {k: place_zeros(p.shape, dt, p.sharding) for k, p in placed.items()}

    return placed, OptState(torch.zeros((), dtype=torch.int32), zeros(), zeros())


class _LayerTiles:
    """One layer's placed parameters as the data shard's positions compute
    with them when ``lm`` runs the layer, inside its remat: the leaves in
    ``split`` (read per model position) stay :class:`Placed`, gathered
    along ``fsdp`` where a position reads them; the others are gathered
    onto ``device`` (and cast for compute)."""

    def __init__(self, module: nn.Module, prefix: str, params: dict, device, cast,
                 split: set):
        self.module, self.prefix, self.device, self.cast = module, prefix, device, cast
        self.names = [k for k in params if k.startswith(prefix)]
        self.params, self.split = params, split

    def parameters(self):
        for k in self.names:
            yield from self.params[k].blocks().values()

    def gather(self) -> nn.Module:
        n = len(self.prefix)
        return lm.module_view(self.module, {k[n:]: _leaf(self.params[k], k in self.split,
                                                         self.device, self.cast)
                                            for k in self.names})


def _leaf(p: Placed, split: bool, device, cast):
    return p if split else cast(p.full(device))


def _shard_model(template: lm.LM, cfg: ModelConfig, params: dict, device, cast):
    """The LM as ``lm.apply_train`` reads it, for one data shard: the top
    leaves gathered onto ``device`` now (the embedding and the head left
    split under a ``model`` axis), the layers as :class:`_LayerTiles`."""
    split = lm.tp_leaf_names(template, cfg) if model_size() > 1 else set()

    def top(name):
        sub = getattr(template, name)
        if sub is None:
            return None
        return lm.module_view(sub, {k: _leaf(p, k in split, device, cast)
                                    for k, p in params.items() if k.startswith(name + ".")},
                              name + ".")

    groups = [[_LayerTiles(layer, f"groups.{gi}.{r}.", params, device, cast, split)
               for r, layer in enumerate(layers)] for gi, layers in enumerate(template.groups)]
    encoder = None if template.encoder is None else [
        _LayerTiles(layer, f"encoder.{r}.", params, device, cast, split)
        for r, layer in enumerate(template.encoder)]
    return types.SimpleNamespace(embed=top("embed"), final_norm=top("final_norm"),
                                 lm_head=top("lm_head"), enc_norm=top("enc_norm"),
                                 groups=groups, encoder=encoder)


def _graded(params: dict) -> set:
    """The (name, position) of every tile of ``params`` that has a gradient."""
    return {(k, pos) for k, p in params.items() for pos in p.positions()
            if p.tiles[pos].grad is not None}


def _shard_replay(counter, mesh, params: dict, coords: dict, tallies: dict, graded: set):
    """A counted data shard's work (``tallies``, position → ``Tally``, and
    the tiles that its backward gave a first gradient, ``graded``) as a
    function that adds it at another shard's positions: the same tallies
    with the shard's mesh coordinates replaced by the other's, and an empty
    gradient on each tile that takes the place of one in ``graded`` and has
    none yet. ``None`` where the work touched a position outside the
    shard (then every shard runs)."""
    axes = {a: mesh.axis_names.index(a) for a in coords}

    def inside(pos):
        return all(pos[i] == coords[a] for a, i in axes.items())

    if not (all(map(inside, tallies)) and all(inside(pos) for _, pos in graded)):
        return None

    def replay(other: dict):
        def move(pos):
            out = list(pos)
            for a, i in axes.items():
                out[i] = other[a]
            return tuple(out)

        counter.add_tallies(tallies, move)
        for k, pos in graded:
            tile = params[k].tiles[move(pos)]
            if tile.grad is None:
                tile.grad = torch.empty_like(tile)

    return replay


def make_mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh, *,
                         compress_grads: bool = False, rules=None):
    """The train step over ``mesh`` (params, opt_state, batch) → (params,
    opt_state, metrics), for the state :func:`place_train_state` lays out;
    tiles and moments are updated in place. The batch's rows are split into
    data shards along the mesh axes of the ``batch`` rule; it runs under
    ``axis_rules(mesh)``, so MoE layers take the expert-parallel
    path within each data shard; ``rules`` replaces the mesh's default
    rules (as :func:`place_train_state`'s). ``metrics``: ``loss`` (the
    global batch's mean, on the mesh's first device), ``grad_norm`` and
    ``lr``."""
    template = lm.init_params(cfg, device="meta")
    cast = functools.partial(_compute_cast, dtype=getattr(torch, cfg.compute_dtype))

    def step(params: dict, opt_state: OptState, batch: dict):
        with axis_rules(mesh, rules):
            first = mesh.devices.flat[0]
            tiles = [t for p in params.values() for t in p.tiles.flat]
            for t in tiles:
                t.grad = None
            mask = batch.get("loss_mask")
            denom = (torch.clamp(mask.sum(), min=1.0) if mask is not None
                     else float(batch["tokens"].numel()))
            loss = replay = None
            shards = batch_shards(batch["tokens"].shape)
            counter = _cost.active()
            on_meta = counter is not None and len(shards) > 2 and all(
                v.device.type == "meta" for v in batch.values())
            for i, (coords, rows) in enumerate(shards):
                if replay is not None:  # on meta: the second shard's count, moved here
                    replay(coords)
                else:
                    dev = mesh.devices[mesh_position(mesh, coords)]
                    sub = {k: v[rows].to(dev) for k, v in batch.items()}
                    d = denom.to(dev) if isinstance(denom, torch.Tensor) else denom
                    watch = on_meta and i == 1
                    graded = _graded(params) if watch else None
                    with (counter.apart() if watch else contextlib.nullcontext()) as own, \
                            on_shard(coords), torch.enable_grad():
                        shard_loss = loss_fn(_shard_model(template, cfg, params, dev, cast), sub,
                                             cfg, denom=d)
                        shard_loss.backward()
                    if watch:
                        replay = _shard_replay(counter, mesh, params, coords, own,
                                               _graded(params) - graded)
                shard_loss = shard_loss.detach().to(first)
                loss = shard_loss if loss is None else loss + shard_loss
            grads = {}
            for k, p in params.items():
                sums = {}  # tile coordinates → the sum of its holders' gradients
                for pos in p.positions():
                    g = p.tiles[pos].grad
                    if g is not None:
                        c = p.sharding.block(pos, p.ndim)
                        sums[c] = g if c not in sums else sums[c] + g.to(sums[c].device)
                grid = np.empty(p.tiles.shape, dtype=object)
                for pos in p.positions():
                    g = sums.get(p.sharding.block(pos, p.ndim))
                    grid[pos] = torch.zeros_like(p.tiles[pos]) if g is None else g.to(
                        p.tiles[pos].device)
                grads[k] = Placed(p.sharding, p.shape, grid)
            for t in tiles:
                t.grad = None
            if compress_grads:
                from .compression import compress_decompress_tree

                full = compress_decompress_tree({k: g.full() for k, g in grads.items()})
                grads = {k: place(full[k], grads[k].sharding) for k in grads}
            _, new_opt, metrics = adamw_update_tiles(params, grads, opt_state, opt_cfg)
        return params, new_opt, dict(metrics, loss=loss)

    return step
