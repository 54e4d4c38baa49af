"""MLA, Mamba and RWKV-6's time mix split over the ``model`` axis, against the
reference on one device, on the CPU.

Reduced cards (DeepSeek-V2: 4 MLA heads; Jamba-v0.1: d_inner 128, GQA and
MoE layers beside Mamba; RWKV6-3B: 4 heads of 16) at float32 compute,
weights made by the JAX ``init_params`` and carried across by
``convert_lm_params`` (RWKV's mixes, bonus, groupnorm and base decay and
Mamba's skip and conv bias drawn from a numpy seed first, so that none of
them is a constant), inputs from a numpy seed. Meshes are device lists
that name the CPU several times, so every split runs for real in one
process, in the serving layout (``lm.place_params``) with the decode
caches laid by ``lm.init_cache`` under the same rules. Each split is held
against the reference's mixer on one device and against the port's own
one-device mixer. The MoE cards run at a capacity of E/k, where the
expert-parallel path of a mesh and the reference's per-row dense path
drop no entry, so both compute the same function.

Tolerances: 1e-5 on activations, states and logits (float32 roundoff in
the sums over positions, added in model order); the train step's loss
1e-4 and parameters 2e-4, the reference's own in
``tests/test_distributed.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro._unused.models import blocks as j_blocks
from repro._unused.models import lm as j_lm
from repro._unused.serve import serve_step as j_serve
from repro._unused.train import optimizer as j_opt
from repro._unused.train import train_step as j_step
from repro_torch.configs.base import get_config
from repro_torch.interop import convert_lm_params, lm_named
from repro_torch.launch.cost import WorkCounter
from repro_torch.launch.mesh import DecodeMesh, make_local_mesh
from repro_torch.launch.train import train_state_tree
from repro_torch._unused.models import blocks, lm, ssm
from repro_torch._unused.serve import serve_step
from repro_torch._unused.train import optimizer, train_step
from repro_torch.sharding.place import Placed
from repro_torch.sharding.rules import SINGLE_POD_RULES, axis_rules, model_split

ATOL = 1e-5
LOSS_ATOL, PARAM_ATOL = 1e-4, 2e-4
B, S, STEPS = 2, 16, 4
CARDS = {"mla": "deepseek-v2-236b", "mamba": "jamba-v0.1-52b", "rwkv6": "rwkv6-3b"}


def _cfgs(name):
    kw = {"compute_dtype": "float32"}
    base = get_config(name).reduced()
    if base.n_experts:
        kw["capacity_factor"] = base.n_experts / base.top_k  # no entry dropped on any path
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(base, **kw))


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mesh(model, data=1):
    return make_local_mesh(data=data, model=model, devices=["cpu"] * (data * model))


@functools.lru_cache(maxsize=None)
def _weights(name):
    jcfg, cfg = _cfgs(name)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: j_lm.init_params(k, jcfg))(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    for group in params["groups"]:
        for layer in group.values():
            p = layer["mixer"]
            draws = {}
            if "w0" in p:  # RWKV: mixes, bonus, groupnorm, base decay
                draws = {"mu": rng.uniform(0, 1, p["mu"].shape),
                         "u": rng.normal(size=p["u"].shape) * 0.5,
                         "ln_scale": 1 + 0.2 * rng.normal(size=p["ln_scale"].shape),
                         "ln_bias": 0.2 * rng.normal(size=p["ln_bias"].shape),
                         "w0": rng.uniform(-6, -1, p["w0"].shape)}
            elif "A_log" in p:  # Mamba: skip and conv bias
                draws = {"D": rng.normal(size=p["D"].shape),
                         "conv_b": 0.2 * rng.normal(size=p["conv_b"].shape)}
            for k, v in draws.items():
                p[k] = v.astype(np.float32)
    return jcfg, cfg, params, convert_lm_params(params, cfg, device="cpu")


def _layer(mixer):
    """(jcfg, cfg, JAX desc, port desc, the layer's JAX mixer params, the
    full port model, the layer's (group, key)) of the first layer of
    ``mixer`` in its reduced card."""
    jcfg, cfg, params, full = _weights(CARDS[mixer])
    for gi, (pattern, _) in enumerate(cfg.layer_list):
        for i, desc in enumerate(pattern):
            if desc.mixer == mixer:
                jp = jax.tree.map(lambda a: a[0], params["groups"][gi][f"l{i}"]["mixer"])
                return (jcfg, cfg, jcfg.layer_list[gi][0][i], desc, jp, full, (gi, f"l{i}"))
    raise AssertionError(mixer)


def _mixer_of(model: lm.LM, where):
    gi, key = where
    return model.groups[gi][0][key].mixer


def _cache_of(cache: dict, where):
    gi, key = where
    return cache["groups"][gi][0][key]["mixer"]


def _apply(p, x, cfg, desc, *, pos, cache=None, cache_len=None):
    return blocks._apply_mixer(p, x, cfg, desc, positions=pos, cache=cache, cache_len=cache_len,
                               causal=True, ctx_parallel=False)


def _all_reduces(counter) -> int:
    return sum(t.collective_counts.get("all-reduce", 0) for t in counter.tallies.values())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=0)


# ---- each mixer, prefill and cached decode -------------------------------------------------
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("mixer", ["mla", "mamba", "rwkv6"])
def test_mixer_split_over_model(mixer, model, phase):
    """The split mixer in the serving layout against the reference's mixer
    and the port's one-device mixer: a prefill of B x S tokens (one sum
    over the positions, two for Mamba), or STEPS decode steps from an empty
    cache laid per position (then the states themselves)."""
    jcfg, cfg, jdesc, desc, jp, full, where = _layer(mixer)
    one_p = _mixer_of(full, where)
    mesh = _mesh(model)
    with axis_rules(mesh):
        laid = _mixer_of(lm.place_params(full, cfg, mesh), where)
    assert isinstance(laid.wo.w if mixer != "mamba" else laid.out_proj.w, Placed)
    if phase == "prefill":
        x, pos = _x(2, B, S, cfg.d_model), np.arange(S)
        want, _ = jax.jit(lambda p, x_: j_blocks._apply_mixer(
            p, x_, jcfg, jdesc, positions=jnp.asarray(pos), cache=None, cache_len=None,
            causal=True, ctx_parallel=False))(jp, jnp.asarray(x))
        one, _ = _apply(one_p, torch.as_tensor(x), cfg, desc, pos=torch.as_tensor(pos))
        with axis_rules(mesh), WorkCounter(target="cpu") as c:
            got, _ = _apply(laid, torch.as_tensor(x), cfg, desc, pos=torch.as_tensor(pos))
        assert _all_reduces(c) == model * (2 if mixer == "mamba" else 1)
        _close(got, want)
        _close(got, one)
        return

    j_step_fn = jax.jit(lambda p, x_, c, n: j_blocks._apply_mixer(
        p, x_, jcfg, jdesc, positions=jnp.full((1,), n), cache=c, cache_len=n, causal=True,
        ctx_parallel=False))
    jc = j_blocks.block_cache_init(jcfg, jdesc, B, STEPS, jnp.float32)["mixer"]
    oc = _cache_of(lm.init_cache(cfg, B, STEPS, torch.float32, device="cpu"), where)
    with axis_rules(mesh):
        tc = _cache_of(lm.init_cache(cfg, B, STEPS, torch.float32, device="cpu"), where)
    laid_leaves = [t for t in tc if isinstance(t, Placed)]
    assert len(laid_leaves) == {"mla": 2, "mamba": 2, "rwkv6": 1}[mixer]
    assert all(t.tiles.shape == (1, model) for t in laid_leaves)
    for t in range(STEPS):
        x = _x(10 + t, B, 1, cfg.d_model)
        pos = torch.full((1,), t)
        want, jc = j_step_fn(jp, jnp.asarray(x), jc, jnp.int32(t))
        one, oc = _apply(one_p, torch.as_tensor(x), cfg, desc, pos=pos, cache=oc, cache_len=t)
        with axis_rules(mesh):
            got, tc = _apply(laid, torch.as_tensor(x), cfg, desc, pos=pos, cache=tc,
                             cache_len=t)
        _close(got, want)
        _close(got, one)
    for j_leaf, t_leaf in zip(jc, tc):  # the states each position kept
        t_full = t_leaf.full("cpu") if isinstance(t_leaf, Placed) else t_leaf
        _close(t_full, j_leaf)


# ---- the traps -----------------------------------------------------------------------------
def test_mamba_in_proj_tile_holds_its_columns_of_both_halves():
    """Over model = 4 a position's ``in_proj`` tile is its d_inner/4
    columns of x's half and of the gate's half: in the serving layout a
    view of the weight, laid once; in the mesh train step's state, a tile
    of the same (d, 2, d_inner) layout holding the same columns, which a
    checkpoint gives back in the reference's (d, 2·d_inner)."""
    _, cfg, _, _, _, full, where = _layer("mamba")
    w = _mixer_of(full, where).in_proj.w
    di, n = cfg.mamba_d_inner, 4
    c = di // n
    mesh = _mesh(n)
    name = f"groups.{where[0]}.0.{where[1]}.mixer.in_proj.w"
    placed, opt = train_step.place_train_state(full, cfg, optimizer.AdamWConfig(), mesh)
    with axis_rules(mesh):
        laid = _mixer_of(lm.place_params(full, cfg, mesh), where).in_proj.w
        cache = _cache_of(lm.init_cache(cfg, B, 8, torch.float32, device="cpu"), where)
        for m in range(n):
            xm_cols, z_cols = w[:, m * c:(m + 1) * c], w[:, di + m * c:di + (m + 1) * c]
            tile = laid.tiles[0, m]
            assert tuple(tile.shape) == (cfg.d_model, 2, c)
            assert tile.data_ptr() == xm_cols.data_ptr()  # a view of the weight
            assert torch.equal(tile[:, 0], xm_cols) and torch.equal(tile[:, 1], z_cols)
            assert placed[name].tiles[0, m].shape == tile.shape
            got = ssm._in_proj_halves(placed[name], m, n, di, {}, "cpu")
            assert torch.equal(got[0], xm_cols) and torch.equal(got[1], z_cols)
    ckpt = train_state_tree(placed, opt)["params"]
    assert torch.equal(lm_named(ckpt)[name], w)
    assert tuple(cache.conv.tiles[0, 3].shape) == (B, cfg.mamba_d_conv - 1, c)
    assert tuple(cache.h.tiles[0, 3].shape) == (B, c, cfg.mamba_d_state)


def test_rwkv_heads_that_do_not_divide_keep_the_whole_path():
    """4 heads over model = 8: the gate's 64 columns would split 8 ways, but
    the time mix decides by its heads, so it keeps the whole path, bit for
    bit the one-device mixer, with its weights and state whole."""
    _, cfg, _, desc, _, full, where = _layer("rwkv6")
    one_p = _mixer_of(full, where)
    x, pos = torch.as_tensor(_x(3, B, S, cfg.d_model)), torch.arange(S)
    want, _ = _apply(one_p, x, cfg, desc, pos=pos)
    oc = _cache_of(lm.init_cache(cfg, B, 2, torch.float32, device="cpu"), where)
    mesh = _mesh(8)
    with axis_rules(mesh):
        assert ssm.rwkv_heads_split(cfg) == 1
        assert model_split(("fsdp", "mlp"), (cfg.d_model, cfg.d_model)) == (1, 8)
        laid = _mixer_of(lm.place_params(full, cfg, mesh), where)
        assert not any(isinstance(t, Placed) for t in laid.parameters())
        got, _ = _apply(laid, x, cfg, desc, pos=pos)
        tc = _cache_of(lm.init_cache(cfg, B, 2, torch.float32, device="cpu"), where)
        assert not any(isinstance(t, Placed) for t in tc)
        for t in range(2):
            xt = torch.as_tensor(_x(20 + t, B, 1, cfg.d_model))
            g, tc = _apply(laid, xt, cfg, desc, pos=torch.full((1,), t), cache=tc, cache_len=t)
            w, oc = _apply(one_p, xt, cfg, desc, pos=torch.full((1,), t), cache=oc, cache_len=t)
            assert torch.equal(g, w) and torch.equal(tc.s, oc.s)
    assert torch.equal(got, want)


@pytest.mark.parametrize("mixer,rules", [("mla", {"mlp": None}), ("rwkv6", {"mlp": None}),
                                         ("mamba", {"fsdp": "model"})])
def test_a_split_that_cannot_align_raises(mixer, rules):
    """Rules that split the heads (or d_inner) but not ``wo``'s rows, the
    RWKV gate, or Mamba's ``in_proj`` halves with them raise, naming the
    mixer; nothing falls back to the whole path."""
    _, cfg, _, desc, _, full, where = _layer(mixer)
    x = torch.as_tensor(_x(4, B, S, cfg.d_model))
    with axis_rules(_mesh(2), dict(SINGLE_POD_RULES, **rules)):
        with pytest.raises(ValueError, match=mixer):
            _apply(_mixer_of(full, where), x, cfg, desc, pos=torch.arange(S))


# ---- the reduced cards ---------------------------------------------------------------------
@pytest.mark.parametrize("name", list(CARDS.values()))
def test_split_card_greedy_tokens_equal_the_reference(name):
    """The reduced card in the serving layout over (1, 2), every mixer
    split and its cache laid per position: greedy tokens equal to the
    reference's on one device."""
    jcfg, cfg, params, full = _weights(name)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (B, 4))
    want = np.asarray(j_serve.greedy_generate(params, jcfg, jnp.asarray(prompt, jnp.int32), 6))
    mesh = _mesh(2)
    with axis_rules(mesh):
        assert blocks.split_mixers(cfg) == {d.mixer for p, _ in cfg.layer_list for d in p}
        got = serve_step.greedy_generate(lm.place_params(full, cfg, mesh), cfg,
                                         torch.as_tensor(prompt), 6)
    assert got.tolist() == want.tolist()


def test_mla_ctx_parallel_decode_in_the_serving_layout():
    """The reduced DeepSeek-V2 in the serving layout over model = 4 (MLA's
    heads laid over it) decoding context-parallel, its latent cache in
    sequence tiles: each tile rebuilds every head with ``wuk`` and ``wuv``
    gathered whole, ``wuq`` and ``wo`` run column- and row-parallel; the
    logits against the reference's context-parallel decode on one device."""
    jcfg, cfg, params, full = _weights(CARDS["mla"])
    s_max, steps = 16, 6
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (B, steps))
    j_step_fn = jax.jit(lambda p, t, c, n: j_lm.apply_decode(p, t, c, n, jcfg, ctx_parallel=True))
    jc = j_lm.init_cache(jcfg, B, s_max, jnp.float32)
    mesh = _mesh(4)
    where = _layer("mla")[-1]
    with axis_rules(mesh):
        laid = lm.place_params(full, cfg, mesh)
        assert isinstance(_mixer_of(laid, where).wuk.w, Placed)
        tc = lm.init_cache(cfg, B, s_max, torch.float32, device="cpu", ctx_parallel=True)
        tiles = _cache_of(tc, where).k
        assert isinstance(tiles, Placed) and tiles.tiles[0, 3].shape[1] == s_max // 4
        for t in range(steps):
            jl, jc = j_step_fn(params, jnp.asarray(toks[:, t:t + 1], jnp.int32), jc, jnp.int32(t))
            tl, tc = lm.apply_decode(laid, torch.as_tensor(toks[:, t:t + 1]), tc, t, cfg,
                                     ctx_parallel=True)
            _close(tl, jl)


def test_jamba_mesh_train_step_over_data_2_model_2():
    """Jamba (reduced: Mamba, GQA and MoE layers in one pattern) over data=2,
    model=2: each data shard's positions compute their d_inner channels,
    heads, experts and vocabulary with tiles gathered along fsdp; loss and
    parameters after one step (read through the checkpoint tree, which
    gives ``in_proj`` back as (d, 2·d_inner)) against the reference's
    one-device step."""
    jcfg, cfg, params, model = _weights("jamba-v0.1-52b")
    j_cfg = j_opt.AdamWConfig(warmup_steps=1, total_steps=10)
    t_cfg = optimizer.AdamWConfig(warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(6)
    toks, labels = rng.integers(0, cfg.vocab, (4, S)), rng.integers(0, cfg.vocab, (4, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    p1, _, m1 = jax.jit(j_step.make_train_step(jcfg, j_cfg))(params, j_opt.adamw_init(
        params, j_cfg), jb)
    mesh = _mesh(2, data=2)
    placed, opt = train_step.place_train_state(model, cfg, t_cfg, mesh)
    step = train_step.make_mesh_train_step(cfg, t_cfg, mesh)
    placed, opt, m2 = step(placed, opt, {"tokens": torch.as_tensor(toks),
                                         "labels": torch.as_tensor(labels)})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < LOSS_ATOL, (m1["loss"], m2["loss"])
    got = lm_named(train_state_tree(placed, opt)["params"])  # in_proj back to (d, 2·d_inner)
    for k, w in lm_named(jax.tree.map(np.asarray, p1)).items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), atol=PARAM_ATOL, rtol=0, err_msg=k)


# ---- the work counter ----------------------------------------------------------------------
@pytest.mark.parametrize("mixer", ["mla", "mamba"])
def test_counter_splits_a_mixer_prefill(mixer):
    """One layer's prefill on meta tensors over model = 4, counted. MLA: the
    latents' and the rope key's products (``wdq``, ``wdkv``, ``wkr``) run
    on the first position, the rest splits by heads; each position sums
    B·S·d float32 bytes. Mamba: every product splits by channel, so each
    position does a quarter of one device's FLOPs, and sums x_proj's
    B·S·(dt_rank + 2N) bytes and out_proj's B·S·d."""
    _, cfg = _cfgs(CARDS[mixer])
    params = lm.init_params(cfg, device="meta")
    where = _layer(mixer)[-1]
    desc = cfg.layer_list[where[0]][0][int(where[1][1:])]
    x = torch.empty((B, S, cfg.d_model), device="meta")
    pos = torch.arange(S, device="meta")
    with WorkCounter() as one:
        _apply(_mixer_of(params, where), x, cfg, desc, pos=pos)
    total, n, d = one.flops, 4, cfg.d_model
    mesh = DecodeMesh(["meta"] * n, (1, n), ("data", "model"))
    with axis_rules(mesh):
        laid = _mixer_of(lm.place_params(params, cfg, mesh), where)
        with WorkCounter() as c:
            _apply(laid, x, cfg, desc, pos=pos)
    if mixer == "mla":
        whole = 2.0 * B * S * d * (cfg.q_lora_rank + cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        reduced = B * S * d * 4
    else:
        whole = 0.0
        reduced = B * S * (cfg.dt_rank + 2 * cfg.mamba_d_state + d) * 4
    assert len(c.tallies) == n
    for (_, m), t in c.tallies.items():
        want = (total - whole) / n + (whole if m == 0 else 0.0)
        assert sum(t.flops.values()) == pytest.approx(want, rel=1e-12), m
        assert dict(t.collective_bytes) == {"all-reduce": reduced}, m


def test_counter_replays_later_data_shards_exactly(monkeypatch):
    """Reduced Jamba's mesh train step on meta over data=4, model=2,
    counted: the step runs two data shards and adds the second's count at
    the other two's positions; every position's tally equals that of
    running all four."""
    _, cfg = _cfgs(CARDS["mamba"])
    mesh = DecodeMesh(["meta"] * 8, (4, 2), ("data", "model"))
    opt_cfg = optimizer.AdamWConfig()
    batch = {k: torch.empty((8, S), dtype=torch.int64, device="meta") for k in ("tokens", "labels")}

    def count():
        params, opt = train_step.place_train_state(lm.init_params(cfg, device="meta"), cfg,
                                                   opt_cfg, mesh)
        with WorkCounter() as c:
            train_step.make_mesh_train_step(cfg, opt_cfg, mesh)(params, opt, batch)
        return {pos: t.as_dict() for pos, t in c.tallies.items()}

    replayed = count()
    monkeypatch.setattr(train_step, "_shard_replay", lambda *a: None)
    assert replayed == count()

