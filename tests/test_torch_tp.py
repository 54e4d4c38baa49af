"""Tensor parallelism over the ``model`` axis against the reference, on the CPU.

Reduced cards at float32 compute; weights made by the JAX ``init_params``
(or a layer's ``*_init``) and carried across by ``convert_lm_params``;
inputs made from a seed with numpy. Meshes are device lists that name the
CPU several times, so every split runs for real in one process, through
the serving layout (``lm.place_params``: each position's slice laid once)
or a layer laid the same way. Each case is held against the reference on
one device and against the port's own one-device path.

Reduced cards have 4 heads of 16, ``kv_heads`` 2 and ``d_ff`` 128: over
``model`` = 2 the kv heads split (one per position, G_loc = 2), over 4 the
rules keep them whole (the divisibility fallback) and each position takes
the kv head its one q head belongs to (G_loc = 1).

Tolerances: 1e-5 on activations and logits (float32 roundoff in the sums
over positions, added in model order); the loss 1e-4 and the train step's
parameters 2e-4, the reference's own in ``tests/test_distributed.py``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro._unused.models import attention as j_attn
from repro._unused.models import layers as j_layers
from repro._unused.models import lm as j_lm
from repro._unused.models import moe as j_moe
from repro._unused.train import optimizer as j_opt
from repro._unused.train import train_step as j_step
from repro.sharding import rules as j_rules
from jax.sharding import AxisType
from repro_torch.configs.base import get_config
from repro_torch.interop import _leaves, convert_lm_params, lm_named
from repro_torch.launch.cost import WorkCounter
from repro_torch.launch.mesh import DecodeMesh, make_local_mesh
from repro_torch._unused.models import attention, blocks, layers, lm, moe
from repro_torch._unused.serve import serve_step
from repro_torch._unused.train import optimizer, train_step
from repro_torch.sharding.place import Placed
from repro_torch.sharding.rules import axis_rules, model_split

ATOL = 1e-5
LOSS_ATOL, PARAM_ATOL = 1e-4, 2e-4
B, S = 2, 16


def _cfgs(name, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(np.array(v)) for k, v in _leaves(tree)}, strict=True)
    return module


def _x(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mesh(model, data=1):
    return make_local_mesh(data=data, model=model, devices=["cpu"] * (data * model))


def _lay(module, axes: dict, cfg, mesh):
    """A layer's serving layout, as ``lm.place_params`` lays an LM
    (``lm.place_module``): each leaf that the split layers read per
    position laid over ``mesh`` by its logical axes with ``fsdp`` whole,
    the others as they are."""
    return lm.place_module(module, dict(lm._flat(axes)), cfg, mesh)


@functools.lru_cache(maxsize=None)
def _weights(name, **kw):
    jcfg, cfg = _cfgs(name, **kw)
    params = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.PRNGKey(0))
    return jcfg, cfg, params, convert_lm_params(_np(params), cfg, device="cpu")


def _all_reduces(counter) -> int:
    return sum(t.collective_counts.get("all-reduce", 0) for t in counter.tallies.values())


# ---- the rules ---------------------------------------------------------------------------
def test_model_split_follows_the_divisibility_fallback():
    with axis_rules(_mesh(4)):
        assert model_split(("fsdp", "kv_heads", "head_dim"), (64, 2, 16)) == (None, 1)
        assert model_split(("fsdp", "heads", "head_dim"), (64, 4, 16)) == (1, 4)
        assert model_split(("mlp", "fsdp"), (128, 64)) == (0, 4)
    with axis_rules(_mesh(2)):
        assert model_split(("fsdp", "kv_heads", "head_dim"), (64, 2, 16)) == (1, 2)
    assert model_split(("fsdp", "heads", "head_dim"), (64, 4, 16)) == (None, 1)  # no rules


# ---- the FFN -----------------------------------------------------------------------------
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("act,card", [("gelu", "starcoder2-3b"), ("relu2", "minitron-8b"),
                                      ("swiglu", "qwen2.5-32b"), ("rwkv_cm", "rwkv6-3b")])
def test_ffn_split_over_mlp(act, card, model):
    jcfg, cfg = _cfgs(card)
    assert cfg.ffn_act == act
    p = _np(j_layers.ffn_init(jax.random.PRNGKey(1), jcfg, cfg.d_ff))
    if act == "rwkv_cm":
        p["mu"] = np.random.default_rng(1).uniform(0, 1, p["mu"].shape).astype(np.float32)
    x, xp = _x(2, B, S, cfg.d_model), _x(3, B, S, cfg.d_model)
    x_prev = torch.as_tensor(xp) if act == "rwkv_cm" else None
    want = np.asarray(j_layers.ffn_apply(p, jnp.asarray(x), jcfg,
                                         x_prev=None if x_prev is None else jnp.asarray(xp)))
    module = _load(layers.ffn_init(cfg, cfg.d_ff, device="cpu"), p)
    one = layers.ffn_apply(module, torch.as_tensor(x), cfg, x_prev=x_prev)
    mesh = _mesh(model)
    with axis_rules(mesh), WorkCounter(target="cpu") as c:
        laid = _lay(module, layers.ffn_axes(cfg), cfg, mesh)
        got = layers.ffn_apply(laid, torch.as_tensor(x), cfg, x_prev=x_prev)
    w_in = laid.wk if act == "rwkv_cm" else laid.wi
    assert tuple(w_in.w.tiles[0, model - 1].shape) == (cfg.d_model, cfg.d_ff // model)
    assert _all_reduces(c) == model  # one sum per FFN, recorded at each position
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


# ---- GQA ---------------------------------------------------------------------------------
@pytest.mark.parametrize("model,g_loc", [(2, 2), (4, 1)], ids=["kv_split", "kv_fallback"])
@pytest.mark.parametrize("kind", ["self", "cross"])
def test_gqa_prefill_split_over_heads(kind, model, g_loc, monkeypatch):
    """Each position launches the flash wrapper (its plain version here) on
    its own heads: contiguous q (B, S, 1, G_loc, dh), k and v (B, T, 1, dh)."""
    jcfg, cfg = _cfgs("seamless-m4t-medium" if kind == "cross" else "starcoder2-3b")
    p = _np(j_attn.gqa_init(jax.random.PRNGKey(4), jcfg))
    x, xa = _x(4, B, S, cfg.d_model), _x(5, B, 12, cfg.d_model)
    pos = np.arange(S)
    kw = dict(causal=kind == "self", xa=None if kind == "self" else jnp.asarray(xa))
    want, _ = j_attn.gqa_apply(p, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), **kw)
    module = _load(attention.gqa_init(cfg, device="cpu"), p)
    tkw = dict(causal=kind == "self", xa=None if kind == "self" else torch.as_tensor(xa))
    one, _ = attention.gqa_apply(module, torch.as_tensor(x), cfg, positions=torch.as_tensor(pos),
                                 **tkw)
    shapes = []
    real = attention.flash_attention

    def seen(q, k, v, **kwargs):
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        shapes.append(tuple(q.shape))
        return real(q, k, v, **kwargs)

    monkeypatch.setattr(attention, "flash_attention", seen)
    mesh = _mesh(model)
    with axis_rules(mesh), attention.flash_enabled("on"):
        laid = _lay(module, attention.gqa_axes(cfg), cfg, mesh)
        got, _ = attention.gqa_apply(laid, torch.as_tensor(x), cfg,
                                     positions=torch.as_tensor(pos), **tkw)
    assert shapes == [(B, S, 1, g_loc, cfg.head_dim)] * model
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("model", [2, 4])
def test_cross_decode_against_a_prefilled_cache(model):
    """The decoder's cached cross-attention: each position reads its kv
    heads of the whole encoder K/V; equal to the one-device step."""
    _, cfg = _cfgs("seamless-m4t-medium")
    module = attention.gqa_init(cfg, gen=torch.Generator().manual_seed(6), device="cpu")
    x = torch.as_tensor(_x(7, B, 1, cfg.d_model))
    kv = attention.KVCache(*(torch.as_tensor(_x(s, B, 12, cfg.n_kv_heads, cfg.head_dim))
                             for s in (8, 9)))
    pos = torch.zeros(1, dtype=torch.long)
    one, _ = attention.gqa_apply(module, x, cfg, positions=pos, causal=False, cache=kv,
                                 kv_cached=True)
    mesh = _mesh(model)
    with axis_rules(mesh):
        got, _ = attention.gqa_apply(_lay(module, attention.gqa_axes(cfg), cfg, mesh), x, cfg,
                                     positions=pos, causal=False, cache=kv, kv_cached=True)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


@pytest.mark.parametrize("model", [2, 4])
def test_split_decode_and_greedy_tokens(model):
    """StarCoder2 (reduced, 2 layers) decoded over the serving layout with
    the cache as kv_heads tiles: every step's logits against the
    reference's one-device decode, and greedy tokens equal to it."""
    jcfg, cfg, params, full = _weights("starcoder2-3b", n_layers=2)
    steps, s_max = 8, 12
    toks = np.random.default_rng(10).integers(0, cfg.vocab, (B, steps))
    j_step_fn = jax.jit(lambda p, t, c, n: j_lm.apply_decode(p, t, c, n, jcfg))
    jc = j_lm.init_cache(jcfg, B, s_max, jnp.float32)
    mesh = _mesh(model)
    err = 0.0
    with axis_rules(mesh):
        laid = lm.place_params(full, cfg, mesh)
        tc = lm.init_cache(cfg, B, s_max, torch.float32, device="cpu")
        k = tc["groups"][0][0]["l0"]["mixer"].k
        assert isinstance(k, Placed) and k.tiles.shape == (1, model)
        assert k.tiles[0, 0].shape[2] == (1 if model == 2 else cfg.n_kv_heads)
        for t in range(steps):
            jl, jc = j_step_fn(params, jnp.asarray(toks[:, t:t + 1], jnp.int32), jc, jnp.int32(t))
            tl, tc = lm.apply_decode(laid, torch.as_tensor(toks[:, t:t + 1]), tc, t, cfg)
            err = max(err, float(np.abs(np.asarray(jl) - tl.numpy()).max()))
        got = serve_step.greedy_generate(laid, cfg, torch.as_tensor(toks[:, :4]), 6)
    assert err <= ATOL, err
    want = serve_step.greedy_generate(full, cfg, torch.as_tensor(toks[:, :4]), 6)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- the vocabulary ----------------------------------------------------------------------
@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("name", ["starcoder2-3b", "minitron-8b"], ids=["tied", "untied"])
def test_vocab_parallel_embedding_and_logits(name, model):
    jcfg, cfg, params, full = _weights(name, n_layers=2)
    assert cfg.tie_embeddings == (name == "starcoder2-3b")
    toks = np.random.default_rng(11).integers(0, cfg.vocab, (B, S))
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(toks, jnp.int32)))
    tt = torch.as_tensor(toks)
    emb1 = lm._embed_tokens(full, tt, cfg)
    mesh = _mesh(model)
    with axis_rules(mesh):
        laid = lm.place_params(full, cfg, mesh)
        emb = lm._embed_tokens(laid, tt, cfg)
        shards = lm.apply_train(laid, {"tokens": tt}, cfg, vocab_shards=True)
        got = lm.apply_train(laid, {"tokens": tt}, cfg)
    assert torch.equal(emb, emb1)  # one row is not zero: the sum is exact
    assert laid.embed.table.tiles[0, model - 1].shape[0] * model == full.embed.table.shape[0]
    assert [s.shape[-1] for s in shards] == [want.shape[-1] // model] * model
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(torch.cat(shards, -1).numpy(), got.numpy(), atol=0, rtol=0)


def test_greedy_argmax_over_vocab_shards_takes_the_lower_index_on_a_tie():
    g = torch.Generator().manual_seed(12)
    logits = torch.randn((3, 8), generator=g)
    logits[0, 2] = logits[0, 6] = 9.0  # a tie across the two shards: index 2 wins
    logits[1, 5] = 9.0  # the second shard's max wins
    logits[2, 4] = logits[2, 5] = 9.0  # a tie inside the second shard: index 4 wins
    got = serve_step.vocab_argmax([logits[:, :4], logits[:, 4:]])
    assert got.tolist() == [2, 5, 4]
    assert torch.equal(got, torch.argmax(logits, -1).to(torch.int32))


def test_split_prefill_step_gives_the_one_device_tokens():
    _, cfg, _, full = _weights("starcoder2-3b", n_layers=2)
    toks = torch.as_tensor(np.random.default_rng(13).integers(0, cfg.vocab, (B, S)))
    step = serve_step.make_prefill_step(cfg)
    want = step(full, {"tokens": toks})
    for model in (2, 4):
        mesh = _mesh(model)
        with axis_rules(mesh):
            assert torch.equal(step(lm.place_params(full, cfg, mesh), {"tokens": toks}), want)


@pytest.mark.parametrize("model", [2, 4])
def test_vocab_parallel_loss(model):
    jcfg, cfg, params, full = _weights("starcoder2-3b", n_layers=2)
    rng = np.random.default_rng(14)
    toks, labels = rng.integers(0, cfg.vocab, (B, S)), rng.integers(0, cfg.vocab, (B, S))
    want = float(jax.jit(lambda p, b: j_step.loss_fn(p, b, jcfg))(
        params, {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}))
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)}
    one = float(train_step.loss_fn(full, batch, cfg))
    mesh = _mesh(model)
    with axis_rules(mesh), WorkCounter(target="cpu") as c:
        got = float(train_step.loss_fn(lm.place_params(full, cfg, mesh), batch, cfg))
    assert abs(got - want) <= LOSS_ATOL and abs(got - one) <= LOSS_ATOL, (got, want, one)
    # the max, the sum of exps and the label's logit: three reductions over the positions
    assert c.tallies[(0, model - 1)].collective_counts["all-reduce"] == 3 + 1 + 2 * 2


# ---- MoE ---------------------------------------------------------------------------------
def _moe_layer():
    jcfg, cfg, params, full = _weights("mixtral-8x22b")
    jp = jax.tree.map(lambda a: a[0], params["groups"][0]["l0"]["ffn"])
    return jcfg, cfg, jp, full.groups[0][0]["l0"].ffn


def test_moe_experts_at_rest_over_model_2():
    """Expert parallelism over the serving layout: each position computes
    with the two experts that rest on it (its tile, not a copy), equal to
    the reference's expert-parallel path on one device."""
    jcfg, cfg, jp, tp = _moe_layer()
    x = _x(15, B, S, cfg.d_model)
    with j_rules.axis_rules(jax.make_mesh((1, 1), ("data", "model"),
                                          axis_types=(AxisType.Auto,) * 2)):
        want = np.asarray(jax.jit(lambda p, x_: j_moe.moe_apply(p, x_, jcfg))(jp, jnp.asarray(x)))
    mesh = _mesh(2)
    with axis_rules(mesh):
        laid = _lay(tp, moe.moe_axes(cfg), cfg, mesh)
        assert moe._ep_enabled(cfg) == "model"
        assert laid.wi.tiles[0, 1].data_ptr() == tp.wi[2:].data_ptr()  # a view: at rest
        with WorkCounter(target="cpu") as c:
            got = moe.moe_apply(laid, torch.as_tensor(x), cfg)
    assert not any("all-gather" in t.collective_bytes for t in c.tallies.values())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_moe_tensor_parallel_within_an_expert_over_model_8():
    """4 experts do not divide 8 positions: the dense path with each
    position's eighth of ``d_ff_expert`` (64 → 8), one sum, against the
    reference's dense path."""
    jcfg, cfg, jp, tp = _moe_layer()
    x = _x(16, B, S, cfg.d_model)
    want = np.asarray(jax.jit(lambda p, x_: j_moe.moe_apply(p, x_, jcfg))(jp, jnp.asarray(x)))
    one = moe.moe_apply(tp, torch.as_tensor(x), cfg)
    mesh = _mesh(8)
    with axis_rules(mesh), WorkCounter(target="cpu") as c:
        laid = _lay(tp, moe.moe_axes(cfg), cfg, mesh)
        assert moe._ep_enabled(cfg) is None
        assert tuple(laid.wi.tiles[0, 7].shape) == (4, cfg.d_model, 8)
        got = moe.moe_apply(laid, torch.as_tensor(x), cfg)
    assert _all_reduces(c) == 8
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got.numpy(), one.numpy(), atol=ATOL, rtol=0)


def test_shared_experts_split_over_mlp():
    _, cfg = _cfgs("deepseek-v2-236b")
    full = lm.init_params(cfg, generator=torch.Generator().manual_seed(17), device="cpu")
    layer = next(l["l0"] for g in full.groups for l in g if isinstance(l["l0"].ffn, moe.MoE))
    x = torch.as_tensor(_x(17, B, S, cfg.d_model))
    with axis_rules(make_local_mesh(devices=["cpu"])):
        want = moe.moe_apply(layer.ffn, x, cfg)
    mesh = _mesh(2)
    with axis_rules(mesh):
        laid = _lay(layer.ffn, moe.moe_axes(cfg), cfg, mesh)
        assert laid.shared.wi.w.tiles[0, 1].shape[1] == layer.ffn.shared.wi.w.shape[1] // 2
        got = moe.moe_apply(laid, x, cfg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL, rtol=0)


# ---- the unsplit mixers -------------------------------------------------------------------
@pytest.mark.parametrize("name", ["deepseek-v2-236b", "jamba-v0.1-52b", "rwkv6-3b"])
def test_unsplit_mixers_keep_their_values(name):
    """MLA, Mamba and RWKV-6's time mix under a (1, 1) mesh and under a
    model axis of 3, which divides neither their 4 heads nor d_inner 128:
    the whole layer on the first position, bit for bit the one-device
    mixer (they split over model = 2 and 4 in ``test_torch_tp_mixers.py``)."""
    _, cfg = _cfgs(name)
    full = lm.init_params(cfg, generator=torch.Generator().manual_seed(18), device="cpu")
    mixers = [(layer[f"l{i}"].mixer, desc) for group, (pattern, _) in
              zip(full.groups, cfg.layer_list) for layer in group[:1]
              for i, desc in enumerate(pattern) if desc.mixer != "gqa"]
    x = torch.as_tensor(_x(18, B, S, cfg.d_model))
    pos = torch.arange(S)
    assert mixers
    for mixer, desc in mixers:
        def run():
            return blocks._apply_mixer(mixer, x, cfg, desc, positions=pos, cache=None,
                                       cache_len=None, causal=True, ctx_parallel=False)[0]

        want = run()
        for model in (1, 3):
            with axis_rules(_mesh(model)):
                assert not blocks.split_mixers(cfg) - {"gqa"}
                got = run()
            assert torch.equal(got, want), (type(mixer).__name__, model)


# ---- the mesh train step -------------------------------------------------------------------
def test_mesh_train_step_over_data_2_model_2():
    """StarCoder2 (reduced, 2 layers) over data=2, model=2: each data shard's
    positions compute their heads, MLP columns and vocabulary with tiles
    gathered along fsdp only; loss and parameters after one step against
    the reference's one-device step."""
    jcfg, cfg, params, model = _weights("starcoder2-3b", n_layers=2)
    j_cfg = j_opt.AdamWConfig(warmup_steps=1, total_steps=10)
    t_cfg = optimizer.AdamWConfig(warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(19)
    toks, labels = rng.integers(0, cfg.vocab, (4, S)), rng.integers(0, cfg.vocab, (4, S))
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    p1, _, m1 = jax.jit(j_step.make_train_step(jcfg, j_cfg))(params, j_opt.adamw_init(
        params, j_cfg), jb)
    mesh = _mesh(2, data=2)
    placed, opt = train_step.place_train_state(model, cfg, t_cfg, mesh)
    assert placed["groups.0.0.l0.mixer.wq.w"].sharding.spec[:2] == ("data", "model")
    step = train_step.make_mesh_train_step(cfg, t_cfg, mesh)
    placed, opt, m2 = step(placed, opt, {"tokens": torch.as_tensor(toks),
                                         "labels": torch.as_tensor(labels)})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < LOSS_ATOL, (m1["loss"], m2["loss"])
    for k, w in lm_named(_np(p1)).items():
        np.testing.assert_allclose(placed[k].full("cpu").detach().numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)


# ---- the work counter ----------------------------------------------------------------------
@pytest.mark.parametrize("model", [2, 4])
def test_counter_splits_a_prefill(model):
    """StarCoder2 (reduced, 2 layers) prefill on meta tensors, counted. Over
    model = 2 every product splits: each position does one device's FLOPs
    / 2. Over model = 4 the kv heads stay whole and each position projects
    the one kv head it reads, so a position's FLOPs are (one device's −
    the k and v projections') / 4 + the projections' / 2 (Hkv = 2). Every
    position receives (1 + 2·layers)·B·S·d·4 bytes of all-reduce: the
    embedding's sum and, per layer, the attention's and the FFN's; no
    all-gather (the serving layout gathers no weight)."""
    _, cfg = _cfgs("starcoder2-3b", n_layers=2)
    params = lm.init_params(cfg, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int64, device="meta")}
    step = serve_step.make_prefill_step(cfg)
    with WorkCounter() as one:
        step(params, batch)
    total = one.flops
    kv = 2 * cfg.n_layers * 2.0 * B * S * cfg.d_model * cfg.n_kv_heads * cfg.head_dim
    mesh = DecodeMesh(["meta"] * model, (1, model), ("data", "model"))
    with axis_rules(mesh), WorkCounter() as c:
        step(lm.place_params(params, cfg, mesh), batch)
    want = total / 2 if model == 2 else (total - kv) / 4 + kv / 2
    reduce_bytes = (1 + 2 * cfg.n_layers) * B * S * cfg.d_model * 4
    assert len(c.tallies) == model
    for pos, t in c.tallies.items():
        assert sum(t.flops.values()) == pytest.approx(want, rel=1e-12), pos
        assert dict(t.collective_bytes) == {"all-reduce": reduce_bytes}, pos
