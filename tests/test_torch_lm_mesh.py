"""The LM over a mesh against the reference, on the CPU: expert parallelism,
the context-parallel cache, the serve CLI's rules, the mesh train step and
the mesh ``TrainLoop``.

Reduced cards at float32 compute; weights made by the JAX
``lm.init_params`` and carried across by ``convert_lm_params``; inputs
made from a seed with numpy. Meshes are device lists that name the CPU
several times, so every split runs for real in one process. The reference
runs over a ``(1, 1)`` mesh whose axes are ``AxisType.Auto``: the installed
JAX makes ``Explicit`` meshes by default, under which the reference's
``shard`` constraints on an unsharded array assert instead of constraining
(the rules, and so the path each layer takes, are the same).

Tolerances: MoE outputs 1e-5 (float32 roundoff in the expert sums);
decode logits 1e-5 (the tiles' softmax partials are joined by the
flash-decode combine, the reference divides before its PV product); the
train step's loss 1e-4 and every parameter 2e-4, the reference's own in
``tests/test_distributed.py``.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs.base import get_config as j_get_config
from repro._unused.models import lm as j_lm
from repro._unused.models import moe as j_moe
from repro._unused.serve import serve_step as j_serve
from repro._unused.train import optimizer as j_opt
from repro._unused.train import train_step as j_step
from repro.sharding import rules as j_rules
from repro_torch.configs.base import get_config
from repro_torch.interop import convert_lm_params, lm_named
from repro_torch.launch import serve, train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch._unused.models import lm, moe
from repro_torch._unused.serve import serve_step
from repro_torch._unused.train import optimizer, train_step
from repro_torch.sharding.place import Placed
from repro_torch.sharding.rules import axis_rules

MOE_ATOL = 1e-5
DECODE_ATOL = 1e-5
LOSS_ATOL, PARAM_ATOL = 1e-4, 2e-4
MOE_CARDS = ("mixtral-8x22b", "deepseek-v2-236b", "jamba-v0.1-52b")


def _j_mesh():
    return jax.make_mesh((1, 1), ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def _cfgs(name, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


@functools.lru_cache(maxsize=None)
def _weights(name, **kw):
    jcfg, cfg = _cfgs(name, **kw)
    params = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.PRNGKey(0))
    model = convert_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    return jcfg, cfg, params, model


def _moe_layer(name):
    """The first MoE layer of the reduced card: (JAX ffn params, port MoE)."""
    jcfg, cfg, params, model = _weights(name)
    for gi, (pattern, _) in enumerate(cfg.layer_list):
        for i, desc in enumerate(pattern):
            if desc.ffn == "moe":
                jp = jax.tree.map(lambda a: a[0], params["groups"][gi][f"l{i}"]["ffn"])
                return jcfg, cfg, jp, model.groups[gi][0][f"l{i}"].ffn
    raise AssertionError(name)


def _j_moe(jp, x, jcfg, rules: bool):
    """The reference's ``moe_apply``, jitted, under a (1, 1) rule context or none."""
    with j_rules.axis_rules(_j_mesh()) if rules else contextlib.nullcontext():
        return np.asarray(jax.jit(lambda p, x_: j_moe.moe_apply(p, x_, jcfg))(jp, jnp.asarray(x)))


def _x(cfg, B=2, S=16, seed=0):
    return np.random.default_rng(seed).normal(size=(B, S, cfg.d_model)).astype(np.float32)


# ---- expert parallelism --------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE_CARDS)
def test_ep_on_one_device_equals_the_reference(name):
    """Under the rules of a (1, 1) mesh both packages take the EP path,
    whose routing group is all B·S tokens; on this input it drops other
    entries than the per-row dense path, so the outputs differ from it."""
    jcfg, cfg, jp, tp = _moe_layer(name)
    x = _x(cfg)
    j_ep, j_dense = _j_moe(jp, x, jcfg, True), _j_moe(jp, x, jcfg, False)
    assert np.abs(j_ep - j_dense).max() > 0.1  # the divergence the CLIs had
    with axis_rules(make_local_mesh(devices=["cpu"])):
        assert moe._ep_enabled(cfg) == "model"
        t_ep = moe.moe_apply(tp, torch.as_tensor(x), cfg).numpy()
    t_dense = moe.moe_apply(tp, torch.as_tensor(x), cfg).numpy()
    np.testing.assert_allclose(t_ep, j_ep, atol=MOE_ATOL, rtol=0)
    np.testing.assert_allclose(t_dense, j_dense, atol=MOE_ATOL, rtol=0)


@pytest.mark.parametrize("name", MOE_CARDS)
def test_ep_over_data_2_model_2(name):
    """Over data=2, model=2 of four CPU entries each data shard routes its
    own rows and each model shard computes half the experts: the result is
    the reference's (1, 1) EP applied to each half of the batch."""
    jcfg, cfg, jp, tp = _moe_layer(name)
    x = _x(cfg)
    want = np.concatenate([_j_moe(jp, h, jcfg, True) for h in (x[:1], x[1:])])
    with axis_rules(make_local_mesh(data=2, model=2, devices=["cpu"] * 4)):
        got = moe.moe_apply(tp, torch.as_tensor(x), cfg).numpy()
        load = moe.ep_load(tp, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got, want, atol=MOE_ATOL, rtol=0)
    assert [d["coords"] for d in load] == [{"data": 0}, {"data": 1}]
    k = cfg.top_k
    assert all(sum(d["kept"]) + sum(d["dropped"]) == 16 * k and len(d["kept"]) == 2
               for d in load)


def test_ep_disabled_where_experts_do_not_divide():
    _, cfg, _, tp = _moe_layer("mixtral-8x22b")  # 4 experts
    x = torch.as_tensor(_x(cfg))
    with axis_rules(make_local_mesh(data=1, model=3, devices=["cpu"] * 3)):
        assert moe._ep_enabled(cfg) is None
        got = moe.moe_apply(tp, x, cfg)
        with pytest.raises(ValueError, match="expert parallelism"):
            moe.ep_load(tp, x, cfg)
    torch.testing.assert_close(got, moe.moe_apply(tp, x, cfg), rtol=0, atol=0)


# ---- the context-parallel cache ------------------------------------------------------------
DECODE_CARDS = {  # GQA, sliding-window GQA (a ring of 8 slots, 2 per tile), MLA
    "minitron-8b": dict(n_layers=2),
    "starcoder2-3b": dict(n_layers=2, sliding_window=8),
    "deepseek-v2-236b": dict(n_layers=2),
}


@pytest.mark.parametrize("name", sorted(DECODE_CARDS))
def test_ctx_parallel_decode_over_model_4(name):
    jcfg, cfg, params, model = _weights(name, **DECODE_CARDS[name])
    B, s_max, steps = 2, 16, 12
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (B, steps))
    j_step_fn = jax.jit(lambda p, t, c, n: j_lm.apply_decode(p, t, c, n, jcfg, ctx_parallel=True))
    jc = j_lm.init_cache(jcfg, B, s_max, jnp.float32)
    with axis_rules(make_local_mesh(data=1, model=4, devices=["cpu"] * 4)):
        tc = lm.init_cache(cfg, B, s_max, torch.float32, device="cpu", ctx_parallel=True)
        leaf = tc["groups"][0][0]["l0"]["mixer"].k
        assert isinstance(leaf, Placed) and leaf.tiles.shape == (1, 4)
        assert tuple(leaf.tiles[0, 3].shape)[1] == leaf.shape[1] // 4
        err = 0.0
        for t in range(steps):
            jl, jc = j_step_fn(params, jnp.asarray(toks[:, t:t + 1], jnp.int32), jc, jnp.int32(t))
            tl, tc = lm.apply_decode(model, torch.as_tensor(toks[:, t:t + 1]), tc, t, cfg,
                                     ctx_parallel=True)
            err = max(err, float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    assert err <= DECODE_ATOL, err
    # the tiles hold the reference's cache
    j_leaf = np.asarray(jc["groups"][0]["l0"]["mixer"].k[0])
    np.testing.assert_allclose(leaf.full("cpu").numpy(), j_leaf, atol=1e-6, rtol=0)


def test_decode_step_turns_ctx_parallel_on_at_the_threshold(monkeypatch):
    _, cfg = _cfgs("minitron-8b", n_layers=1)
    assert serve_step.CTX_PARALLEL_THRESHOLD == j_serve.CTX_PARALLEL_THRESHOLD == 32768
    assert serve_step.make_decode_step(cfg, 32768).ctx_parallel
    assert not serve_step.make_decode_step(cfg, 32767).ctx_parallel
    seen = []
    real = lm.apply_decode
    monkeypatch.setattr(lm, "apply_decode",
                        lambda *a, **k: seen.append(k["ctx_parallel"]) or real(*a, **k))
    model = lm.init_params(cfg, device="cpu")
    with axis_rules(make_local_mesh(data=1, model=2, devices=["cpu"] * 2)):
        cache = lm.init_cache(cfg, 1, 32768, torch.float32, device="cpu", ctx_parallel=True)
        assert isinstance(cache["groups"][0][0]["l0"]["mixer"].v, Placed)
        serve_step.make_decode_step(cfg, 32768)(model, torch.zeros((1, 1), dtype=torch.long),
                                                cache, 0)
    assert seen == [True]


# ---- the serve CLI under the rules -----------------------------------------------------------
def _j_cli_tokens(cfg, params, prompt, new, rules: bool):
    """The reference CLI's loop (``repro.launch.serve``) on given weights."""
    B, P = prompt.shape
    s_max = P + new
    with j_rules.axis_rules(_j_mesh()) if rules else contextlib.nullcontext():
        cache = j_lm.init_cache(cfg, B, s_max)
        step = jax.jit(j_serve.make_decode_step(cfg, s_max))
        prompt = jnp.asarray(prompt, jnp.int32)
        for t in range(P):
            nxt, cache = step(params, prompt[:, t:t + 1], cache, jnp.int32(t))
        tok, outs = nxt[:, None], []
        for t in range(new):
            outs.append(tok)
            nxt, cache = step(params, tok, cache, jnp.int32(P + t))
            tok = nxt[:, None]
    return np.asarray(jnp.concatenate(outs, axis=1))


def test_serve_cli_loop_gives_the_reference_cli_tokens():
    """Mixtral ``.reduced()`` at the CLI's own settings (its weights, batch 4,
    a 16-token prompt from ``default_rng(0)``), 16 new tokens: the port's
    CLI loop under ``axis_rules(make_local_mesh())`` gives the reference
    CLI's greedy tokens; without the rules (the dense MoE path) the tokens
    differ, as the port's CLI's did before it ran under the rules."""
    jcfg = j_get_config("mixtral-8x22b").reduced()
    cfg = get_config("mixtral-8x22b").reduced()
    params = jax.jit(lambda k: j_lm.init_params(k, jcfg))(jax.random.PRNGKey(0))
    model = convert_lm_params(jax.tree.map(np.asarray, params), cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab, (4, 16))
    want = _j_cli_tokens(jcfg, params, prompt, 16, rules=True)
    got, _ = serve.generate(cfg, model, torch.as_tensor(prompt), 16,
                            make_local_mesh(devices=["cpu"]))
    np.testing.assert_array_equal(got.numpy(), want)
    dense = serve_step.greedy_generate(model, cfg, torch.as_tensor(prompt), 16)
    assert (dense.numpy() != want).sum() > 0
    np.testing.assert_array_equal(dense.numpy(), _j_cli_tokens(jcfg, params, prompt, 16, False))


def test_serve_cli_runs_under_the_rules(monkeypatch, capsys):
    seen = []
    real = moe._moe_apply_ep
    monkeypatch.setattr(moe, "_moe_apply_ep", lambda *a: seen.append(a[3]) or real(*a))
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "mixtral-8x22b", "--device", "cpu",
                                     "--batch", "2", "--prompt-len", "2", "--new-tokens", "2"])
    serve.main()
    assert " on CPU: 4 tokens in " in capsys.readouterr().out
    assert seen and set(seen) == {"model"}  # every MoE layer took the EP path


# ---- training over a mesh ----------------------------------------------------------------------
def _train_batch(cfg, B=8, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab, (B, S)), rng.integers(0, cfg.vocab, (B, S)))


def _compare_step(name, mesh, *, j_rules_on, compress=False, **kw):
    jcfg, cfg, params, model = _weights(name, **kw)
    j_cfg = j_opt.AdamWConfig(warmup_steps=1, total_steps=10)
    t_cfg = optimizer.AdamWConfig(warmup_steps=1, total_steps=10)
    toks, labels = _train_batch(cfg)
    jb = {"tokens": jnp.asarray(toks, jnp.int32), "labels": jnp.asarray(labels, jnp.int32)}
    with j_rules.axis_rules(_j_mesh()) if j_rules_on else contextlib.nullcontext():
        p1, _, m1 = jax.jit(j_step.make_train_step(jcfg, j_cfg, compress_grads=compress))(
            params, j_opt.adamw_init(params, j_cfg), jb)
    placed, opt = train_step.place_train_state(model, cfg, t_cfg, mesh)
    step = train_step.make_mesh_train_step(cfg, t_cfg, mesh, compress_grads=compress)
    placed, opt, m2 = step(placed, opt, {"tokens": torch.as_tensor(toks),
                                         "labels": torch.as_tensor(labels)})
    assert abs(float(m1["loss"]) - float(m2["loss"])) < LOSS_ATOL, (m1["loss"], m2["loss"])
    want = lm_named(jax.tree.map(np.asarray, p1))
    assert set(want) == set(placed)
    for k, w in want.items():
        np.testing.assert_allclose(placed[k].full("cpu").detach().numpy(), w.numpy(),
                                   atol=PARAM_ATOL, rtol=0, err_msg=k)
    return placed, opt


def test_mesh_train_step_matches_single_device():
    """The reference's ``test_sharded_train_step_matches_single_device``:
    minitron ``.reduced()`` in float32, one step on data=4, model=2 against
    the reference's single-device step."""
    mesh = make_local_mesh(data=4, model=2, devices=["cpu"] * 8)
    placed, opt = _compare_step("minitron-8b", mesh, j_rules_on=False)
    w = placed["groups.0.0.l0.mixer.wq.w"]
    assert w.tiles.shape == (4, 2) and w.sharding.spec[0] == "data"  # FSDP over data
    assert int(opt.step) == 1 and isinstance(opt.m["embed.table"], Placed)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "compress_grads"])
def test_mesh_train_step_moe_under_the_rules(compress):
    """Mixtral ``.reduced()`` over data=1, model=2 (EP: two experts per
    model shard) against the reference's step under a (1, 1) rule context,
    with and without the int8 round trip on the summed gradients."""
    mesh = make_local_mesh(data=1, model=2, devices=["cpu"] * 2)
    _compare_step("mixtral-8x22b", mesh, j_rules_on=True, compress=compress)


def test_mesh_train_loop_restores_after_a_failure(tmp_path):
    """``TrainLoop`` over data=2 of two CPU entries: an injected failure at
    step 5 restores the step-4 checkpoint (gathered from the tiles, written
    in the reference's layout) into the tiles and the loop finishes."""
    cfg = get_config("starcoder2-3b").reduced()
    mesh = make_local_mesh(data=2, devices=["cpu"] * 2)
    loop = train.TrainLoop(cfg, optimizer.AdamWConfig(total_steps=8, warmup_steps=2), mesh,
                           ckpt_dir=tmp_path, global_batch=2, seq_len=16, ckpt_every=4)
    try:
        assert loop.sharded and isinstance(loop.params["embed.table"], Placed)
        log = loop.run(8, inject_failure_at=5)
        assert loop.step == 8 and log[-1]["step"] == 8 and np.isfinite(log[-1]["loss"])
        assert loop.ckpt.latest_step() == 8
        saved = loop.ckpt.restore(8, train.train_state_tree(loop.params, loop.opt_state,
                                                            device="meta"))
        for k, t in lm_named(saved["params"]).items():
            assert torch.equal(t, loop.params[k].full("cpu").detach()), k
    finally:
        loop.pipeline.close()
