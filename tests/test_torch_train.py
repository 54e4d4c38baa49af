"""The port's training path against the JAX package, on the CPU: the loss and
its gradients, the flash ``autograd.Function``, AdamW, gradient
compression, the synthetic stream, checkpoints (and checkpoints across the
two packages) and the ``TrainLoop`` with failure recovery.

Reduced cards at float32 compute, weights made by the JAX
``lm.init_params`` and carried across by ``convert_lm_params``, the same
numpy batches. Tolerances: loss 1e-5 and gradients 1e-5 absolute plus 1e-4
of each leaf's largest entry (float32 roundoff through a few layers and the
backward, whose sums run in another order); one train step's parameters
1e-6 wherever the two gradients agree to 1 % (the first step moves each by
lr · g / (|g| + eps), about lr · sign(g)) and 2·lr where the gradient is
roundoff; the flash function's gradients 2e-3 against
the reference (both backwards store the probabilities in bf16, whose
rounding may fall differently where the two forwards differ by a float32
ulp) and bit-equal to autograd through the port's own streaming softmax;
AdamW alone 1e-6 relative; compression, the stream and checkpoints exact.
"""

import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro._unused.models import attention as j_attn
from repro._unused.models import lm as j_lm
from repro._unused.train import checkpoint as j_ckpt
from repro._unused.train import compression as j_comp
from repro._unused.train import data as j_data
from repro._unused.train import optimizer as j_opt
from repro._unused.train import train_step as j_step
from repro_torch.configs.base import get_config
from repro_torch.interop import convert_lm_params, lm_tree
from repro_torch.launch import train
from repro_torch._unused.models import attention, lm
from repro_torch._unused.train import checkpoint, compression, data, optimizer, train_step

B, S = 2, 32
CARDS = {  # a dense card, the enc-dec card, a MoE card
    "starcoder2-3b": dict(n_layers=2),
    "seamless-m4t-medium": {},
    "mixtral-8x22b": {},
}


def _cfgs(name, **kw):
    kw = {**CARDS.get(name, {}), "compute_dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.encdec:
        batch["frames"] = rng.normal(size=(B, 24, cfg.d_model)).astype(np.float32)
    return batch


def _tb(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _close_trees(got: dict, want, atol, rtol_of_max):
    flat_w = jax.tree_util.tree_flatten_with_path(_np(want))[0]
    flat_g = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), got))[0]
    assert [k for k, _ in flat_g] == [k for k, _ in flat_w]
    for (key, w), (_, g) in zip(flat_w, flat_g):
        np.testing.assert_allclose(g, w, atol=atol + rtol_of_max * np.abs(w).max(), rtol=0,
                                   err_msg=jax.tree_util.keystr(key))


# ---- the loss and its gradients ---------------------------------------------------------
@pytest.mark.parametrize("name", list(CARDS))
def test_loss_and_grads_match_jax(name):
    jcfg, cfg = _cfgs(name)
    params = j_lm.init_params(jax.random.PRNGKey(5), jcfg)
    batch = _batch(cfg, 5)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: j_step.loss_fn(p, b, jcfg)))(params, jax.tree.map(jnp.asarray, batch))
    model = convert_lm_params(_np(params), cfg, device="cpu").requires_grad_(True)
    leaves = dict(model.named_parameters())
    loss = train_step.loss_fn(model, _tb(batch), cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=1e-5)
    _close_trees(lm_tree(grads), jgrads, 1e-5, 1e-4)


def test_loss_mask():
    _, cfg = _cfgs("starcoder2-3b")
    model = lm.init_params(cfg, device="cpu")
    batch = _tb(_batch(cfg, 6))
    mask = torch.zeros((B, S))
    mask[:, :5] = 1
    with torch.no_grad():
        logits = lm.apply_train(model, batch, cfg)
        nll = torch.logsumexp(logits, -1) - logits.gather(-1, batch["labels"][..., None].long())[
            ..., 0]
        got = train_step.loss_fn(model, {**batch, "loss_mask": mask}, cfg)
    torch.testing.assert_close(got, nll[:, :5].mean(), atol=1e-6, rtol=1e-6)


def test_layers_are_recomputed_under_a_gradient(monkeypatch):
    """With grad enabled each layer (and each encoder layer) runs under
    ``torch.utils.checkpoint``; under ``no_grad`` none does,
    ``make_prefill_step`` serves under ``no_grad``, and with grad enabled a
    module whose parameters require none (serving's) does not checkpoint."""
    _, cfg = _cfgs("seamless-m4t-medium")
    model = lm.init_params(cfg, device="cpu").requires_grad_(True)
    calls = []
    real = lm.checkpoint
    monkeypatch.setattr(lm, "checkpoint", lambda *a, **k: calls.append(k) or real(*a, **k))
    batch = _tb(_batch(cfg, 7))
    loss = train_step.loss_fn(model, batch, cfg)
    assert len(calls) == cfg.n_layers + cfg.n_encoder_layers
    assert all(k == {"use_reentrant": False, "preserve_rng_state": False} for k in calls)
    loss.backward()
    assert model.encoder[0]["l0"].mixer.wq.w.grad is not None
    calls.clear()
    from repro_torch._unused.serve.serve_step import make_prefill_step

    make_prefill_step(cfg)(model, batch)
    serving = lm.init_params(cfg, device="cpu")
    assert calls == [] and not serving.embed.table.requires_grad
    assert torch.is_grad_enabled() and not lm.apply_train(serving, batch, cfg).requires_grad
    assert calls == []


@pytest.mark.parametrize("mesh", [None, (2, 1)])
@pytest.mark.parametrize("name", ["starcoder2-3b", "mixtral-8x22b"])
def test_remat_dots_gives_full_remats_gradients(monkeypatch, name, mesh):
    """``REPRO_REMAT=dots`` keeps the products' outputs and recomputes the
    rest: the loss and every gradient equal full remat's bit for bit (the
    same ops on the same inputs), with the flash ``autograd.Function`` in
    the layers and, under a (2, 1) mesh's rules, the remat's rule context
    entered beside the policy; the step's FLOPs counted on meta
    (``launch/cost.py``) are below full remat's, and the default is full
    remat."""
    import contextlib

    from repro_torch.launch.cost import WorkCounter
    from repro_torch.launch.mesh import DecodeMesh
    from repro_torch.sharding.rules import axis_rules

    _, cfg = _cfgs(name)
    batch = _tb(_batch(cfg, 8))

    def run(mode, model, batch):
        if mode is None:
            monkeypatch.delenv("REPRO_REMAT", raising=False)
        else:
            monkeypatch.setenv("REPRO_REMAT", mode)
        rules = (axis_rules(DecodeMesh([model.embed.table.device] * 2, mesh, ("data", "model")))
                 if mesh else contextlib.nullcontext())
        with rules, attention.flash_enabled("on"):
            loss = train_step.loss_fn(model, batch, cfg)
            return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))

    model = lm.init_params(cfg, generator=torch.Generator().manual_seed(8),
                           device="cpu").requires_grad_(True)
    (l_full, g_full), (l_dots, g_dots) = run("full", model, batch), run("dots", model, batch)
    assert torch.equal(l_full, l_dots)
    assert all(torch.equal(a, b) for a, b in zip(g_full, g_dots))
    meta = lm.init_params(cfg, device="meta").requires_grad_(True)
    meta_batch = {k: v.to("meta") for k, v in batch.items()}
    flops = {}
    for mode in ("full", "dots", None):
        with WorkCounter() as c:
            run(mode, meta, meta_batch)
        flops[mode] = c.flops
    assert flops["dots"] < flops["full"] == flops[None]


def test_cast_params_for_compute():
    """bf16 compute: float32 leaves of rank >= 2 are cast (the QKV biases,
    (H, dh), too; the norms stay float32); the gradient arrives at the float32 masters; the loss
    and gradients are the reference's at bf16 level."""
    jcfg, cfg = _cfgs("starcoder2-3b", compute_dtype="bfloat16")
    params = j_lm.init_params(jax.random.PRNGKey(8), jcfg)
    batch = _batch(cfg, 8)
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: j_step.loss_fn(
        j_step.cast_params_for_compute(p, jcfg), b, jcfg)))(params,
                                                            jax.tree.map(jnp.asarray, batch))
    model = convert_lm_params(_np(params), cfg, device="cpu").requires_grad_(True)
    view = train_step.cast_params_for_compute(model, cfg)
    blk = view.groups[0][0]["l0"]
    assert view.embed.table.dtype == blk.mixer.wq.w.dtype == torch.bfloat16
    assert blk.mixer.wq.b.dtype == torch.bfloat16
    assert blk.norm1.scale.dtype == blk.norm1.bias.dtype == torch.float32
    assert model.embed.table.dtype == torch.float32  # the masters are untouched
    leaves = dict(model.named_parameters())
    loss = train_step.loss_fn(view, _tb(batch), cfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert all(g.dtype == torch.float32 for g in grads.values())
    np.testing.assert_allclose(float(loss.detach()), float(jloss), atol=2e-2)
    got, want = lm_tree(grads), _np(jgrads)
    gn = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads.values()))
    jn = np.sqrt(sum(float((w.astype(np.float64) ** 2).sum()) for w in jax.tree.leaves(want)))
    assert abs(gn - jn) <= 2e-2 * jn
    cos = float(np.dot(got["embed"]["table"].numpy().ravel(), want["embed"]["table"].ravel()) / (
        np.linalg.norm(got["embed"]["table"].numpy()) * np.linalg.norm(want["embed"]["table"])))
    assert cos > 0.999


# ---- the flash function -------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,T", [(True, 24, 64), (False, None, 96)])
def test_flash_function_grads(monkeypatch, causal, window, T):
    """The flash function's vjp against ``jax.vjp`` of the reference's
    ``_flash_with_xla_bwd`` (its Pallas kernel in interpret mode, as
    ``tests/test_flash_attention.py`` runs it), and bit-equal to autograd
    through the port's ``_attend_chunked`` alone (the same backward)."""
    import repro._unused.flash_attention as j_fa

    monkeypatch.setattr(j_fa, "flash_attention", functools.partial(
        j_fa.flash_attention, q_chunk=32, kv_chunk=32, interpret=True))
    rng = np.random.default_rng(9)
    Sq, Hkv, G, dh = 64, 2, 3, 16
    q = rng.normal(size=(B, Sq, Hkv, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    g = rng.normal(size=(B, Sq, Hkv, G, dh)).astype(np.float32)
    kw = dict(causal=causal, window=window, scale=0.25)
    jout, vjp = jax.vjp(lambda *a: j_attn._flash_with_xla_bwd(*a, **kw),
                        *map(jnp.asarray, (q, k, v)))
    jgrads = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = attention._flash_with_plain_bwd(tq, tk, tv, **kw)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-5)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    plain = attention._attend_chunked(tq, tk, tv, **kw)
    for got, want in zip(grads, torch.autograd.grad(plain, (tq, tk, tv), torch.as_tensor(g))):
        assert torch.equal(got, want)


# ---- AdamW ----------------------------------------------------------------------------------
def test_cosine_schedule_matches_jax():
    cfg = optimizer.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = j_opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
        got = optimizer.cosine_schedule(cfg, step)
        want = np.asarray(j_opt.cosine_schedule(jcfg, jnp.int32(step)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    """One update at step 3 with random moments: weight decay on every leaf
    (the 1-D norm and bias too), the clip from one global norm (which the
    gradients here exceed)."""
    rng = np.random.default_rng(10)
    shapes = {"w": (16, 8), "norm": (8,), "b": (3, 5)}
    p, g, m, v = ({k: rng.normal(size=s).astype(np.float32) * sc for k, s in shapes.items()}
                  for sc in (1.0, 2.0, 0.1, 1.0))
    v = {k: np.abs(x) for k, x in v.items()}
    kw = dict(lr=1e-2, grad_clip=clip, warmup_steps=2, total_steps=20)
    jnew, jstate, jm = j_opt.adamw_update(
        p, g, j_opt.OptState(jnp.int32(3), m, v), j_opt.AdamWConfig(**kw))
    tp, tm, tv = ({k: torch.tensor(x) for k, x in d.items()} for d in (p, m, v))
    new, state, metrics = optimizer.adamw_update(
        tp, {k: torch.tensor(x) for k, x in g.items()},
        optimizer.OptState(torch.tensor(3, dtype=torch.int32), tm, tv), optimizer.AdamWConfig(**kw))
    assert int(state.step) == 4 and new is tp and state.m is tm
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(float(metrics["lr"]), float(jm["lr"]), rtol=1e-6)
    for got, want in ((new, jnew), (state.m, jstate.m), (state.v, jstate.v)):
        for key in shapes:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                       atol=1e-7)


def test_train_step_matches_jax():
    """One ``make_train_step`` step of the enc-dec card at float32 compute:
    loss, gradient norm and every updated parameter and moment against the
    reference's."""
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    params = j_lm.init_params(jax.random.PRNGKey(13), jcfg)
    batch = _batch(cfg, 13)
    ocfg = dict(warmup_steps=1, total_steps=10)
    jstep = jax.jit(j_step.make_train_step(jcfg, j_opt.AdamWConfig(**ocfg)))
    jopt = j_opt.adamw_init(params, j_opt.AdamWConfig(**ocfg))
    jp, jo, jm = jstep(params, jopt, jax.tree.map(jnp.asarray, batch))
    model = convert_lm_params(_np(params), cfg, device="cpu")
    assert not model.embed.table.requires_grad  # serving leaves them off
    model.requires_grad_(True)  # the trainer switches them on once
    opt = optimizer.adamw_init(dict(model.named_parameters()), optimizer.AdamWConfig(**ocfg))
    step = train_step.make_train_step(cfg, optimizer.AdamWConfig(**ocfg))
    model2, opt, metrics = step(model, opt, _tb(batch))
    assert model2 is model and model.embed.table.requires_grad
    np.testing.assert_allclose(float(metrics["loss"]), float(jm["loss"]), atol=1e-5)
    np.testing.assert_allclose(float(metrics["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    tree = train.train_state_tree(model, opt)
    _close_trees(tree["opt"].m, jo.m, 1e-7, 1e-4)
    # the first step moves a parameter by lr · g / (|g| + eps), about lr · sign(g): equal
    # wherever the two gradients agree to 1 %, and within 2 lr where g is roundoff (the
    # cross-attention's K bias, whose gradient is 0 in exact arithmetic)
    lr = float(jm["lr"])
    flat_p = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(),
                                                               tree["params"]))[0]
    for (key, got), want, m_got, m in zip(flat_p, jax.tree.leaves(_np(jp)),
                                          jax.tree.leaves(lm_tree(opt.m)),
                                          jax.tree.leaves(_np(jo.m))):
        sure = np.abs(m) > 100 * np.abs(m_got.numpy() - m)
        np.testing.assert_allclose(got[sure], want[sure], atol=1e-6, rtol=0,
                                   err_msg=jax.tree_util.keystr(key))
        np.testing.assert_allclose(got, want, atol=2 * lr, rtol=0)


# ---- compression --------------------------------------------------------------------------
def test_quantize_int8_bit_equal():
    rng = np.random.default_rng(14)
    ties = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5, -126.5] * 32, np.float32)
    for arr in (rng.normal(size=(1024,)).astype(np.float32),
                rng.normal(size=(5, 200)).astype(np.float32) * 1e-3,  # padded to 1024
                ties, np.zeros(300, np.float32)):
        jq, js = j_comp.quantize_int8(jnp.asarray(arr))
        q, s = compression.quantize_int8(torch.as_tensor(arr))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            compression.dequantize_int8(q, s, arr.shape, torch.float32).numpy(),
            np.asarray(j_comp.dequantize_int8(jq, js, arr.shape, jnp.float32)))
    q, _ = compression.quantize_int8(torch.as_tensor(ties))
    assert q[0, :8].tolist() == [127, 0, 2, 2, 0, -2, 4, -126]  # round half to even


def test_compress_tree_and_error_feedback_bit_equal():
    rng = np.random.default_rng(15)
    tree = {"w": rng.normal(size=(24, 40)).astype(np.float32),
            "scale": rng.normal(size=(77,)).astype(np.float32)}  # < 256: passes through
    want = j_comp.compress_decompress_tree(jax.tree.map(jnp.asarray, tree))
    got = compression.compress_decompress_tree({k: torch.as_tensor(x) for k, x in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["scale"].numpy(), tree["scale"])
    jstate = j_comp.ef_init(tree)
    state = compression.ef_init({k: torch.as_tensor(x) for k, x in tree.items()})
    for _ in range(3):
        jg, jstate = j_comp.ef_compress(jax.tree.map(jnp.asarray, tree), jstate)
        g, state = compression.ef_compress({k: torch.as_tensor(x) for k, x in tree.items()}, state)
        for k in tree:
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(jg[k]))
            np.testing.assert_array_equal(state.residual[k].numpy(), np.asarray(jstate.residual[k]))


# ---- data -------------------------------------------------------------------------------------
def test_synthetic_stream_equals_the_reference():
    for kw in (dict(vocab=512, seq_len=16, global_batch=4, seed=9),
               dict(vocab=32768, seq_len=8, global_batch=8, seed=1, host_index=1, host_count=2)):
        ref, port = j_data.SyntheticLMStream(**kw), data.SyntheticLMStream(**kw)
        assert port.local_batch == ref.local_batch
        for step in (0, 13):
            want, got = ref.batch(step), port.batch(step)
            for key in ("tokens", "labels"):
                assert got[key].dtype == want[key].dtype == np.int32
                np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError):
        data.SyntheticLMStream(vocab=64, seq_len=8, global_batch=7, host_count=2)


def test_prefetch_pipeline_and_straggler_fallback():
    class SlowStream:
        def batch(self, step):
            if step >= 2:
                time.sleep(0.5)  # straggling shard
            return {"x": np.full((2,), step)}

    p = data.PrefetchPipeline(SlowStream(), depth=1)
    try:
        p.next_batch(timeout=2.0)
        b1 = p.next_batch(timeout=2.0)
        b2 = p.next_batch(timeout=0.01)
        assert p.stats["straggler_fallbacks"] >= 1
        np.testing.assert_array_equal(b2["x"], b1["x"])
    finally:
        p.close()
    assert not p._thread.is_alive()


# ---- checkpoints --------------------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": torch.as_tensor(rng.normal(size=(8, 16)).astype(np.float32)),
            "nested": {"b": torch.as_tensor(rng.integers(0, 100, (4,)), dtype=torch.int32)},
            "scalar": np.float32(3.5),
            "opt": optimizer.OptState(torch.tensor(2, dtype=torch.int32), [np.ones(3)], [])}


def test_checkpoint_roundtrip(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(7, t)
    out = mgr.restore(None, t)
    assert isinstance(out["opt"], optimizer.OptState) and list(out) == list(t)
    for (ka, a), (kb, b) in zip(checkpoint.flatten_with_paths(t),
                                checkpoint.flatten_with_paths(out)):
        assert ka == kb and isinstance(b, torch.Tensor)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    keys = [leaf["key"] for leaf in __import__("json").loads(
        (tmp_path / "step_00000007" / "manifest.json").read_text())["leaves"]]
    assert keys == ["a", "nested/b", "opt/step", "opt/m/0", "scalar"]


def test_checkpoint_keep_rotation(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree(s))
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert (tmp_path / "latest").read_text() == "4"


def test_checkpoint_atomicity_partial_tmp(tmp_path):
    """A stale .tmp dir (a crash mid-save) must not break restore."""
    mgr = checkpoint.CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree(1))
    bad = tmp_path / "step_00000002.tmp"
    bad.mkdir()
    (bad / "leaf_00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    out = mgr.restore(None, _tree())
    np.testing.assert_array_equal(out["a"].numpy(), _tree(1)["a"].numpy())


def test_checkpoint_async(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path, keep=2)
    mgr.save_async(5, _tree(5))
    mgr.wait()
    assert mgr.latest_step() == 5


def test_checkpoint_restore_detects_mismatch(tmp_path):
    mgr = checkpoint.CheckpointManager(tmp_path)
    mgr.save(1, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"only_one_leaf": torch.zeros(3)})
    wrong = _tree()
    wrong["a"] = torch.zeros(8, 15)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore(1, wrong)
    with pytest.raises(FileNotFoundError):
        checkpoint.CheckpointManager(tmp_path / "empty").restore(None, _tree())


@pytest.fixture(scope="module")
def encdec_state():
    """The reference's enc-dec parameters and AdamW state (random moments,
    step 7), and the port's counterparts."""
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    params = _np(j_lm.init_params(jax.random.PRNGKey(16), jcfg))
    rng = np.random.default_rng(16)
    moment = lambda: jax.tree.map(  # noqa: E731
        lambda x: rng.normal(size=x.shape).astype(np.float32), params)
    jopt = j_opt.OptState(jnp.int32(7), moment(), moment())
    model = convert_lm_params(params, cfg, device="cpu")
    opt = optimizer.adamw_init(dict(model.named_parameters()), optimizer.AdamWConfig())
    return params, jopt, model, opt


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path, encdec_state):
    params, jopt, model, opt = encdec_state
    j_ckpt.CheckpointManager(tmp_path).save(7, {"params": params, "opt": jopt})
    mgr = checkpoint.CheckpointManager(tmp_path)
    fresh = convert_lm_params(jax.tree.map(np.zeros_like, params), _cfgs("seamless-m4t-medium")[1],
                              device="cpu")
    like = train.train_state_tree(fresh, opt)
    state = train.load_train_state(mgr.restore(None, like), fresh, opt)
    assert int(state.step) == 7
    back = train.train_state_tree(fresh, state)
    _close_trees(back["params"], params, 0.0, 0.0)
    _close_trees(back["opt"].m, jopt.m, 0.0, 0.0)
    _close_trees(back["opt"].v, jopt.v, 0.0, 0.0)


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path, encdec_state):
    params, jopt, model, opt = encdec_state
    rng = np.random.default_rng(17)
    for moments in (opt.m, opt.v):
        for t in moments.values():
            t.copy_(torch.as_tensor(rng.normal(size=t.shape).astype(np.float32)))
    opt = optimizer.OptState(torch.tensor(9, dtype=torch.int32), opt.m, opt.v)
    tree = train.train_state_tree(model, opt)
    checkpoint.CheckpointManager(tmp_path).save(9, tree)
    zeros = jax.tree.map(np.zeros_like, params)
    like = {"params": zeros, "opt": j_opt.OptState(jnp.int32(0), zeros, zeros)}
    out = j_ckpt.CheckpointManager(tmp_path).restore(None, like)
    assert int(out["opt"].step) == 9
    _close_trees(tree["params"], out["params"], 0.0, 0.0)
    _close_trees(tree["opt"].m, out["opt"].m, 0.0, 0.0)
    _close_trees(tree["opt"].v, out["opt"].v, 0.0, 0.0)


# ---- the train loop -------------------------------------------------------------------------------
def test_train_loop_failure_recovery(tmp_path):
    """``--preset tiny`` on the CPU: an injected failure at step 12 restores
    the step-8 checkpoint and the loop finishes its 24 steps."""
    cfg = get_config("starcoder2-3b").reduced()
    loop = train.TrainLoop(cfg, optimizer.AdamWConfig(total_steps=24, warmup_steps=2), "cpu",
                           ckpt_dir=tmp_path, global_batch=2, seq_len=32, ckpt_every=8)
    try:
        log = loop.run(24, inject_failure_at=12)
        assert loop.step == 24 and log[-1]["step"] == 24
        assert loop.ckpt.latest_step() >= 16
        assert [r["step"] for r in log] == [10, 10, 20, 24]  # step 10 ran twice
    finally:
        loop.pipeline.close()


def test_train_loop_device_rules(tmp_path):
    from repro_torch.launch.mesh import make_local_mesh

    cfg = get_config("starcoder2-3b").reduced()
    opt = optimizer.AdamWConfig()
    two = make_local_mesh(devices=["cpu"] * 2)
    loop = train.TrainLoop(cfg, opt, two, ckpt_dir=tmp_path)  # a mesh of two: the sharded step
    loop.pipeline.close()
    assert loop.sharded and loop.mesh is two and loop.device == torch.device("cpu")
    loop = train.TrainLoop(cfg, opt, make_local_mesh(devices=["cpu"]), ckpt_dir=tmp_path)
    loop.pipeline.close()
    assert not loop.sharded and loop.device == torch.device("cpu")
    if not torch.cuda.is_available():
        from repro_torch.device import DeviceUnavailableError

        with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
            train.TrainLoop(cfg, opt, ckpt_dir=tmp_path)


def test_train_cli_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", [
        "train", "--device", "cpu", "--steps", "20", "--global-batch", "2", "--seq-len", "16",
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "5", "--inject-failure-at", "7",
        "--compress-grads"])
    train.main()
    out = capsys.readouterr().out
    assert "[train] failure at step 7: injected node failure; restoring" in out
    assert "[train] done on CPU: loss" in out
