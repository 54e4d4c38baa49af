"""The port's enc-dec card (SeamlessM4T-medium) and VLM stub (Pixtral-12B)
against the JAX package, on the CPU.

Both cards ``reduced()`` (d_model 64, head_dim 16; Seamless with 2 encoder
and 1 decoder layer, Pixtral with 4 patch positions), float32 compute,
weights made by the JAX ``lm.init_params`` and carried across by
``convert_lm_params``; the same numpy tokens, frames and patch embeddings
go through both. Tolerances: 1e-5 on a block, 1e-4 on logits (float32
roundoff over a few layers, as ``test_torch_lm.py``); cached decode against
teacher forcing at the reference's own 1e-4
(``tests/test_decode_consistency.py::test_encdec_decode_with_cross_cache``).
Each JAX function runs once per geometry (module fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro._unused.models import blocks as j_blocks
from repro._unused.models import lm as j_lm
from repro_torch.configs.base import LayerDesc, get_config
from repro_torch.interop import _leaves, convert_lm_params, lm_named, lm_tree
from repro_torch._unused.models import attention, blocks, lm
from repro_torch._unused.serve import serve_step

B, S, SX = 2, 24, 20  # decoder tokens, encoder frames
GQA = LayerDesc(mixer="gqa", ffn="dense")


def _cfgs(name, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config(name).reduced(), **kw),
            dataclasses.replace(get_config(name).reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.as_tensor(np.array(a))


def _load(module, tree):
    module.load_state_dict({k: _t(v) for k, v in _leaves(tree)}, strict=True)
    return module


@pytest.fixture(scope="module")
def seamless():
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    params = j_lm.init_params(jax.random.PRNGKey(11), jcfg)
    rng = np.random.default_rng(11)
    frames = rng.normal(size=(B, SX, 64)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(frames)}
    logits = np.asarray(jax.jit(lambda p, b: j_lm.apply_train(p, b, jcfg))(params, batch))
    enc = np.asarray(jax.jit(lambda p, f: j_lm.encode(p, f, jcfg))(params, batch["frames"]))
    return dict(jcfg=jcfg, cfg=cfg, params=params, model=convert_lm_params(_np(params), cfg,
                                                                             device="cpu"),
                frames=frames, toks=toks, logits=logits, enc=enc)


@pytest.fixture(scope="module")
def pixtral():
    jcfg, cfg = _cfgs("pixtral-12b")
    params = j_lm.init_params(jax.random.PRNGKey(12), jcfg)
    rng = np.random.default_rng(12)
    patches = rng.normal(size=(B, cfg.n_patches, 64)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    logits = np.asarray(jax.jit(lambda p, b: j_lm.apply_train(p, b, jcfg))(
        params, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}))
    return dict(jcfg=jcfg, cfg=cfg, params=params,
                model=convert_lm_params(_np(params), cfg, device="cpu"), patches=patches,
                toks=toks, logits=logits)


# ---- the cross block and the encoder -------------------------------------------------
@pytest.mark.parametrize("flash", ["off", "on"])
def test_cross_block_matches_jax(flash):
    """A decoder block with ``norm_x`` and cross-attention against the
    encoder output (S != Sx): no rope on K, not causal, no window; flash
    forced on runs its plain version on CPU tensors."""
    jcfg, cfg = _cfgs("seamless-m4t-medium")
    p = _np(j_blocks.block_init(jax.random.PRNGKey(6), jcfg, GQA, cross=True))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, S, 64)).astype(np.float32)
    xa = rng.normal(size=(B, SX, 64)).astype(np.float32)
    pos = np.arange(S)
    want, _ = j_blocks.block_apply(p, jnp.asarray(x), jcfg, GQA, positions=jnp.asarray(pos),
                                   xa=jnp.asarray(xa))
    block = _load(blocks.block_init(cfg, GQA, device="cpu", cross=True), p)
    assert block.cross is not None and block.norm_x is not None
    with attention.flash_enabled(flash):
        got, cache = blocks.block_apply(block, _t(x), cfg, GQA, positions=torch.as_tensor(pos),
                                        xa=_t(xa))
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_encode_matches_jax(seamless):
    got = lm.encode(seamless["model"], _t(seamless["frames"]), seamless["cfg"])
    assert got.shape == (B, SX, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), seamless["enc"], atol=1e-5)


# ---- the full forward ------------------------------------------------------------------
@pytest.mark.parametrize("flash", ["off", "on"])
def test_apply_train_with_frames_matches_jax(seamless, flash):
    cfg, model = seamless["cfg"], seamless["model"]
    assert lm.count_params(model) == j_lm.count_params(seamless["params"])
    assert len(model.encoder) == 2 and len(model.groups[0]) == 1
    batch = {"tokens": _t(seamless["toks"]), "frames": _t(seamless["frames"])}
    with attention.flash_enabled(flash), torch.no_grad():
        got = lm.apply_train(model, batch, cfg)
    np.testing.assert_allclose(got.numpy(), seamless["logits"], atol=1e-4)


def test_apply_train_with_patches_matches_jax(pixtral):
    cfg, model = pixtral["cfg"], pixtral["model"]
    batch = {"tokens": _t(pixtral["toks"]), "patch_embeds": _t(pixtral["patches"])}
    with torch.no_grad():
        got = lm.apply_train(model, batch, cfg)
    np.testing.assert_allclose(got.numpy(), pixtral["logits"], atol=1e-4)


def test_patch_positions_take_the_patches_not_the_tokens(pixtral):
    """The first ``n_patches`` logits follow ``patch_embeds`` and ignore the
    tokens they replace; the later ones see both (causal attention)."""
    cfg, model = pixtral["cfg"], pixtral["model"]
    P = cfg.n_patches
    toks, patches = _t(pixtral["toks"]), _t(pixtral["patches"])
    other = toks.clone()
    other[:, :P] = (other[:, :P] + 7) % cfg.vocab
    with torch.no_grad():
        base = lm.apply_train(model, {"tokens": toks, "patch_embeds": patches}, cfg)
        same = lm.apply_train(model, {"tokens": other, "patch_embeds": patches}, cfg)
        moved = lm.apply_train(model, {"tokens": toks, "patch_embeds": patches.flip(1)}, cfg)
    assert torch.equal(base, same)
    assert (moved[:, :P] - base[:, :P]).abs().amin(-1).max() > 0
    assert (moved[:, P:] - base[:, P:]).abs().max() > 1e-3


def test_prefill_step_takes_frames_and_patches(seamless, pixtral):
    for case, extra in ((seamless, {"frames": _t(seamless["frames"])}),
                        (pixtral, {"patch_embeds": _t(pixtral["patches"])})):
        step = serve_step.make_prefill_step(case["cfg"])
        got = step(case["model"], {"tokens": _t(case["toks"]), **extra})
        np.testing.assert_array_equal(got.numpy(), case["logits"][:, -1].argmax(-1))


# ---- decode against the cross cache ----------------------------------------------------
def test_decode_with_cross_cache_matches_teacher_forcing_and_jax(seamless):
    """``prefill_cross`` then cached float32 ``apply_decode``: equal to the
    full forward (teacher forcing) and to the reference's cached steps; the
    cross K/V stay untouched through the steps."""
    jcfg, cfg, params, model = (seamless[k] for k in ("jcfg", "cfg", "params", "model"))
    toks, frames = seamless["toks"][:, :10], seamless["frames"]
    enc = lm.encode(model, _t(frames), cfg)
    cache = lm.init_cache(cfg, B, 10, dtype=torch.float32, cross_len=SX, device="cpu")
    assert cache["groups"][0][0]["l0"]["cross"].k.shape == (B, SX, 2, 16)
    cache = lm.prefill_cross(model, enc, cfg, cache)
    cross_k = cache["groups"][0][0]["l0"]["cross"].k.clone()
    jenc = j_lm.encode(params, jnp.asarray(frames), jcfg)
    jcache = j_lm.prefill_cross(params, jenc, jcfg, j_lm.init_cache(
        jcfg, B, 10, dtype=jnp.float32, cross_len=SX))
    np.testing.assert_allclose(
        cross_k.numpy(), np.asarray(jcache["groups"][0]["l0"]["cross"].k[0]), atol=1e-5)
    jstep = jax.jit(lambda p, t, c, n: j_lm.apply_decode(p, t, c, n, jcfg))
    outs = []
    for t in range(10):
        jl, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = lm.apply_decode(model, _t(toks[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
        outs.append(lg[:, 0])
    assert torch.equal(cache["groups"][0][0]["l0"]["cross"].k, cross_k)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), seamless["logits"][:, :10],
                               atol=1e-4)


def test_decode_without_cross_cache_takes_the_references_branch(seamless):
    """A cache made without ``cross_len`` (as the serve CLI makes it): the
    cross block then attends over its own token, as the reference's does;
    greedy tokens equal."""
    jcfg, cfg, params, model = (seamless[k] for k in ("jcfg", "cfg", "params", "model"))
    prompt = seamless["toks"][:, :4]
    from repro._unused.serve import serve_step as j_serve

    want = np.asarray(j_serve.greedy_generate(params, jcfg, jnp.asarray(prompt), 5))
    got = serve_step.greedy_generate(model, cfg, _t(prompt), 5)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- counts, configs and the parameter layout ------------------------------------------
@pytest.mark.parametrize("name", ["seamless-m4t-medium", "pixtral-12b"])
def test_cards_and_param_counts_match_the_reference(name):
    want, got = j_get_config(name), get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for j, p in ((want, got), (want.reduced(), got.reduced())):
        assert p.n_params_estimate == j.n_params_estimate
        shapes = jax.eval_shape(lambda k: j_lm.init_params(k, j), jax.random.PRNGKey(0))
        n = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
        assert lm.count_params(lm.init_params(p, device="meta")) == lm.param_count(p) == n


def test_convert_encdec_params_both_ways(seamless):
    """Every leaf of the reference's enc-dec tree (the stacked ``encoder``,
    ``enc_norm``, each decoder block's ``norm_x`` and ``cross``) is matched
    by one parameter; ``lm_tree`` gives the reference's tree back."""
    params, model = _np(seamless["params"]), seamless["model"]
    named = dict(model.named_parameters())
    assert "encoder.1.l0.mixer.wq.b" in named and "groups.0.0.l0.cross.wk.w" in named
    assert "groups.0.0.l0.norm_x.bias" in named and "enc_norm.scale" in named
    assert lm_named(params).keys() == named.keys()
    back = lm_tree(named)
    flat_want = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.numpy(), back))[0]
    assert [k for k, _ in flat_got] == [k for k, _ in flat_want]
    for (_, a), (_, b) in zip(flat_want, flat_got):
        np.testing.assert_array_equal(a, b)
    bad = {**params, "extra": {"w": np.zeros(3, np.float32)}}
    with pytest.raises(RuntimeError, match="extra"):
        convert_lm_params(bad, seamless["cfg"], device="cpu")

