"""The port's MoE FFN and the cards it brings (Mixtral-8x22B, and the dense
GQA cards Qwen2.5-32B, Minitron-8B and Command-R-35B) against the JAX
package, on the CPU.

``moe_apply`` against the reference's ``_moe_apply_dense`` at d 64, E 4,
k 2, f 32, S 16 in float32: renormalization on and off, shared experts on
and off, a capacity that drops tokens, ties in the router and S = 1 (decode,
C = 1); atol 1e-5 (roundoff: both route in float32, the experts' products
differ only in summation order), and a bfloat16 case at atol 5e-2, the
LM tests' bf16 tolerance (the frameworks round bf16 intermediates of
magnitude 2–4 at other places: JAX's SiLU rounds its sigmoid to bf16,
PyTorch's computes in float32 inside). Each card's ``reduced()`` logits
(float32 compute, weights made by the JAX ``init_params`` and carried across
by ``convert_lm_params``) against the reference's at atol 1e-4; Mixtral's
cached decode past its reduced window of 64 against the reference's cached
steps at atol 1e-4, and its bf16 logits at 5e-2, as ``test_torch_lm.py``
holds StarCoder2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as j_get_config
from repro._unused.models import lm as j_lm
from repro._unused.models import moe as j_moe
from repro_torch.configs.base import LayerDesc, get_config
from repro_torch.interop import _leaves, convert_lm_params
from repro_torch._unused.models import lm, moe

B, D_MODEL = 2, 64
CARDS = ["qwen2.5-32b", "minitron-8b", "command-r-35b", "mixtral-8x22b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(np.array(v)) for k, v in _leaves(tree)}, strict=True)
    return module


def _moe_cfgs(**kw):
    kw = {"d_model": D_MODEL, "n_experts": 4, "top_k": 2, "d_ff_expert": 32,
          "compute_dtype": "float32", **kw}
    return (dataclasses.replace(j_get_config("mixtral-8x22b").reduced(), **kw),
            dataclasses.replace(get_config("mixtral-8x22b").reduced(), **kw))


def _run_both(jcfg, cfg, S, seed, *, zero_router=False):
    p = _np(j_moe.moe_init(jax.random.PRNGKey(seed), jcfg))
    if zero_router:  # every probability 1/E: top-k must pick the lowest ids
        p["router"]["w"] = np.zeros_like(p["router"]["w"])
    x = np.random.default_rng(seed).normal(size=(B, S, D_MODEL)).astype(np.float32)
    want = jax.jit(lambda p_, x_: j_moe._moe_apply_dense(p_, x_, jcfg))(
        p, jnp.asarray(x).astype(jcfg.compute_dtype))
    module = _load(moe.moe_init(cfg, device="cpu"), p)
    xt = torch.as_tensor(x).to(getattr(torch, cfg.compute_dtype))
    got = moe.moe_apply(module, xt, cfg)
    return np.asarray(want.astype(jnp.float32)), got.float().numpy(), int(moe.dropped(module, xt, cfg))


@pytest.mark.parametrize("renorm", [True, False])
@pytest.mark.parametrize("shared", [0, 1])
def test_moe_apply_matches_jax(renorm, shared):
    jcfg, cfg = _moe_cfgs(renorm_topk=renorm, n_shared_experts=shared)
    want, got, _ = _run_both(jcfg, cfg, 16, seed=10 + 2 * shared + renorm)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_capacity_drops_tokens_as_jax():
    """capacity_factor 0.5: C = ceil(0.5·16·2/4) = 4 slots for about 8
    entries per expert, so entries past rank 4 go to the overflow slot."""
    jcfg, cfg = _moe_cfgs(capacity_factor=0.5)
    assert moe.moe_capacity(cfg, 16) == 4
    want, got, dropped = _run_both(jcfg, cfg, 16, seed=21)
    assert dropped >= 8
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_router_ties_pick_the_lower_expert():
    """A zero router makes every probability 1/E: ``jax.lax.top_k`` takes
    experts 0 and 1, so only their capacity (C = 10 of 16 tokens) decodes."""
    jcfg, cfg = _moe_cfgs()
    want, got, dropped = _run_both(jcfg, cfg, 16, seed=22, zero_router=True)
    assert dropped == B * 2 * (16 - moe.moe_capacity(cfg, 16))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_decode_length_one():
    """S = 1: capacity 1, each of the k entries in its own expert."""
    jcfg, cfg = _moe_cfgs(n_shared_experts=1)
    assert moe.moe_capacity(cfg, 1) == 1 == j_moe.moe_capacity(jcfg, 1)
    want, got, dropped = _run_both(jcfg, cfg, 1, seed=23)
    assert dropped == 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_moe_bf16_compute_matches_jax():
    jcfg, cfg = _moe_cfgs(compute_dtype="bfloat16", n_shared_experts=1)
    want, got, _ = _run_both(jcfg, cfg, 16, seed=24)
    np.testing.assert_allclose(got, want, atol=5e-2)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 100, 4096])
@pytest.mark.parametrize("cf", [0.5, 1.0, 1.25])
def test_moe_capacity_matches_jax(S, cf):
    jcfg, cfg = _moe_cfgs(capacity_factor=cf)
    assert moe.moe_capacity(cfg, S) == j_moe.moe_capacity(jcfg, S)
    full, jfull = get_config("mixtral-8x22b"), j_get_config("mixtral-8x22b")
    assert moe.moe_capacity(full, S) == j_moe.moe_capacity(jfull, S)


def test_moe_params_follow_the_reference_tree():
    """The port's module names are the reference's pytree keys; a missing
    leaf is refused by ``convert_lm_params``'s strict load."""
    jcfg, cfg = _moe_cfgs(n_shared_experts=1)
    p = _np(j_moe.moe_init(jax.random.PRNGKey(0), jcfg))
    names = dict(_leaves(p))
    module = moe.moe_init(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in module.state_dict().items()} == {
        k: v.shape for k, v in names.items()}
    assert module.router.w.dtype == torch.float32
    jparams = _np(j_lm.init_params(jax.random.PRNGKey(1), jcfg))
    del jparams["groups"][0]["l0"]["ffn"]["router"]
    with pytest.raises(RuntimeError, match="router"):
        convert_lm_params(jparams, cfg, device="cpu")


# ---- the cards ---------------------------------------------------------------------
@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(4).integers(0, 512, (B, 96)).astype(np.int32)


def _card(name, **kw):
    jcfg = dataclasses.replace(j_get_config(name).reduced(), **kw)
    cfg = dataclasses.replace(get_config(name).reduced(), **kw)
    params = j_lm.init_params(jax.random.PRNGKey(len(name)), jcfg)
    return jcfg, cfg, params, convert_lm_params(_np(params), cfg, device="cpu")


@pytest.mark.parametrize("name", CARDS)
def test_card_reduced_logits_match_jax(name, tokens):
    jcfg, cfg, params, model = _card(name, compute_dtype="float32")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert lm.count_params(model) == j_lm.count_params(params)
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert got.shape == want.shape == (B, 96, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_mixtral_reduced_bf16_logits_match_jax(tokens):
    jcfg, cfg, params, model = _card("mixtral-8x22b")
    assert cfg.compute_dtype == "bfloat16"
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


@pytest.mark.parametrize("cf", [1.25, 2.0])
def test_mixtral_reduced_cached_decode_matches_jax(tokens, cf):
    """72 cached steps, past the reduced window of 64 (the ring buffer), with
    the MoE at S = 1 per step (C = 1, nothing dropped): the reference's
    cached logits at every step. At capacity_factor 2, C = S in the full
    forward too, so no token is dropped there either and the cached steps
    equal the port's own full forward; at the card's 1.25 the full forward
    drops tokens that decode keeps."""
    jcfg, cfg, params, model = _card("mixtral-8x22b", compute_dtype="float32",
                                     capacity_factor=cf)
    assert cfg.sliding_window == 64 and cfg.pattern == (LayerDesc(mixer="gqa", ffn="moe"),)
    n = 72
    jstep = jax.jit(lambda p, t, c, n_: j_lm.apply_decode(p, t, c, n_, jcfg))
    jcache = j_lm.init_cache(jcfg, B, n, dtype=jnp.float32)
    cache = lm.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    full = lm.apply_train(model, {"tokens": torch.as_tensor(tokens[:, :n])}, cfg).numpy()
    for t in range(n):
        jl, jcache = jstep(params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
        pl, cache = lm.apply_decode(model, torch.as_tensor(tokens[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
        if cf == 2.0:
            np.testing.assert_allclose(pl[:, 0].numpy(), full[:, t], atol=1e-4)


@pytest.mark.parametrize("name", CARDS)
def test_card_full_size_count_from_shapes(name):
    """On the meta device: the count from the shapes is ``lm.param_count``,
    the reference's ``n_params_estimate`` plus the norms, the QKV biases and
    the vocab pad, which the estimate leaves out."""
    cfg = get_config(name)
    assert lm.count_params(lm.init_params(cfg, device="meta")) == lm.param_count(cfg)
    assert cfg.n_params_estimate == j_get_config(name).n_params_estimate
