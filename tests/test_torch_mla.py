"""The port's MLA (DeepSeek-V2 multi-head latent attention) and the
DeepSeek-V2 card against the JAX package, on the CPU.

Weights are made by the JAX initializers and carried across by name;
inputs come from a numpy seed. ``reduced()`` DeepSeek-V2: d 64, 4 heads,
q_lora 32, kv_lora 32, dn 16, dr 8, dv 16 (so dk = 24 ≠ dv), a dense prefix
layer and one MLA + MoE layer. Tolerances: float32 compute atol/rtol 1e-5
for the mixer and the blocks (prefill, cached steps and caches), atol 1e-4
on the card's logits, as ``test_torch_lm.py`` holds StarCoder2; bf16
compute atol 5e-2 for the mixer and each block, and for the whole card a
deviation from the float32 logits no larger than the reference's own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import LayerDesc as JLayerDesc
from repro.configs.base import get_config as j_get_config
from repro._unused.models import attention as j_attn
from repro._unused.models import blocks as j_blocks
from repro._unused.models import lm as j_lm
from repro._unused.serve import serve_step as j_serve
from repro_torch.configs.base import LayerDesc, get_config
from repro_torch.interop import _leaves, convert_lm_params
from repro_torch._unused.models import attention, blocks, layers, lm
from repro_torch._unused.serve import serve_step

B = 2
NAME = "deepseek-v2-236b"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    module.load_state_dict({k: torch.tensor(np.array(v)) for k, v in _leaves(tree)}, strict=True)
    return module


def _cfgs(**kw):
    return (dataclasses.replace(j_get_config(NAME).reduced(), **kw),
            dataclasses.replace(get_config(NAME).reduced(), **kw))


def _x(seed, S):
    return np.random.default_rng(seed).normal(size=(B, S, 64)).astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def mla32():
    jcfg, cfg = _cfgs(compute_dtype="float32")
    p = _np(j_attn.mla_init(jax.random.PRNGKey(21), jcfg))
    return jcfg, cfg, p, _load(attention.mla_init(cfg, device="cpu"), p)


def _j_mla(p, x, jcfg, S):
    return jax.jit(lambda p_, x_: j_attn.mla_apply(p_, x_, jcfg, positions=jnp.arange(S)))(
        p, x)


@pytest.mark.parametrize("S", [1, 40])
def test_mla_prefill_matches_jax(mla32, S):
    jcfg, cfg, p, module = mla32
    x = _x(30 + S, S)
    want, _ = _j_mla(p, jnp.asarray(x), jcfg, S)
    got, cache = attention.mla_apply(module, torch.as_tensor(x), cfg, positions=torch.arange(S))
    assert cache is None and got.shape == (B, S, 64)
    _close(got.numpy(), want)


def test_mla_params_follow_the_reference_tree(mla32):
    _, cfg, p, module = mla32
    assert sorted(n for n, _ in module.named_parameters()) == sorted(k for k, _ in _leaves(p))
    assert module.wuq.w.shape == (32, 4, 24) and module.wuk.w.shape == (32, 4, 16)
    assert module.wkr.w.shape == (64, 8) and module.q_norm.scale.shape == (32,)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_decode_matches_jax_and_the_prefill(mla32, cache_dtype):
    """8 cached steps: outputs and the latent and rope-key caches equal to
    the reference's; with a float32 cache the outputs equal the port's
    prefill. A bf16 cache under float32 compute promotes the rebuilt keys
    and values as JAX's einsum does."""
    jcfg, cfg, p, module = mla32
    n = 8
    x = _x(40, n)
    jcache = j_attn.KVCache(jnp.zeros((B, n, 32), cache_dtype), jnp.zeros((B, n, 8), cache_dtype))
    cache = blocks.block_cache_init(cfg, LayerDesc(mixer="mla"), B, n,
                                    getattr(torch, cache_dtype), device="cpu")["mixer"]
    assert cache.k.shape == (B, n, 32) and cache.v.shape == (B, n, 8)
    jstep = jax.jit(lambda p_, x_, c_, t_: j_attn.mla_apply(
        p_, x_, jcfg, positions=t_[None], cache=c_, cache_len=t_))
    outs = []
    for t in range(n):
        want, jcache = jstep(p, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t))
        got, cache = attention.mla_apply(module, torch.as_tensor(x[:, t:t + 1]), cfg,
                                         positions=torch.tensor([t]), cache=cache, cache_len=t)
        _close(got.numpy(), want)
        for g, w in zip(cache, jcache):
            _close(g.float().numpy(), np.asarray(w.astype(jnp.float32)))
        outs.append(got)
    if cache_dtype == "float32":
        full, _ = attention.mla_apply(module, torch.as_tensor(x), cfg, positions=torch.arange(n))
        _close(torch.cat(outs, 1).numpy(), full.numpy())


def test_mla_bf16_matches_jax(mla32):
    jcfg, cfg, p, _ = mla32
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    module = _load(attention.mla_init(cfg, device="cpu"), p)
    x = _x(50, 40)
    want, _ = _j_mla(p, jnp.asarray(x).astype(jnp.bfloat16), jcfg, 40)
    got, _ = attention.mla_apply(module, torch.as_tensor(x).bfloat16(), cfg,
                                 positions=torch.arange(40))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=5e-2)


def test_mla_prefill_never_runs_flash(mla32, monkeypatch):
    """MLA's prefill is the streaming softmax even with flash forced on
    (the reference calls ``_attend_chunked`` directly)."""
    _, cfg, _, module = mla32
    calls = {"flash": 0, "chunked": 0}
    chunked = attention._attend_chunked

    def flash(*a, **k):
        calls["flash"] += 1
        raise AssertionError("MLA reached the flash kernel")

    def counted(*a, **k):
        calls["chunked"] += 1
        return chunked(*a, **k)

    monkeypatch.setattr(attention, "flash_attention", flash)
    monkeypatch.setattr(attention, "_attend_chunked", counted)
    with attention.flash_enabled("on"):
        attention.mla_apply(module, torch.as_tensor(_x(60, 16)), cfg, positions=torch.arange(16))
    assert calls == {"flash": 0, "chunked": 1}


def test_dense_apply_promotes_like_jax():
    """A float32 input against bf16 compute: both operands in float32 after
    the weight's bf16 cast, as JAX's einsum promotes."""
    _, cfg = _cfgs()
    d = layers.dense_init(64, (4, 8), cfg, gen=torch.Generator().manual_seed(0), device="cpu")
    x = torch.as_tensor(_x(70, 3))
    got = layers.dense_apply(d, x, cfg)
    want = (x @ d.w.bfloat16().float().reshape(64, 32)).reshape(B, 3, 4, 8)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want)
    assert layers.dense_apply(d, x.bfloat16(), cfg).dtype == torch.bfloat16


# ---- blocks -------------------------------------------------------------------------
@pytest.mark.parametrize("ffn", ["dense", "moe"])
def test_mla_block_with_cache_matches_jax(ffn):
    jcfg, cfg = _cfgs(compute_dtype="float32")
    desc, jdesc = LayerDesc(mixer="mla", ffn=ffn), JLayerDesc(mixer="mla", ffn=ffn)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(22), jcfg, jdesc))
    block = _load(blocks.block_init(cfg, desc, device="cpu"), p)
    x, pos = _x(80, 24), np.arange(24)
    want, _ = jax.jit(lambda p_, x_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=jnp.asarray(pos)))(p, jnp.asarray(x))
    got, nc = blocks.block_apply(block, torch.as_tensor(x), cfg, desc,
                                 positions=torch.as_tensor(pos))
    assert nc is None
    _close(got.numpy(), want)
    jcache = j_blocks.block_cache_init(jcfg, jdesc, B, 6, jnp.float32)
    cache = blocks.block_cache_init(cfg, desc, B, 6, torch.float32, device="cpu")
    jstep = jax.jit(lambda p_, x_, pos_, c_, n_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=pos_, cache=c_, cache_len=n_))
    for t in range(6):
        xt, pt = x[:, t:t + 1], np.array([t])
        want, jnc = jstep(p, jnp.asarray(xt), jnp.asarray(pt), jcache, jnp.int32(t))
        got, nc = blocks.block_apply(block, torch.as_tensor(xt), cfg, desc,
                                     positions=torch.as_tensor(pt), cache=cache, cache_len=t)
        _close(got.numpy(), want)
        for g, w in zip(nc["mixer"], jnc["mixer"]):
            _close(g.numpy(), np.asarray(w))
        jcache, cache = {**jcache, **jnc}, {**cache, **nc}


# ---- the card --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(9).integers(0, 512, (B, 48)).astype(np.int32)


def _j_init(seed, jcfg):
    return jax.jit(j_lm.init_params, static_argnums=1)(jax.random.PRNGKey(seed), jcfg)


@pytest.fixture(scope="module")
def card32():
    jcfg, cfg = _cfgs(compute_dtype="float32", capacity_factor=2.0)
    params = _j_init(16, jcfg)
    return jcfg, cfg, params, convert_lm_params(_np(params), cfg, device="cpu")


def test_card_reduced_logits_match_jax(card32, tokens):
    jcfg, cfg, params, model = card32
    assert [d.mixer + "/" + d.ffn for g, _ in cfg.layer_list for d in g] == ["mla/dense",
                                                                            "mla/moe"]
    assert lm.count_params(model) == j_lm.count_params(params) == lm.param_count(cfg)
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert got.shape == want.shape == (B, 48, 512)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_card_reduced_bf16_is_as_close_as_jax(tokens):
    """bf16 compute over the two layers: the port's logits lie no farther
    from the reference's float32 logits than the reference's own bf16
    logits do (mean absolute deviation, within a tenth; both are about
    0.0128, with a largest deviation of about 0.6 in each). Each layer kind
    alone is held at atol 5e-2 below; over the whole card bf16 rounding
    moves 0.3 % of the logits by more than that in either framework."""
    want, params = {}, None
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg = _cfgs(compute_dtype=dtype)
        params = _j_init(16, jcfg) if params is None else params  # init ignores the dtype
        want[dtype] = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
            params, jnp.asarray(tokens)))
    model = convert_lm_params(_np(params), cfg, device="cpu")
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg).numpy()
    ours = np.abs(got - want["float32"]).mean()
    theirs = np.abs(want["bfloat16"] - want["float32"]).mean()
    assert 0 < ours <= 1.1 * theirs


@pytest.mark.parametrize("ffn", ["dense", "moe"])
def test_mla_block_bf16_matches_jax(ffn):
    """atol 5e-2 and rtol 2^-7: the block's outputs reach ~7, where one
    bf16 ulp is 2^-5 or 2^-4."""
    jcfg, cfg = _cfgs()
    desc, jdesc = LayerDesc(mixer="mla", ffn=ffn), JLayerDesc(mixer="mla", ffn=ffn)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(23), jcfg, jdesc))
    block = _load(blocks.block_init(cfg, desc, device="cpu"), p)
    x, pos = _x(90, 48), np.arange(48)
    want, _ = jax.jit(lambda p_, x_: j_blocks.block_apply(
        p_, x_, jcfg, jdesc, positions=jnp.asarray(pos)))(p, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = blocks.block_apply(block, torch.as_tensor(x).bfloat16(), cfg, desc,
                                positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=5e-2, rtol=2 ** -7)


def test_card_reduced_decode_and_greedy_match_jax(card32, tokens):
    """16 cached steps: the reference's cached logits at every step and the
    port's full forward (capacity_factor 2: C = S, no token dropped);
    greedy tokens equal to the reference's (bf16 cache, the default)."""
    jcfg, cfg, params, model = card32
    n = 16
    jstep = jax.jit(lambda p, t, c, n_: j_lm.apply_decode(p, t, c, n_, jcfg))
    jcache = j_lm.init_cache(jcfg, B, n, dtype=jnp.float32)
    cache = lm.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    full = lm.apply_train(model, {"tokens": torch.as_tensor(tokens[:, :n])}, cfg).numpy()
    for t in range(n):
        jl, jcache = jstep(params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
        pl, cache = lm.apply_decode(model, torch.as_tensor(tokens[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-4)
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, t], atol=1e-4)
    prompt = tokens[:, :4]
    step = jax.jit(j_serve.make_decode_step(jcfg, 12))
    jc = j_lm.init_cache(jcfg, B, 12)
    want = []
    for t in range(12):
        tok = jnp.asarray(prompt[:, t:t + 1]) if t < 4 else nxt[:, None]
        nxt, jc = step(params, tok, jc, jnp.int32(t))
        if t >= 3:
            want.append(np.asarray(nxt))
    got = serve_step.greedy_generate(model, cfg, torch.as_tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), np.stack(want[:8], 1))


def test_card_full_size_count_from_shapes():
    cfg = get_config(NAME)
    model = lm.init_params(cfg, device="meta")
    assert lm.count_params(model) == lm.param_count(cfg)
    assert cfg.n_params_estimate == j_get_config(NAME).n_params_estimate
    assert cfg.n_active_params_estimate == j_get_config(NAME).n_active_params_estimate
    mla = model.groups[1][0]["l0"].mixer
    assert mla.wuq.w.shape == (1536, 128, 192) and mla.wuv.w.shape == (512, 128, 128)
    assert model.groups[0][0]["l0"].ffn.wi.w.shape == (5120, 12288)
    assert len(model.groups[1]) == 59 and model.groups[1][0]["l0"].ffn.wi.shape == (160, 5120, 1536)


def test_entry_points_build_the_mla_cache():
    _, cfg = _cfgs()
    c = lm.init_cache(cfg, 3, 10, device="cpu")["groups"]
    assert [g[0]["l0"]["mixer"].k.shape for g in c] == [(3, 10, 32)] * 2
    assert c[1][0]["l0"]["mixer"].v.shape == (3, 10, 8) and c[0][0]["l0"]["mixer"].k.dtype == torch.bfloat16
