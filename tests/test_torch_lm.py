"""The port's LM serving path (StarCoder2-3B) against the JAX package, on the CPU.

StarCoder2-3B ``reduced()`` with ``n_layers=2`` (so that the reference's
scan axis is unstacked into two layers), weights made by the JAX
``lm.init_params`` and carried across by ``convert_lm_params``; the same
numpy tokens go through both. Tolerances: float32 compute agrees to
roundoff (atol 1e-4 on logits of 128 tokens, where the reduced window of 64
masks); bf16 compute at bf16 level (atol 5e-2 on logits of magnitude ~1,
about six bf16 ulps, since the two frameworks round at other places);
flash against the streaming path at the 2e-2 of
``tests/test_flash_attention.py::test_flash_matches_model_streaming_path``.
Each JAX function runs once per geometry (module fixtures): compiling a
reduced ``apply_train`` costs seconds here.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_config as j_get_config
from repro._unused.models import attention as j_attn
from repro._unused.models import blocks as j_blocks
from repro._unused.models import layers as j_layers
from repro._unused.models import lm as j_lm
from repro._unused.serve import serve_step as j_serve
from repro_torch.configs.base import LayerDesc, get_config, list_archs
from repro_torch.interop import _leaves, convert_lm_params
from repro_torch._unused import flash_attention as fa
from repro_torch._unused.models import attention, blocks, layers, lm
from repro_torch._unused.serve import serve_step

S_TOK, B = 128, 2
GQA = LayerDesc(mixer="gqa", ffn="dense")


def _cfgs(**kw):
    """(JAX config, port config) of reduced StarCoder2-3B with two layers."""
    kw = {"n_layers": 2, **kw}
    return (dataclasses.replace(j_get_config("starcoder2-3b").reduced(), **kw),
            dataclasses.replace(get_config("starcoder2-3b").reduced(), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _load(module, tree):
    """Load a JAX pytree (numpy leaves) into a port module, names checked."""
    module.load_state_dict({k: torch.tensor(np.array(v)) for k, v in _leaves(tree)}, strict=True)
    return module


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def model32():
    jcfg, cfg = _cfgs(compute_dtype="float32")
    params = j_lm.init_params(jax.random.PRNGKey(3), jcfg)
    return jcfg, cfg, params, convert_lm_params(_np(params), cfg, device="cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(5).integers(0, 512, (B, S_TOK)).astype(np.int32)


@pytest.fixture(scope="module")
def logits32(model32, tokens):
    jcfg, _, params, _ = model32
    return np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))


# ---- layers -------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", ["layernorm", "rmsnorm"])
def test_norm_matches_jax(norm_type, dtype):
    jcfg, cfg = _cfgs(norm_type=norm_type)
    rng = np.random.default_rng(0)
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if norm_type == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32) * 3 + 1
    want = j_layers.norm_apply(p, jnp.asarray(x).astype(dtype), jcfg)
    got = layers.norm_apply(_load(layers.norm_init(64, cfg), p), _t(x).to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype)  # computed in float32, cast back
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "relu2"])
def test_ffn_matches_jax(act):
    jcfg, cfg = _cfgs(ffn_act=act, compute_dtype="float32")
    p = _np(j_layers.ffn_init(jax.random.PRNGKey(1), jcfg, 128))
    x = np.random.default_rng(1).normal(size=(2, 7, 64)).astype(np.float32)
    want = j_layers.ffn_apply(p, jnp.asarray(x), jcfg)
    got = layers.ffn_apply(_load(layers.ffn_init(cfg, 128, device="cpu"), p), _t(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu defaults to tanh; PyTorch's default is the exact erf form."""
    _, cfg = _cfgs(compute_dtype="float32")
    x = torch.linspace(-4, 4, 401)
    assert torch.allclose(F.gelu(x, approximate="tanh"), torch.as_tensor(np.array(
        jax.nn.gelu(jnp.asarray(x.numpy())))), atol=1e-6)
    assert (F.gelu(x) - F.gelu(x, approximate="tanh")).abs().max() > 1e-4
    ffn = layers.ffn_init(cfg, 128, device="cpu")
    xs = torch.randn(1, 3, 64, generator=torch.Generator().manual_seed(0))
    h = xs @ ffn.wi.w
    assert torch.allclose(layers.ffn_apply(ffn, xs, cfg), F.gelu(h, approximate="tanh") @ ffn.wo.w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_rope_match_jax(dtype):
    jcfg, cfg = _cfgs(compute_dtype=dtype)
    p = _np(j_layers.dense_init(jax.random.PRNGKey(2), 64, (4, 16), jcfg, bias=True))
    p["b"] = np.random.default_rng(2).normal(size=(4, 16)).astype(np.float32)
    x = np.random.default_rng(3).normal(size=(2, 9, 64)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = j_layers.dense_apply(p, jx, jcfg, contract="bsd,dhe->bshe")
    got = layers.dense_apply(_load(layers.dense_init(64, (4, 16), cfg, bias=True), p),
                             _t(x).to(getattr(torch, dtype)), cfg)
    assert got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)
    pos = np.arange(100, 109)
    jsin, jcos = j_layers.rope_sin_cos(jnp.asarray(pos), 16, cfg.rope_theta)
    sin, cos = layers.rope_sin_cos(torch.as_tensor(pos), 16, cfg.rope_theta)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    want = j_layers.apply_rope(want, jsin[None], jcos[None])
    got = layers.apply_rope(got, sin[None], cos[None])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


def test_rope_is_rotate_half():
    """The halves are concatenated: dim i pairs with dim i + dh/2, not i ^ 1."""
    x = torch.zeros(1, 1, 1, 8)
    x[..., 0] = 1.0
    sin, cos = layers.rope_sin_cos(torch.tensor([3]), 8, 10_000.0)
    y = layers.apply_rope(x, sin[None], cos[None])[0, 0, 0]
    ang = 3.0
    assert torch.allclose(y, torch.tensor([math.cos(ang), 0, 0, 0, math.sin(ang), 0, 0, 0]),
                          atol=1e-6)


def test_vocab_padding_and_embedding():
    assert [layers.round_vocab(v) for v in (49152, 500, 512, 1)] == [49152, 512, 512, 256]
    _, cfg = _cfgs(vocab=500)
    model = lm.init_params(cfg, device="cpu")
    assert model.embed.table.shape == (512, 64)
    logits = lm.apply_train(model, {"tokens": torch.zeros((1, 4), dtype=torch.long)}, cfg)
    assert logits.shape == (1, 4, 512) and logits.dtype == torch.float32  # argmax spans 512


# ---- attention and blocks ----------------------------------------------------------
@pytest.mark.parametrize("flash", ["off", "on"])
def test_gqa_matches_jax_streaming_path(flash):
    """f32: the port's streaming path (flash off) and plain flash version
    (flash on) agree with the reference's streaming path to roundoff; bf16:
    the flash path against the streaming path at bf16 level (the stored
    probabilities are bf16 there, float32 in the flash path)."""
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 2e-2)):
        jcfg, cfg = _cfgs(compute_dtype=dtype)
        p = _np(j_attn.gqa_init(jax.random.PRNGKey(4), jcfg))
        x = np.random.default_rng(4).normal(size=(B, S_TOK, 64)).astype(np.float32)
        pos = np.arange(S_TOK)
        want, _ = j_attn.gqa_apply(p, jnp.asarray(x).astype(dtype), jcfg, positions=jnp.asarray(pos))
        module = _load(attention.gqa_init(cfg, device="cpu"), p)
        fa.launches = 0
        with attention.flash_enabled(flash):
            got, _ = attention.gqa_apply(module, _t(x).to(getattr(torch, dtype)), cfg,
                                         positions=torch.as_tensor(pos))
        assert fa.launches == 0  # CPU tensors: the plain version
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_flash_auto_means_cuda_tensors():
    x = torch.zeros(1)
    assert not attention._use_flash(x)
    with attention.flash_enabled("on"):
        assert attention._use_flash(x)
    with attention.flash_enabled("off"):
        assert not attention._use_flash(x)
    assert attention._use_flash(torch.zeros(1, device="meta")) is False


@pytest.mark.parametrize("parallel", [False, True])
def test_block_matches_jax(parallel):
    jcfg, cfg = _cfgs(compute_dtype="float32", parallel_block=parallel)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(6), jcfg, GQA))
    x = np.random.default_rng(6).normal(size=(B, 64, 64)).astype(np.float32)
    pos = np.arange(64)
    want, _ = j_blocks.block_apply(p, jnp.asarray(x), jcfg, GQA, positions=jnp.asarray(pos))
    block = _load(blocks.block_init(cfg, GQA, device="cpu"), p)
    assert (block.norm2 is None) == parallel
    got, _ = blocks.block_apply(block, _t(x), cfg, GQA, positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("parallel", [False, True])
def test_moe_block_matches_jax(parallel):
    """The MoE FFN is ported: a ``ffn="moe"`` block builds, takes the
    reference's weights and gives its output (float32 compute)."""
    desc = LayerDesc(mixer="gqa", ffn="moe")
    kw = dict(compute_dtype="float32", parallel_block=parallel, n_experts=4, top_k=2,
              d_ff_expert=32)
    jcfg, cfg = _cfgs(**kw)
    p = _np(j_blocks.block_init(jax.random.PRNGKey(8), jcfg, desc))
    x = np.random.default_rng(8).normal(size=(B, 32, 64)).astype(np.float32)
    pos = np.arange(32)
    want, _ = j_blocks.block_apply(p, jnp.asarray(x), jcfg, desc, positions=jnp.asarray(pos))
    block = _load(blocks.block_init(cfg, desc, device="cpu"), p)
    assert tuple(block.ffn.wi.shape) == (4, 64, 32) and (block.norm2 is None) == parallel
    got, _ = blocks.block_apply(block, _t(x), cfg, desc, positions=torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# ---- the model ---------------------------------------------------------------------
def test_apply_train_f32_matches_jax(model32, tokens, logits32):
    _, cfg, params, model = model32
    assert lm.count_params(model) == j_lm.count_params(params)
    assert len(model.groups[0]) == 2  # the scan axis, unstacked
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert got.shape == logits32.shape == (B, S_TOK, 512)
    np.testing.assert_allclose(got.numpy(), logits32, atol=1e-4)


def test_apply_train_flash_on_matches_jax_streaming(model32, tokens, logits32):
    """Flash forced on (the plain version on a CPU tensor) against the
    reference's streaming path, at the flash-vs-streaming tolerance."""
    _, cfg, _, model = model32
    with attention.flash_enabled("on"):
        got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    np.testing.assert_allclose(got.numpy(), logits32, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), logits32, atol=1e-4)  # f32 compute: roundoff


def test_apply_train_bf16_matches_jax(model32, tokens):
    jcfg, cfg, params, _ = model32
    jcfg, cfg = (dataclasses.replace(c, compute_dtype="bfloat16") for c in (jcfg, cfg))
    want = np.asarray(jax.jit(lambda p, t: j_lm.apply_train(p, {"tokens": t}, jcfg))(
        params, jnp.asarray(tokens)))
    model = convert_lm_params(_np(params), cfg, device="cpu")
    got = lm.apply_train(model, {"tokens": torch.as_tensor(tokens)}, cfg)
    assert got.dtype == torch.float32 and model.embed.table.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-2)


def test_apply_decode_and_greedy_match_jax(model32, tokens):
    """Eight cached steps: logits equal to the reference's and to the
    full forward's; greedy tokens equal to the reference's (bf16 cache, the
    default, in both)."""
    jcfg, cfg, params, model = model32
    n = 8
    jstep = jax.jit(lambda p, t, c, n_: j_lm.apply_decode(p, t, c, n_, jcfg))
    jcache = j_lm.init_cache(jcfg, B, n, dtype=jnp.float32)
    cache = lm.init_cache(cfg, B, n, dtype=torch.float32, device="cpu")
    full = lm.apply_train(model, {"tokens": torch.as_tensor(tokens[:, :n])}, cfg).numpy()
    for t in range(n):
        jl, jcache = jstep(params, jnp.asarray(tokens[:, t:t + 1]), jcache, jnp.int32(t))
        pl, cache = lm.apply_decode(model, torch.as_tensor(tokens[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=1e-5)
        np.testing.assert_allclose(pl[:, 0].numpy(), full[:, t], atol=1e-5)
    prompt = tokens[:, :4]
    want = np.asarray(j_serve.greedy_generate(params, jcfg, jnp.asarray(prompt), n))
    got = serve_step.greedy_generate(model, cfg, torch.as_tensor(prompt), n)
    assert got.dtype == torch.int32 and got.shape == (B, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_prefill_step_is_the_last_positions_argmax(model32, tokens, logits32):
    _, cfg, _, model = model32
    got = serve_step.make_prefill_step(cfg)(model, {"tokens": torch.as_tensor(tokens)})
    np.testing.assert_array_equal(got.numpy(), logits32[:, -1].argmax(-1))


def test_ring_buffer_decode_past_the_window():
    """Decode 3× past the window: the ring-buffered cache (window slots,
    slot = t % window, the reference's valid mask) gives the reference's
    cached logits at every step and the full forward's."""
    jcfg, cfg = _cfgs(compute_dtype="float32", sliding_window=8)
    params = j_lm.init_params(jax.random.PRNGKey(7), jcfg)
    model = convert_lm_params(_np(params), cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, 512, (1, 24)).astype(np.int32)
    full = lm.apply_train(model, {"tokens": torch.as_tensor(toks)}, cfg)
    jstep = jax.jit(lambda p, t, c, n_: j_lm.apply_decode(p, t, c, n_, jcfg))
    jcache = j_lm.init_cache(jcfg, 1, 24, dtype=jnp.float32)
    cache = lm.init_cache(cfg, 1, 24, dtype=torch.float32, device="cpu")
    assert cache["groups"][0][0]["l0"]["mixer"].k.shape[1] == 8
    outs = []
    for t in range(24):
        jl, jcache = jstep(params, jnp.asarray(toks[:, t:t + 1]), jcache, jnp.int32(t))
        lg, cache = lm.apply_decode(model, torch.as_tensor(toks[:, t:t + 1]), cache, t, cfg)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jl), atol=1e-5)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(), atol=1e-5)


def test_cache_defaults():
    _, cfg = _cfgs()
    for s_max, slots in ((40, 40), (64, 64), (100, 64)):
        c = lm.init_cache(cfg, 3, s_max, device="cpu")["groups"][0][1]["l0"]["mixer"]
        assert c.k.dtype == torch.bfloat16 and c.k.shape == (3, slots, 2, 16)


def test_full_size_count_from_shapes():
    cfg = get_config("starcoder2-3b")
    model = lm.init_params(cfg, device="meta")
    assert lm.count_params(model) == 3_029_818_368
    assert lm.count_params(model) - cfg.n_params_estimate == 482_304  # biases and norms
    assert model.groups[0][29]["l0"].mixer.wq.w.shape == (3072, 24, 128)


def test_configs_match_the_reference():
    assert list_archs() == ["command-r-35b", "deepseek-v2-236b", "jamba-v0.1-52b",
                            "minitron-8b", "mixtral-8x22b", "pixtral-12b", "qwen2.5-32b",
                            "rwkv6-3b", "seamless-m4t-medium", "starcoder2-3b"]
    for name in list_archs():
        want, got = j_get_config(name), get_config(name)
        for j, p in ((want, got), (want.reduced(), got.reduced())):
            assert dataclasses.asdict(p) == dataclasses.asdict(j)
            assert p.n_params_estimate == j.n_params_estimate


@pytest.mark.parametrize("shared", [0, 2])
def test_moe_param_count_matches_jax(shared):
    """The MoE FFN is counted by the reference's formula: router, routed and
    shared experts."""
    kw = dict(pattern=(LayerDesc(ffn="moe"),), n_experts=8, top_k=2, d_ff_expert=1024,
              n_shared_experts=shared)
    want = dataclasses.replace(j_get_config("starcoder2-3b"), **kw)
    got = dataclasses.replace(get_config("starcoder2-3b"), **kw)
    assert got.n_params_estimate == want.n_params_estimate
    assert got.reduced().n_params_estimate == want.reduced().n_params_estimate


def test_entry_points_default_to_the_card():
    _, cfg = _cfgs()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device exists: the default is valid here")
    from repro_torch.device import DeviceUnavailableError

    for call in (lambda: lm.init_params(cfg), lambda: lm.init_cache(cfg, 1, 4),
                 lambda: convert_lm_params({}, cfg)):
        with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
            call()


def test_serve_cli_rehearses_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--device", "cpu", "--batch", "2",
                                     "--prompt-len", "3", "--new-tokens", "4"])
    serve.main()
    out = capsys.readouterr().out
    assert "[serve] rwkv6-3b-reduced on CPU: 8 tokens" in out
