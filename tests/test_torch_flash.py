"""The port's flash attention against the JAX package, on the CPU.

The same numpy inputs go through ``repro._unused.flash_attention`` (the
Pallas kernel in interpret mode) and ``repro_torch._unused.flash_attention``
(the wrapper, which runs its plain version ``ref_mha`` on a CPU tensor), over
the sweep of ``tests/test_flash_attention.py`` with its tolerances: f32 atol
2e-5 / rtol 1e-5, bf16 3e-2. The wrapper's ``ValueError``s match the
reference's.

The CUDA kernel ``csrc/flash_attention.cu`` cannot run here. Its tile plan,
band block range and argument list are Python functions the tests reach,
and the kernel is modelled CTA by CTA and thread by thread in numpy (row
and key ownership, the 16-thread row reductions, the PV dims, the band's
blocks and the -1e30 sentinel) and held against ``ref_mha``;
``chip_smoke.py`` holds the kernel itself against ``ref_mha`` on the card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro._unused.flash_attention import flash_attention as j_flash
from repro_torch._unused import flash_attention as fa

F32_TOL = dict(atol=2e-5, rtol=1e-5)
BF16_TOL = dict(atol=3e-2, rtol=3e-2)


def _mk(seed, B, S, T, Hkv, G, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, S, Hkv, G, dh)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, dh)).astype(np.float32)
    return q, k, v


# B, S, T, Hkv, G, dh, causal, window, q_chunk, kv_chunk, dtype — the reference's sweep
SWEEP = [
    *[(B, S, S, Hkv, G, dh, causal, None, 64, 64, "float32")
      for (B, S, Hkv, G, dh) in [(2, 128, 2, 1, 32), (1, 256, 1, 4, 64), (2, 64, 4, 2, 16)]
      for causal in (True, False)],
    (1, 128, 128, 2, 2, 32, True, 32, 32, 32, "float32"),  # sliding window
    (1, 128, 128, 2, 2, 64, True, None, 64, 64, "bfloat16"),
    (1, 64, 128, 2, 2, 32, False, None, 32, 64, "float32"),  # T != S
    (1, 128, 128, 1, 3, 32, False, 40, 64, 64, "float32"),  # non-causal window
]


@pytest.mark.parametrize("B,S,T,Hkv,G,dh,causal,window,qc,kc,dtype", SWEEP)
def test_plain_matches_jax_kernel(B, S, T, Hkv, G, dh, causal, window, qc, kc, dtype):
    q, k, v = _mk(B * S + T + G, B, S, T, Hkv, G, dh)
    kw = dict(causal=causal, window=window, q_chunk=qc, kv_chunk=kc)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    want = j_flash(*(jnp.asarray(a).astype(jd) for a in (q, k, v)), interpret=True, **kw)
    fa.launches = 0
    got = fa.flash_attention(*(torch.as_tensor(a).to(td) for a in (q, k, v)), **kw)
    assert got.dtype == td and got.shape == q.shape and fa.launches == 0
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(BF16_TOL if dtype == "bfloat16" else F32_TOL))


@pytest.mark.parametrize("S,T,qc,kc", [(96, 96, 64, 64), (128, 96, 64, 64), (64, 200, 64, 64)])
def test_chunks_that_do_not_divide_raise_like_the_reference(S, T, qc, kc):
    q, k, v = _mk(0, 1, S, T, 1, 2, 16)
    with pytest.raises(ValueError) as want:
        j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_chunk=qc, kv_chunk=kc,
                interpret=True)
    with pytest.raises(ValueError) as got:
        fa.flash_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                           q_chunk=qc, kv_chunk=kc)
    assert str(got.value) == str(want.value)


# ---- the kernel's helpers ---------------------------------------------------------
def test_tile_plan():
    grid, threads, smem = fa.tile_plan(2, 8192, 2, 12, 128)  # StarCoder2-3B prefill
    assert grid == (8192 * 12 // 64, 4) and threads == 256
    assert smem == 4 * 3 * 64 * 132 and 2 * smem <= 233472  # two CTAs per SM
    assert fa.tile_plan(1, 100, 1, 3, 16) == ((5, 1), 256, 4 * (64 * 20 + 64 * 68 + 64 * 20))
    with pytest.raises(ValueError, match="head_dim"):
        fa.tile_plan(1, 64, 1, 1, 48)


def test_launch_args_packing():
    q, k, v = _mk(0, 2, 64, 128, 2, 3, 32)
    q, k, v = (torch.as_tensor(a) for a in (q, k, v))
    out = torch.empty_like(q)
    args = fa.launch_args(q, k, v, out, causal=False, window=16, scale=0.125)
    assert args == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    2, 64, 128, 2, 3, 32, 0, 0, 16, 0.125)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    args = fa.launch_args(qb, kb, vb, torch.empty_like(qb), causal=True, window=None, scale=1.0)
    assert args[10:] == (1, 1, -1, 1.0)
    bad = [
        (q.half(), k.half(), v.half(), out.half(), {}, "float32 or bfloat16"),
        (q, kb, v, out, {}, "k is"),
        (q, k.transpose(1, 2), v, out, {}, "shapes"),
        (q, k[:, ::2], v[:, ::2], out, {}, "contiguous"),
        (q, k, v, out, {"window": 0}, "window"),
        (q[..., :16].contiguous(), k[..., :16].contiguous(), v[..., :16].contiguous(),
         out[..., :16].contiguous(), {}, None),
    ]
    for qq, kk, vv, oo, kw, msg in bad:
        kw = {"causal": True, "window": None, "scale": 1.0, **kw}
        if msg is None:
            fa.launch_args(qq, kk, vv, oo, **kw)  # dh = 16 is built
            continue
        with pytest.raises(ValueError, match=msg):
            fa.launch_args(qq, kk, vv, oo, **kw)
    q48 = torch.zeros((1, 64, 1, 1, 48))
    with pytest.raises(ValueError, match="head_dim"):
        fa.launch_args(q48, torch.zeros((1, 64, 1, 48)), torch.zeros((1, 64, 1, 48)),
                       torch.empty_like(q48), causal=True, window=None, scale=1.0)


ROWS, KEYS, THREADS = fa.ROWS_PER_CTA, fa.KEYS_PER_BLOCK, fa.THREADS


def _thread_maps(D):
    """Per thread (rg, cg): its 4 rows, its 4 keys in the score phase and its
    dims in the PV phase, as csrc/flash_attention.cu indexes them."""
    vec = 4 if D >= 64 else D // 16
    nv = D // (16 * vec)
    maps = []
    for tid in range(THREADS):
        rg, cg = tid >> 4, tid & 15
        rows = [rg * 4 + i for i in range(4)]
        keys = [cg + 16 * j for j in range(4)]
        dims = [n * 16 * vec + cg * vec + c for n in range(nv) for c in range(vec)]
        maps.append((rows, keys, dims))
    return maps


def _kernel_model(q, k, v, *, causal, window, scale, masked=fa.NEG_INF):
    """numpy model of csrc/flash_attention.cu, one CTA and one thread at a
    time. Returns (out, CTAs that saw a block entirely masked for one of
    their rows before that row's first valid key)."""
    B, S, Hkv, G, D = q.shape
    T = k.shape[1]
    n_rows = S * G
    (gx, gy), threads, _ = fa.tile_plan(B, S, Hkv, G, D)
    assert threads == THREADS
    maps = _thread_maps(D)
    out = np.zeros(q.shape, np.float32)
    sentinel_ctas = 0
    for by in range(gy):
        b, h = divmod(by, Hkv)
        qrows = q[b, :, h].reshape(n_rows, D).astype(np.float32)
        for bx in range(gx):
            row0 = (gx - 1 - bx) * ROWS
            rows = min(ROWS, n_rows - row0)
            Qs = np.zeros((ROWS, D), np.float32)
            Qs[:rows] = qrows[row0:row0 + rows] * np.float32(scale)
            pos = (row0 + np.arange(ROWS)) // G
            m = np.full(ROWS, masked, np.float32)
            l = np.zeros(ROWS, np.float32)
            acc = np.zeros((ROWS, D), np.float32)
            lo, hi = fa.band_blocks(row0, rows, G, T, causal, window)
            saw_sentinel = False
            for kb in range(lo, hi):
                t = kb * KEYS + np.arange(KEYS)
                Ks = np.zeros((KEYS, D), np.float32)
                Vs = np.zeros((KEYS, D), np.float32)
                ok_t = t < T
                Ks[ok_t], Vs[ok_t] = k[b, t[ok_t], h], v[b, t[ok_t], h]
                # score phase: thread partials, then the 16-thread row reductions
                part_max = np.full((ROWS, 16), masked, np.float32)
                s = np.zeros((ROWS, KEYS), np.float32)
                for tid, (rws, kys, _) in enumerate(maps):
                    cg = tid & 15
                    st = Qs[rws] @ Ks[kys].T
                    ok = np.ones((len(rws), len(kys)), bool)
                    if causal:
                        ok = ok & (np.array(kys)[None, :] + kb * KEYS <= pos[rws][:, None])
                    if window:
                        ok = ok & (np.array(kys)[None, :] + kb * KEYS > pos[rws][:, None] - window)
                    st = np.where(ok, st, np.float32(masked))
                    st = np.where(ok_t[kys][None, :], st, np.float32(-np.inf))  # past T
                    s[np.ix_(rws, kys)] = st
                    part_max[rws, cg] = st.max(1)
                mx = part_max.max(1)
                valid_rows = np.arange(ROWS) < rows
                saw_sentinel |= bool(((m == masked) & (mx == masked) & valid_rows).any())
                with np.errstate(invalid="ignore"):
                    m_new = np.maximum(m, mx)
                    alpha = np.exp(m - m_new)
                    p = np.exp(s - m_new[:, None])
                l = l * alpha + p.sum(1)
                m = m_new
                # PV phase: each thread its 4 rows × its dims
                new_acc = acc * alpha[:, None]
                for rws, _, dims in maps:
                    new_acc[np.ix_(rws, dims)] += p[rws] @ Vs[:, dims]
                acc = new_acc
            sentinel_ctas += saw_sentinel
            res = acc / np.maximum(l, np.float32(1e-30))[:, None]
            for r in range(rows):
                R = row0 + r
                out[b, R // G, h, R % G] = res[r]
    return out, sentinel_ctas


def test_thread_maps_partition_the_tiles():
    for D in fa.HEAD_DIMS:
        maps = _thread_maps(D)
        cover = np.zeros((ROWS, KEYS), int)
        dims_cover = np.zeros((ROWS, D), int)
        for rows, keys, dims in maps:
            cover[np.ix_(rows, keys)] += 1
            dims_cover[np.ix_(rows, dims)] += 1
        assert (cover == 1).all() and (dims_cover == 1).all()


@pytest.mark.parametrize("S,T,G,causal,window", [
    (40, 40, 3, True, None), (40, 40, 3, True, 7), (64, 64, 2, True, 32),
    (40, 100, 2, False, None), (40, 100, 2, False, 50), (100, 100, 1, True, 70),
])
def test_band_blocks_are_exactly_the_blocks_with_a_valid_key(S, T, G, causal, window):
    n_rows = S * G
    for row0 in range(0, n_rows, ROWS):
        rows = min(ROWS, n_rows - row0)
        pos = (row0 + np.arange(rows)) // G
        t = np.arange(T)
        ok = np.ones((rows, T), bool)
        if causal:
            ok &= t[None] <= pos[:, None]
        if window:
            ok &= t[None] > pos[:, None] - window
        want = sorted({int(x) // KEYS for x in np.nonzero(ok.any(0))[0]})
        lo, hi = fa.band_blocks(row0, rows, G, T, causal, window)
        assert list(range(lo, hi)) == want


@pytest.mark.parametrize("B,S,T,Hkv,G,D,causal,window", [
    (1, 96, 96, 2, 2, 32, True, 20),  # windowed: rows meet fully masked blocks first
    (1, 80, 80, 1, 3, 16, True, None),
    (1, 48, 130, 1, 2, 64, False, None),  # a ragged last key block
    (2, 40, 40, 1, 5, 128, False, 9),
    (1, 100, 70, 1, 3, 32, False, 20),  # rows at p >= T + w - 1 see no key
])
def test_kernel_model_matches_ref_mha(B, S, T, Hkv, G, D, causal, window):
    q, k, v = _mk(S + T + D, B, S, T, Hkv, G, D)
    scale = 1.0 / math.sqrt(D)
    got, sentinel_ctas = _kernel_model(q, k, v, causal=causal, window=window, scale=scale)
    want = fa.ref_mha(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal, window=window)
    np.testing.assert_allclose(got, want.numpy(), **F32_TOL)
    if window == 20:
        assert sentinel_ctas > 0  # the case the -1e30 sentinel exists for is reached
        inf_out, _ = _kernel_model(q, k, v, causal=causal, window=window, scale=scale,
                                   masked=-np.inf)
        assert np.isnan(inf_out).any()  # with -inf that case gives NaN
