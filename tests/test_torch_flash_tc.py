"""The flash kernel's tensor-core body modelled in torch, on the CPU.

``csrc/flash_attention.cu``'s bfloat16 body (``flash_tc_kernel``) runs
``wgmma`` on bf16 tiles; it cannot run here, so its arithmetic is modelled
tile by tile: CTAs of 128 rows (two warpgroups of 64, rows that straddle
positions when G does not divide 128) over the band's 64-key blocks of the
CTA, S = Q·Kᵀ of the unscaled bf16 values in float32 (their products are
exact), then × scale·log2(e) and the online softmax in base 2 with the
-1e30 sentinel, P split into ``hi = bf16(p)`` and ``lo = bf16(p - hi)``
whose two products with V accumulate in float32, and ``acc / max(l,
1e-30)`` rounded to bf16. The model is held against the JAX package's
``ref_mha`` at ``chip_smoke.py`` phase 15's bf16 limit, atol 2e-5 +
2^-8·|ref| (one rounding of the float32 result). The single-bf16-P variant
is run beside it and its worst share of that limit printed: the record of
why P is split (it is not a pass condition). The tile plan, the band's
blocks over 128-row tiles and the edge-block predicate (which blocks the
body masks) are checked too.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro._unused.flash_attention import ref_mha as j_ref_mha
from repro_torch._unused import flash_attention as fa

ATOL, RTOL = 2e-5, 2.0 ** -8  # chip_smoke.py phase 15, bf16
ROWS, KEYS = fa.TC_ROWS_PER_CTA, fa.TC_KEYS_PER_BLOCK
LOG2E = 1.4426950408889634


def _bf16_inputs(seed, B, S, T, Hkv, G, dh):
    rng = np.random.default_rng(seed)
    mk = lambda *shape: torch.as_tensor(rng.normal(size=shape).astype(np.float32)).bfloat16()
    return mk(B, S, Hkv, G, dh), mk(B, T, Hkv, dh), mk(B, T, Hkv, dh)


def tc_model(q, k, v, *, causal, window, scale, split=True):
    """The tensor-core body's arithmetic, one CTA and one warpgroup at a time."""
    B, S, Hkv, G, D = q.shape
    T = k.shape[1]
    n_rows = S * G
    (gx, gy), _, _ = fa.tc_tile_plan(B, S, Hkv, G, D)
    c = torch.tensor(scale * LOG2E, dtype=torch.float32)
    masked = torch.tensor(fa.NEG_INF, dtype=torch.float32)
    out = torch.zeros(q.shape, dtype=torch.bfloat16)
    for by in range(gy):
        b, h = divmod(by, Hkv)
        qrows = q[b, :, h].reshape(n_rows, D).float()
        for bx in range(gx):
            row0 = (gx - 1 - bx) * ROWS  # heaviest tiles first
            rows = min(ROWS, n_rows - row0)
            lo_blk, hi_blk = fa.band_blocks(row0, rows, G, T, causal, window)
            for wg in range(2):
                r0 = row0 + wg * 64
                Q = torch.zeros((64, D))
                n_valid = max(0, min(64, n_rows - r0))
                Q[:n_valid] = qrows[r0:r0 + n_valid]
                pos = (r0 + torch.arange(64)) // G
                m = torch.full((64,), fa.NEG_INF)
                l = torch.zeros(64)
                acc = torch.zeros((64, D))
                for kb in range(lo_blk, hi_blk):
                    t = kb * KEYS + torch.arange(KEYS)
                    Kt, Vt = torch.zeros((KEYS, D)), torch.zeros((KEYS, D))  # zero past T
                    Kt[t < T], Vt[t < T] = k[b, t[t < T], h].float(), v[b, t[t < T], h].float()
                    s = (Q @ Kt.T) * c
                    if fa.tc_block_needs_mask(r0, n_rows, G, T, kb, causal, window):
                        ok = torch.ones((64, KEYS), dtype=torch.bool)
                        if causal:
                            ok &= t[None, :] <= pos[:, None]
                        if window:
                            ok &= t[None, :] > pos[:, None] - window
                        s = torch.where(ok, s, masked)  # outside the band: the sentinel
                        s = torch.where((t < T)[None, :], s, -torch.inf)  # past T: weight 0
                    m_new = torch.maximum(m, s.max(1).values)
                    alpha = torch.exp2(m - m_new)
                    p = torch.exp2(s - m_new[:, None])
                    l = l * alpha + p.sum(1)
                    m = m_new
                    hi = p.bfloat16()
                    acc = acc * alpha[:, None] + hi.float() @ Vt
                    if split:
                        acc = acc + (p - hi.float()).bfloat16().float() @ Vt
                res = (acc / torch.clamp(l, min=1e-30)[:, None]).bfloat16()
                for r in range(n_valid):
                    R = r0 + r
                    out[b, R // G, h, R % G] = res[r]
    return out


CASES = [  # B, S, T, Hkv, G, dh, causal, window
    (1, 40, 40, 1, 12, 128, True, 20),  # G = 12: tiles straddle positions; S·G = 480
    (1, 70, 70, 2, 12, 64, True, 30),  # a window below one key block
    (1, 36, 100, 1, 5, 32, False, None),  # T != S, ragged last key block
    (2, 64, 40, 1, 2, 16, False, None),  # T < S, dh = 16
    (1, 96, 96, 1, 4, 64, True, None),
    (1, 300, 200, 1, 3, 32, False, 70),  # rows at p >= T + w - 1 see no key
]


@pytest.mark.parametrize("B,S,T,Hkv,G,dh,causal,window", CASES)
def test_split_p_model_meets_the_bf16_limit(B, S, T, Hkv, G, dh, causal, window):
    q, k, v = _bf16_inputs(B * S + T + G + dh, B, S, T, Hkv, G, dh)
    scale = 1.0 / math.sqrt(dh)
    want = np.asarray(j_ref_mha(*(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                                  for a in (q, k, v)), causal=causal, window=window), np.float32)
    limit = ATOL + RTOL * np.abs(want)
    shares = {}
    for split in (True, False):
        got = tc_model(q, k, v, causal=causal, window=window, scale=scale, split=split)
        assert got.dtype == torch.bfloat16 and got.shape == q.shape
        shares[split] = float((np.abs(got.float().numpy() - want) / limit).max())
    print(f"worst share of atol {ATOL} + 2^-8·|ref|: split P {shares[True]:.3f}, "
          f"single bf16 P {shares[False]:.3f}")
    assert np.isfinite(shares[True]) and shares[True] <= 1.0


def test_tc_tile_plan():
    grid, threads, smem = fa.tc_tile_plan(2, 8192, 2, 12, 128)  # StarCoder2-3B prefill
    assert grid == (8192 * 12 // 128, 4) and threads == 288
    # Q 32 KB + TC_STAGES stages of K and V (16 KB each) + barriers and 1 KB alignment slack
    n_st = fa.TC_STAGES
    assert smem == 128 * 256 + n_st * 2 * 64 * 256 + 1024 + 64 and smem <= 232448
    assert fa.tc_tile_plan(1, 100, 1, 3, 16) == ((3, 1), 288, 128 * 32 + n_st * 2 * 64 * 32 + 1088)
    with pytest.raises(ValueError, match="head_dim"):
        fa.tc_tile_plan(1, 64, 1, 1, 48)


@pytest.mark.parametrize("S,T,G,causal,window", [
    (40, 40, 12, True, None), (40, 40, 12, True, 7), (200, 200, 3, True, 50),
    (40, 100, 5, False, None), (40, 100, 2, False, 50), (300, 300, 1, True, 70),
    (300, 200, 3, False, 70),  # tiles with rows that see no key walk every block
])
def test_band_blocks_over_128_row_tiles(S, T, G, causal, window):
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
        if not ok.any(1).all():  # a row with no key: every block
            want = list(range(-(-T // KEYS)))
        lo, hi = fa.band_blocks(row0, rows, G, T, causal, window)
        assert list(range(lo, hi)) == want
        for wg in range(2):  # a block the body does not mask has every key valid for every row
            r0 = row0 + wg * 64
            wpos = (r0 + np.arange(64)) // G
            wpos = wpos[r0 + np.arange(64) < n_rows]
            for kb in range(lo, hi):
                if fa.tc_block_needs_mask(r0, n_rows, G, T, kb, causal, window):
                    continue
                tk = kb * KEYS + np.arange(KEYS)
                assert (tk < T).all() and len(wpos)
                if causal:
                    assert (tk[None] <= wpos[:, None]).all()
                if window:
                    assert (tk[None] > wpos[:, None] - window).all()
