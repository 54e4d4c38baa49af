"""K2-prefix with lanes on blocks and the fused kernel's prefix tail on the
warp bodies (``csrc/traceback.cu``, ``csrc/fused.cu``,
``csrc/traceback_core.cuh``), modelled in numpy on the CPU.

The CUDA kernels cannot run here, so both bodies are modelled lane by lane,
vectorized over the lanes of every CTA:

- K2-prefix: a CTA of Gb parallel blocks (the size class its planner picks,
  a power of two up to 32) and ``prefix_warps`` warps; lane l is block
  l & (Gb - 1) and sub-lane l / Gb; sub-lane j of warp w composes items
  j + (32/Gb)(w + nw·r) of the block's n_act·N/K (chunk, K states) items,
  K = min(N, 32) chains per thread; one thread per block walks the maps;
  (decode chunk, block) pairs expand on threads, block fastest.
- The fused tail: a one-warp CTA of G blocks × L = N/S lanes (the G of
  ``fused.smem_plan(..., "prefix", lanes=L)``), lane = j·G + g, 32 chains
  per lane, over the CTA's ``[t][w][g]`` history (the history of blocks
  past B is garbage, as the ACS never stores it); a lane of phase C gathers
  a window word in a register and ors it into the shared window once.

Both carry the chains as the kernels do: the complement u = ~h, words
complemented and reversed, a select on bits 5 and 6 of u for W <= 4 and two
funnel shifts per step. The models assert that a chain only steps through
the words its lane loaded for that row (a ring of ``LANE_DEPTH`` rows in
flight), that no lane loads a word of a block past B or a stage at or past
T, that every map is written once, and that nothing is stored for lanes
past B. Their bits must equal JAX ``traceback_ref`` and the port's plain
versions on seeded numpy words for N = 64 and 256, ragged B, ``tb_chunk``
1, 7, 64 and > T, ``decode_start`` 0 and > 0 and zero and random starts,
and, in one small case each, JAX ``traceback_prefix_pallas`` and
``pbvd_fused_pallas(tb_mode="prefix")`` in interpret mode. Also here: the
planners against the parent's (every geometry it accepted is accepted,
every one it refused is refused with the same message) and the routing of
the mother codes' prefix walk to the warp bodies. ``chip_smoke.py`` holds
the kernels themselves against the plain versions on the card.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.kernels import ref as j_ref
from repro.kernels.fused import pbvd_fused_pallas
from repro.kernels.traceback import traceback_prefix_pallas
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused, ref, traceback

M32 = 0xFFFFFFFF
LANE_DEPTH = 4  # traceback_core.cuh: kLaneDepth
MAX_WARPS = 16  # traceback.cu: kPrefixMaxWarps
MOTHERS = ("ccsds", "is95-k9", "lte-1/3")
# N = 64 (CCSDS, W = 2) and 256 (IS-95, W = 8), and two small codes (W = 1)
POLYS = {4: ((1, 1, 1), (1, 0, 1)), 16: ((1, 0, 0, 1, 1), (1, 1, 1, 0, 1)),
         64: ((1, 1, 1, 1, 0, 0, 1), (1, 0, 1, 1, 0, 1, 1)),
         256: ((1, 0, 1, 1, 1, 0, 0, 0, 1), (1, 1, 1, 1, 0, 1, 0, 1, 1))}


# ---- the chain arithmetic of traceback_core.cuh ---------------------------------

def chain_step(u, x, hi_ones):
    """chain_step: rotate ~word left by u & 31, shift its bit 31 into u."""
    s = u & 31
    r = ((x << s) | (x >> (32 - s))) & M32
    return (((u << 1) | (r >> 31)) | hi_ones) & M32


def pick_word(rw, u, W):
    """pick_word<kW>: rw (..., W) are a row's words complemented and reversed."""
    if W == 1:
        return rw[..., 0]
    lo = np.where(u & 32, rw[..., 1], rw[..., 0])
    if W == 2:
        return lo
    return np.where(u & 64, np.where(u & 32, rw[..., 3], rw[..., 2]), lo)


def compose(C, stage0, s0, act, N, W, K, load_row, load_word):
    """compose_chains for every thread at once: stage0, s0, act (n,); returns
    the (n, K) composed maps. The ring of LANE_DEPTH rows loaded ahead is
    tracked by stage, and a chain steps only through the row it waits for."""
    hi_ones = (~(N - 1)) & M32 if W == 1 else 0
    u = ~(s0[:, None] + np.arange(K)[None, :]) & M32
    if W <= 4:
        buf = np.zeros((LANE_DEPTH, len(s0), W), np.int64)
        held = np.full((LANE_DEPTH, len(s0)), -(1 << 40))
        for d in range(LANE_DEPTH):
            if C - 1 - d >= 0:
                buf[d], held[d] = load_row(stage0 + C - 1 - d, act), stage0 + C - 1 - d
        for r0 in range(C - 1, -1, -LANE_DEPTH):
            for d in range(LANE_DEPTH):
                row = r0 - d
                if row < 0:
                    continue
                assert (held[d][act] == (stage0 + row)[act]).all(), "a chain read a row not loaded"
                u = chain_step(u, pick_word(buf[d][:, None, :], u, W), hi_ones)
                if row - LANE_DEPTH >= 0:
                    buf[d], held[d] = (load_row(stage0 + row - LANE_DEPTH, act),
                                       stage0 + row - LANE_DEPTH)
    else:
        for row in range(C - 1, -1, -1):
            u = chain_step(u, load_word(stage0 + row, (~u >> 5) & (W - 1), act), 0)
    return ~u & (N - 1)


def expand(C, stage0, h, act, log2n, W, load_row, load_word, emit):
    """expand_chain for every task at once: emit(row, bits) at rows C-1 .. 0,
    stepping through rows C-1 .. 1."""
    N = 1 << log2n
    hi_ones = (~(N - 1)) & M32 if W == 1 else 0
    u = ~h & M32
    buf = np.zeros((LANE_DEPTH, len(h), max(W, 1)), np.int64)
    held = np.full((LANE_DEPTH, len(h)), -(1 << 40))
    if W <= 4:
        for d in range(LANE_DEPTH):
            if C - 1 - d >= 1:
                buf[d], held[d] = load_row(stage0 + C - 1 - d, act), stage0 + C - 1 - d
    for r0 in range(C - 1, -1, -LANE_DEPTH):
        for d in range(LANE_DEPTH):
            row = r0 - d
            if row < 0:
                continue
            emit(row, (~u >> (log2n - 1)) & 1)
            if row == 0:
                continue
            if W <= 4:
                assert (held[d][act] == (stage0 + row)[act]).all(), "a chain read a row not loaded"
                u = chain_step(u, pick_word(buf[d], u, W), hi_ones)
                if row - LANE_DEPTH >= 1:
                    buf[d], held[d] = (load_row(stage0 + row - LANE_DEPTH, act),
                                       stage0 + row - LANE_DEPTH)
            else:
                u = chain_step(u, load_word(stage0 + row, (~u >> 5) & (W - 1), act), 0)


def loaders(words, T, W, where, act_ok):
    """load_row / load_word over ``words[stage, w, where]``: complemented,
    the zero pad below stage 0; loading lanes must pass ``act_ok``."""

    def load_word(stage, w, act):
        assert act_ok[act].all(), "a lane loaded a word of a block past B"
        assert (stage[act] < T).all(), "a lane loaded a stage at or past T"
        st = np.broadcast_to(stage[:, None] if np.ndim(w) == 2 else stage, np.shape(w))
        loc = np.broadcast_to(where[:, None] if np.ndim(w) == 2 else where, np.shape(w))
        on = np.broadcast_to(act[:, None] if np.ndim(w) == 2 else act, np.shape(w)) & (st >= 0)
        x = np.zeros(np.shape(w), np.int64)
        x[on] = words[st[on], w[on], loc[on]]
        return ~x & M32

    def load_row(stage, act):
        return np.stack([load_word(stage, np.full(len(stage), W - 1 - k), act)
                         for k in range(W)], axis=-1)

    return load_row, load_word


# ---- K2-prefix with lanes on blocks ------------------------------------------------

def prefix_warps(n_items, log2g):
    """traceback.cu::prefix_warps."""
    rounds = -(-n_items // (32 >> log2g))
    per_warp = -(-rounds // MAX_WARPS)
    return -(-rounds // per_warp)


def k2_prefix_model(sp, log2n, ds, nd, start, tb_chunk, G=None):
    """traceback.cu::traceback_prefix_lanes_kernel: bits (nd, B)."""
    T, W, B = sp.shape
    N = 1 << log2n
    C, P, n_chunks, c_lo, c_hi = traceback.prefix_chunk_geometry(T, ds, nd, tb_chunk)
    n_act, nc_e, ds_local = n_chunks - c_lo, c_hi - c_lo + 1, ds + P - c_lo * C
    if G is None:
        G = traceback.prefix_smem_plan(N, n_act, nc_e)[0]
    log2g = G.bit_length() - 1
    K = min(N, 32)
    nsg = N // K
    n_items = n_act * nsg
    nw, J, n_cta = prefix_warps(n_items, log2g), 32 // G, -(-B // G)
    words = sp.astype(np.int64) & M32
    # phase A: one row per thread of every CTA, (cta, warp, lane) flattened
    cta, warp, lane = (a.ravel() for a in np.meshgrid(np.arange(n_cta), np.arange(nw),
                                                      np.arange(32), indexing="ij"))
    blk, j = lane & (G - 1), lane >> log2g
    b = cta * G + blk
    valid = b < B
    load_row, load_word = loaders(words, T, W, np.minimum(b, B - 1), valid)
    maps = np.full((n_cta, n_act, N, G), -1, np.int64)
    for r in range(-(-n_items // (J * nw)) + 1):
        i = j + J * (warp + nw * r)
        act = valid & (i < n_items)
        if not act.any():
            continue
        c, s0 = i // nsg, (i % nsg) * K
        m = compose(C, (c_lo + c) * C - P, s0, act, N, W, K, load_row, load_word)
        for q in range(K):
            at = (cta[act], c[act], s0[act] + q, blk[act])
            assert (maps[at] == -1).all(), "a map written twice"
            maps[at] = m[act, q]
    vb = np.arange(B)
    assert (maps[vb // G, :, :, vb % G] >= 0).all(), "a map of a block never composed"
    # phase B: one thread per block
    state, entry = start.astype(np.int64) & (N - 1), np.zeros((nc_e, B), np.int64)
    for c in range(n_act - 1, -1, -1):
        if c < nc_e:
            entry[c] = state
        state = maps[vb // G, c, state, vb % G]
    # phase C: (decode chunk, block) on threads, block fastest
    ci, bt = (a.ravel() for a in np.meshgrid(np.arange(nc_e), np.arange(n_cta * G),
                                             indexing="ij"))
    live = bt < B
    bits = np.full((nd, n_cta * G), -1, np.int64)  # -1: never stored
    load_row, load_word = loaders(words, T, W, np.minimum(bt, B - 1), live)

    def emit(row, bit):
        idx = ci * C - ds_local + row
        on = live & (idx >= 0) & (idx < nd)
        assert (bits[idx[on], bt[on]] == -1).all(), "a bit stored twice"
        bits[idx[on], bt[on]] = bit[on]

    expand(C, (c_lo + ci) * C - P, entry[ci, np.minimum(bt, B - 1)], live, log2n, W, load_row,
           load_word, emit)
    assert (bits[:, B:] == -1).all(), "a bit stored for a lane past B"
    return bits[:, :B].astype(np.int32)


# ---- the fused tail on the warp bodies ---------------------------------------------

def fused_tail_model(sp, log2n, ds, n_decode, start, tb_chunk, G, L, rng):
    """fused.cu::prefix_tail_warp over each CTA's [t][w][g] history: packed
    words (n_decode/32, B)."""
    T, W, B = sp.shape
    N, K = 1 << log2n, 32
    n_window, n_words = min(n_decode, T - ds), n_decode // 32
    C, P, n_chunks, c_lo, c_hi = traceback.prefix_chunk_geometry(T, ds, n_window, tb_chunk)
    n_act, nc_e, ds_local = n_chunks - c_lo, c_hi - c_lo + 1, ds + P - c_lo * C
    n_cta, nt, log2g = -(-B // G), G * L, G.bit_length() - 1
    assert nt <= 32 and G & (G - 1) == 0
    # the CTAs' histories: hist[cta, t, w, g]; blocks past B hold garbage
    hist = rng.integers(0, 1 << 32, (n_cta, T, W, G), dtype=np.int64)
    full = np.zeros((T, W, n_cta * G), np.int64)
    full[:, :, :B] = sp.astype(np.int64) & M32
    hist_b = full.reshape(T, W, n_cta, G).transpose(2, 0, 1, 3)
    hist[:, :, :, :] = np.where((np.arange(n_cta * G) < B).reshape(n_cta, 1, 1, G), hist_b, hist)
    flat = hist.transpose(1, 2, 0, 3).reshape(T, W, n_cta * G)  # words[stage, w, cta*G + g]
    cta, lane = (a.ravel() for a in np.meshgrid(np.arange(n_cta), np.arange(nt), indexing="ij"))
    g, j = lane & (G - 1), lane >> log2g
    b = cta * G + g
    valid = b < B
    load_row, load_word = loaders(flat, T, W, b, valid)
    nsg = N // K
    n_items = n_act * nsg
    maps = np.full((n_cta, n_act, N, G), -1, np.int64)
    for r in range(-(-n_items // L)):
        i = j + L * r
        act = valid & (i < n_items)
        if not act.any():
            continue
        c, s0 = i // nsg, (i % nsg) * K
        m = compose(C, (c_lo + c) * C - P, s0, act, N, W, K, load_row, load_word)
        for q in range(K):
            at = (cta[act], c[act], s0[act] + q, g[act])
            assert (maps[at] == -1).all(), "a map written twice"
            maps[at] = m[act, q]
    vb = np.arange(B)
    state, entry = start.astype(np.int64) & (N - 1), np.zeros((nc_e, B), np.int64)
    for c in range(n_act - 1, -1, -1):
        if c < nc_e:
            entry[c] = state
        state = maps[vb // G, c, state, vb % G]
    # phase C: a word of bits gathered per lane, or-ed into the window once
    ci, bt = (a.ravel() for a in np.meshgrid(np.arange(nc_e), np.arange(n_cta * G),
                                             indexing="ij"))
    live = bt < B
    window = np.zeros((n_words, n_cta * G), np.int64)
    cur, acc = np.full(len(ci), -1), np.zeros(len(ci), np.int64)
    load_row, load_word = loaders(flat, T, W, bt, live)

    def flush(on):
        on = on & (acc != 0)
        np.bitwise_or.at(window, (cur[on], bt[on]), acc[on])

    def emit(row, bit):
        idx = ci * C - ds_local + row
        on = live & (idx >= 0) & (idx < n_window)
        new = on & ((idx >> 5) != cur)
        flush(new)
        cur[new], acc[new] = idx[new] >> 5, 0
        acc[on] |= bit[on] << (idx[on] & 31)

    expand(C, (c_lo + ci) * C - P, entry[ci, np.minimum(bt, B - 1)], live, log2n, W, load_row,
           load_word, emit)
    flush(live)
    out = np.full((n_words, n_cta * G), -1, np.int64)  # -1: never stored
    out[:, :B] = window[:, :B]
    assert (out[:, B:] == -1).all()
    out = out[:, :B]
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)


# ---- references ----------------------------------------------------------------------

def _case(N, T, B, seed, policy):
    rng = np.random.default_rng(seed)
    W = max(1, N // 32)
    sp = rng.integers(-(1 << 31), 1 << 31, (T, W, B), dtype=np.int64).astype(np.int32)
    start = (np.zeros(B, np.int32) if policy == "zero"
             else rng.integers(0, N, B).astype(np.int32))
    return sp, start


@functools.lru_cache(maxsize=None)
def _jax_walk(N, T, B, seed, policy, ds, nd):
    """JAX traceback_ref of a case (independent of tb_chunk)."""
    sp, start = _case(N, T, B, seed, policy)
    from repro.core.trellis import ConvCode as JConvCode

    jcode = JConvCode(polys=POLYS[N])
    return np.asarray(j_ref.traceback_ref(jnp.asarray(sp), jcode, ds, nd, jnp.asarray(start)))


GEOMETRIES = [  # T, B, decode_start, n_decode
    (100, 37, 10, 60), (60, 70, 0, 60)]


@pytest.mark.parametrize("policy", ["zero", "random"])
@pytest.mark.parametrize("tb_chunk", [1, 7, 64, "T+5"])
@pytest.mark.parametrize("T,B,ds,nd", GEOMETRIES)
@pytest.mark.parametrize("N", [64, 256])
def test_k2_prefix_model_equals_reference(N, T, B, ds, nd, tb_chunk, policy):
    tb = T + 5 if tb_chunk == "T+5" else tb_chunk
    code = ConvCode(polys=POLYS[N])
    sp, start = _case(N, T, B, N + T, policy)
    got = k2_prefix_model(sp, code.v, ds, nd, start, tb)
    np.testing.assert_array_equal(got, _jax_walk(N, T, B, N + T, policy, ds, nd))
    plain = traceback.traceback_prefix(torch.as_tensor(sp), code, ds, nd,
                                       torch.as_tensor(start), tb)
    np.testing.assert_array_equal(plain.numpy(), got)


def _class_geometry(G, N=256):
    """A geometry (T, decode_start, n_decode, tb_chunk) whose maps K2-prefix's
    planner puts G blocks of to a CTA: per-block scratch in
    (SMEM/(2G), SMEM/G], one-stage chunks."""
    per_map = 4 * N
    n_act = (traceback.SMEM_PER_CTA // G) // per_map - 1
    T = n_act + 3
    return T, 3, min(20, T - 3), 1


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_k2_prefix_model_at_each_size_class(G):
    """The planner's size classes: a geometry it plans at each G, run there by
    the model (small B, one case per class) and held against the plain walk;
    and the main geometry at every G the kernel takes."""
    N = 256 if G < 32 else 64
    T, ds, nd, tb = _class_geometry(G, N)
    if G == 32:
        T, ds, nd, tb = 596, 42, 512, 64
    C, P, n_chunks, c_lo, c_hi = traceback.prefix_chunk_geometry(T, ds, nd, tb)
    planned, nbytes = traceback.prefix_smem_plan(N, n_chunks - c_lo, c_hi - c_lo + 1)
    assert planned == G and nbytes <= traceback.SMEM_PER_CTA
    assert 2 * nbytes > traceback.SMEM_PER_CTA or G == 32
    code = ConvCode(polys=POLYS[N])
    B = G + 3 if G < 32 else 35
    sp, start = _case(N, T, B, G, "random")
    want = traceback.traceback_plain(torch.as_tensor(sp), code, ds, nd, torch.as_tensor(start))
    np.testing.assert_array_equal(k2_prefix_model(sp, code.v, ds, nd, start, tb), want.numpy())
    sp, start = _case(64, 130, 41, G, "random")  # a short block at this G, forced
    want = traceback.traceback_plain(torch.as_tensor(sp), ConvCode(polys=POLYS[64]), 11, 100,
                                     torch.as_tensor(start))
    np.testing.assert_array_equal(k2_prefix_model(sp, 6, 11, 100, start, 16, G=G), want.numpy())


@pytest.mark.parametrize("B,G", [(32, 1), (264, 2), (1001, 4), (4223, 16), (4224, 32),
                                 (8192, 32)])
def test_k2_prefix_plan_spreads_a_small_batch(B, G):
    """A batch too small for a CTA of the smem class on each of 132 SMs takes
    fewer blocks per CTA (at least one), and the model at that G stays
    equal to the plain walk."""
    assert traceback.prefix_plan(64, 596, 42, 512, 64) == ((64, 44, 10, 1, 9), 32)
    assert traceback.prefix_plan(64, 596, 42, 512, 64, B, 132)[1] == G
    assert traceback.prefix_plan(256, 596, 42, 512, 8, B, 1)[1] == 2  # the smem class caps it
    if B <= 264:
        code = ConvCode(polys=POLYS[64])
        sp, start = _case(64, 80, B, B, "random")
        want = traceback.traceback_plain(torch.as_tensor(sp), code, 9, 64, torch.as_tensor(start))
        G_run = traceback.prefix_plan(64, 80, 9, 64, 16, B, 132)[1]
        np.testing.assert_array_equal(k2_prefix_model(sp, 6, 9, 64, start, 16, G=G_run),
                                      want.numpy())


@pytest.mark.parametrize("N", [4, 16])
def test_k2_prefix_model_small_codes(N):
    """W = 1 with N < 32: fewer chains per thread (K = N), the high bits of
    the complemented state kept set."""
    code = ConvCode(polys=POLYS[N])
    sp, start = _case(N, 50, 45, N, "random")
    want = traceback.traceback_plain(torch.as_tensor(sp), code, 4, 40, torch.as_tensor(start))
    for tb in (1, 3, 64):
        np.testing.assert_array_equal(k2_prefix_model(sp, code.v, 4, 40, start, tb), want.numpy())


def test_k2_prefix_model_equals_pallas_interpret():
    jcode = j_get_code_spec("ccsds").code
    T, B, ds, nd, tb = 60, 128, 9, 40, 7
    sp, start = _case(64, T, B, 1818, "random")
    want = traceback_prefix_pallas(jnp.asarray(sp), jnp.asarray(start), jcode, decode_start=ds,
                                   n_decode=nd, tb_chunk=tb, interpret=True)
    np.testing.assert_array_equal(k2_prefix_model(sp, 6, ds, nd, start, tb), np.asarray(want))


# ---- the fused tail ------------------------------------------------------------------

FUSED_GEOMETRIES = [  # T, B, decode_start, n_decode, tb_chunk
    (596, 37, 42, 512, 64),  # the main geometry, a ragged batch
    (100, 21, 10, 96, 7),    # a packed width past T - decode_start
    (70, 19, 0, 64, 1),
    (60, 40, 5, 64, 65),     # tb_chunk > T
]


def _packed_reference(sp, code, ds, n_decode, start):
    T = sp.shape[0]
    n_window = min(n_decode, T - ds)
    bits = ref.traceback_ref(torch.as_tensor(sp), code, ds, n_window, torch.as_tensor(start))
    bits = torch.cat([bits, bits.new_zeros((n_decode - n_window, bits.shape[1]))])
    return ref._pack_decisions(bits).numpy()


@pytest.mark.parametrize("policy", ["zero", "random"])
@pytest.mark.parametrize("geometry", FUSED_GEOMETRIES)
@pytest.mark.parametrize("name,S", [(n, S) for n in MOTHERS
                                    for S in acs.warp_states(get_code_spec(n).code)])
def test_fused_tail_model_equals_reference(name, S, geometry, policy):
    """Each S variant of the warp body of each mother code at the G that
    smem_plan picks for it under prefix."""
    T, B, ds, nd, tb = geometry
    code = get_code_spec(name).code
    N, L = code.n_states, code.n_states // S
    if N == 256 and T == 596:
        T, ds, nd = 300, 42, 224  # the K = 9 main block at a width the model runs quickly
    G, _ = fused.smem_plan(T, N, "prefix", tb, decode_start=ds, n_decode=nd, lanes=L)
    sp, start = _case(N, T, B, T + S + N, policy)
    rng = np.random.default_rng(S)
    got = fused_tail_model(sp, code.v, ds, nd, start, tb, G, L, rng)
    np.testing.assert_array_equal(got, _packed_reference(sp, code, ds, nd, start))
    if T == 100:  # the port's plain prefix walk, packed
        n_window = min(nd, T - ds)
        plain = traceback.traceback_prefix(torch.as_tensor(sp), code, ds, n_window,
                                           torch.as_tensor(start), tb)
        plain = torch.cat([plain, plain.new_zeros((nd - n_window, B))])
        np.testing.assert_array_equal(ref._pack_decisions(plain).numpy(), got)


def test_fused_tail_planned_geometry():
    """What smem_plan picks under prefix on the warp bodies at CCSDS, T = 596:
    4,768 B of history and (576 + 9 + 16)·4 = 2,404 B of prefix scratch per
    block; G = 16 keeps two CTAs, 32 blocks, resident on an SM (the serial
    variant three CTAs, 48 blocks). At S = 64 (one lane per block) G = 32
    ties G = 16 at 32 blocks and the larger wins; at S = 16 (four lanes) G =
    2 holds 15 CTAs of 8 threads, 30 blocks, where G = 8 would hold 24."""
    per_block = 4 * (596 * 2 + 9 * 64 + 9 + 16)
    assert per_block == 4768 + 2404
    G, nbytes = fused.smem_plan(596, 64, "prefix", 64, decode_start=42, n_decode=512, lanes=2)
    assert (G, nbytes) == (16, 16 * per_block)
    assert fused.residency(G, nbytes, 2) == (2, 2)
    G_serial, serial = fused.smem_plan(596, 64, lanes=2)
    assert (G_serial, fused.residency(G_serial, serial, 2)[0]) == (16, 3)
    assert [fused.smem_plan(596, 64, "prefix", 64, decode_start=42, n_decode=512,
                            lanes=64 // S)[0] for S in (64, 16)] == [32, 2]


def test_fused_tail_model_equals_pallas_interpret():
    """The history the fused ACS writes (K1's survivor words) through the tail
    model, against JAX pbvd_fused_pallas(tb_mode="prefix") in interpret mode."""
    code, jcode = get_code_spec("ccsds").code, j_get_code_spec("ccsds").code
    T, ds, nd, tb = 60, 12, 32, 16
    rng = np.random.default_rng(2020)
    y = rng.integers(-127, 128, (T, 2, 128)).astype(np.int8)
    st = rng.integers(0, 64, 128).astype(np.int32)
    want = pbvd_fused_pallas(jnp.asarray(y), jcode, decode_start=ds, n_decode=nd,
                             start_state=jnp.asarray(st), interpret=True, tb_mode="prefix",
                             tb_chunk=tb)
    sp, _ = acs.acs_forward(torch.as_tensor(y[:, :, :37]), code)  # the plain ACS: sp (T, 2, B)
    G, _ = fused.smem_plan(T, 64, "prefix", tb, decode_start=ds, n_decode=nd, lanes=2)
    got = fused_tail_model(sp.numpy(), 6, ds, nd, st[:37], tb, G, 2, rng)
    np.testing.assert_array_equal(got, np.asarray(want)[:, :37])


# ---- planners and routing ------------------------------------------------------------

def _parent_prefix_smem_plan(n_states, n_act, nc_e):
    """The parent's K2-prefix planner, as it was."""
    per_block = 4 * (n_act * n_states + nc_e)
    G = max(1, 128 // n_states)
    if G * per_block > traceback.SMEM_PER_CTA:
        G = 1
    if per_block > traceback.SMEM_PER_CTA:
        raise ValueError(
            f"the prefix traceback's scratch of {n_act} composed maps at N={n_states} states "
            f"needs {per_block} bytes of shared memory per parallel block, above the "
            f"{traceback.SMEM_PER_CTA} bytes a CTA may use; use a larger tb_chunk"
        )
    return G, G * per_block


def _outcome(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except ValueError as err:
        return str(err)
    return None


PLAN_SWEEP = [(T, ds, nd, tb) for T in (1, 40, 596, 2000, 4224)
              for ds, nd in ((0, T), (min(42, T - 1), max(1, T - min(42, T - 1) - 42)))
              for tb in (1, 2, 7, 16, 64, T + 5)]


@pytest.mark.parametrize("N", [2, 16, 64, 256, 1024])
def test_k2_prefix_planner_accepts_and_refuses_as_the_parent(N):
    for T, ds, nd, tb in PLAN_SWEEP:
        C, P, n_chunks, c_lo, c_hi = traceback.prefix_chunk_geometry(T, ds, nd, tb)
        args = (N, n_chunks - c_lo, c_hi - c_lo + 1)
        want = _outcome(_parent_prefix_smem_plan, *args)
        assert _outcome(traceback.prefix_smem_plan, *args) == want, (N, T, ds, nd, tb)
        assert _outcome(traceback.prefix_plan, N, T, ds, nd, tb) == want
        if want is None:
            G, nbytes = traceback.prefix_smem_plan(*args)
            assert G in (1, 2, 4, 8, 16, 32) and nbytes == G * 4 * (args[1] * N + args[2])
            assert nbytes <= traceback.SMEM_PER_CTA
            assert G == 32 or 2 * nbytes > traceback.SMEM_PER_CTA  # the largest class that fits


@pytest.mark.parametrize("name", MOTHERS)
def test_fused_prefix_planner_accepts_and_refuses_as_the_parent(name):
    """The parent planned every prefix launch on the table bodies (lanes
    None); the mother codes now plan it on the warp bodies, refused exactly
    where the parent refused, with its message."""
    code = get_code_spec(name).code
    N = code.n_states
    for T, ds, nd, tb in PLAN_SWEEP:
        nd32 = 32 * max(1, -(-min(nd, 4096) // 32))
        for k in (0, 2):
            kw = dict(decode_start=min(ds, T - 1), n_decode=nd32, matrix_k=k, R=code.R)
            want = _outcome(fused.smem_plan, T, N, "prefix", tb, **kw)
            for S in (acs.warp_states(code) if not k else (acs.matrix_states(code, k),)):
                assert _outcome(fused.smem_plan, T, N, "prefix", tb, lanes=N // S, **kw) == want
                if want is None:
                    G, nbytes = fused.smem_plan(T, N, "prefix", tb, lanes=N // S, **kw)
                    assert G * (N // S) <= 32 and nbytes <= fused.SMEM_PER_CTA


def test_prefix_runs_on_the_warp_bodies():
    for name in MOTHERS:
        code = get_code_spec(name).code
        assert fused.kernel_body(code, "prefix") == fused.kernel_body(code, "serial") == "warp"
    k5 = ConvCode(polys=POLYS[16])
    assert fused.kernel_body(k5, "prefix") == "table"
    with pytest.raises(ValueError, match="unknown tb_mode"):
        fused.kernel_body(k5, "auto")
    # CPU tensors run the plain versions and count nothing
    fused.launches = fused.prefix_launches = traceback.prefix_launches = 0
    y = torch.zeros((40, 2, 3), dtype=torch.int8)
    fused.pbvd_fused(y, get_code_spec("ccsds").code, decode_start=1, n_decode=32,
                     tb_mode="prefix", states_per_thread=16)
    traceback.traceback_prefix(torch.zeros((40, 2, 3), dtype=torch.int32),
                               get_code_spec("ccsds").code, 1, 30)
    assert (fused.launches, fused.prefix_launches, traceback.prefix_launches) == (0, 0, 0)
