#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed on its own lines; any mismatch or exception exits
non-zero and prints no result:

1. build every kernel of ``src/repro_torch/kernels/csrc/`` with nvcc;
2. K1 (forward ACS) against its plain PyTorch version on the card, at the
   main path's shapes and for several codes, symbol dtypes and ragged batch
   widths: survivor words equal, path metrics equal (float32: allclose,
   rtol 1e-6, though the same add order makes them exact); then every
   mother code with a warp-body instantiation (CCSDS, IS-95, LTE) at each
   of its S variants, and the runtime-table body ((2,1,5)), at B = 5, 33,
   40, 300, 1001 and 8192 + 17, T = 1, 97, 596 and 597 (odd T at radix 4),
   f32/i16/i8 (many normalization intervals; refused where the budget
   refuses), each launch counted on the body its code chose, words and
   metrics equal;
3. K2 (serial traceback, the staged walk) against its plain version: zero,
   argmin and random start states, bits equal; then at every W it is built
   for (N = 4 ... 1024 states) on random survivor words, ragged batches,
   ``decode_start`` 0 and > 0 and one-stage blocks;
4. the main path, ``DecoderEngine(PBVDConfig()).decode`` on a 4,194,304-bit
   CCSDS stream made on the card at Eb/N0 4 dB: equal to ``backend="ref"``
   bit for bit, both kernels launched, a noiseless stream decoded with 0
   errors, and the BER printed (and below 1e-4);
5. the serving path, ``decode_batch`` of 64 streams × 65,536 bits (and a
   small ragged fleet) equal to per-stream ``decode``;
6. times: each kernel's median CUDA-event time at the main-path shapes, its
   plain version's, its bound and K1's share of it, K1's S variants for
   each mother code, K2's own traffic (every word of each walked stage)
   and its device time per launch under ``torch.profiler``, decoded Mb/s
   end to end and on the device, bytes per decoded bit and the host phases.

Then the fused backend, the narrow metric modes and radix 4:

7. K1 in the metric modes i16/i8 and at radix 4 against its plain version
   (survivor words equal, path metrics equal after a cast to int32), and the
   fused kernel against its plain version (packed words equal): CCSDS at the
   main shapes, K=9, rate 1/3, a 16-state code, a ragged batch, int8/int16/
   float32 symbols, odd T, zero and random start states, a packed width that
   overhangs the block and a K=9 block (D=4096, L=64) whose survivor history
   needs more than 48 KB of shared memory; and, as in phase 2, every mother
   code at each S variant of the warp body and the runtime-table body, each
   launch counted on its body. Combinations whose saturation budget
   ``norm_interval`` refuses are printed as refused;
8. the fused main path, ``DecoderEngine(PBVDConfig(backend="fused")).decode``
   on the 4,194,304-bit stream: equal to ``"ref"`` and ``"cuda"``, i16 equal
   to f32, i8 at radix 4 through ``"fused"`` and ``"cuda"`` equal to
   ``"ref"`` in that configuration (each radix-4 path's launches counted), a
   noiseless stream with 0 errors, one fused launch and no K1/K2 launch per
   decode, and ``decode_batch`` of 64 × 65,536 bits in one fused launch;
9. times of the fused kernel (radix 2 and 4, f32 and i8; its S variants
   with their blocks per CTA and the CTAs, blocks and warps an SM holds)
   and of K1 at radix 4 and in i8, beside their plain versions, bounds and
   shares of them, end-to-end Mb/s of ``"fused"`` beside ``"cuda"``, and a
   ``torch.profiler`` window over five decodes of each (device busy share,
   top kernels).

Then the prefix traceback and the matrix ACS:

10. K1-matrix against its plain version (survivor words and path metrics
    equal): CCSDS at k = 2, 3, 4 at the main shapes, the rate-1/3 code at
    k = 2, K = 9 and (2,1,5), f32 with int8 symbols, i16 and i8 (refused
    where the budget refuses), T mod k != 0 and a ragged batch; then every
    mother code (CCSDS, IS-95, LTE) at every k built for it in f32, i16 and
    i8, T mod k != 0, T < k and T = 97, B = 5, 33, 1001 and 8192 + 17;
    each launch counted on the body its code chose (the matrix warp body
    for the mother codes, the runtime-table matrix body for (2,1,5)); float
    symbols, which launch the butterfly kernel and no K1-matrix;
11. K2-prefix (lanes on parallel blocks) against its plain version and the
    serial walk, each launch counted: tb_chunk 1, 7, 64 and T+5, the main
    window and one whose first chunk is chunk 0 (c_lo = 0), W = 1, 2 and 8,
    a ragged batch, random start states (scratch that does not fit printed
    as refused; the ``"cuda"`` and ``"fused"`` backends refuse it before any
    kernel launches); one geometry per size class of its CTA (G = 1, 2, 4,
    8, 16 and 32 blocks, each planned at its class);
12. the fused kernel against its plain version in prefix, in matrix and in
    both, including the K = 9, D = 4096, L = 64 history with the prefix
    scratch and a geometry whose scratch does not fit (printed as refused):
    every prefix case of a mother code on the warp bodies, the butterfly's
    at each S variant the serial warp path builds and the matrix warp
    body's at its one S per (code, k); the serial matrix variant on the
    matrix warp body for every mother code at every built k, f32/i16/i8,
    ragged B and odd T, at half the decode depth (D = 256); (2,1,5) on the runtime-table bodies; each launch
    counted on its body (the table-body counters stay at 0 for the mother
    codes);
13. the new main paths: the 4,194,304-bit stream through ``"cuda"`` and
    ``"fused"`` with ``acs_impl="matrix", acs_k=2, tb_mode="prefix"`` and
    with each knob alone, each bit-equal to ``"ref"`` at the default
    config, with their launch counts (``"cuda"``: one K1-matrix and/or one
    K2-prefix; ``"fused"``: one fused launch on a warp body, no K1 or K2);
14. the matrix warp body's S per (code, k); times of K1-matrix (k = 2, 3,
    4), K2-prefix (with its device time) and the fused variants (matrix
    at k = 2 and 3, prefix, prefix with matrix; each with its body, G and
    resident blocks per SM) beside their plain versions, bounds and shares
    of them; serial against prefix at B = 32, 264 and 8192 (K2 and
    K2-prefix, the fused serial and prefix variants); and end-to-end Mb/s
    of the new paths in turns. A kernel's bound is that of the function it
    computes, which is the function of K1, K2 or the fused serial kernel;
    the work of the algorithm it chose (the k-stage tournament, the composed
    maps) is printed beside it as a separate floor, with the kernel's share
    of it; a ``torch.profiler`` window over five decodes of each matrix
    path (device busy share, top kernels).

Then the LM serving path, StarCoder2-3B at full width and depth:

15. the flash-attention kernel against its plain version ``ref_mha``:
    causal, windowed (window < S and window >= S), non-causal with and
    without a window, T != S, G = 1, 2 and 12, head dims 16 to 128, float32
    (atol 2e-5, rtol 1e-5) on the CUDA-core body and bf16 (atol 2e-5, rtol
    2^-8: one rounding of the float32 result) on the tensor-core body, each
    launch counted on its body; bf16 cases at the tensor-core body's edges
    (128-row tiles straddling positions with S·G not a multiple of 128, a
    window below one 64-key block, T != S, causal with T > S, dh = 16 and
    32); and the main shapes (B=2, S=T=8192, Hkv=2, G=12, dh=128, bf16,
    causal, window 4096); the ``ValueError`` of an S that ``q_chunk`` does
    not divide;
16. StarCoder2-3B with random weights drawn on the card: the parameter
    count; ``make_prefill_step`` on 2 prompts of 8192 tokens with one flash
    launch per layer counted, all on the tensor-core body; the same forward with the flash kernel off
    (the streaming path), last-position logits within a stated tolerance;
    at float32 compute (whose ``apply_train`` runs the CUDA-core body, one
    launch per layer), cached ``apply_decode`` over 64 tokens against
    ``apply_train``; ``greedy_generate`` for 4 requests (prompt 16, 64 new
    tokens); the ring-buffered cache past its window on a two-layer
    StarCoder2 with the window cut to 64, 160 cached steps against
    ``apply_train``;
17. the flash kernel's time at the main shapes beside its plain version's,
    its bound, the tensor-core body's own work (QKᵀ and P·V twice: 1.5× the
    function's FLOP) and ``scaled_dot_product_attention``'s time on the same
    inputs and band mask (timed only; the port never calls it); the same
    for the CUDA-core body on the float32 copies of those inputs; end to end
    prefill tokens/s and decode ms per step, and a ``torch.profiler`` window
    over one prefill and 4 decode steps (device busy share, top kernels).

Then streaming, the sessions and the session pool:

18. the 4,194,304-bit stream of phase 4, fed from host memory to
    ``DecoderEngine(...).session()`` in 4096-bit and in seeded random
    chunks through ``"cuda"`` and ``"fused"``, at the defaults, at
    ``acs_radix=4, metric_mode="i8"`` and with ``acs_impl="matrix",
    tb_mode="prefix"``: each equal to its one-shot decode bit for bit, with
    the counters at 0 before each session and one launch of each kernel of
    its path per non-empty chunk after it; B = 1, 2, 3, 5, 8 and 33 blocks
    per launch on both backends and both walks; a ccsds-3/4 stream in
    random 1-D chunks and int8 chunks equal to ``"ref"``; a snapshot taken
    halfway, pickled and restored into a fresh session; ``SessionPool`` over
    64 streams × 65,536 bits in 16 rounds equal to ``decode_batch``, one
    launch per group per step (a second group on ``"fused"``); a fault hook
    that marks 3 of 64 streams, exactly those quarantined by
    ``step(isolate=True)``; ``serve_decoder.main`` in single and pooled
    modes;
19. chunk latency (p50/p99) of one session at 1024-, 4096- and
    65,536-bit chunks on ``"cuda"`` and ``"fused"``, the pool's step
    latency and aggregate Mb/s (64 streams, 4096-bit chunks), the host
    phases of a session step (ingest, window copy and framing, launch,
    commit) and a ``torch.profiler`` window over the first 4 pool steps
    (device busy share, top kernels).

Then the serving fabric, the async service over paged slabs:

20. on ``"cuda"`` and ``"fused"`` at the defaults, each run with the
    counters at 0 before it and one launch of each kernel of the path per
    pool launch after it, no slab page left in use, and every stream equal
    bit for bit to its one-shot ``engine.decode``: ``run_poisson_trace`` of
    64 streams × 65,536 bits in 4096-bit chunks through a slab of 1024
    pages of D + 2L = 596 stages, at 25 and 200 chunks/s per stream
    (dispatches, launches, blocks per launch, slab high-water, slab
    backpressure); 512 streams × 8192 bits through 1024 pages; the
    reference's chaos schedule (stream poison, dispatch, slab, device loss,
    an admission fault) plus a silent corruption caught by the integrity
    sentinel, on 64 streams at 14 dB: healthy streams exact, failures typed,
    the injector's and the service's counts equal to the schedule; the
    ``serve_decoder`` CLI in its durable mode, killed by SIGKILL at its
    third dispatch and recovered from its journal, every stream exact and
    delivered once;
21. chunk latency p50/p99 and sustained Mb/s of the 25 chunks/s trace on
    ``"cuda"`` at deadline 1 and 5 ms × ``max_batch_blocks`` 32 and 512,
    and a ``torch.profiler`` window over one trace (device busy share, top
    kernels, device time per pool launch against the p50), each line with
    the card's name and power limit.

Then the lane split over a decode mesh (a device list that names the one
card once per shard, or distinct cards where torch finds more than one):

22. the 4,194,304-bit main path through ``"cuda"`` and ``"fused"`` at
    ``data=4`` under both shard dispatches, each equal to phase 4's
    ``"ref"`` bits with one launch of each kernel per shard; a ragged
    ``decode_batch`` of 64 streams at ``data=8`` equal to meshless; the
    pool with a meshless, a ``"constraint"`` and a ``"shard_map"`` group
    at a ragged cadence, equal to ``decode_batch``; the mesh-loss drill
    (``data=4`` → 3 → 2 → meshless under a ``FaultInjector`` schedule) on
    16 streams, every stream exact and the counts equal to the schedule;
    the CLI's pooled mode with ``--mesh data=1``; end-to-end ms of
    meshless against ``data=4`` in turns, with the card's name and power
    limit, and a ``torch.profiler`` window over five ``data=4`` decodes of
    each backend (device busy share, top kernels).

Then the paper's science, the examples and the rest of the dense and MoE
LM cards:

23. the BER harness (``core/ber.py``, Fig. 4) at 2^24 bits per point:
    ``simulate_ber`` on ``"cuda"`` for CCSDS, D = 512, q = 8 at Eb/N0 2, 3
    and 4 dB × L = 14, 28 and 42, ``hard_decision_ber`` at 4 dB, L = 42,
    and ``ccsds-3/4`` at 5.5 dB, L = 42; a replay of the generator draws
    each point's symbols again, which decode through ``"cuda"`` (the same
    errors), ``"fused"`` and, at 4 dB / L = 42, ``"ref"``, bit for bit,
    each decode's launches counted; the bands of
    ``tests/test_ber_regression.py`` (soft ≤ 3e-4, hard in [1e-3, 1e-2],
    soft < hard < uncoded), BER not rising with Eb/N0 at any L and L = 14
    no better than L = 42 at 4 dB; then ``examples/torch_quickstart.py``
    and ``examples/torch_ber_sweep.py --bits 1048576`` as subprocesses,
    each exiting 0;
24. Qwen2.5-32B, Minitron-8B, Command-R-35B and Mixtral-8x22B, one at a
    time, at full width with the depth cut to 2 layers and random seeded
    float32 weights: the flash kernel at the card's G (5, 4, 8, 6) against
    its plain version, the parameter count against ``n_params_estimate``,
    ``make_prefill_step`` on 2 × 4096 tokens (Mixtral 2 × 8192, past its
    4096 window) with one flash launch per layer, all on the tensor-core
    body (Mixtral: the entries dropped by capacity per layer), flash
    against streaming prefill, float32 cached ``apply_decode`` against
    ``apply_train`` (Mixtral at a capacity of S), ``greedy_generate`` for
    4 requests × (prompt 16, 32 new), and the flash kernel at the
    prefill's shapes against ``ref_mha`` (atol 2e-5, rtol 2^-8) with its
    time beside its bound and SDPA's; each card's seconds are a lap.

Then the LM's remaining decoder mixers, each card at full width with random
seeded float32 weights, one at a time:

25. RWKV6-3B at its full 32 layers, DeepSeek-V2 (MLA + MoE) with its depth
    cut 60 -> 2 (the dense-FFN prefix layer and one MLA + MoE layer) and
    Jamba-v0.1 (Mamba + GQA + MoE) cut 32 -> 8 (one period of its pattern,
    the least depth that holds its attention layer): the parameter count
    against ``lm.param_count``; ``make_prefill_step`` on 2 x 4096 tokens
    with its flash launches (none for RWKV and DeepSeek, whose MLA runs the
    streaming softmax; exactly one for Jamba, on the tensor-core body), its
    time, tokens/s and peak memory, finite logits whose argmax is the
    step's; the prefill's time split between the mixers' cores (the chunked
    scans, MLA's streaming softmax) and the rest, each core bracketed by
    synchronizes; the entries dropped by capacity per MoE layer; float32 cached
    ``apply_decode`` over 66 tokens against ``apply_train`` (the MoE at a
    capacity of S; RWKV6-3B at atol 0.1 over its 32 random layers, which
    amplify float32 roundoff, and its first two layers alone at 1e-3), and
    for Jamba each Mamba layer's state after the
    prefill's chunked scan against its state after the 66 cached steps;
    ``greedy_generate`` for 4 requests x (prompt 16, 32 new); for Jamba the
    flash kernel at its prefill's shapes (G = 4, dh = 128, no window)
    against ``ref_mha`` (atol 2e-5, rtol 2^-8), with its time beside its
    bound and SDPA's; each card's seconds are a lap.

Then the enc-dec card, the VLM stub and the training path:

26. SeamlessM4T-medium at full width and depth (12 encoder and 12 decoder
    layers) and Pixtral-12B at full width with its depth cut 40 -> 2, random
    seeded float32 weights: the parameter count against ``lm.param_count``;
    ``make_prefill_step`` on 2 x 4096 tokens (Seamless with 2 x 2048 frames
    of 1024 from the seeded generator, the audio stub; Pixtral with 256
    patch embeddings in the first positions) with its flash launches (36
    for Seamless: encoder, decoder self- and cross-attention; 2 for
    Pixtral; all on the tensor-core body), time, tokens/s and peak memory;
    flash against the streaming prefill; for Seamless ``lm.encode`` +
    ``lm.prefill_cross`` and float32 cached ``apply_decode`` over 32 tokens
    against teacher-forced ``apply_train`` (atol 1e-3) and greedy ms per
    step against the cross cache; for Pixtral the first positions' logits
    bit-equal when the replaced tokens change and moved when the patches
    do; the flash kernel at each attention's shapes (Seamless: encoder S =
    T = 2048 non-causal, decoder causal S = 4096, cross S = 4096 against
    T = 2048; Pixtral G = 4, dh = 128) against ``ref_mha`` with its time
    beside its bound and SDPA's;
27. the training path on StarCoder2-3B: the flash ``autograd.Function`` at
    the step's attention shapes (B = 2, S = T = 2048, G = 12, dh = 128,
    bf16), its q, k, v gradients bit-equal to autograd through
    ``_attend_chunked``; a 2-layer step at full width and float32 compute,
    gradients with flash on against flash off within 3e-2 of each leaf's
    largest entry; ``make_train_step`` at the full 30 layers (bf16
    compute, per-layer remat, AdamW) for 6 steps of ``SyntheticLMStream``
    batches of 2 x 2048 tokens: finite loss that falls, step ms, tokens/s,
    peak memory, 60 flash launches per step on the tensor-core body, and a
    profiler window over one step; the same 6 steps from the same
    parameters under ``REPRO_REMAT=dots`` (the products' outputs saved):
    losses within 1e-4 of full remat's, step ms, tokens/s, peak memory and
    the step's FLOPs counted on meta (``launch/cost.py``) under either
    policy; then ``python -m repro_torch.launch.train --preset 100m
    --steps 20`` with a failure injected at step 12 and checkpoints every
    10 steps: restored and finished;
28. the LM's mesh, in one process over device lists on the one card:
    Jamba-v0.1 at full width, 8 layers (one pattern repeat), float32
    weights, served over data=1, model=4 of ``[cuda:0] * 4`` under
    ``axis_rules``: ``make_prefill_step`` on 2 x 2048 tokens (bf16; the
    flash kernel's launches counted, one per model position of the
    attention layer; MoE layers on the expert-parallel path, 16 experts
    on 4 shards, each shard's routed tokens printed), then the float32
    prefill of the first 512 tokens (the Mamba layers split over
    ``d_inner``, the attention over its heads), its last logits and next
    tokens against the same over a (1, 1) mesh (atol 1e-3); then ``make_decode_step`` at s_max = 32768 (context
    parallel: the attention layer's cache as 4 sequence tiles of 8192),
    its first 30,000 positions seeded K/V (so every tile takes part),
    a 4-token prompt and 16 greedy steps in float32, logits allclose to
    the (1, 1) run and equal tokens, ms per step; the serve CLI
    (``launch/serve.py``, Mixtral's tiny preset) on the card, every MoE
    call on the expert-parallel path; StarCoder2-3B at full
    width, 2 layers, two float32 ``make_mesh_train_step`` steps over
    data=2 of ``[cuda:0] * 2`` against two single-device steps (loss
    within 1e-4, parameters within 2e-4), flash launches counted;
    ``pipeline_apply`` (P = 4, M = 6, (2, 16) microbatches) over
    ``[cuda:0] * 4`` against the sequential stages;
29. the dry-run tooling (CPU only, on meta tensors, started in the
    background at the beginning, read after phase 32): ``python -m repro_torch.launch.dryrun``
    for the decoder cells (``--viterbi``), StarCoder2-3B × train_4k and ×
    decode_32k (the context-parallel cache) and DeepSeek-V2 × train_4k with
    and without ``REPRO_MOE_RULES=fsdp``, each report's counted FLOPs,
    bytes, collective bytes and argument GB of the busiest mesh position;
    K1's and K2's counted work at 8,192 int8 blocks equal to their bounds'
    inputs; then phase 6's decode from framed blocks and phase 17's prefill
    (30 flash launches of the band's FLOPs) counted on meta, each count's
    bound over the time that phase measured: a roofline share above 1.0
    fails;
30. the decode fleet across processes: two ranks (this script with
    ``--fleet-rank``, ``MASTER_ADDR=127.0.0.1``, ``WORLD_SIZE=2``,
    ``RANK=i``) on the one card, each starting the default group with
    ``maybe_init_distributed`` (NCCL, which the decoder never touches) and
    laying ``make_decode_mesh("data=2")`` over both ranks' ``cuda:0``: the
    4,194,304-bit stream through ``"cuda"`` and ``"fused"`` equal to phase
    4's ``"ref"`` bits on both ranks, with one launch of each kernel per
    rank; a ragged ``decode_batch`` of phase 5's 64 streams equal to the
    meshless one; each rank's decode ms and the gather's ms; then
    ``python -m repro_torch.launch.serve_decoder --mesh data=2 --streams 64``
    under two ranks. A failing or late rank fails the phase;
31. tensor parallelism over the ``model`` axis (``[31 tp]``), meshes of
    the one card named n times: StarCoder2-3B at full width and depth,
    bf16, in the serving layout (``lm.place_params``) over (1, 2):
    ``make_prefill_step`` on 2 x 4096 tokens with 60 flash launches, each
    on one position's heads at (Hkv_loc, G_loc) = (1, 12), ms per
    position, the counted all-reduce bytes (meta) and no gathered weight;
    ``greedy_generate`` for 4 requests (prompt 16, 32 new); at 2 layers
    in float32 over (1, 2) and (1, 4) (the kv_heads fallback, G_loc = 6)
    the last-position logits within 1e-3 of (1, 1) and equal greedy
    tokens; the flash kernel against ``ref_mha`` at both per-position
    shapes with its time, bound and SDPA's; the mesh train step over
    (2, 2) against one device (loss 1e-4, parameters 2e-4); Mixtral-8x22B
    at 2 layers, float32, over (1, 4) (experts at rest: views, memory
    flat over decode steps, a counted step gathers nothing) and (1, 16)
    (tensor parallel within each expert, d_ff_expert 16384 -> 1024, 3
    heads a position) against (1, 1), logits and greedy tokens;
32. MLA, Mamba and RWKV-6's time mix split over the ``model`` axis
    (``[32 tp mixers]``), meshes of the one card named n times: one
    full-width float32 layer of each (DeepSeek-V2's MLA, 128 heads;
    Jamba's Mamba, ``d_inner`` 8192; RWKV6-3B's time mix, 40 heads, its
    mixes, bonus, groupnorm, base decay and Mamba's skip drawn at random)
    laid by ``lm.place_module`` over (1, 2) and (1, 4), RWKV also over
    (1, 8) and over (1, 16), where its heads do not divide and it keeps
    the whole path bit for bit: a prefill of 2 x 2048 tokens and 8 cached
    steps from an empty cache laid per position (``lm.init_cache``), the
    outputs and the states within 1e-3 of (1, 1), the tiles views of the
    weights, ms per position; RWKV6-3B at full depth, bf16, in the serving
    layout over (1, 4): the prefill of 2 x 4096 tokens with ms per
    position, beside phase 25's one-device prefill; DeepSeek-V2 (capacity
    E/k) and RWKV6-3B at 2 layers, float32, over (1, 4): the last logits
    within 1e-3 of (1, 1) and ``greedy_generate``'s tokens equal.

Each phase prints its seconds (``[seconds]`` lines). The line before the
last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
torch finds no CUDA device or when the port's sources are missing.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
try:  # the H100's peaks and each kernel's (bytes, operations): one source with the roofline
    from repro_torch.launch.cost import (BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S,
                                         INT32_OPS_PER_S, bound, flash_cost, fused_cost,
                                         k1_cost, k1_matrix_cost, k2_cost, k2_prefix_cost,
                                         k2_staged_bytes)
except ImportError:  # no port beside this script: main() says so and exits non-zero
    pass

DEVICE = "cuda"
SEED = 20261016
N_MAIN_BLOCKS = 8192  # 8192 × D=512 = 4,194,304 decoded bits
EBN0_DB = 4.0
N_STREAMS, STREAM_BITS = 64, 65536
SLAB_STREAMS, SLAB_STREAM_BITS, SLAB_PAGES = 512, 8192, 1024  # phase 20's slab


# the LM path: StarCoder2-3B prefill of 2 prompts × 8192 tokens
LM_BATCH, LM_SEQ = 2, 8192
LM_PARAMS = 3_029_818_368  # count_params; n_params_estimate leaves out biases and norms
PREFILL_LOGIT_ATOL = 0.25  # bf16 compute over 30 layers: flash (f32 p) vs streaming (bf16 p)
DECODE_LOGIT_ATOL = 1e-3  # float32 compute: cached decode vs full forward, roundoff only

# phase 23: the paper's Fig. 4 on the card; soft BER at 4 dB is about 1e-5,
# so a point needs millions of bits to count errors at all
BER_BITS = 1 << 24
# phase 24: the remaining dense GQA cards and Mixtral at full width, depth cut
CARDS = ("qwen2.5-32b", "minitron-8b", "command-r-35b", "mixtral-8x22b")
CARD_LAYERS = 2
CARD_SEQ = {"qwen2.5-32b": 4096, "minitron-8b": 4096, "command-r-35b": 4096,
            "mixtral-8x22b": 8192}  # Mixtral: past its 4096 window
CARD_DECODE = 32  # cached float32 steps held against apply_train
# phase 25: the LM's other mixers (RWKV-6, MLA, Mamba) at full width; depth None = full
MIXER_CARDS = (("rwkv6-3b", None), ("deepseek-v2-236b", 2), ("jamba-v0.1-52b", 8))
MIXER_BATCH, MIXER_SEQ = 2, 4096
MIXER_DECODE = 66  # cached float32 steps: past two RWKV chunks (32) and a Mamba chunk (64)
MAMBA_STATE_RTOL = 1e-4  # float32 compute: prefill's scan state vs decoded state, roundoff only
# RWKV6-3B's 32 random layers amplify float32 roundoff: its chunked WKV and its cached steps
# agree to ~1e-6 of the mixer's output in every layer, yet at 32 layers cached decode and
# apply_train differ by 3.4e-2 on the card and 3.8e-2 on the CPU, and apply_train on the card
# and on the CPU by 5.7e-3 (2, 8, 16 layers: 1.9e-4, 3.4e-3, 7.9e-3). So the full depth is held
# at 0.1 and the first two layers alone at DECODE_LOGIT_ATOL.
RWKV_DEPTH_ATOL = 0.1
# phase 26: the enc-dec card at full width and depth, the VLM stub at full width, depth cut
ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_FRAMES = 2, 4096, 2048  # frames: the audio stub's input
ENCDEC_DECODE = 32  # cached float32 steps held against teacher-forced apply_train
ENCDEC_GREEDY = 32  # timed greedy steps against the cross cache (bf16)
VLM_LAYERS = 2
# phase 27: the training step on StarCoder2-3B at full width (and full depth)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 2, 2048, 6
# phase 28: the LM's mesh over device lists on the one card
MESH_SERVE_LAYERS, MESH_PREFILL = 8, (2, 2048)  # Jamba: one pattern repeat; 2 x 2048 tokens
MESH_S_MAX, MESH_PROMPT, MESH_NEW = 32768, 4, 16  # context-parallel decode from 32768
MESH_CTX = 30000  # cache positions filled with seeded K/V before the prompt: all 4 tiles live
MESH_LOGIT_ATOL = 1e-3  # float32: 4 sequence tiles' combine vs 1 tile, roundoff only
# model=4 splits the layers' sums (tensor parallelism), which reorders bf16 roundings through
# 8 layers of MoE routing: the prefill's parity with (1, 1) is held in float32, on the first
# MESH_PARITY_SEQ tokens, at MESH_LOGIT_ATOL
MESH_PARITY_SEQ = 512
MESH_TRAIN = (4, 1024, 2)  # StarCoder2-3B: batch, sequence, steps
MESH_LOSS_ATOL, MESH_PARAM_ATOL = 1e-4, 2e-4  # the reference's tests/test_distributed.py
PIPE_ATOL = 1e-5
# phase 31: tensor parallelism over the model axis, meshes over the one card named n times
TP_PREFILL = (2, 4096)  # StarCoder2-3B's full-depth bf16 serving prefill over (1, 2)
TP_GREEDY = (4, 16, 32)  # requests, prompt tokens, new tokens
TP_LOGIT_ATOL = 1e-3  # float32: the sums over positions in model order vs one device
TP_TRAIN = (4, 1024, 2)  # StarCoder2-3B at 2 layers over (2, 2): batch, sequence, steps
TP_MOE = (2, 1024, 8)  # Mixtral-8x22B at 2 layers: prefill rows, sequence, greedy new tokens
# allocated bytes may move by the loop's own token tensors across decode steps; one
# expert's slice (6144 x 16384 x 3 float32) is 1.2 GB, so a per-step weight copy cannot hide
TP_MEM_SLACK = 1 << 20
# phase 32: MLA, Mamba and RWKV-6's time mix split over the model axis
TPM_LAYER = (2, 2048)  # one full-width float32 layer of each mixer: batch, prefill tokens
TPM_DECODE = 8  # cached decode steps from an empty cache laid per position
TPM_RWKV_PREFILL = (2, 4096)  # RWKV6-3B at full depth, bf16, the serving layout over (1, 4)
TPM_GREEDY = (4, 16, 16)  # DeepSeek-V2 and RWKV6-3B at 2 layers, float32: requests, prompt, new
# phase 27: REPRO_REMAT=dots keeps the products that full remat recomputes, so the losses
# should agree as closely as the mesh step's do (the reference's tests/test_distributed.py)
DOTS_LOSS_ATOL = 1e-4
# phase 29: the dry-runs (CPU only, on meta tensors), started in the background at the
# beginning and read at the end: (label, knobs, arguments of repro_torch.launch.dryrun)
DRYRUNS = (
    ("MOE train_4k", {}, ("--arch", "MOE", "--shape", "train_4k")),
    ("MOE train_4k fsdp", {"REPRO_MOE_RULES": "fsdp"}, ("--arch", "MOE", "--shape", "train_4k")),
    ("starcoder2-3b train_4k", {}, ("--arch", "starcoder2-3b", "--shape", "train_4k")),
    ("starcoder2-3b decode_32k", {}, ("--arch", "starcoder2-3b", "--shape", "decode_32k")),
    ("viterbi", {}, ("--viterbi",)),
)
DRYRUN_MOE = "deepseek-v2-236b"
DRYRUN_AT_ONCE = 2  # background processes beside the phases (the two MoE runs first)
# times of earlier phases that [29 roofline] divides the counted bounds by (not timed again)
MEASURED: dict = {}
# float32 compute, flash on vs off: the flash path's backward stores the probabilities in bf16
# (the reference's _attend_chunked default), the streaming path's in float32, so the gradients
# differ at bf16 level: each leaf within 3e-2 of its largest entry
TRAIN_GRAD_RTOL = 3e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in ms, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(torch, fn, reps: int) -> float:
    """Median host-clock time of ``fn`` in ms, each run ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_profile(torch, fn, top: int = 6):
    """One run of ``fn`` under ``torch.profiler``: (wall ms, the ``top``
    kernels by device time as (name, ms, count), device busy ms). The wall
    time includes the profiler's own cost; kernels of one stream do not
    overlap, so their sum over the wall time is the busy share."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            kernels.append((e.key[:70], us / 1e3, e.count))
    kernels.sort(key=lambda k: -k[1])
    return wall, kernels[:top], sum(k[1] for k in kernels)


def kernel_device_ms(torch, fn, reps: int = 10) -> float | None:
    """Device time per launch, under ``torch.profiler``, of the decoder kernel
    that ``fn`` launches (kernels named traceback* or fused*); None when the
    profiler saw no device time."""
    fn()
    _, kernels, _ = device_profile(torch, lambda: [fn() for _ in range(reps)], top=50)
    hits = [(ms, c) for n, ms, c in kernels if "traceback" in n or "fused" in n]
    return sum(ms for ms, _ in hits) / sum(c for _, c in hits) if hits else None


def lm_phases(torch, dev, gen, decoder_counters) -> dict:
    """Phases 15-17: the flash kernel and the StarCoder2-3B serving path.
    Returns the flash kernel's rows of the ``kernels`` line, one per body."""
    import dataclasses

    import torch.nn.functional as F

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, lm
    from repro_torch._unused.serve.serve_step import (
        greedy_generate, make_decode_step, make_prefill_step)

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    bf16, f32 = torch.bfloat16, torch.float32

    def qkv(B, S, T, Hkv, G, dh, dtype):
        return (torch.randn((B, S, Hkv, G, dh), generator=gen, device=dev).to(dtype),
                torch.randn((B, T, Hkv, dh), generator=gen, device=dev).to(dtype),
                torch.randn((B, T, Hkv, dh), generator=gen, device=dev).to(dtype))

    # ---- 15. the flash kernel against its plain version -------------------------
    main_shape = (LM_BATCH, LM_SEQ, LM_SEQ, 2, 12, 128, bf16, True, 4096)
    cases = [
        ("causal", (2, 256, 256, 2, 2, 64, f32, True, None)),
        ("window < S", (1, 512, 512, 2, 12, 128, f32, True, 100)),
        ("window >= S", (1, 256, 256, 2, 2, 64, f32, True, 1000)),
        ("non-causal", (2, 128, 128, 2, 1, 32, f32, False, None)),
        ("non-causal window", (1, 256, 256, 1, 2, 64, bf16, False, 77)),
        ("T != S non-causal", (1, 128, 512, 2, 2, 128, f32, False, None)),
        ("T != S non-causal", (1, 256, 64, 1, 3, 16, bf16, False, None)),
        ("G = 1", (2, 320, 320, 2, 1, 128, bf16, True, None)),
        ("G = 2", (1, 192, 192, 4, 2, 64, f32, True, 50)),
        ("G = 12", (1, 1024, 1024, 2, 12, 128, bf16, True, 256)),
        ("ragged rows", (1, 100, 100, 1, 5, 128, f32, True, 33)),
        # the tensor-core body's edges: 128-row tiles that straddle positions
        # (G = 12) with S·G not a multiple of 128, a window below one 64-key
        # block, T != S, causal with T > S, dh = 16 and 32
        ("G = 12 ragged", (1, 100, 100, 2, 12, 128, bf16, True, 37)),
        ("G = 12 T != S", (1, 200, 300, 1, 12, 64, bf16, False, None)),
        ("causal T > S", (1, 128, 256, 1, 2, 64, bf16, True, None)),
        ("window < block", (2, 129, 129, 1, 3, 16, bf16, True, 9)),
        ("dh = 32 window", (1, 300, 200, 2, 5, 32, bf16, False, 70)),
        ("dh = 16 causal", (1, 333, 333, 2, 1, 16, bf16, True, None)),
        ("dh = 32 G = 12", (1, 96, 96, 1, 12, 32, bf16, True, 200)),
        # rows at p >= T + window - 1 see no key: the mean of V over all keys
        ("no key f32", (1, 300, 200, 1, 3, 64, f32, False, 70)),
        ("main shapes", main_shape),
    ]
    flash_err, main_qkv = {f32: 0.0, bf16: 0.0}, None
    for label, (B, S, T, Hkv, G, dh, dtype, causal, window) in cases:
        q, k, v = qkv(B, S, T, Hkv, G, dh, dtype)
        fa.launches = fa.tc_launches = 0
        out = fa.flash_attention(q, k, v, causal=causal, window=window, q_chunk=S, kv_chunk=T)
        torch.cuda.synchronize()
        body = (fa.launches, fa.tc_launches)
        if body != (1, int(dtype == bf16)) or out.dtype != dtype or out.shape != q.shape:
            raise AssertionError(f"flash {label}: launches (all, tensor-core) {body}, "
                                 f"{out.dtype} {out.shape}")
        ref = fa.ref_mha(q, k, v, causal=causal, window=window)
        diff = (out.float() - ref).abs()
        err = float(diff.max())
        # float32: another summation order. bf16: the kernel rounds its
        # float32 result once, which moves it by at most the bf16 unit
        # roundoff 2^-8 of the value; atol covers the float32 part.
        atol, rtol = (2e-5, 1e-5) if dtype == f32 else (2e-5, 2.0 ** -8)
        worst = float((diff / (atol + rtol * ref.abs())).max())
        if not bool(torch.isfinite(out).all()) or not worst <= 1.0:
            raise AssertionError(f"flash {label}: max abs error {err}, {worst:.3f} of the limit "
                                 f"atol {atol} + rtol {rtol}·|ref|")
        flash_err[dtype] = max(flash_err[dtype], err)
        log(f"[15 flash] {label:18s} B={B} S={S} T={T} Hkv={Hkv} G={G} dh={dh} {str(dtype):14s} "
            f"causal={causal} window={window}: max abs err {err:.3e}, {worst:.3f} of the limit "
            f"(atol {atol}, rtol {rtol:.3e}); {'tensor-core' if body[1] else 'CUDA-core'} body")
        del diff
        if label == "main shapes":
            main_qkv = (q, k, v)
        del ref, out
    q, k, v = qkv(1, 96, 96, 1, 2, 64, f32)
    fa.launches = 0
    try:
        fa.flash_attention(q, k, v, q_chunk=64, kv_chunk=64)
    except ValueError as err:
        if fa.launches:
            raise AssertionError("flash launched before refusing S % q_chunk") from err
        log(f"[15 flash] S=96, q_chunk=64: ValueError: {err}")
    else:
        raise AssertionError("flash took S=96 with q_chunk=64")

    # ---- 16. StarCoder2-3B at full width and depth --------------------------------
    cfg = get_config("starcoder2-3b")
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
    n_params = lm.count_params(params)
    if n_params != LM_PARAMS:
        raise AssertionError(f"starcoder2-3b has {n_params} parameters, want {LM_PARAMS}")
    log(f"[16 lm] {cfg.name}: {n_params:,} parameters ({cfg.param_dtype}; n_params_estimate "
        f"{cfg.n_params_estimate:,} + {n_params - cfg.n_params_estimate:,} biases and norms), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, "
        f"window {cfg.sliding_window}, compute {cfg.compute_dtype}")
    batch = {"tokens": torch.randint(0, cfg.vocab, (LM_BATCH, LM_SEQ), generator=gen, device=dev)}
    prefill = make_prefill_step(cfg)
    prefill(params, {"tokens": batch["tokens"][:, :256]})  # warm up
    torch.cuda.synchronize()
    for mod, attr in decoder_counters:
        setattr(mod, attr, 0)
    fa.launches = fa.tc_launches = 0
    torch.cuda.reset_peak_memory_stats()
    next_tok = prefill(params, batch)
    torch.cuda.synchronize()
    prefill_launches, prefill_tc = fa.launches, fa.tc_launches
    others = {attr: getattr(mod, attr) for mod, attr in decoder_counters if getattr(mod, attr)}
    if prefill_launches != cfg.n_layers or prefill_tc != cfg.n_layers or others:
        raise AssertionError(f"prefill launched flash {prefill_launches} times, {prefill_tc} on "
                             f"the tensor-core body (want {cfg.n_layers} of each), and decoder "
                             f"kernels {others}")
    log(f"[16 lm] make_prefill_step, {LM_BATCH} × {LM_SEQ} tokens: flash launches "
        f"{prefill_launches} (one per layer), {prefill_tc} on the tensor-core body, "
        f"{prefill_launches - prefill_tc} on the CUDA-core body; next tokens "
        f"{next_tok.tolist()}, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    last = lm.apply_train(params, batch, cfg)[:, -1]
    with attention.flash_enabled("off"):
        fa.launches = 0
        last_plain = lm.apply_train(params, batch, cfg)[:, -1]
        if fa.launches:
            raise AssertionError("flash launched with flash_enabled('off')")
    torch.cuda.synchronize()
    if not (bool(torch.isfinite(last).all()) and torch.equal(last.argmax(-1).int(), next_tok)):
        raise AssertionError("prefill logits not finite or not the prefill step's tokens")
    diff = float((last - last_plain).abs().max())
    if diff > PREFILL_LOGIT_ATOL:
        raise AssertionError(f"flash vs streaming prefill: last logits differ by {diff}")
    top, top_plain = last.argmax(-1), last_plain.argmax(-1)
    gaps = [float(last_plain[i, top_plain[i]] - last_plain[i, top[i]]) for i in range(LM_BATCH)]
    log(f"[16 lm] flash vs streaming prefill (flash_enabled('off')): last-position logits max "
        f"abs diff {diff:.4f} (atol {PREFILL_LOGIT_ATOL}, bf16 compute), argmax "
        f"{top.tolist()} vs {top_plain.tolist()}"
        f"{'' if torch.equal(top, top_plain) else f', streaming logit gap {gaps}'}")
    del last, last_plain

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    n_dec = 64
    toks = batch["tokens"][:, :n_dec]
    fa.launches = fa.tc_launches = 0
    full = lm.apply_train(params, {"tokens": toks}, cfg32)
    torch.cuda.synchronize()
    f32_launches = fa.launches - fa.tc_launches  # float32 compute: the CUDA-core body
    if (fa.launches, fa.tc_launches) != (cfg.n_layers, 0):
        raise AssertionError(f"float32 apply_train launched flash {fa.launches} times, "
                             f"{fa.tc_launches} on the tensor-core body")
    cache = lm.init_cache(cfg32, LM_BATCH, n_dec, dtype=f32, device=dev)
    dec = []
    for t in range(n_dec):
        lg, cache = lm.apply_decode(params, toks[:, t:t + 1], cache, t, cfg32)
        dec.append(lg[:, 0])
    dec_err = float((torch.stack(dec, 1) - full).abs().max())
    if not dec_err <= DECODE_LOGIT_ATOL:
        raise AssertionError(f"cached decode vs apply_train at float32: {dec_err}")
    log(f"[16 lm] float32 compute, cached apply_decode × {n_dec} vs apply_train: logits max abs "
        f"diff {dec_err:.3e} (atol {DECODE_LOGIT_ATOL}); apply_train's flash launches "
        f"{f32_launches}, all on the CUDA-core body")
    del full, cache, dec

    prompt = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev)
    gen_toks = greedy_generate(params, cfg, prompt, 64)
    torch.cuda.synchronize()
    if gen_toks.shape != (4, 64) or not bool(((gen_toks >= 0) & (gen_toks < 49152)).all()):
        raise AssertionError(f"greedy_generate gave {gen_toks.shape}")
    log(f"[16 lm] greedy_generate, 4 requests × (prompt 16, 64 new): first tokens "
        f"{gen_toks[:, :4].tolist()}")

    ring_cfg = dataclasses.replace(cfg, n_layers=2, sliding_window=64, compute_dtype="float32")
    ring_params = lm.init_params(ring_cfg, generator=torch.Generator(device=dev).manual_seed(SEED),
                                 device=dev)
    n_ring = 160
    rtoks = torch.randint(0, cfg.vocab, (LM_BATCH, n_ring), generator=gen, device=dev)
    full = lm.apply_train(ring_params, {"tokens": rtoks}, ring_cfg)
    cache = lm.init_cache(ring_cfg, LM_BATCH, n_ring, dtype=f32, device=dev)
    slots = cache["groups"][0][0]["l0"]["mixer"].k.shape[1]
    dec = []
    for t in range(n_ring):
        lg, cache = lm.apply_decode(ring_params, rtoks[:, t:t + 1], cache, t, ring_cfg)
        dec.append(lg[:, 0])
    ring_err = float((torch.stack(dec, 1) - full).abs().max())
    if slots != 64 or not ring_err <= DECODE_LOGIT_ATOL:
        raise AssertionError(f"ring buffer: {slots} slots, decode vs apply_train {ring_err}")
    log(f"[16 lm] ring buffer: 2-layer StarCoder2 (full width, window 64), {slots} cache slots, "
        f"{n_ring} cached steps vs apply_train at float32: logits max abs diff {ring_err:.3e} "
        f"(atol {DECODE_LOGIT_ATOL})")
    del ring_params, full, cache, dec

    # ---- 17. times ------------------------------------------------------------------
    q, k, v = main_qkv
    B, S, T, Hkv, G, dh, dtype, causal, window = main_shape
    flash_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                       reps=10)
    plain_ms = cuda_ms(torch, lambda: fa.ref_mha(q, k, v, causal=causal, window=window), reps=3,
                       warmup=1)
    nbytes, flops = flash_cost(B, S, T, Hkv, G, dh, causal, window, q.element_size())
    bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    pos = torch.arange(S, device=dev)
    band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
    qs, ks, vs = q.reshape(B, S, Hkv * G, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band, enable_gqa=True)
        sdpa = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=band, enable_gqa=True)
        how = "enable_gqa=True"
    except TypeError:
        kr, vr = ks.repeat_interleave(G, dim=1), vs.repeat_interleave(G, dim=1)
        sdpa = lambda: F.scaled_dot_product_attention(qs, kr, vr, attn_mask=band)
        how = "K/V repeated G times"
    library_ms = cuda_ms(torch, sdpa, reps=10)
    # the tensor-core body does QKᵀ and P·V twice (P split into hi and lo)
    log(f"[17 times] flash_attention tensor-core body, B={B} S=T={S} Hkv={Hkv} G={G} dh={dh} bf16 "
        f"causal window {window}: {flash_ms:.3f} ms (plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by}: {flops:.4e} FLOP at {BF16_FLOPS_PER_S:.3g}/s, "
        f"{nbytes:.4e} B at {HBM_BYTES_PER_S:.3g} B/s; {flops / flash_ms / 1e9:.2f} TFLOP/s of "
        f"the function achieved; the body's own tensor-core work {1.5 * flops:.4e} FLOP, "
        f"{1.5 * flops / BF16_FLOPS_PER_S * 1e3:.4f} ms, {1.5 * flops / flash_ms / 1e9:.2f} "
        f"TFLOP/s; scaled_dot_product_attention with the band mask, {how}: {library_ms:.3f} "
        f"ms); launches per prefill {prefill_tc}")
    q32, k32, v32 = q.float(), k.float(), v.float()
    f32_ms = cuda_ms(torch, lambda: fa.flash_attention(q32, k32, v32, causal=causal,
                                                       window=window), reps=5)
    f32_plain_ms = cuda_ms(torch, lambda: fa.ref_mha(q32, k32, v32, causal=causal,
                                                     window=window), reps=3, warmup=1)
    f32_bytes = flash_cost(B, S, T, Hkv, G, dh, causal, window, 4)[0]
    f32_bound, f32_by = bound(f32_bytes, flops, F32_FLOPS_PER_S)
    ks32, vs32 = k32.transpose(1, 2), v32.transpose(1, 2)
    qs32 = q32.reshape(B, S, Hkv * G, dh).transpose(1, 2)
    if how == "enable_gqa=True":
        sdpa32 = lambda: F.scaled_dot_product_attention(qs32, ks32, vs32, attn_mask=band,
                                                        enable_gqa=True)
    else:
        kr32, vr32 = ks32.repeat_interleave(G, dim=1), vs32.repeat_interleave(G, dim=1)
        sdpa32 = lambda: F.scaled_dot_product_attention(qs32, kr32, vr32, attn_mask=band)
    try:
        f32_library_ms = cuda_ms(torch, sdpa32, reps=3)
    except torch.cuda.OutOfMemoryError:  # timed only where it fits beside the model
        f32_library_ms = None
        torch.cuda.empty_cache()
    log(f"[17 times] flash_attention CUDA-core body, the same shapes in float32: {f32_ms:.3f} ms "
        f"(plain {f32_plain_ms:.3f} ms; bound {f32_bound:.4f} ms by {f32_by} at the "
        f"{F32_FLOPS_PER_S:.3g} FLOP/s float32 CUDA-core peak; scaled_dot_product_attention "
        f"in float32 {'not measured (out of memory)' if f32_library_ms is None else f'{f32_library_ms:.3f} ms'}); "
        f"launches in the float32 apply_train of phase 16 "
        f"{f32_launches}")
    del q32, k32, v32, qs32, ks32, vs32
    n_tok = LM_BATCH * LM_SEQ
    pre = [wall_ms(torch, lambda: prefill(params, batch), reps=1) for _ in range(3)]
    MEASURED.update(prefill_ms=statistics.median(pre), flash_ms=flash_ms)
    log(f"[17 times] prefill end to end, {LM_BATCH} × {LM_SEQ} tokens: ms {pre}, median "
        f"{statistics.median(pre):.1f} ms → {n_tok / statistics.median(pre) * 1e3:.0f} tokens/s")
    n_prompt, n_steps, n_req = 16, 32, 4
    step = make_decode_step(cfg, n_prompt + 2 * n_steps)
    cache = lm.init_cache(cfg, n_req, n_prompt + 2 * n_steps, device=dev)
    prompt = torch.randint(0, cfg.vocab, (n_req, n_prompt), generator=gen, device=dev)
    for t in range(n_prompt):
        nxt, cache = step(params, prompt[:, t:t + 1], cache, t)
    state = {"tok": nxt[:, None], "t": n_prompt}

    def decode_steps(n=n_steps // 2):  # the cache is written in place
        for _ in range(n):
            nxt, _ = step(params, state["tok"], cache, state["t"])
            state["tok"], state["t"] = nxt[:, None], state["t"] + 1

    dec_ms = [wall_ms(torch, decode_steps, reps=1) / (n_steps // 2) for _ in range(2)]
    log(f"[17 times] decode end to end, batch {n_req}, cache of "
        f"{n_prompt + 2 * n_steps} slots: ms per step {dec_ms} → "
        f"{n_req / statistics.median(dec_ms) * 1e3:.1f} tokens/s")
    # a quarter of the timed window under the profiler: gathering the trace of 16 decode
    # steps took about 20 s of host time
    for what, fn in (("prefill", lambda: prefill(params, batch)),
                     (f"{n_steps // 8} decode steps", lambda: decode_steps(n_steps // 8))):
        wall, kernels, busy = device_profile(torch, fn)
        if busy <= 0:
            log(f"[17 profile] {what}: the profiler saw no device time (not measured)")
            continue
        log(f"[17 profile] {what}: wall {wall:.1f} ms under the profiler, device busy "
            f"{busy:.1f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top kernels: "
            + "; ".join(f"{n} {ms:.1f} ms × {c}" for n, ms, c in kernels))
    src_fa = "src/repro_torch/kernels/csrc/flash_attention.cu"
    return [dict(name="flash_attention (tensor-core body, bf16)", route="cuda", source=src_fa,
                 replaces="src/repro/_unused/flash_attention.py:54", launches=prefill_tc,
                 max_abs_err=flash_err[bf16], ms=flash_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms),
            dict(name="flash_attention (CUDA-core body, float32)", route="cuda", source=src_fa,
                 replaces="src/repro/_unused/flash_attention.py:54", launches=f32_launches,
                 max_abs_err=flash_err[f32], ms=f32_ms, plain_ms=f32_plain_ms, bound_ms=f32_bound,
                 bound_by=f32_by, library_ms=f32_library_ms)]


class PhaseClock:
    """Seconds per phase: ``lap(label)`` prints the time since the last lap
    (or the start) and since the start."""

    def __init__(self):
        self.t0 = self.last = time.perf_counter()

    def lap(self, label: str) -> None:
        now = time.perf_counter()
        log(f"[seconds] {label}: {now - self.last:.1f} s (script {now - self.t0:.1f} s)")
        self.last = now


def percentiles(ms: list[float]) -> str:
    import numpy as np

    a = np.asarray(ms, np.float64)
    return (f"p50 {np.percentile(a, 50):.3f} ms, p99 {np.percentile(a, 99):.3f} ms, "
            f"max {a.max():.3f} ms (n={a.size})")


def counter_fns(torch, counters):
    """(zero, read) over the (key, module, attribute) launch counters: set
    every count to 0, and read the non-zero ones, each after a synchronize."""

    def zero():
        torch.cuda.synchronize()
        for _, mod, attr in counters:
            setattr(mod, attr, 0)

    def read() -> dict:
        torch.cuda.synchronize()
        return {key: getattr(mod, attr) for key, mod, attr in counters if getattr(mod, attr)}

    return zero, read


def streaming_phases(torch, dev, gen, counters, y, ref_bits) -> None:
    """Phases 18-19: streaming sessions and the session pool on the card.
    ``y`` is the main path's stream on the card, ``ref_bits`` its one-shot
    ``"ref"`` decode; ``counters`` the (key, module, attribute) launch
    counters of every decoder kernel."""
    import contextlib
    import io
    import pickle
    import re

    import numpy as np

    from repro_torch.core.channel import transmit
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.encoder import encode
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.core.quantize import quantize_soft
    from repro_torch.launch import serve_decoder
    from repro_torch.launch.faults import StreamError
    from repro_torch.launch.serve_decoder import SessionPool

    cfg = PBVDConfig()
    D, L = cfg.D, cfg.L
    n_bits = ref_bits.shape[0]
    y_host = y.cpu().numpy()  # a receiver hands the session host memory
    rng = np.random.default_rng(SEED)

    zero, read = counter_fns(torch, counters)

    def want_counts(be: str, knobs: dict, n: int) -> dict:
        mat, pre = knobs.get("acs_impl") == "matrix", knobs.get("tb_mode") == "prefix"
        if be == "cuda":
            return {"acs_matrix" if mat else "acs": n, "traceback_prefix" if pre else "traceback": n}
        return {"fused": n, **({"fused_matrix": n} if mat else {}),
                **({"fused_prefix": n} if pre else {})}

    def by_rows(yh, rows: int) -> list:
        return [yh[i : i + rows] for i in range(0, len(yh), rows)]

    def random_parts(yh, n_parts: int) -> list:
        cuts = np.sort(rng.choice(np.arange(1, len(yh)), n_parts - 1, replace=False))
        return np.split(yh, cuts)

    def stream(eng, parts, nb, label, want_bits, knobs, be):
        """Feed ``parts`` to a fresh session with the counters at 0; check the
        bits and that every non-empty output came from one launch of each
        kernel of the path."""
        sess = eng.session()
        zero()
        outs = [sess.decode(c) for c in parts]
        outs.append(sess.finish(nb))
        counts = read()
        n_launch = sum(int(o.shape[0] > 0) for o in outs)
        got = torch.cat(outs)
        if got.shape != want_bits.shape or not torch.equal(got, want_bits):
            raise AssertionError(f"session {label}: streamed bits differ from the one-shot decode")
        if counts != want_counts(be, knobs, n_launch):
            raise AssertionError(f"session {label}: launches {counts}, expected one of each "
                                 f"kernel of the path per non-empty chunk ({n_launch})")
        if sess.bits_emitted != nb:
            raise AssertionError(f"session {label}: bits_emitted {sess.bits_emitted} != {nb}")
        return counts, len(parts)

    # ---- 18. streaming equals one-shot -------------------------------------------
    main_configs = [("cuda", {}), ("fused", {}),
                    ("cuda", dict(acs_radix=4, metric_mode="i8")),
                    ("fused", dict(acs_radix=4, metric_mode="i8")),
                    ("cuda", dict(acs_impl="matrix", tb_mode="prefix")),
                    ("fused", dict(acs_impl="matrix", tb_mode="prefix"))]
    engines = {}
    for be, knobs in main_configs:
        eng = DecoderEngine(PBVDConfig(backend=be, **knobs), device=dev)
        engines[be, tuple(knobs.items())] = eng
        want_bits = eng.decode(y, n_bits) if knobs else ref_bits
        for chunking, parts in (("4096-bit chunks", by_rows(y_host, 4096)),
                                ("seeded random chunks", random_parts(y_host, 700))):
            counts, n_parts = stream(eng, parts, n_bits, f"{be} {knobs} {chunking}", want_bits,
                                     knobs, be)
            log(f"[18 session] {n_bits} bits, {be} {knobs or 'default'}, {n_parts} {chunking}: == "
                f"one-shot{' (ref)' if not knobs else ''} bit for bit; launches {counts}")

    # B parallel blocks per launch: a first chunk of B·D + L stages, then B·D
    # per chunk; every block's window lies inside the prefix, so its bits are
    # those of the whole stream's one-shot decode
    for B in (1, 2, 3, 5, 8, 33):
        nb = 4 * B * D
        parts = [y_host[: B * D + L]] + [y_host[L + i * B * D : L + (i + 1) * B * D]
                                         for i in range(1, 4)]
        for be in ("cuda", "fused"):
            for walk in ("serial", "prefix"):
                knobs = {"tb_mode": walk} if walk == "prefix" else {}
                eng = DecoderEngine(PBVDConfig(backend=be, **knobs), device=dev)
                counts, _ = stream(eng, parts, nb, f"B={B} {be} {walk}", ref_bits[:nb], knobs, be)
                if min(counts.values()) != 4:
                    raise AssertionError(f"B={B} {be} {walk}: launches {counts}, expected 4")
        log(f"[18 small B] B={B} blocks per launch, 4 launches: cuda and fused, serial and "
            f"prefix walks == ref bit for bit")

    # a punctured stream (1-D wire format, random cuts through the puncture
    # period) and pre-quantized int8 chunks
    spec34 = get_code_spec("ccsds-3/4")
    nb34 = n_bits // 4
    pay34 = torch.randint(0, 2, (nb34 + spec34.code.v,), generator=gen, device=dev,
                          dtype=torch.int32)
    y34 = transmit(gen, spec34.puncture_stream(encode(pay34, spec34.code)), EBN0_DB, spec34.rate)
    eng34 = DecoderEngine(PBVDConfig(spec=spec34), device=dev)
    want34 = DecoderEngine(PBVDConfig(spec=spec34, backend="ref"), device=dev).decode(y34, nb34)
    if not torch.equal(eng34.decode(y34, nb34), want34):
        raise AssertionError("ccsds-3/4 one-shot: cuda differs from ref")
    counts, n_parts = stream(eng34, random_parts(y34.cpu().numpy(), 500), nb34, "ccsds-3/4",
                             want34, {}, "cuda")
    log(f"[18 session] ccsds-3/4, {nb34} bits in {n_parts} random 1-D chunks: == ref bit for "
        f"bit; launches {counts}; {int((want34 != pay34[:nb34]).sum())} bit errors at "
        f"{EBN0_DB} dB")
    yq = quantize_soft(y, 8).cpu().numpy()
    counts, n_parts = stream(engines["cuda", ()], by_rows(yq, 4096), n_bits, "int8 chunks",
                             ref_bits, {}, "cuda")
    log(f"[18 session] pre-quantized int8 chunks ({n_parts}): == ref bit for bit; launches {counts}")

    # a snapshot halfway, through pickle, restored into a fresh session
    parts = by_rows(y_host, 4096)
    half = len(parts) // 2
    first = engines["cuda", ()].session()
    head = [first.decode(c) for c in parts[:half]]
    snap = pickle.loads(pickle.dumps(first.snapshot()))
    second = engines["cuda", ()].session()
    second.restore(snap)
    tail = [second.decode(c) for c in parts[half:]] + [second.finish(n_bits)]
    if not torch.equal(torch.cat(head + tail), ref_bits):
        raise AssertionError("snapshot/restore: the continued stream differs from ref")
    log(f"[18 snapshot] snapshot after {half} of {len(parts)} chunks ({len(pickle.dumps(snap))} "
        f"B pickled, {snap['store']['rows'].shape[0]} buffered stages), restored into a fresh "
        f"session: == ref bit for bit")

    # the pool: N_STREAMS streams of STREAM_BITS in 16 rounds against decode_batch
    pay = torch.randint(0, 2, (N_STREAMS, STREAM_BITS), generator=gen, device=dev,
                        dtype=torch.int32)
    pay = torch.cat([pay, pay.new_zeros((N_STREAMS, cfg.code.v))], dim=1)
    ys = transmit(gen, encode(pay, cfg.code), EBN0_DB, cfg.codespec.rate)
    eng_c, eng_f = engines["cuda", ()], engines["fused", ()]
    batch = eng_c.decode_batch(list(ys), [STREAM_BITS] * N_STREAMS)
    ys_host = ys.cpu().numpy()
    bounds = np.linspace(0, ys_host.shape[1], 17).astype(int)
    n_fused = 8  # a second group: the first streams again, on "fused"

    def run_pool(isolate_marks=None):
        pool = SessionPool()
        handles = [pool.open(eng_c) for _ in range(N_STREAMS)]
        fhandles = [] if isolate_marks else [pool.open(eng_f) for _ in range(n_fused)]
        if isolate_marks:
            marked = {handles[i] for i in isolate_marks}

            def hook(entries, isolating):
                if any(ps in marked for ps, _ in entries):
                    raise StreamError("marked stream")

            pool.fault_hook = hook
        outs = [[] for _ in handles + fhandles]
        per_step = []
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            for i, h in enumerate(handles + fhandles):
                h.feed(ys_host[i % N_STREAMS, lo:hi])
            before = pool.launches
            zero()
            pool.step(isolate=bool(isolate_marks))
            per_step.append((pool.launches - before, read()))
            for o, h in zip(outs, handles + fhandles):
                o.append(h.take())
        return pool, handles, fhandles, outs, per_step

    pool, handles, fhandles, outs, per_step = run_pool()
    for (n_l, counts), hi in zip(per_step, bounds[1:]):
        want = (2, {"acs": 1, "traceback": 1, "fused": 1}) if hi >= D + L else (0, {})
        if (n_l, counts) != want:
            raise AssertionError(f"pool step: {n_l} launches, kernels {counts}; expected one "
                                 f"per group (K1 and K2 for cuda, one fused)")
    for i, h in enumerate(handles + fhandles):
        got = torch.cat(outs[i] + [h.finish(STREAM_BITS)])
        if not torch.equal(got, batch[i % N_STREAMS]):
            raise AssertionError(f"pool stream {i} differs from decode_batch")
    log(f"[18 pool] {N_STREAMS} streams x {STREAM_BITS} bits on cuda + {n_fused} on fused, 16 "
        f"rounds: == decode_batch bit for bit; launches per step {[n for n, _ in per_step]} "
        f"(kernels per step {per_step[-1][1]}); {pool.launches} launches in all "
        f"with the {N_STREAMS + n_fused} finishes")

    marks = (1, N_STREAMS // 2, N_STREAMS - 1)
    pool, handles, _, outs, per_step = run_pool(isolate_marks=marks)
    bad = pool.drain_quarantined()
    if {ps for ps, _ in bad} != {handles[i] for i in marks} or len(pool) != N_STREAMS - 3:
        raise AssertionError(f"isolate: quarantined {len(bad)} streams, pool keeps {len(pool)}")
    for i, h in enumerate(handles):
        if i in marks:
            continue
        if not torch.equal(torch.cat(outs[i] + [h.finish(STREAM_BITS)]), batch[i]):
            raise AssertionError(f"isolate: healthy stream {i} differs from decode_batch")
    log(f"[18 isolate] hook marks streams {marks} of {N_STREAMS}: exactly those quarantined "
        f"({', '.join(type(e).__name__ for _, e in bad)}); the other {N_STREAMS - 3} == "
        f"decode_batch bit for bit; launches per step {[n for n, _ in per_step]}")

    for argv in (["--chunk-bits", "4096", "--n-chunks", "64"],
                 ["--streams", "16", "--chunk-bits", "4096", "--n-chunks", "16"]):
        buf = io.StringIO()
        zero()
        with contextlib.redirect_stdout(buf):
            serve_decoder.main(argv)
        counts = read()
        lines = buf.getvalue().strip().splitlines()
        m = re.search(r"BER = \S+ \((\d+) errors", lines[-1])
        total = int(argv[argv.index("--chunk-bits") + 1]) * int(argv[argv.index("--n-chunks") + 1])
        total *= int(argv[1]) if argv[0] == "--streams" else 1
        if m is None or int(m.group(1)) > total * 1e-3 or counts.get("acs", 0) < 1:
            raise AssertionError(f"serve_decoder {argv}: {lines}, launches {counts}")
        for line in lines:
            log(f"[18 cli] {line}")
        log(f"[18 cli] launches {counts}")

    # ---- 19. times ---------------------------------------------------------------
    for be in ("cuda", "fused"):
        eng = engines[be, ()]
        for chunk_bits in (1024, 4096, 65536):
            sess = eng.session()
            lat = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for c in by_rows(y_host, chunk_bits):
                t1 = time.perf_counter()
                sess.decode(c)
                torch.cuda.synchronize()
                lat.append((time.perf_counter() - t1) * 1e3)
            sess.finish(n_bits)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            log(f"[19 latency] {be} session, {chunk_bits}-bit chunks: chunk latency "
                f"{percentiles(lat)}; {n_bits} bits in {wall:.1f} ms = "
                f"{n_bits / wall / 1e3:.1f} Mb/s")

    for rep in range(2):  # the second run is the one read
        pool = SessionPool()
        handles = [pool.open(eng_c) for _ in range(N_STREAMS)]
        step_ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            for i, h in enumerate(handles):
                h.feed(ys_host[i, lo:hi])
            t1 = time.perf_counter()
            pool.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
            for h in handles:
                h.take()
        for h in handles:
            h.finish(STREAM_BITS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    log(f"[19 pool] {N_STREAMS} streams x {STREAM_BITS} bits in 16 rounds of "
        f"{STREAM_BITS // 16}-bit chunks on cuda: step latency {percentiles(step_ms)}; "
        f"{N_STREAMS * STREAM_BITS} bits in {wall:.1f} ms (feeds, steps, takes, finishes) = "
        f"aggregate {N_STREAMS * STREAM_BITS / wall / 1e3:.1f} Mb/s")

    # the host phases of a session step at 4096-bit chunks
    phases = {"ingest": [], "window copy and framing": [], "launch": [], "commit": []}
    for be in ("cuda", "fused"):
        eng = engines[be, ()]
        sess = eng.session()
        for k in phases:
            phases[k] = []
        for c in by_rows(y_host, 4096)[:512]:
            torch.cuda.synchronize()
            t = [time.perf_counter()]
            sess.ingest(c)
            t.append(time.perf_counter())
            b1 = sess.ready_blocks()
            blocks = sess._frame_ready(b1)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            eng._decode_blocks(blocks, (b1 - sess._blocks_done,)).t().reshape(-1)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            sess._commit(b1)
            t.append(time.perf_counter())
            for k, a, b in zip(phases, t[:-1], t[1:]):
                phases[k].append((b - a) * 1e3)
        log(f"[19 host] {be} session step at 4096-bit chunks (8 blocks), medians over "
            f"{len(phases['ingest'])} chunks: " + ", ".join(
                f"{k} {statistics.median(v):.4f} ms" for k, v in phases.items()))

    def four_steps():  # the first 4 of the 16: the trace of 16 took about 15 s to gather
        pool = SessionPool()
        handles = [pool.open(eng_c) for _ in range(N_STREAMS)]
        for lo, hi in zip(bounds[:4], bounds[1:5]):
            for i, h in enumerate(handles):
                h.feed(ys_host[i, lo:hi])
            pool.step()

    wall, kernels_p, busy = device_profile(torch, four_steps)
    if busy <= 0:
        log("[19 profile] the profiler saw no device time (not measured)")
    else:
        log(f"[19 profile] 4 pool steps of {N_STREAMS} streams: wall {wall:.3f} ms under the "
            f"profiler, device busy {busy:.3f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
            f"top kernels: " + "; ".join(f"{n} {ms:.3f} ms × {c}" for n, ms, c in kernels_p))


def serving_phases(torch, dev, gen, counters, power: str) -> None:
    """Phases 20-21: the serving fabric on the card (the async service over
    paged slabs, its failure model, the chunk journal and crash recovery,
    the CLI's async and durable modes), at the default config on ``"cuda"``
    and ``"fused"``. ``counters`` are the (key, module, attribute) launch
    counters of every decoder kernel; ``power`` is the card's name and
    power limit as nvidia-smi prints them."""
    import asyncio
    import contextlib
    import os
    import shutil

    from repro_torch.core.channel import transmit
    from repro_torch.core.encoder import encode
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.launch.faults import FaultInjector, IntegrityError, StreamError, SymbolError
    from repro_torch.launch.serve_async import AsyncDecodeService, run_poisson_trace
    from repro_torch.launch.slab import SymbolSlab

    cfg = PBVDConfig()
    D, L = cfg.D, cfg.L
    page = D + 2 * L  # one decode window per slab page
    zero, read = counter_fns(torch, counters)
    engines = {be: DecoderEngine(PBVDConfig(backend=be), device=dev) for be in ("cuda", "fused")}

    def streams(n: int, n_bits: int, ebn0: float):
        """n seeded streams on the card: (symbols on the card, host copies)."""
        pay = torch.randint(0, 2, (n, n_bits + cfg.code.v), generator=gen, device=dev,
                            dtype=torch.int32)
        pay[:, n_bits:] = 0  # terminated
        ys = transmit(gen, encode(pay, cfg.code), ebn0, cfg.codespec.rate)
        return ys, ys.cpu().numpy()  # a receiver hands the service host memory

    def one_shot(be: str, ys, n_bits: int) -> list:
        return [engines[be].decode(y, n_bits) for y in ys]

    @contextlib.contextmanager
    def clocked(*names):
        """Count the calls of, and the host seconds spent in, these methods of
        AsyncDecodeService (a coroutine's seconds include its awaits)."""
        stats = {n: [0, 0.0] for n in names}
        saved = {n: getattr(AsyncDecodeService, n) for n in names}

        def wrap(n, f):
            if asyncio.iscoroutinefunction(f):
                async def g(*a, **k):
                    t = time.perf_counter()
                    try:
                        return await f(*a, **k)
                    finally:
                        stats[n][0] += 1
                        stats[n][1] += time.perf_counter() - t
            else:
                def g(*a, **k):
                    t = time.perf_counter()
                    try:
                        return f(*a, **k)
                    finally:
                        stats[n][0] += 1
                        stats[n][1] += time.perf_counter() - t
            return g

        for n, f in saved.items():
            setattr(AsyncDecodeService, n, wrap(n, f))
        try:
            yield stats
        finally:
            for n, f in saved.items():
                setattr(AsyncDecodeService, n, f)

    def trace(be, ys_host, n_bits, rate, *, slab_pages, chunk=4096, mbb=512, deadline=5.0,
              injector=None, extra=None):
        """One run_poisson_trace with the counters at 0 before it and read
        after: (results, metrics, launches by kernel, slab, host seconds,
        host breakdown)."""
        slab = SymbolSlab(n_pages=slab_pages, page_stages=page, R=cfg.code.R)
        zero()
        t0 = time.perf_counter()
        with clocked("_dispatch", "_wait_for_space", "_finish") as stats:
            results, report = asyncio.run(run_poisson_trace(
                engines[be], list(ys_host), [n_bits] * len(ys_host), chunk_symbols=chunk,
                rate_chunks_per_s=rate, seed=SEED, slab=slab, fault_injector=injector,
                service_kwargs=dict(max_batch_blocks=mbb, deadline_ms=deadline,
                                    **(extra or {}))))
        wall = time.perf_counter() - t0
        host = (f"host: {wall:.3f} s in all, {stats['_dispatch'][1]:.3f} s in "
                f"{stats['_dispatch'][0]} dispatch calls, {stats['_finish'][1]:.3f} s in "
                f"{stats['_finish'][0]} finishes, {stats['_wait_for_space'][0]} admission "
                f"waits parked {stats['_wait_for_space'][1]:.3f} s in all")
        counts = read()
        want = ({"acs": report["launches"], "traceback": report["launches"]} if be == "cuda"
                else {"fused": report["launches"]})
        if counts != want:
            raise AssertionError(f"service on {be}: kernel launches {counts}, expected one of "
                                 f"each kernel of the path per pool launch ({report['launches']})")
        if slab.pages_in_use != 0 or slab.high_water > slab_pages:
            raise AssertionError(f"service on {be}: {slab.pages_in_use} pages leaked, "
                                 f"high-water {slab.high_water} of {slab_pages}")
        return results, report, counts, slab, host

    def check_bits(label, results, refs, skip=()):
        for i, (got, ref) in enumerate(zip(results, refs)):
            if i in skip:
                continue
            if not isinstance(got, torch.Tensor) or not torch.equal(got, ref):
                raise AssertionError(f"{label}: stream {i} differs from its one-shot decode "
                                     f"({type(got).__name__})")

    def summary(report, n_blocks) -> str:
        mbps = report["sustained_mbps"]
        return (f"{report['dispatches']} dispatches, {report['launches']} launches, "
                f"{n_blocks / report['launches']:.1f} blocks per launch, slab high-water "
                f"{report['slab_pages_high_water']} pages, slab backpressure "
                f"{report['errors_by_class'].get('SlabExhausted', 0)}; chunk latency p50 "
                f"{report['p50_ms']:.3f} ms, p99 {report['p99_ms']:.3f} ms (n={report['chunks']}); "
                f"sustained {mbps:.3f} Mb/s")

    # ---- 20. the service: 64 streams, under and over the pool's capacity ------------
    n_bits = STREAM_BITS
    ys, ys_host = streams(N_STREAMS, n_bits, EBN0_DB)
    n_blocks = N_STREAMS * (n_bits // D)
    svc_refs = {}
    for be in ("cuda", "fused"):
        refs = svc_refs[be] = one_shot(be, ys, n_bits)
        for rate in (25.0, 200.0):
            results, report, counts, slab, host = trace(be, ys_host, n_bits, rate,
                                                        slab_pages=1024)
            check_bits(f"[20 service] {be} {rate}/s", results, refs)
            log(f"[20 service] {be}, {N_STREAMS} streams x {n_bits} bits in 4096-bit chunks at "
                f"{rate:g} chunks/s per stream, deadline 5 ms, max_batch_blocks 512, 1024 "
                f"pages of {page} stages: == one-shot bit for bit; {summary(report, n_blocks)}; "
                f"launches {counts}; {host}")

    # ---- 20. the slab: 512 short streams through 1024 pages --------------------------
    ys_s, ys_s_host = streams(SLAB_STREAMS, SLAB_STREAM_BITS, EBN0_DB)
    for be in ("cuda", "fused"):
        refs = one_shot(be, ys_s, SLAB_STREAM_BITS)
        results, report, counts, slab, host = trace(be, ys_s_host, SLAB_STREAM_BITS, 25.0,
                                                    slab_pages=SLAB_PAGES)
        check_bits(f"[20 slab] {be}", results, refs)
        log(f"[20 slab] {be}, {SLAB_STREAMS} streams x {SLAB_STREAM_BITS} bits "
            f"({SLAB_STREAMS * SLAB_STREAM_BITS} bits) in 4096-bit chunks through {SLAB_PAGES} "
            f"pages: == one-shot bit for bit; "
            f"{summary(report, SLAB_STREAMS * SLAB_STREAM_BITS // D)}; pages in use at the end "
            f"{slab.pages_in_use}; {host}")

    # ---- 20. chaos: the reference's schedule plus a silent corruption ---------------
    chaos_bits, poisoned = 4096, {3, 17}
    # decode_corrupt is consulted once per stream that receives bits inside a dispatch (a
    # stream's tail flushed by finish() is screened, not consulted), so how many visits a
    # trace makes depends on the host's timing: the corruption strikes the first delivery,
    # which every trace makes (the 41st visit once never came on the card)
    schedule = {"stream_poison": poisoned, "dispatch": {1, 4}, "slab": {5, 30}, "mesh": {2},
                "admission": {100}, "decode_corrupt": {0}}
    # 14 dB: the clean re-encode agrees on every symbol, so a bound of 0.9995
    # catches one flipped bit (10 re-encoded symbols) in spans to 20,000 symbols
    ys_c, ys_c_host = streams(N_STREAMS, chaos_bits, 14.0)
    for be in ("cuda", "fused"):
        refs = one_shot(be, ys_c, chaos_bits)
        injector = FaultInjector(seed=5, schedule=schedule)
        results, report, counts, slab, host = trace(
            be, ys_c_host, chaos_bits, 200.0, slab_pages=1024, chunk=1024, injector=injector,
            extra=dict(integrity_rate=1.0, integrity_min_agreement=0.9995))
        failed = {i: type(r).__name__ for i, r in enumerate(results)
                  if not isinstance(r, torch.Tensor)}
        typed = all(isinstance(results[i], StreamError) for i in failed)
        corrupt = [i for i, r in enumerate(results) if isinstance(r, IntegrityError)]
        admission = [i for i, r in enumerate(results) if isinstance(r, SymbolError)]
        errs = report["errors_by_class"]
        fired = {k: len(v) for k, v in schedule.items()}
        if (not poisoned <= set(failed) or not typed or len(corrupt) != 1
                or len(admission) > 1 or dict(injector.fired) != fired
                or report["faults_injected"] != fired
                or (errs.get("DispatchError"), errs.get("MeshLost"), errs.get("SlabExhausted"),
                    errs.get("SymbolError"), errs.get("IntegrityError")) != (2, 1, 2, 1, 1)
                or not 1 <= errs.get("StreamError", 0) <= 2
                or report["quarantined_streams"] != len(failed)
                or report["integrity_flagged"] != 1):
            raise AssertionError(f"[20 chaos] {be}: failed {failed}, fired "
                                 f"{dict(injector.fired)}, visits {dict(injector.counts)}, "
                                 f"errors {errs}, report {report}")
        check_bits(f"[20 chaos] {be}", results, refs, skip=failed)
        log(f"[20 chaos] {be}, {N_STREAMS} streams x {chaos_bits} bits, schedule "
            f"{ {k: sorted(v) for k, v in schedule.items()} }, integrity_rate 1.0: the "
            f"{N_STREAMS - len(failed)} healthy streams == one-shot bit for bit; failed {failed}; "
            f"fired {dict(injector.fired)}; decode_corrupt visits "
            f"{injector.counts['decode_corrupt']}; errors_by_class {errs}; "
            f"retries {report['retries']}; "
            f"integrity {report['integrity_flagged']}/{report['integrity_checked']} flagged; "
            f"launches {counts}; {host}")

    # ---- 20. durable: the CLI killed by SIGKILL at its 3rd dispatch, then recovered --
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    n_streams_d, chunk_bits_d, n_chunks_d = 4, 2048, 8
    for be in ("cuda", "fused"):
        jdir = root / "build" / f"serve-journal-{be}"
        shutil.rmtree(jdir, ignore_errors=True)
        argv = [sys.executable, "-m", "repro_torch.launch.serve_decoder", "--backend", be,
                "--device", dev.type, "--serve-async", "--journal-dir", str(jdir), "--streams", str(n_streams_d),
                "--chunk-bits", str(chunk_bits_d), "--n-chunks", str(n_chunks_d),
                "--rate-chunks-per-s", "100", "--integrity-rate", "1.0"]
        t0 = time.perf_counter()
        killed = subprocess.run(argv + ["--kill-at", "3"], capture_output=True, text=True,
                                cwd=root, env=env, timeout=300)
        t1 = time.perf_counter()
        sizes = [(jdir / f"delivered-{i}.bits").stat().st_size
                 for i in range(n_streams_d) if (jdir / f"delivered-{i}.bits").exists()]
        recovered = subprocess.run(argv + ["--recover"], capture_output=True, text=True,
                                   cwd=root, env=env, timeout=300)
        t2 = time.perf_counter()
        final = [(jdir / f"delivered-{i}.bits").stat().st_size for i in range(n_streams_d)]
        if killed.returncode != -9:
            raise AssertionError(f"[20 durable] {be}: --kill-at 3 exited {killed.returncode}, "
                                 f"not by SIGKILL:\n{killed.stdout}\n{killed.stderr}")
        if (recovered.returncode != 0 or "all streams bit-exact" not in recovered.stdout
                or final != [chunk_bits_d * n_chunks_d] * n_streams_d):
            raise AssertionError(f"[20 durable] {be}: --recover exited {recovered.returncode}, "
                                 f"files {final}:\n{recovered.stdout}\n{recovered.stderr}")
        log(f"[20 durable] {be}: --kill-at 3 died by SIGKILL (returncode -9) after "
            f"{t1 - t0:.1f} s with {sum(sizes)} bits persisted; --recover exit 0 in "
            f"{t2 - t1:.1f} s, every stream {chunk_bits_d * n_chunks_d} bits exactly once: "
            f"{recovered.stdout.strip().splitlines()[-1]}")
        shutil.rmtree(jdir, ignore_errors=True)

    # ---- 21. latency by trigger, and where a dispatch's time goes -------------------
    for deadline in (1.0, 5.0):
        for mbb in (32, 512):
            results, report, _, _, host = trace("cuda", ys_host, n_bits, 25.0, slab_pages=1024,
                                                mbb=mbb, deadline=deadline)
            check_bits(f"[21 latency] deadline {deadline} mbb {mbb}", results, svc_refs["cuda"])
            log(f"[21 latency] {power}: cuda, 25 chunks/s per stream, deadline_ms {deadline:g}, "
                f"max_batch_blocks {mbb}: {summary(report, n_blocks)}; {host}")
    profiled = {}

    def profiled_trace():
        results, profiled["report"], *_ = trace("cuda", ys_host, n_bits, 25.0, slab_pages=1024)
        check_bits("[21 profile]", results, svc_refs["cuda"])

    wall, kernels_p, busy = device_profile(torch, profiled_trace)
    report = profiled["report"]
    if busy <= 0:
        log(f"[21 profile] {power}: the profiler saw no device time (not measured)")
        return
    per_launch = busy / report["launches"]  # the pool's launches: steps and flushes
    if report["p50_ms"] < per_launch:
        raise AssertionError(f"[21 profile] chunk latency p50 {report['p50_ms']} ms is below "
                             f"the device time of a pool launch ({per_launch} ms)")
    log(f"[21 profile] {power}: the 25 chunks/s trace on cuda (deadline 5 ms, "
        f"max_batch_blocks 512) under the profiler: wall {wall:.3f} ms, device busy "
        f"{busy:.3f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; "
        f"{report['dispatches']} dispatches and {report['launches']} pool launches, "
        f"{per_launch:.3f} ms of device time per launch <= chunk latency p50 "
        f"{report['p50_ms']:.3f} ms; top kernels: "
        + "; ".join(f"{n} {ms:.3f} ms × {c}" for n, ms, c in kernels_p))


def mesh_phases(torch, dev, counters, y, ref_bits, ys, batch, power: str) -> None:
    """Phase 22: the lane split over a decode mesh on the card. The mesh is
    a device list that names ``cuda:0`` once per shard (distinct devices
    where torch finds more than one card). ``y``/``ref_bits`` are the main
    path's stream and its ``"ref"`` decode, ``ys``/``batch`` phase 5's 64
    streams and their per-stream decodes; ``counters`` the (key, module,
    attribute) launch counters of every decoder kernel; ``power`` the card's
    name and power limit as nvidia-smi prints them."""
    import asyncio
    import contextlib
    import io
    import re

    import numpy as np

    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.kernels.ops import SHARD_DISPATCH
    from repro_torch.launch import serve_decoder
    from repro_torch.launch.faults import FaultInjector
    from repro_torch.launch.mesh import make_decode_mesh
    from repro_torch.launch.serve_async import AsyncDecodeService
    from repro_torch.launch.serve_decoder import SessionPool

    cfg = PBVDConfig()
    D = cfg.D
    n_bits = ref_bits.shape[0]
    zero, read = counter_fns(torch, counters)
    n_cards = torch.cuda.device_count()

    def mesh(n: int):
        devs = [torch.device("cuda", i % n_cards) for i in range(n)]
        return make_decode_mesh(f"data={n}", devices=devs)

    def where(m) -> str:
        names = [str(d) for d in m.devices.flat]
        if len(set(names)) == 1:
            return f"{m.size} shards on one card ({names[0]} named {m.size} times)"
        return f"{m.size} shards on {len(set(names))} cards ({', '.join(names)})"

    def engine(be: str, n: int, dispatch: str = "constraint"):
        return DecoderEngine(PBVDConfig(backend=be), mesh=mesh(n), shard_dispatch=dispatch)

    one_launch = {"cuda": {"acs": 1, "traceback": 1}, "fused": {"fused": 1}}

    # ---- the main path at data=4, both backends, both dispatches ------------------
    for be in ("cuda", "fused"):
        for dispatch in SHARD_DISPATCH:
            eng = engine(be, 4, dispatch)
            eng.decode(y[: 4 * D], 4 * D)
            zero()
            bits = eng.decode(y, n_bits)
            counts = read()
            want = {k: 4 * v for k, v in one_launch[be].items()}
            if not torch.equal(bits, ref_bits) or counts != want:
                raise AssertionError(f"[22 mesh] {be} {dispatch}: equal {torch.equal(bits, ref_bits)}, "
                                     f"launches {counts}, expected {want}")
            log(f"[22 mesh] {n_bits} bits, {be}, data=4 {dispatch}, {where(eng.mesh)}: == ref "
                f"(phase 4) bit for bit; launches {counts} (one per kernel per shard)")

    # ---- a ragged 64-stream decode_batch at data=8 against meshless ---------------
    lens = [STREAM_BITS - (i * 1013) % (STREAM_BITS * 5 // 8) for i in range(len(ys))]
    plain = DecoderEngine(cfg, device=dev)
    base = plain.decode_batch(ys, lens)
    for dispatch in SHARD_DISPATCH:
        eng = engine("cuda", 8, dispatch)
        zero()
        got = eng.decode_batch(ys, lens)
        counts = read()
        bad = [i for i, (a, b) in enumerate(zip(got, base)) if not torch.equal(a, b)]
        if bad or counts != {"acs": 8, "traceback": 8}:
            raise AssertionError(f"[22 mesh] ragged batch {dispatch}: streams {bad} differ, "
                                 f"launches {counts}")
        log(f"[22 mesh] decode_batch of {len(ys)} ragged streams ({min(lens)}-{max(lens)} bits, "
            f"{sum(-(-n // D) for n in lens)} blocks), cuda, data=8 {dispatch}, {where(eng.mesh)}: "
            f"== meshless bit for bit; launches {counts}")

    # ---- the three-group pool at a ragged cadence ---------------------------------
    n_pool = 8
    ys_host = [t.cpu().numpy() for t in ys[:n_pool]]
    engines = [plain, engine("cuda", 4), engine("cuda", 4, "shard_map")]
    pool = SessionPool()
    handles = [pool.open(e) for e in engines for _ in range(n_pool)]
    pos, outs = [0] * len(handles), [[] for _ in handles]
    cut = np.random.default_rng(SEED)
    steps = []
    while any(p < len(ys_host[0]) for p in pos):
        for i, h in enumerate(handles):
            step = int(cut.integers(2000, 9000))
            h.feed(ys_host[i % n_pool][pos[i]: pos[i] + step])
            pos[i] += step
        before = pool.launches
        zero()
        pool.step()
        steps.append((pool.launches - before, read()))
        for o, h in zip(outs, handles):
            o.append(h.take())
    groups = len({pool._group_key(h._session) for h in handles})
    for i, h in enumerate(handles):
        if not torch.equal(torch.cat(outs[i] + [h.finish(STREAM_BITS)]), batch[i % n_pool]):
            raise AssertionError(f"[22 pool] handle {i} (group {i // n_pool}) differs")
    full = [c for n, c in steps if n == 3]
    if groups != 3 or not full or max(n for n, _ in steps) != 3:
        raise AssertionError(f"[22 pool] {groups} groups, launches per step {steps}")
    log(f"[22 pool] {n_pool} streams x {STREAM_BITS} bits on each of meshless, data=4 constraint "
        f"and data=4 shard_map ({where(engines[1].mesh)}), chunks of 2000-9000 stages: "
        f"{groups} groups, each == decode_batch bit for bit; pool launches per step "
        f"{[n for n, _ in steps]}, kernels of the first step with all three groups {full[0]} "
        f"(meshless one K1 and one K2, each data=4 group one per non-empty shard)")

    # ---- the mesh-loss drill: data=4 → 3 → 2 → meshless ------------------------------
    n_drill, n_chunks = 16, 8
    drill_host = [t.cpu().numpy() for t in ys[:n_drill]]
    schedule = {"mesh": {1, 3, 5}}

    async def drill():
        inj = FaultInjector(schedule=schedule)
        svc = AsyncDecodeService(max_batch_blocks=100000, deadline_ms=0.0, fault_injector=inj)
        eng = engine("cuda", 4)
        streams = [svc.open(eng) for _ in range(n_drill)]
        shapes = [4]
        cs = -(-len(drill_host[0]) // n_chunks)
        for k in range(n_chunks):
            for st, yh in zip(streams, drill_host):
                await st.send(yh[k * cs: (k + 1) * cs])
            for _ in range(2):
                svc.poll()
                e = streams[0]._handle._session.engine
                shape = None if e.mesh is None else e.mesh.shape["data"]
                if shape != shapes[-1]:
                    shapes.append(shape)
        outs = [torch.cat([st.take(), await st.finish(STREAM_BITS)]) for st in streams]
        return outs, svc.metrics(), inj, shapes

    zero()
    outs, m, inj, shapes = asyncio.run(drill())
    counts = read()
    bad = [i for i, o in enumerate(outs) if not torch.equal(o, batch[i])]
    fired = {k: len(v) for k, v in schedule.items()}
    if (bad or dict(inj.fired) != fired or m["faults_injected"] != fired
            or m["errors_by_class"] != {"MeshLost": 3} or shapes != [4, 3, 2, None]):
        raise AssertionError(f"[22 drill] streams {bad} differ; fired {dict(inj.fired)}, "
                             f"errors {m['errors_by_class']}, meshes {shapes}")
    log(f"[22 drill] {n_drill} streams x {STREAM_BITS} bits in {n_chunks} chunks, cuda, "
        f"FaultInjector(schedule={ {k: sorted(v) for k, v in schedule.items()} }): meshes "
        f"data={' → data='.join(str(s) for s in shapes[:-1])} → meshless; every stream == "
        f"decode_batch bit for bit; fired {dict(inj.fired)}; errors_by_class "
        f"{m['errors_by_class']}; retries {m['retries']}; {m['dispatches']} dispatches, "
        f"{m['launches']} pool launches; kernels {counts}")

    # ---- the CLI on a one-device mesh -----------------------------------------------
    argv = ["--mesh", "data=1", "--shard-dispatch", "shard_map", "--streams", "8",
            "--chunk-bits", "4096", "--n-chunks", "8"]
    buf = io.StringIO()
    zero()
    with contextlib.redirect_stdout(buf):
        serve_decoder.main(argv)
    counts = read()
    lines = buf.getvalue().strip().splitlines()
    errs = re.search(r"BER = \S+ \((\d+) errors", lines[-1])
    if (errs is None or int(errs.group(1)) > 8 * 4096 * 8 * 1e-3 or counts.get("acs", 0) < 1
            or not lines[0].startswith("[serve_decoder] mesh {'data': 1}")):
        raise AssertionError(f"[22 cli] serve_decoder {argv}: {lines}, launches {counts}")
    for line in lines:
        log(f"[22 cli] {line}")
    log(f"[22 cli] launches {counts}")

    # ---- end to end: meshless against data=4 on the card, in turns -------------------
    for be in ("cuda", "fused"):
        engs = {"meshless": DecoderEngine(PBVDConfig(backend=be), device=dev),
                "constraint": engine(be, 4), "shard_map": engine(be, 4, "shard_map")}
        turns = ("meshless", "constraint", "shard_map", "shard_map", "constraint", "meshless")
        ms = {k: [] for k in engs}
        for k in turns:
            ms[k].append(wall_ms(torch, lambda: engs[k].decode(y, n_bits), reps=10))
        base_ms = statistics.mean(ms["meshless"])
        log(f"[22 times] {power}: {be}, {n_bits} bits end to end, ms in turns "
            f"(meshless, constraint, shard_map, shard_map, constraint, meshless): "
            + "; ".join(f"{k} {', '.join(f'{t:.3f}' for t in v)}" for k, v in ms.items())
            + f"; data=4 ({where(engs['constraint'].mesh)}) over meshless: constraint "
            f"{statistics.mean(ms['constraint']) / base_ms:.2f}x, shard_map "
            f"{statistics.mean(ms['shard_map']) / base_ms:.2f}x")
        eng = engs["constraint"]
        wall, kernels_p, busy = device_profile(torch, lambda: [eng.decode(y, n_bits)
                                                               for _ in range(5)])
        if busy <= 0:
            log(f"[22 profile] {be} data=4: the profiler saw no device time (not measured)")
            continue
        log(f"[22 profile] {power}: {be}, data=4 constraint ({where(eng.mesh)}), 5 decodes of "
            f"{n_bits} bits: wall {wall:.3f} ms under the profiler, device busy {busy:.3f} ms "
            f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top kernels: "
            + "; ".join(f"{n} {t:.3f} ms × {c}" for n, t, c in kernels_p))


FLEET_DEADLINE_S = 240  # the parent's wait for the two ranks, and again for the CLI's


def _fleet_env(rank: int, port: int) -> dict:
    root = Path(__file__).resolve().parent
    return {**os.environ, "PYTHONPATH": str(root / "src"), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(rank)}


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _run_ranks(argvs: list[list[str]], work: Path, tag: str) -> list[str]:
    """Start one process per argv as ranks 0, 1, ... of one group; wait for
    all of them until ``FLEET_DEADLINE_S``, kill any still running, and fail
    unless every rank exited 0. Returns each rank's output."""
    root = Path(__file__).resolve().parent
    port = _free_port()
    outs = [open(work / f"{tag}-{r}.log", "w") for r in range(len(argvs))]
    procs = [subprocess.Popen(argv, cwd=root, env=_fleet_env(r, port), stdout=outs[r],
                              stderr=subprocess.STDOUT) for r, argv in enumerate(argvs)]
    deadline = time.monotonic() + FLEET_DEADLINE_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in outs:
            f.close()
    said = [(work / f"{tag}-{r}.log").read_text() for r in range(len(argvs))]
    for r, p in enumerate(procs):
        if p.returncode:
            raise AssertionError(f"[30 fleet] {tag} rank {r} exited {p.returncode}:\n{said[r]}")
    return said


def fleet_rank(work: Path) -> int:
    """One rank of phase 30 (``chip_smoke.py --fleet-rank DIR``): decode the
    main stream and the ragged batch that the parent left in ``work``
    through a ``data=2`` mesh over both ranks' ``cuda:0``, check and time
    them, and write the rank's findings to ``work/rank<i>.json``."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.kernels import acs, fused, traceback
    from repro_torch.launch.mesh import fleet_group, make_decode_mesh, maybe_init_distributed
    from repro_torch.sharding import smap

    if not maybe_init_distributed():
        raise AssertionError("maybe_init_distributed started no process group")
    rank = dist.get_rank()
    dev = torch.device(DEVICE)
    # every CUDA device torch finds, on every rank
    mesh = make_decode_mesh("data=2", devices=None if dev.type == "cuda" else [dev])
    inputs = torch.load(work / "inputs.pt")
    y, ref_bits = inputs["y"].to(dev), inputs["ref_bits"].to(dev)
    ys = [t.to(dev) for t in inputs["ys"]]
    lens = inputs["lens"]
    n_bits = ref_bits.shape[0]
    D = PBVDConfig().D
    counters = [("acs", acs, "launches"), ("traceback", traceback, "launches"),
                ("fused", fused, "launches")]
    zero, read = counter_fns(torch, counters)
    wait_ms: list[float] = []
    gather_ms: list[float] = []
    plain_gather = smap._gather_slices

    def timed_gather(*args, **kwargs):
        # the wait for the other rank's slice first (a gloo barrier), then the gather
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.barrier(group=fleet_group())
        t1 = time.perf_counter()
        out = plain_gather(*args, **kwargs)
        torch.cuda.synchronize()
        wait_ms.append((t1 - t0) * 1e3)
        gather_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    found: dict = {"rank": rank, "owners": mesh.owners.tolist(),
                   "devices": [str(d) for d in mesh.devices.flat],
                   "default backend": dist.get_backend()}
    for be in ("cuda", "fused"):
        eng = DecoderEngine(PBVDConfig(backend=be), mesh=mesh)
        eng.decode(y[: 4 * D], 4 * D)  # first call loads the kernels
        zero()
        bits = eng.decode(y, n_bits)
        found[be] = {"equal": bool(torch.equal(bits, ref_bits)), "launches": read()}
        smap._gather_slices = timed_gather
        wait_ms.clear()
        gather_ms.clear()
        found[be]["decode_ms"] = [wall_ms(torch, lambda: eng.decode(y, n_bits), reps=1)
                                  for _ in range(5)]
        found[be]["wait_ms"], found[be]["gather_ms"] = list(wait_ms), list(gather_ms)
        smap._gather_slices = plain_gather
        # the same stream meshless, in both ranks at once (each decodes all of it)
        base = DecoderEngine(PBVDConfig(backend=be), device=dev)
        dist.barrier(group=fleet_group())
        found[be]["meshless_ms"] = [wall_ms(torch, lambda: base.decode(y, n_bits), reps=1)
                                    for _ in range(5)]
    eng = DecoderEngine(PBVDConfig(), mesh=mesh)
    zero()
    got = eng.decode_batch(ys, lens)
    launches = read()
    base = DecoderEngine(PBVDConfig(), device=dev).decode_batch(ys, lens)
    found["batch"] = {"differ": [i for i, (a, b) in enumerate(zip(got, base))
                                 if not torch.equal(a, b)], "launches": launches}
    (work / f"rank{rank}.json").write_text(json.dumps(found))
    dist.destroy_process_group()
    return 0


def fleet_phases(torch, y, ref_bits, ys, power: str) -> None:
    """Phase 30: the decode fleet across two processes on the one card.
    ``y``/``ref_bits`` are the main path's stream and its ``"ref"`` decode,
    ``ys`` phase 5's 64 streams; each rank (:func:`fleet_rank`) reads them
    from a file under ``build/``."""
    root = Path(__file__).resolve().parent
    work = root / "build" / "fleet"
    work.mkdir(parents=True, exist_ok=True)
    for old in work.glob("rank*.json"):
        old.unlink()
    lens = [STREAM_BITS - (i * 1013) % (STREAM_BITS * 5 // 8) for i in range(len(ys))]
    torch.save({"y": y.cpu(), "ref_bits": ref_bits.cpu(), "ys": [t.cpu() for t in ys],
                "lens": lens}, work / "inputs.pt")
    t0 = time.perf_counter()
    me = [sys.executable, str(Path(__file__).resolve()), "--fleet-rank", str(work)]
    _run_ranks([me, me], work, "rank")
    found = [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]
    one = {"cuda": {"acs": 1, "traceback": 1}, "fused": {"fused": 1}}
    for f in found:
        for be in ("cuda", "fused"):
            if not f[be]["equal"] or f[be]["launches"] != one[be]:
                raise AssertionError(f"[30 fleet] rank {f['rank']} {be}: equal "
                                     f"{f[be]['equal']}, launches {f[be]['launches']}, "
                                     f"expected {one[be]}")
        if f["batch"]["differ"] or f["batch"]["launches"] != one["cuda"]:
            raise AssertionError(f"[30 fleet] rank {f['rank']} ragged batch: streams "
                                 f"{f['batch']['differ']} differ, launches "
                                 f"{f['batch']['launches']}")
    n_bits = ref_bits.shape[0]
    for f in found:
        log(f"[30 fleet] rank {f['rank']} of 2 (default group {f['default backend']}, mesh "
            f"data=2 over {f['devices']} of ranks {f['owners']}): {n_bits} bits through cuda "
            f"and fused == ref (phase 4) bit for bit, launches cuda {f['cuda']['launches']}, "
            f"fused {f['fused']['launches']}; decode_batch of {len(ys)} ragged streams "
            f"({min(lens)}-{max(lens)} bits) == meshless, launches {f['batch']['launches']}")
        for be in ("cuda", "fused"):
            def ms(key: str) -> str:
                v = f[be][key]
                return f"{', '.join(f'{t:.3f}' for t in v)} (median {statistics.median(v):.3f})"

            log(f"[30 fleet] {power}: rank {f['rank']} {be}, {n_bits} bits end to end, ms "
                f"{ms('decode_ms')}; of it the wait for the other rank {ms('wait_ms')} and "
                f"the gather (device to host, gloo all_gather, host to device) "
                f"{ms('gather_ms')}; meshless in both ranks at once {ms('meshless_ms')}")
    log(f"[30 fleet] two ranks: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cli = [sys.executable, "-m", "repro_torch.launch.serve_decoder", "--mesh", "data=2",
           "--streams", "64", "--n-chunks", "16"]
    said = _run_ranks([cli, cli], work, "cli")
    for r, text in enumerate(said):
        lines = [ln for ln in text.splitlines() if ln.startswith("[serve_decoder]")]
        errs = [re.search(r"BER = \S+ \((\d+) errors", ln) for ln in lines]
        errs = [int(m.group(1)) for m in errs if m]
        if (not lines or f"(this is rank {r} of 2)" not in lines[0] or len(errs) != 1
                or errs[0] > 64 * 4096 * 16 * 1e-3):
            raise AssertionError(f"[30 fleet] serve_decoder rank {r}: {text}")
        for ln in lines:
            log(f"[30 fleet] cli rank {r}: {ln}")
    log(f"[30 fleet] {' '.join(cli[1:])} under two ranks: {time.perf_counter() - t0:.1f} s "
        f"({power})")


def ber_phases(torch, dev, counters, power: str) -> None:
    """Phase 23 (ber): the paper's Fig. 4 on the card. Each point draws
    ``BER_BITS`` bits with ``simulate_ber`` / ``hard_decision_ber`` on
    ``"cuda"``; a replay of the generator then draws the same payload and
    symbols again (``draw_trial``), which decode through ``"cuda"`` (the same
    error count), ``"fused"`` and, at the 4 dB / L = 42 soft point,
    ``"ref"``, bit for bit. The bands of ``tests/test_ber_regression.py``
    must hold, BER must not rise with Eb/N0 at any L, and L = 14 must be no
    better than L = 42 at 4 dB. Each point prints the kernels' launches
    in ``simulate_ber`` and in one decode per backend."""
    import dataclasses

    from repro_torch.core.ber import draw_trial, hard_decision_ber, simulate_ber, uncoded_ber
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig

    zero, read = counter_fns(torch, counters)
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    points = [("soft", "ccsds", e, L) for e in (2.0, 3.0, 4.0) for L in (14, 28, 42)]
    points += [("hard", "ccsds", 4.0, 42), ("soft", "ccsds-3/4", 5.5, 42)]
    ber, errs = {}, {}
    for point in points:
        launches = {}
        kind, spec_name, ebn0, L = point
        spec = get_code_spec(spec_name)
        cfg = PBVDConfig(spec=spec, D=512, L=L, q=8)
        state = gen.get_state()
        sim = hard_decision_ber if kind == "hard" else simulate_ber
        zero()
        ber[point] = sim(gen, ebn0, cfg, n_bits=BER_BITS, device=dev)
        launches["simulate"] = read()
        replay = torch.Generator(device=dev)
        replay.set_state(state)
        bits, y = draw_trial(replay, ebn0, spec, BER_BITS, dev)
        if kind == "hard":
            y, cfg = torch.sign(y), dataclasses.replace(cfg, q=None)
        backends = ("cuda", "fused") + (("ref",) if point == ("soft", "ccsds", 4.0, 42) else ())
        dec = {}
        for be in backends:
            eng = DecoderEngine(dataclasses.replace(cfg, backend=be), device=dev)
            zero()
            dec[be] = eng.decode(y, BER_BITS + spec.code.v)[:BER_BITS]
            launches[be] = read()
        errs[point] = int((dec["cuda"] != bits).sum())
        if errs[point] != round(ber[point] * BER_BITS):
            raise AssertionError(f"[23 ber] {point}: the replayed symbols give {errs[point]} "
                                 f"errors, {sim.__name__} {ber[point] * BER_BITS}")
        for be in backends[1:]:
            if not torch.equal(dec[be], dec["cuda"]):
                raise AssertionError(f"[23 ber] {point}: {be} differs from cuda in "
                                     f"{int((dec[be] != dec['cuda']).sum())} bits")
        log(f"[23 ber] {kind} {spec_name:9s} Eb/N0 {ebn0} dB, D=512, L={L:2d}, "
            f"q={'None (sign)' if kind == 'hard' else 8}: {errs[point]} errors / {BER_BITS} bits "
            f"= {ber[point]:.3e} (uncoded {uncoded_ber(ebn0):.3e}); cuda == "
            f"{' == '.join(backends[1:])} bit for bit; launches per decode: simulate_ber "
            f"{launches['simulate']}, " + ", ".join(f"{be} {launches[be]}" for be in backends))
    soft, hard = ber["soft", "ccsds", 4.0, 42], ber["hard", "ccsds", 4.0, 42]
    if not soft <= 3e-4:
        raise AssertionError(f"[23 ber] soft-decision BER at 4 dB regressed: {soft:.3e}")
    if not 1e-3 <= hard <= 1e-2:
        raise AssertionError(f"[23 ber] hard-decision BER at 4 dB out of band: {hard:.3e}")
    if not soft < hard < uncoded_ber(4.0):
        raise AssertionError(f"[23 ber] soft {soft:.3e} < hard {hard:.3e} < uncoded fails")
    for L in (14, 28, 42):
        curve = [ber["soft", "ccsds", e, L] for e in (2.0, 3.0, 4.0)]
        if not curve[0] >= curve[1] >= curve[2]:
            raise AssertionError(f"[23 ber] L={L}: BER rises with Eb/N0: {curve}")
    if not ber["soft", "ccsds", 4.0, 14] >= soft:
        raise AssertionError(f"[23 ber] L=14 beats L=42 at 4 dB")
    p34 = ber["soft", "ccsds-3/4", 5.5, 42]
    if not p34 < uncoded_ber(5.5):
        raise AssertionError(f"[23 ber] ccsds-3/4 at 5.5 dB: {p34:.3e} is not below uncoded")
    log(f"[23 ber] {power}: Fig. 4 table, errors / {BER_BITS} bits per point (CCSDS, D=512, "
        f"q=8): " + "; ".join(f"{e} dB: " + ", ".join(
            f"L={L} {errs['soft', 'ccsds', e, L]}" for L in (14, 28, 42)) for e in (2.0, 3.0, 4.0))
        + f"; hard 4 dB L=42 {errs['hard', 'ccsds', 4.0, 42]}; ccsds-3/4 5.5 dB L=42 "
        f"{errs['soft', 'ccsds-3/4', 5.5, 42]}; bands of tests/test_ber_regression.py hold "
        f"(soft {soft:.3e} <= 3e-4, hard {hard:.3e} in [1e-3, 1e-2], soft < hard < uncoded "
        f"{uncoded_ber(4.0):.3e}); BER falls with Eb/N0 at every L; L=14 >= L=42 at 4 dB")


def example_phases(power: str) -> None:
    """Phase 23 (examples): ``examples/torch_quickstart.py`` and
    ``examples/torch_ber_sweep.py --bits 1048576`` as subprocesses on the
    card, sharing the kernels built in phase 1; each must exit 0."""
    import os

    root = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": str(root / "src")}
    for argv in (["examples/torch_quickstart.py"],
                 ["examples/torch_ber_sweep.py", "--bits", "1048576"]):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, *argv], cwd=root, env=env, capture_output=True,
                              text=True, timeout=300)
        for line in (proc.stdout + proc.stderr).splitlines():
            log(f"[23 examples] {line}")
        if proc.returncode:
            raise AssertionError(f"[23 examples] {' '.join(argv)} exited {proc.returncode}")
        log(f"[23 examples] {' '.join(argv)}: exit 0 in {time.perf_counter() - t0:.1f} s "
            f"({power})")


def flash_at_prefill(torch, dev, gen, tag: str, name: str, power: str, B: int, S: int, Hkv: int,
                     G: int, dh: int, window, pre_launches: int, *, T: int | None = None,
                     causal: bool = True) -> dict:
    """The flash kernel (bf16, the tensor-core body) at a card's prefill
    shapes (S queries against T = S keys unless given, causal unless not)
    against ``ref_mha`` (atol 2e-5, rtol 2^-8), then its time beside its
    bound and SDPA's on the same inputs and band mask. Returns the numbers
    (ms, bound_ms, bound_by, library_ms, max_abs_err)."""
    import gc

    import torch.nn.functional as F

    from repro_torch._unused import flash_attention as fa

    T = S if T is None else T
    H = Hkv * G
    q = torch.randn((B, S, Hkv, G, dh), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, T, Hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    fa.launches = fa.tc_launches = 0
    out = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    body = (fa.launches, fa.tc_launches)
    ref = fa.ref_mha(q, k, v, causal=causal, window=window)
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    worst = float((diff / (2e-5 + 2.0 ** -8 * ref.abs())).max())
    shapes = (f"B={B} {f'S=T={S}' if T == S else f'S={S} T={T}'} Hkv={Hkv} G={G} dh={dh} bf16 "
              f"{'causal' if causal else 'non-causal'} window {window}")
    if body != (1, 1) or not bool(torch.isfinite(out).all()) or not worst <= 1.0:
        raise AssertionError(f"{tag} {name}: flash at the prefill's shapes launches "
                             f"{body}, {worst:.3f} of the limit")
    log(f"{tag} {name}: flash tensor-core body at the prefill's shapes {shapes} vs ref_mha: max "
        f"abs err {err:.3e}, {worst:.3f} of the limit (atol 2e-5, rtol 2^-8)")
    del out, ref, diff
    f_ms = cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal, window=window),
                   reps=5)
    nbytes, flops = flash_cost(B, S, T, Hkv, G, dh, causal, window, 2)
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
    qpos, kpos = torch.arange(S, device=dev), torch.arange(T, device=dev)
    band = None
    if causal or window:
        band = torch.ones((S, T), dtype=torch.bool, device=dev)
        if causal:
            band &= kpos[None, :] <= qpos[:, None]
        if window:
            band &= kpos[None, :] > qpos[:, None] - window
    qs, ks, vs = q.reshape(B, S, H, dh).transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        lib_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=band, enable_gqa=True), reps=5)
    except (TypeError, RuntimeError):  # timed only where this torch offers GQA
        lib_ms = None
    log(f"{tag} {power}: {name} flash tensor-core body at the prefill's shapes {shapes}: "
        f"{f_ms:.3f} ms (bound {b_ms:.4f} ms by {b_by}, {flops:.4e} FLOP; "
        f"{flops / f_ms / 1e9:.1f} TFLOP/s; SDPA with "
        f"{'the band mask' if band is not None else 'no mask'}, enable_gqa=True: "
        f"{'not measured' if lib_ms is None else f'{lib_ms:.3f} ms'}); launches per prefill "
        f"{pre_launches}")
    del q, k, v, qs, ks, vs, band
    gc.collect()
    torch.cuda.empty_cache()
    return dict(ms=f_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms, max_abs_err=err)


def card_phases(torch, dev, counters, power: str, clock: PhaseClock) -> None:
    """Phase 24 (cards): the dense GQA cards Qwen2.5-32B, Minitron-8B and
    Command-R-35B and the MoE card Mixtral-8x22B, one at a time, each at
    full width with its depth cut to ``CARD_LAYERS`` layers and random
    seeded weights in its own ``param_dtype``: the flash kernel at the
    card's G against its plain version, the parameter count, the prefill
    with its flash launches (all on the tensor-core body; Mixtral: the
    entries dropped by capacity per layer), flash against the streaming
    prefill, float32 cached decode against ``apply_train``, greedy
    generation, and the flash kernel at the prefill's shapes against
    ``ref_mha``, with its time beside its bound and SDPA's. Each card's
    seconds are a lap of ``clock``."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, blocks, lm, moe
    from repro_torch._unused.models.layers import round_vocab
    from repro_torch._unused.serve.serve_step import greedy_generate, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    for name in CARDS:
        full = get_config(name)
        cfg = dataclasses.replace(full, n_layers=CARD_LAYERS)
        S = CARD_SEQ[name]
        B, H, Hkv, dh = LM_BATCH, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        G, window = H // Hkv, cfg.sliding_window
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)

        # the flash kernel at this card's G (dh = 128, bf16, the tensor-core body)
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
                   for shape in ((1, 1024, 2, G, dh), (1, 1024, 2, dh), (1, 1024, 2, dh)))
        fa.launches = fa.tc_launches = 0
        out = fa.flash_attention(q, k, v, causal=True, window=300)
        ref = fa.ref_mha(q, k, v, causal=True, window=300)
        diff = (out.float() - ref).abs()
        worst = float((diff / (2e-5 + 2.0 ** -8 * ref.abs())).max())
        if (fa.launches, fa.tc_launches) != (1, 1) or not worst <= 1.0:
            raise AssertionError(f"[24 cards] {name}: flash at G={G} launches "
                                 f"{(fa.launches, fa.tc_launches)}, {worst:.3f} of the limit")
        log(f"[24 cards] {name}: flash tensor-core body at G={G}, B=1 S=T=1024 Hkv=2 dh={dh} "
            f"bf16 causal window 300 vs ref_mha: max abs err {float(diff.max()):.3e}, "
            f"{worst:.3f} of the limit (atol 2e-5, rtol 2^-8)")
        del q, k, v, out, ref, diff

        params = lm.init_params(cfg, generator=gen, device=dev)
        n_params = lm.count_params(params)
        extra = lm.param_count(cfg) - cfg.n_params_estimate
        if n_params != cfg.n_params_estimate + extra:
            raise AssertionError(f"[24 cards] {name}: {n_params} parameters, n_params_estimate "
                                 f"{cfg.n_params_estimate} + {extra} norms, biases and pad")
        V = round_vocab(cfg.vocab)
        log(f"[24 cards] {name} ({full.source}): full width (d_model {cfg.d_model}, "
            f"{H}/{Hkv} heads, G={G}, d_ff {cfg.d_ff_expert or cfg.d_ff}"
            f"{f', {cfg.n_experts} experts top-{cfg.top_k}' if cfg.n_experts else ''}, vocab "
            f"{cfg.vocab}, window {window}), depth cut {full.n_layers} -> {cfg.n_layers} layers; "
            f"{n_params:,} parameters ({cfg.param_dtype}) = n_params_estimate "
            f"{cfg.n_params_estimate:,} + {extra:,} norms, biases and vocab pad; full depth "
            f"{full.n_params_estimate:,} by the estimate")

        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        batch = {"tokens": tokens}
        prefill = make_prefill_step(cfg)
        prefill(params, {"tokens": tokens[:, :256]})  # warm up
        moe_inputs = []  # each MoE layer's (params, input) in the prefill, for its drops

        def recorded(p, x, cfg_):
            moe_inputs.append((p, x))
            return moe.moe_apply(p, x, cfg_)

        zero()
        fa.launches = fa.tc_launches = 0
        torch.cuda.reset_peak_memory_stats()
        blocks.moe_apply = recorded
        try:
            t0 = time.perf_counter()
            next_tok = prefill(params, batch)
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
        finally:
            blocks.moe_apply = moe.moe_apply
        others = read()
        if (fa.launches, fa.tc_launches) != (cfg.n_layers, cfg.n_layers) or others:
            raise AssertionError(f"[24 cards] {name}: prefill launched flash {fa.launches} "
                                 f"times, {fa.tc_launches} on the tensor-core body (want "
                                 f"{cfg.n_layers} of each), decoder kernels {others}")
        pre_launches = fa.tc_launches
        log(f"[24 cards] {name}: make_prefill_step, {B} x {S} tokens: flash launches "
            f"{fa.launches}, all on the tensor-core body; {pre_ms:.1f} ms -> "
            f"{B * S / pre_ms * 1e3:.0f} tokens/s; peak {torch.cuda.max_memory_allocated() / 1e9:.2f}"
            f" GB; the step builds every position's logits, {B} x {S} x {V} float32 = "
            f"{B * S * V * 4 / 1e9:.2f} GB, and keeps the last; next tokens {next_tok.tolist()}")
        if cfg.n_experts:
            drops = [int(moe.dropped(p, x, cfg)) for p, x in moe_inputs]
            if len(drops) != cfg.n_layers:
                raise AssertionError(f"[24 cards] {name}: {len(drops)} MoE layers ran")
            C = moe.moe_capacity(cfg, S)
            log(f"[24 cards] {name}: entries dropped by capacity per layer {drops} of "
                f"{B * S * cfg.top_k} (B x S x top_k), capacity C = {C} per expert and row")
        del moe_inputs

        last = lm.apply_train(params, batch, cfg)[:, -1]
        with attention.flash_enabled("off"):
            fa.launches = 0
            last_plain = lm.apply_train(params, batch, cfg)[:, -1]
            if fa.launches:
                raise AssertionError("flash launched with flash_enabled('off')")
        torch.cuda.synchronize()
        diff = float((last - last_plain).abs().max())
        if not (bool(torch.isfinite(last).all()) and torch.equal(last.argmax(-1).int(), next_tok)
                and diff <= PREFILL_LOGIT_ATOL):
            raise AssertionError(f"[24 cards] {name}: flash vs streaming prefill {diff}, or "
                                 f"logits not finite or not the prefill step's tokens")
        log(f"[24 cards] {name}: flash vs streaming prefill (flash_enabled('off')): "
            f"last-position logits max abs diff {diff:.4f} (atol {PREFILL_LOGIT_ATOL}), argmax "
            f"{last.argmax(-1).tolist()} vs {last_plain.argmax(-1).tolist()}")
        del last, last_plain

        # float32 compute; a capacity of S for the MoE (capacity_factor E/k), so that the
        # full forward drops no token that the cached steps (S = 1, C = 1) keep
        cf = {"capacity_factor": cfg.n_experts / cfg.top_k} if cfg.n_experts else {}
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32", **cf)
        cap = f" (capacity_factor {cfg32.capacity_factor}: C = S)" if cf else ""
        n_dec = CARD_DECODE
        toks = tokens[:, :n_dec]
        ref32 = lm.apply_train(params, {"tokens": toks}, cfg32)
        cache = lm.init_cache(cfg32, B, n_dec, dtype=torch.float32, device=dev)
        dec = []
        for t in range(n_dec):
            lg, cache = lm.apply_decode(params, toks[:, t:t + 1], cache, t, cfg32)
            dec.append(lg[:, 0])
        dec_err = float((torch.stack(dec, 1) - ref32).abs().max())
        if not dec_err <= DECODE_LOGIT_ATOL:
            raise AssertionError(f"[24 cards] {name}: cached decode vs apply_train {dec_err}")
        log(f"[24 cards] {name}: float32 compute{cap}, cached apply_decode x {n_dec} vs "
            f"apply_train: logits max abs diff {dec_err:.3e} "
            f"(atol {DECODE_LOGIT_ATOL})")
        del ref32, cache, dec

        prompt = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev)
        t0 = time.perf_counter()
        gen_toks = greedy_generate(params, cfg, prompt, 32)
        torch.cuda.synchronize()
        g_ms = (time.perf_counter() - t0) * 1e3
        if gen_toks.shape != (4, 32) or not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
            raise AssertionError(f"[24 cards] {name}: greedy_generate gave {gen_toks.shape}")
        log(f"[24 cards] {name}: greedy_generate, 4 requests x (prompt 16, 32 new): "
            f"{g_ms:.0f} ms for 48 steps ({g_ms / 48:.1f} ms/step); first tokens "
            f"{gen_toks[:, :4].tolist()}")
        del params, tokens, batch, prompt, gen_toks
        gc.collect()
        torch.cuda.empty_cache()

        # the flash kernel at the prefill's shapes against ref_mha, its time, bound and SDPA's
        flash_at_prefill(torch, dev, gen, "[24 cards]", name, power, B, S, Hkv, G, dh, window,
                         pre_launches)
        clock.lap(f"phase 24 {name}")


def mixer_phases(torch, dev, counters, power: str, clock: PhaseClock) -> None:
    """Phase 25 (mixers): RWKV6-3B at full depth, DeepSeek-V2 (MLA + MoE)
    and Jamba-v0.1 (Mamba + GQA + MoE) with their depth cut, one at a time,
    each at full width with random seeded weights in its own
    ``param_dtype``: the parameter count, the prefill with its flash
    launches (RWKV and DeepSeek none, Jamba one on the tensor-core body),
    its time and peak memory, the entries dropped by capacity per MoE layer,
    float32 cached decode against ``apply_train`` (and Jamba's Mamba states
    against the prefill's), greedy generation, and for Jamba the flash
    kernel at its prefill's shapes. Each card's seconds are a lap of
    ``clock``."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, blocks, lm, moe, ssm
    from repro_torch._unused.models.layers import round_vocab
    from repro_torch._unused.serve.serve_step import greedy_generate, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    B, S = MIXER_BATCH, MIXER_SEQ
    cores = {"rwkv6": (ssm, "_rwkv_chunked"), "mamba": (ssm, "_mamba_scan_chunked"),
             "mla": (attention, "_attend_chunked")}
    for name, depth in MIXER_CARDS:
        full = get_config(name)
        cfg = full if depth is None else dataclasses.replace(full, n_layers=depth)
        kinds = [f"{d.mixer}/{d.ffn}" for pattern, repeat in cfg.layer_list
                 for d in pattern for _ in range(repeat)]
        n_attn = sum(k.startswith("gqa") for k in kinds)
        n_moe = sum(k.endswith("moe") for k in kinds)
        gen = torch.Generator(device=dev).manual_seed(SEED + 25)
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, generator=gen, device=dev)
        n_params = lm.count_params(params)
        if n_params != lm.param_count(cfg):
            raise AssertionError(f"[25 mixers] {name}: {n_params} parameters, param_count "
                                 f"{lm.param_count(cfg)}")
        V = round_vocab(cfg.vocab)
        w_bytes = n_params * 4
        log(f"[25 mixers] {name} ({full.source}): full width (d_model {cfg.d_model}, vocab "
            f"{cfg.vocab}), depth {'full, ' if depth is None else f'cut {full.n_layers} -> '}"
            f"{cfg.n_layers} layers {kinds}; {n_params:,} parameters ({cfg.param_dtype}, "
            f"{w_bytes / 1e9:.2f} GB) = lm.param_count = n_params_estimate "
            f"{cfg.n_params_estimate:,} {n_params - cfg.n_params_estimate:+,} (norms, biases, "
            f"vocab pad and the mixers' vectors; RWKV: less the gate LoRA it does not build); "
            f"full depth {full.n_params_estimate:,} by the estimate")

        tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
        prefill = make_prefill_step(cfg)
        prefill(params, {"tokens": tokens[:, :256]})  # warm up
        moe_inputs = []  # each MoE layer's (params, input) in the prefill, for its drops

        def recorded(p, x, cfg_):
            moe_inputs.append((p, x))
            return moe.moe_apply(p, x, cfg_)

        # the peak, reckoned: the weights, the step's float32 logits over every position and
        # its bf16 product, and the largest layer's bf16 weight copies (cast at each use)
        expert = 3 * cfg.d_model * cfg.d_ff_expert * cfg.n_experts if n_moe else 0
        reckoned = w_bytes + B * S * V * 6 + 2 * max(expert, V * cfg.d_model)
        zero()
        fa.launches = fa.tc_launches = 0
        torch.cuda.reset_peak_memory_stats()
        blocks.moe_apply = recorded
        try:
            t0 = time.perf_counter()
            next_tok = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
        finally:
            blocks.moe_apply = moe.moe_apply
        peak = torch.cuda.max_memory_allocated()
        MEASURED[f"{name} prefill_ms"] = pre_ms  # phase 32 sets the split prefill beside it
        others = read()
        if (fa.launches, fa.tc_launches) != (n_attn, n_attn) or others:
            raise AssertionError(f"[25 mixers] {name}: prefill launched flash {fa.launches} "
                                 f"times, {fa.tc_launches} on the tensor-core body (want "
                                 f"{n_attn} of each), decoder kernels {others}")
        pre_launches = fa.tc_launches
        log(f"[25 mixers] {power}: {name} make_prefill_step, {B} x {S} tokens: flash launches "
            f"{fa.launches} ({fa.tc_launches} on the tensor-core body; {n_attn} attention "
            f"layers); {pre_ms:.1f} ms -> {B * S / pre_ms * 1e3:.0f} tokens/s; peak "
            f"{peak / 1e9:.2f} GB (reckoned {reckoned / 1e9:.2f} GB: weights, the "
            f"{B} x {S} x {V} float32 logits and their bf16 product, the largest bf16 weight "
            f"copy) of {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; next "
            f"tokens {next_tok.tolist()}")
        if n_moe:
            drops = [int(moe.dropped(p, x, cfg)) for p, x in moe_inputs]
            if len(drops) != n_moe:
                raise AssertionError(f"[25 mixers] {name}: {len(drops)} MoE layers ran")
            log(f"[25 mixers] {name}: entries dropped by capacity per MoE layer {drops} of "
                f"{B * S * cfg.top_k} (B x S x top_k), capacity C = {moe.moe_capacity(cfg, S)} "
                f"per expert and row")
        del moe_inputs
        last = lm.apply_train(params, {"tokens": tokens}, cfg)[:, -1]
        if not (bool(torch.isfinite(last).all()) and torch.equal(last.argmax(-1).int(), next_tok)):
            raise AssertionError(f"[25 mixers] {name}: prefill logits not finite or not the "
                                 f"step's tokens")
        del last

        # where the prefill's time goes: each mixer's core (the chunked scans, MLA's streaming
        # softmax) bracketed by synchronizes in one more prefill, on the host clock
        spent, patched = {}, []
        for mod, attr in sorted({cores[d.mixer] for pattern, _ in cfg.layer_list
                                 for d in pattern if d.mixer in cores}):
            core = getattr(mod, attr)

            def timed(*a, _core=core, _attr=attr, **k):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = _core(*a, **k)
                torch.cuda.synchronize()
                spent[_attr] = spent.get(_attr, 0.0) + (time.perf_counter() - t) * 1e3
                return out

            setattr(mod, attr, timed)
            patched.append((mod, attr, core))
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            split_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for mod, attr, core in patched:
                setattr(mod, attr, core)
        log(f"[25 mixers] {power}: {name} prefill split, the cores bracketed by synchronizes: "
            + "; ".join(f"{k} {v:.1f} ms ({v / split_ms:.1%})" for k, v in spent.items())
            + f"; the rest (projections, FFN/MoE, norms, logits) {split_ms - sum(spent.values()):.1f}"
            f" ms; {split_ms:.1f} ms in all")

        # float32 compute; a capacity of S for the MoE (capacity_factor E/k), so that the
        # full forward drops no token that the cached steps (S = 1, C = 1) keep
        cf = {"capacity_factor": cfg.n_experts / cfg.top_k} if cfg.n_experts else {}
        cfg32 = dataclasses.replace(cfg, compute_dtype="float32", **cf)
        n_dec = MIXER_DECODE
        toks = tokens[:, :n_dec]
        states = []  # the last state of each Mamba layer's chunked scan in apply_train

        def scan(*a):
            y, h = mamba_scan(*a)
            states.append(h)
            return y, h

        mamba_scan = ssm._mamba_scan_chunked
        ssm._mamba_scan_chunked = scan
        try:
            ref32 = lm.apply_train(params, {"tokens": toks}, cfg32)
        finally:
            ssm._mamba_scan_chunked = mamba_scan

        def cached(model, cfg_):
            cache_ = lm.init_cache(cfg_, B, n_dec, dtype=torch.float32, device=dev)
            out = []
            for t in range(n_dec):
                lg, cache_ = lm.apply_decode(model, toks[:, t:t + 1], cache_, t, cfg_)
                out.append(lg[:, 0])
            return torch.stack(out, 1), cache_

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec, cache = cached(params, cfg32)
        torch.cuda.synchronize()
        dec32_ms = (time.perf_counter() - t0) * 1e3 / n_dec
        dec_err = float((dec - ref32).abs().max())
        atol = RWKV_DEPTH_ATOL if cfg.ffn_act == "rwkv_cm" else DECODE_LOGIT_ATOL
        if not dec_err <= atol:
            raise AssertionError(f"[25 mixers] {name}: cached decode vs apply_train {dec_err}")
        cap = f" (capacity_factor {cfg32.capacity_factor:g}: C = S)" if cf else ""
        log(f"[25 mixers] {name}: float32 compute{cap}, cached apply_decode x {n_dec} vs "
            f"apply_train, {cfg.n_layers} layers: logits max abs diff {dec_err:.3e} (atol "
            f"{atol}); {dec32_ms:.1f} ms per float32 step at batch {B}")
        if cfg.ffn_act == "rwkv_cm":  # the first two layers alone, at the roundoff limit
            cfg2 = dataclasses.replace(cfg32, n_layers=2)
            first2 = lm.LM(params.embed, params.final_norm, torch.nn.ModuleList(
                [torch.nn.ModuleList(list(params.groups[0])[:2])]), params.lm_head)
            err2 = float((cached(first2, cfg2)[0]
                          - lm.apply_train(first2, {"tokens": toks}, cfg2)).abs().max())
            if not err2 <= DECODE_LOGIT_ATOL:
                raise AssertionError(f"[25 mixers] {name}: first two layers, cached decode vs "
                                     f"apply_train {err2}")
            log(f"[25 mixers] {name}: the first two layers alone, cached apply_decode x {n_dec} "
                f"vs apply_train: logits max abs diff {err2:.3e} (atol {DECODE_LOGIT_ATOL})")
        decoded = [c["mixer"].h for g in cache["groups"] for layer in g for c in layer.values()
                   if isinstance(c["mixer"], ssm.MambaCache)]
        if len(decoded) != len(states) or len(states) != kinds.count("mamba/dense") + kinds.count(
                "mamba/moe"):
            raise AssertionError(f"[25 mixers] {name}: {len(states)} scanned and {len(decoded)} "
                                 f"decoded Mamba states")
        if states:
            rel = max(float((h_d - h_p).abs().max() / h_p.abs().max())
                      for h_d, h_p in zip(decoded, states))
            if not rel <= MAMBA_STATE_RTOL:
                raise AssertionError(f"[25 mixers] {name}: Mamba state after the prefill vs "
                                     f"after {n_dec} cached steps: {rel:.3e} of the largest")
            log(f"[25 mixers] {name}: Mamba state (B, {cfg.mamba_d_inner}, {cfg.mamba_d_state}) "
                f"of each of {len(states)} Mamba layers after the prefill's chunked scan of "
                f"{n_dec} tokens vs after {n_dec} cached steps: max abs diff {rel:.3e} of the "
                f"largest state (limit {MAMBA_STATE_RTOL})")
        del ref32, cache, dec, states, decoded

        prompt = torch.randint(0, cfg.vocab, (4, 16), generator=gen, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen_toks = greedy_generate(params, cfg, prompt, 32)
        torch.cuda.synchronize()
        g_ms = (time.perf_counter() - t0) * 1e3
        if gen_toks.shape != (4, 32) or not bool(((gen_toks >= 0) & (gen_toks < cfg.vocab)).all()):
            raise AssertionError(f"[25 mixers] {name}: greedy_generate gave {gen_toks.shape}")
        log(f"[25 mixers] {power}: {name} greedy_generate, 4 requests x (prompt 16, 32 new), "
            f"bf16 compute and cache: {g_ms:.0f} ms for 48 steps ({g_ms / 48:.1f} ms/step); "
            f"first tokens {gen_toks[:, :4].tolist()}")
        del params, tokens, prompt, gen_toks
        gc.collect()
        torch.cuda.empty_cache()
        if n_attn:
            Hkv, G = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
            flash_at_prefill(torch, dev, gen, "[25 mixers]", name, power, B, S, Hkv, G,
                             cfg.head_dim, cfg.sliding_window, pre_launches)
        clock.lap(f"phase 25 {name}")


def encdec_phases(torch, dev, counters, power: str, clock: PhaseClock) -> dict:
    """Phase 26 (encdec): SeamlessM4T-medium at full width and depth and
    Pixtral-12B at full width with its depth cut to ``VLM_LAYERS``, random
    seeded float32 weights: the parameter count, the prefill through
    ``make_prefill_step`` with its flash launches (Seamless: encoder,
    decoder self- and cross-attention; all on the tensor-core body), its
    time, tokens/s and peak memory, flash against the streaming prefill,
    Seamless's ``prefill_cross`` plus float32 cached ``apply_decode``
    against teacher-forced ``apply_train`` and its greedy steps against the
    cross cache, Pixtral's patch positions, and the flash kernel at each
    attention's shapes. Returns the flash launches per prefill and the
    kernel's numbers at each Seamless shape."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, lm
    from repro_torch._unused.models.layers import round_vocab
    from repro_torch._unused.serve.serve_step import make_decode_step, make_prefill_step

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    B, S, SX = ENCDEC_BATCH, ENCDEC_SEQ, ENCDEC_FRAMES
    tag = "[26 encdec]"
    result = {"launches": {}, "seamless": {}}

    def prefill_run(name, cfg, params, batch, want):
        prefill = make_prefill_step(cfg)
        prefill(params, {k: v[:, :256] for k, v in batch.items()})  # warm up
        zero()
        fa.launches = fa.tc_launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        next_tok = prefill(params, batch)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        others = read()
        if (fa.launches, fa.tc_launches) != (want, want) or others:
            raise AssertionError(f"{tag} {name}: prefill launched flash {fa.launches} times, "
                                 f"{fa.tc_launches} on the tensor-core body (want {want} of "
                                 f"each), decoder kernels {others}")
        result["launches"][name] = fa.tc_launches
        again = [wall_ms(torch, lambda: prefill(params, batch), reps=1) for _ in range(2)]
        V = round_vocab(cfg.vocab)
        log(f"{tag} {power}: {name} make_prefill_step, {B} x {S} tokens: flash launches "
            f"{want}, all on the tensor-core body; {pre_ms:.1f} ms, then {again} ms -> "
            f"{B * S / statistics.median([pre_ms, *again]) * 1e3:.0f} tokens/s (median of 3); "
            f"peak {peak / 1e9:.2f} GB, of which the {B} x {S} x {V} float32 logits "
            f"{B * S * V * 4 / 1e9:.2f} GB and their bf16 product {B * S * V * 2 / 1e9:.2f} GB; "
            f"next tokens {next_tok.tolist()}")
        with torch.no_grad():
            last = lm.apply_train(params, batch, cfg)[:, -1]
            with attention.flash_enabled("off"):
                fa.launches = 0
                last_plain = lm.apply_train(params, batch, cfg)[:, -1]
                if fa.launches:
                    raise AssertionError("flash launched with flash_enabled('off')")
        diff = float((last - last_plain).abs().max())
        if not (bool(torch.isfinite(last).all()) and torch.equal(last.argmax(-1).int(), next_tok)
                and diff <= PREFILL_LOGIT_ATOL):
            raise AssertionError(f"{tag} {name}: flash vs streaming prefill {diff}, or logits "
                                 f"not finite or not the prefill step's tokens")
        log(f"{tag} {name}: flash vs streaming prefill (flash_enabled('off')): last-position "
            f"logits max abs diff {diff:.4f} (atol {PREFILL_LOGIT_ATOL}), argmax "
            f"{last.argmax(-1).tolist()} vs {last_plain.argmax(-1).tolist()}")

    # ---- SeamlessM4T-medium: encoder, cross-attention, the cross cache ------------------
    cfg = get_config("seamless-m4t-medium")
    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    params = lm.init_params(cfg, generator=gen, device=dev).requires_grad_(True)
    n_params = lm.count_params(params)
    if n_params != lm.param_count(cfg):
        raise AssertionError(f"{tag} seamless: {n_params} parameters, param_count "
                             f"{lm.param_count(cfg)}")
    log(f"{tag} {cfg.name} ({cfg.source}): full width and depth ({cfg.n_encoder_layers} "
        f"encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, vocab {cfg.vocab}); {n_params:,} parameters ({cfg.param_dtype}, "
        f"{n_params * 4 / 1e9:.2f} GB) = lm.param_count = n_params_estimate "
        f"{cfg.n_params_estimate:,} + {n_params - cfg.n_params_estimate:,} norms, biases and "
        f"vocab pad; frames {B} x {SX} x {cfg.d_model} from the seeded generator (the audio "
        f"frontend is a stub)")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    frames = torch.randn((B, SX, cfg.d_model), generator=gen, device=dev)
    prefill_run("seamless", cfg, params, {"tokens": tokens, "frames": frames},
                cfg.n_encoder_layers + 2 * cfg.n_layers)

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    n_dec = ENCDEC_DECODE
    toks = tokens[:, :n_dec]
    with torch.no_grad():
        ref32 = lm.apply_train(params, {"tokens": toks, "frames": frames}, cfg32)
        enc = lm.encode(params, frames, cfg32)
    cache = lm.init_cache(cfg32, B, n_dec, dtype=torch.float32, cross_len=SX, device=dev)
    cache = lm.prefill_cross(params, enc, cfg32, cache)
    cross_k = cache["groups"][0][0]["l0"]["cross"].k.clone()
    dec = []
    for t in range(n_dec):
        lg, cache = lm.apply_decode(params, toks[:, t:t + 1], cache, t, cfg32)
        dec.append(lg[:, 0])
    dec_err = float((torch.stack(dec, 1) - ref32).abs().max())
    if not dec_err <= DECODE_LOGIT_ATOL or not torch.equal(
            cache["groups"][0][0]["l0"]["cross"].k, cross_k):
        raise AssertionError(f"{tag} seamless: cached decode vs teacher forcing {dec_err}, or "
                             f"the cross K/V moved")
    log(f"{tag} seamless: float32 compute, lm.encode + lm.prefill_cross ({SX} frames) then "
        f"cached apply_decode x {n_dec} vs teacher-forced apply_train: logits max abs diff "
        f"{dec_err:.3e} (atol {DECODE_LOGIT_ATOL}); the cross K/V unchanged by the steps")
    del ref32, enc, cache, dec, cross_k

    n_prompt, n_new = 16, ENCDEC_GREEDY
    with torch.no_grad():
        enc = lm.encode(params, frames, cfg)
    cache = lm.prefill_cross(params, enc, cfg, lm.init_cache(
        cfg, B, n_prompt + n_new, cross_len=SX, device=dev))
    step = make_decode_step(cfg, n_prompt + n_new)
    for t in range(n_prompt):
        nxt, cache = step(params, tokens[:, t:t + 1], cache, t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tok = nxt[:, None]
    for t in range(n_new):
        nxt, cache = step(params, tok, cache, n_prompt + t)
        tok = nxt[:, None]
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - t0) * 1e3 / n_new
    log(f"{tag} {power}: seamless greedy decode against the cross cache ({SX} frames), batch "
        f"{B}, bf16 compute and cache: {g_ms:.1f} ms per step ({B / g_ms * 1e3:.1f} tokens/s)")
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    del params, tokens, frames, enc, cache
    gc.collect()
    torch.cuda.empty_cache()
    for label, S_, T_, causal in (("encoder", SX, SX, False), ("decoder self", S, S, True),
                                  ("cross", S, SX, False)):
        result["seamless"][label] = flash_at_prefill(
            torch, dev, gen, tag, f"seamless {label}", power, B, S_, Hkv, H // Hkv, dh, None,
            result["launches"]["seamless"], T=T_, causal=causal)
    clock.lap("phase 26 seamless")

    # ---- Pixtral-12B: patch embeddings in the first positions -----------------------------
    full = get_config("pixtral-12b")
    cfg = dataclasses.replace(full, n_layers=VLM_LAYERS)
    params = lm.init_params(cfg, generator=gen, device=dev).requires_grad_(True)
    n_params = lm.count_params(params)
    if n_params != lm.param_count(cfg):
        raise AssertionError(f"{tag} pixtral: {n_params} parameters")
    P = cfg.n_patches
    log(f"{tag} {full.name} ({full.source}): full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}), depth cut "
        f"{full.n_layers} -> {cfg.n_layers} layers; {n_params:,} parameters "
        f"({n_params * 4 / 1e9:.2f} GB); {P} patch embeddings of {cfg.d_model} in the first "
        f"positions of each prompt (the vision frontend is a stub)")
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    patches = torch.randn((B, P, cfg.d_model), generator=gen, device=dev)
    prefill_run("pixtral", cfg, params, {"tokens": tokens, "patch_embeds": patches},
                cfg.n_layers)
    other = tokens.clone()
    other[:, :P] = (other[:, :P] + 1) % cfg.vocab
    keep = P + 16
    with torch.no_grad():
        base = lm.apply_train(params, {"tokens": tokens, "patch_embeds": patches}, cfg)[:, :keep]
        same = lm.apply_train(params, {"tokens": other, "patch_embeds": patches}, cfg)[:, :keep]
        moved = lm.apply_train(params, {"tokens": tokens, "patch_embeds": patches.flip(1)},
                               cfg)[:, :keep]
    moved_min = float((moved[:, :P] - base[:, :P]).abs().amax(-1).min())
    if not torch.equal(base, same) or not moved_min > 0:
        raise AssertionError(f"{tag} pixtral: the patch positions' logits follow the tokens they "
                             f"replace, or not the patches ({moved_min})")
    log(f"{tag} pixtral: the logits of the first {keep} positions are bit-equal with the "
        f"{P} replaced tokens changed; with the patches reordered every patch position's logits "
        f"move (least max abs change {moved_min:.3e})")
    del params, tokens, patches, other, base, same, moved
    gc.collect()
    torch.cuda.empty_cache()
    flash_at_prefill(torch, dev, gen, tag, "pixtral", power, B, S, cfg.n_kv_heads,
                     cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.sliding_window,
                     result["launches"]["pixtral"])
    clock.lap("phase 26 pixtral")
    return result


def train_phases(torch, dev, counters, power: str, clock: PhaseClock) -> dict:
    """Phase 27 (train): the training path on StarCoder2-3B at full width.
    The flash ``autograd.Function`` at the step's attention shapes (its q,
    k, v gradients bit-equal to autograd through ``_attend_chunked``); a
    2-layer step at float32 compute with flash on against flash off
    (gradients within ``TRAIN_GRAD_RTOL`` of each leaf's largest); the
    full-depth ``make_train_step`` (bf16 compute, per-layer remat, AdamW)
    for ``TRAIN_STEPS`` steps of ``SyntheticLMStream`` batches: finite,
    falling loss, step time, tokens/s, peak memory and flash launches per
    step, and a profiler window over one step; then the train CLI at
    ``--preset 100m`` with an injected failure, restored from its last
    checkpoint. Returns the flash launches per step."""
    import dataclasses
    import gc
    import math
    import os
    import shutil

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, lm
    from repro_torch._unused.train.data import SyntheticLMStream
    from repro_torch._unused.train.optimizer import AdamWConfig, adamw_init
    from repro_torch._unused.train.train_step import (cast_params_for_compute, loss_fn,
                                                      make_train_step)
    from repro_torch.launch.cost import WorkCounter

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    tag = "[27 train]"
    cfg = get_config("starcoder2-3b")
    B, S = TRAIN_BATCH, TRAIN_SEQ
    Hkv, G, dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)

    # ---- the flash Function at the step's attention shapes ------------------------------
    kw = dict(causal=True, window=cfg.sliding_window, scale=1.0 / math.sqrt(dh))
    q = torch.randn((B, S, Hkv, G, dh), generator=gen, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, dh), generator=gen, device=dev).to(torch.bfloat16)
            for _ in range(2))
    g = torch.randn((B, S, Hkv, G, dh), generator=gen, device=dev).to(torch.bfloat16)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fa.launches = fa.tc_launches = 0
    out = attention._flash_with_plain_bwd(q, k, v, **kw)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    body = (fa.launches, fa.tc_launches)
    plain = attention._attend_chunked(q, k, v, **kw)
    pgrads = torch.autograd.grad(plain, (q, k, v), g.float())
    equal = [torch.equal(a, b) for a, b in zip(grads, pgrads)]
    if body != (1, 1) or not all(equal) or not all(bool(torch.isfinite(a).all()) for a in grads):
        raise AssertionError(f"{tag} flash Function: launches {body}, q/k/v grads bit-equal to "
                             f"_attend_chunked's {equal}")
    fwd_ms = cuda_ms(torch, lambda: attention._flash_with_plain_bwd(q, k, v, **kw), reps=5)
    bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        attention._flash_with_plain_bwd(q, k, v, **kw), (q, k, v), g), reps=3) - fwd_ms
    log(f"{tag} {power}: flash autograd.Function at the step's shapes B={B} S=T={S} Hkv={Hkv} "
        f"G={G} dh={dh} bf16 causal window {cfg.sliding_window}: forward one tensor-core launch, "
        f"{fwd_ms:.3f} ms; backward (the _attend_chunked recompute and its vjp, plain PyTorch) "
        f"{bwd_ms:.3f} ms; q, k, v gradients bit-equal to autograd through _attend_chunked "
        f"alone: {equal}")
    del q, k, v, g, out, grads, plain, pgrads

    # ---- 2 layers at full width, float32 compute: flash on vs off --------------------------
    stream = SyntheticLMStream(cfg.vocab, S, B, seed=SEED)

    def on_device(batch):
        return {key: torch.as_tensor(val, dtype=torch.int64, device=dev)
                for key, val in batch.items()}

    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    params = lm.init_params(cfg2, generator=gen, device=dev).requires_grad_(True)
    leaves = dict(params.named_parameters())
    batch = on_device(stream.batch(0))
    runs = {}
    for mode in ("on", "off"):
        fa.launches = fa.tc_launches = 0
        with attention.flash_enabled(mode):
            loss = loss_fn(params, batch, cfg2)
            runs[mode] = (float(loss.detach()), torch.autograd.grad(loss, list(leaves.values())),
                          (fa.launches, fa.tc_launches))
    if runs["on"][2] != (2 * cfg2.n_layers, 0) or runs["off"][2] != (0, 0):
        raise AssertionError(f"{tag} 2 layers: flash launches on {runs['on'][2]}, off "
                             f"{runs['off'][2]}")
    worst, worst_key = 0.0, None
    for key, a, b in zip(leaves, runs["on"][1], runs["off"][1]):
        ratio = float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
        if ratio > worst:
            worst, worst_key = ratio, key
    if not worst <= TRAIN_GRAD_RTOL:
        raise AssertionError(f"{tag} 2 layers: flash on vs off gradient of {worst_key} differs "
                             f"by {worst:.3e} of its largest entry")
    log(f"{tag} 2-layer StarCoder2-3B at full width, float32 compute, {B} x {S} tokens: loss "
        f"flash on {runs['on'][0]:.6f} vs off {runs['off'][0]:.6f}; flash launches with "
        f"the gradient {runs['on'][2][0]} (forward + remat recompute, CUDA-core body); "
        f"gradients of {len(leaves)} leaves, largest difference {worst:.3e} of its leaf's largest "
        f"entry ({worst_key}; limit {TRAIN_GRAD_RTOL})")
    del params, leaves, runs
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the full-depth step -----------------------------------------------------------------
    def full_depth_params():  # the same initial parameters for full remat and for dots
        init = torch.Generator(device=dev).manual_seed(SEED + 270)
        return lm.init_params(cfg, generator=init, device=dev).requires_grad_(True)

    params = full_depth_params()
    n_params = lm.count_params(params)
    # the reference's AdamW defaults: lr 3e-4 after 100 warmup steps, so these steps take
    # 3e-6 to 1.8e-5 (one step at 3e-4 on these random 30 layers sends the loss from 11.3 to 21.9)
    opt_cfg = AdamWConfig()
    opt = adamw_init(dict(params.named_parameters()), opt_cfg)
    step = make_train_step(cfg, opt_cfg)
    state_gb = 4 * n_params * 4 / 1e9
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, {n_params:,} parameters; float32 parameters, "
        f"gradients and AdamW m and v {state_gb:.1f} GB, the bf16 casts "
        f"{n_params * 2 / 1e9:.1f} GB, layer inputs kept by remat "
        f"{cfg.n_layers * B * S * cfg.d_model * 2 / 1e9:.2f} GB")
    losses, times, launches = [], [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        batch = on_device(stream.batch(i))
        zero()
        fa.launches = fa.tc_launches = 0
        t0 = time.perf_counter()
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        launches.append((fa.launches, fa.tc_launches))
        others = read()
        if others:
            raise AssertionError(f"{tag} the train step launched decoder kernels {others}")
    peak = torch.cuda.max_memory_allocated()
    want = (2 * cfg.n_layers, 2 * cfg.n_layers)
    if (not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]
            or any(n != want for n in launches)):
        raise AssertionError(f"{tag} full depth: losses {losses}, flash launches per step "
                             f"{launches} (want {want}), step ms {times}")
    med = statistics.median(times[1:])
    log(f"{tag} {power}: make_train_step, {cfg.name} full depth, {B} x {S} tokens per step, "
        f"bf16 compute, per-layer remat, AdamW: losses {[round(x, 4) for x in losses]}; step ms "
        f"{[round(x, 1) for x in times]} (the first allocates), median of the rest {med:.1f} ms "
        f"-> {B * S / med * 1e3:.0f} tokens/s; peak {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; flash launches per "
        f"step {launches[0][0]} ({cfg.n_layers} forward + {cfg.n_layers} remat recompute), all "
        f"on the tensor-core body")
    batch = on_device(stream.batch(TRAIN_STEPS))
    wall, kernels, busy = device_profile(torch, lambda: step(params, opt, batch), top=8)
    if busy > 0:
        log(f"{tag} {power}: one step under the profiler: wall {wall:.1f} ms, device busy "
            f"{busy:.1f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top kernels: "
            + "; ".join(f"{n} {ms:.1f} ms x {c}" for n, ms, c in kernels))
    else:
        log(f"{tag} one step under the profiler: no device time seen (not measured)")
    del params, opt, step, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    clock.lap("phase 27 train step")

    # ---- the same steps under REPRO_REMAT=dots: the products' outputs kept ----------------
    prev = os.environ.get("REPRO_REMAT")
    os.environ["REPRO_REMAT"] = "dots"
    try:
        params = full_depth_params()
        opt = adamw_init(dict(params.named_parameters()), opt_cfg)
        step = make_train_step(cfg, opt_cfg)
        dots_losses, dots_times = [], []
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_STEPS):
            batch = on_device(stream.batch(i))
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            dots_losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            dots_times.append((time.perf_counter() - t0) * 1e3)
        dots_peak = torch.cuda.max_memory_allocated()
        del params, opt, step, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        if prev is None:
            os.environ.pop("REPRO_REMAT", None)
        else:
            os.environ["REPRO_REMAT"] = prev
    loss_diff = max(abs(a - b) for a, b in zip(dots_losses, losses))
    if not loss_diff <= DOTS_LOSS_ATOL:
        raise AssertionError(f"{tag} REPRO_REMAT=dots: losses {dots_losses} against full "
                             f"remat's {losses}, {loss_diff:.3e} apart")
    counted = {}
    meta_params = lm.init_params(cfg, device="meta").requires_grad_(True)
    meta_batch = {key: torch.empty((B, S), dtype=torch.int64, device="meta")
                  for key in ("tokens", "labels")}
    for mode in ("full", "dots"):
        os.environ["REPRO_REMAT"] = mode
        try:
            with WorkCounter() as c, torch.enable_grad():
                loss = loss_fn(cast_params_for_compute(meta_params, cfg), meta_batch, cfg)
                torch.autograd.grad(loss, list(meta_params.parameters()))
        finally:
            os.environ.pop("REPRO_REMAT", None)
        counted[mode] = c.flops
    with WorkCounter() as c, torch.no_grad():
        loss_fn(cast_params_for_compute(meta_params, cfg), meta_batch, cfg)
    forward = c.flops
    if prev is not None:
        os.environ["REPRO_REMAT"] = prev
    dots_med = statistics.median(dots_times[1:])
    log(f"{tag} {power}: REPRO_REMAT=dots, {cfg.name} full depth, {B} x {S} tokens per step: "
        f"losses {[round(x, 4) for x in dots_losses]}, {loss_diff:.3e} from full remat's "
        f"(atol {DOTS_LOSS_ATOL}); step ms {[round(x, 1) for x in dots_times]}, median of the "
        f"rest {dots_med:.1f} ms (full remat {med:.1f}) -> {B * S / dots_med * 1e3:.0f} "
        f"tokens/s; peak {dots_peak / 1e9:.2f} GB (full remat {peak / 1e9:.2f}); counted step "
        f"FLOP (launch/cost.py, on meta) full remat {counted['full']:.6e}, dots "
        f"{counted['dots']:.6e}: {counted['full'] - counted['dots']:.6e} less recompute, "
        f"{(counted['full'] - counted['dots']) / (counted['full'] - 3 * forward):.1%} of full "
        f"remat's recompute (the step less three forwards of {forward:.6e})")
    clock.lap("phase 27 dots")

    # ---- the train CLI: an injected failure restored from the last checkpoint -------------
    root = Path(__file__).resolve().parent
    ckpt = root / "build" / "train-ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    argv = ["-m", "repro_torch.launch.train", "--preset", "100m", "--steps", "20",
            "--ckpt-every", "10", "--inject-failure-at", "12", "--ckpt-dir", str(ckpt)]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], cwd=root, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": str(root / "src")}, timeout=300)
    for line in (proc.stdout + proc.stderr).splitlines():
        log(f"{tag} cli: {line}")
    text = proc.stdout
    if (proc.returncode or "[train] failure at step 12: injected node failure" not in text
            or "[train] done on " not in text):
        raise AssertionError(f"{tag} the train CLI exited {proc.returncode} without recovering")
    log(f"{tag} {power}: python -m repro_torch.launch.train {' '.join(argv[2:])}: restored "
        f"and finished, exit 0 in {time.perf_counter() - t0:.1f} s")
    shutil.rmtree(ckpt, ignore_errors=True)
    clock.lap("phase 27 train cli")
    return {"train step": launches[-1][1]}


def lm_mesh_phases(torch, dev, counters, power: str, clock: PhaseClock) -> dict:
    """Phase 28 (lm mesh): the LM over meshes of device lists on the one
    card (see the module docstring). Returns the flash launches of the
    mesh prefill and of one mesh train step."""
    import contextlib
    import dataclasses
    import gc
    import io

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import blocks, lm, moe, ssm
    from repro_torch._unused.serve.serve_step import make_decode_step, make_prefill_step
    from repro_torch._unused.train.optimizer import AdamWConfig, adamw_init
    from repro_torch._unused.train.train_step import (make_mesh_train_step, make_train_step,
                                                      place_train_state)
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_decode_mesh, make_local_mesh
    from repro_torch.launch.pp import bubble_fraction, pipeline_apply
    from repro_torch.sharding.place import Placed
    from repro_torch.sharding.rules import axis_rules

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    tag = "[28 lm mesh]"
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    mesh4 = make_local_mesh(data=1, model=4, devices=[dev] * 4)
    mesh1 = make_local_mesh(devices=[dev])
    card = mesh1.devices.flat[0]  # the one card, by index

    # ---- Jamba-v0.1 served over data=1, model=4 ------------------------------------------
    full = get_config("jamba-v0.1-52b")
    cfg = dataclasses.replace(full, n_layers=MESH_SERVE_LAYERS)
    params = lm.init_params(cfg, generator=gen, device=dev)
    kinds = [f"{d.mixer}/{d.ffn}" for pattern, repeat in cfg.layer_list for d in pattern
             for _ in range(repeat)]
    B, S = MESH_PREFILL
    tokens = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    prefill = make_prefill_step(cfg)
    with axis_rules(mesh4):
        prefill(params, {"tokens": tokens[:, :256]})  # warm up
    loads = []

    def recorded(p, x, cfg_):
        loads.append(moe.ep_load(p, x, cfg_))
        return moe.moe_apply(p, x, cfg_)

    zero()
    fa.launches = fa.tc_launches = 0
    blocks.moe_apply = recorded
    try:
        with axis_rules(mesh4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            next4 = prefill(params, {"tokens": tokens})
            torch.cuda.synchronize()
            pre_ms = (time.perf_counter() - t0) * 1e3
    finally:
        blocks.moe_apply = moe.moe_apply
    pre_launches = (fa.launches, fa.tc_launches)
    others = read()
    n_attn, n_moe = kinds.count("gqa/dense") + kinds.count("gqa/moe"), sum(
        k.endswith("moe") for k in kinds)
    # the 32 heads split over model=4: each position launches on its own 8
    want_flash = 4 * n_attn
    if pre_launches != (want_flash, want_flash) or others or len(loads) != n_moe:
        raise AssertionError(f"{tag} jamba mesh prefill: flash launches {pre_launches} (want "
                             f"{want_flash} on the tensor-core body), decoder kernels "
                             f"{others}, {len(loads)} MoE layers recorded (want {n_moe})")
    log(f"{tag} {power}: {cfg.name} ({full.source}) at full width, {cfg.n_layers} layers "
        f"{kinds}, {lm.count_params(params):,} float32 parameters, over data=1, model=4 of "
        f"[{card}] * 4: make_prefill_step, {B} x {S} tokens, bf16: {pre_ms:.1f} ms, flash "
        f"launches {pre_launches[0]} ({pre_launches[1]} on the tensor-core body, one per model "
        f"position of each attention layer); EP routing "
        f"group {B * S} tokens, capacity C = {loads[0][0]['capacity']} per expert, routed "
        f"entries kept per model shard (4 experts each) in each MoE layer "
        f"{[ld[0]['kept'] for ld in loads]}, dropped {[sum(ld[0]['dropped']) for ld in loads]}"
        f" of {B * S * cfg.top_k}")
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    part = {"tokens": tokens[:, :MESH_PARITY_SEQ]}
    with torch.no_grad():
        with axis_rules(mesh4):
            mamba_ways = ssm.mamba_split(cfg32)
            last4 = lm.apply_train(params, part, cfg32)[:, -1]
        with axis_rules(mesh1):
            next1 = prefill(params, {"tokens": tokens})
            last1 = lm.apply_train(params, part, cfg32)[:, -1]
    pre_err = float((last4 - last1).abs().max())
    same = torch.equal(last4.argmax(-1), last1.argmax(-1))
    if not (same and pre_err <= MESH_LOGIT_ATOL and bool(torch.isfinite(last4).all())):
        raise AssertionError(f"{tag} jamba float32 prefill model=4 vs (1, 1): next tokens "
                             f"equal {same}, last logits differ by {pre_err}")
    log(f"{tag} {cfg.name} float32 prefill of {B} x {MESH_PARITY_SEQ} tokens over model=4 (the "
        f"Mamba layers split over d_inner {cfg.mamba_d_inner} {mamba_ways} ways, the attention "
        f"over its heads) vs (1, 1): next tokens equal {last4.argmax(-1).tolist()}, last-position logits max abs "
        f"diff {pre_err:.3e} (atol {MESH_LOGIT_ATOL}); the bf16 prefill's next tokens "
        f"{next4.tolist()} over model=4, {next1.tolist()} over (1, 1)")
    del last4, last1

    prompt = tokens[:, :MESH_PROMPT]
    # a long context: the attention cache's first MESH_CTX positions filled with seeded K/V,
    # the same in both runs, so that every sequence tile takes part in the combine
    kv_shape = (B, MESH_S_MAX, cfg.n_kv_heads, cfg.head_dim)
    ctx_kv = [torch.randn(kv_shape, generator=gen, device=dev) for _ in range(2)]
    for t in ctx_kv:
        t[:, MESH_CTX:] = 0

    def serve_run(mesh):
        logits, times = [], []
        real = lm.apply_decode

        def keep(*a, **k):
            out = real(*a, **k)  # the step asks for the logits' vocab blocks
            logits.append(torch.cat([s.to(dev) for s in out[0]], -1)[:, -1])
            return out

        lm.apply_decode = keep
        try:
            with axis_rules(mesh):
                step = make_decode_step(cfg32, MESH_S_MAX)
                cache = lm.init_cache(cfg32, B, MESH_S_MAX, torch.float32, device=dev,
                                      ctx_parallel=step.ctx_parallel)
                for g in cache["groups"]:
                    for layer in g:
                        for c in layer.values():
                            if hasattr(c["mixer"], "k"):
                                c["mixer"].k.copy_(ctx_kv[0])
                                c["mixer"].v.copy_(ctx_kv[1])
                for t in range(MESH_PROMPT):
                    nxt, cache = step(params, prompt[:, t:t + 1], cache, MESH_CTX + t)
                toks = []
                for t in range(MESH_NEW):
                    toks.append(nxt)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    nxt, cache = step(params, nxt[:, None], cache, MESH_CTX + MESH_PROMPT + t)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
        finally:
            lm.apply_decode = real
        kv = [c["mixer"].k for g in cache["groups"] for layer in g for c in layer.values()
              if hasattr(c["mixer"], "k")]
        return step.ctx_parallel, torch.stack(toks, 1), torch.stack(logits, 1), times, kv

    ctx4, toks4, logits4, times4, kv4 = serve_run(mesh4)
    ctx1, toks1, logits1, times1, kv1 = serve_run(mesh1)
    dec_err = float((logits4 - logits1).abs().max())
    tiles = [tuple(k.tiles.shape) for k in kv4 if isinstance(k, Placed)]
    if not (ctx4 and ctx1 and tiles == [(1, 4)] * n_attn and torch.equal(toks4, toks1)
            and dec_err <= MESH_LOGIT_ATOL):
        raise AssertionError(f"{tag} jamba decode: ctx_parallel {ctx4}/{ctx1}, cache tiles "
                             f"{tiles}, tokens equal {torch.equal(toks4, toks1)}, logits "
                             f"differ by {dec_err}")
    log(f"{tag} {power}: {cfg.name} make_decode_step(s_max={MESH_S_MAX}) (context parallel: "
        f"the attention cache as {tiles[0][1]} sequence tiles of "
        f"{MESH_S_MAX // tiles[0][1]}, its first {MESH_CTX} positions seeded K/V), float32, "
        f"batch {B}, prompt {MESH_PROMPT} then {MESH_NEW} greedy steps over model=4 vs (1, 1): "
        f"tokens equal {toks4[0].tolist()}; "
        f"logits max abs diff {dec_err:.3e} over {logits4.shape[1]} steps (atol "
        f"{MESH_LOGIT_ATOL}); ms per greedy step: model=4 median "
        f"{statistics.median(times4):.1f}, (1, 1) median {statistics.median(times1):.1f}")
    del params, tokens, logits4, logits1, kv4, kv1, ctx_kv
    gc.collect()
    torch.cuda.empty_cache()

    # the serve CLI on the card, under axis_rules(make_local_mesh()): a MoE card takes EP
    ep_calls = []
    real_ep = moe._moe_apply_ep
    moe._moe_apply_ep = lambda *a: ep_calls.append(a[3]) or real_ep(*a)
    argv = sys.argv
    sys.argv = ["serve", "--arch", "mixtral-8x22b", "--batch", "4", "--new-tokens", "16",
                "--device", str(dev)]
    try:
        cli_out = io.StringIO()
        with contextlib.redirect_stdout(cli_out):
            serve.main()
    finally:
        moe._moe_apply_ep, sys.argv = real_ep, argv
    line = cli_out.getvalue().strip()
    if not (ep_calls and set(ep_calls) == {"model"} and line.startswith("[serve] ")):
        raise AssertionError(f"{tag} the serve CLI: EP calls {len(ep_calls)}, output {line!r}")
    log(f"{tag} {power}: launch.serve.main(), --arch mixtral-8x22b --batch 4 --new-tokens 16 "
        f"(tiny preset, 16 + 16 steps), under axis_rules(make_local_mesh()): {len(ep_calls)} MoE "
        f"calls, every one on the expert-parallel path; {line}")
    clock.lap("phase 28 jamba mesh serve")

    # ---- StarCoder2-3B: the mesh train step over data=2 ---------------------------------------
    tcfg = dataclasses.replace(get_config("starcoder2-3b"), n_layers=2, compute_dtype="float32")
    Bt, St, n_steps = MESH_TRAIN
    opt_cfg = AdamWConfig()  # lr 3e-6 at step 1 (warmup 100)
    single = lm.init_params(tcfg, generator=gen, device=dev).requires_grad_(True)
    mesh2 = make_local_mesh(data=2, devices=[dev] * 2)
    placed, popt = place_train_state(single, tcfg, opt_cfg, mesh2)
    sopt = adamw_init(dict(single.named_parameters()), opt_cfg)
    s_step = make_train_step(tcfg, opt_cfg)
    m_step = make_mesh_train_step(tcfg, opt_cfg, mesh2)
    losses, m_ms, s_ms, m_launches = [], [], [], []
    for i in range(n_steps):
        batch = {"tokens": torch.randint(0, tcfg.vocab, (Bt, St), generator=gen, device=dev),
                 "labels": torch.randint(0, tcfg.vocab, (Bt, St), generator=gen, device=dev)}
        zero()
        fa.launches = fa.tc_launches = 0
        t0 = time.perf_counter()
        placed, popt, mm = m_step(placed, popt, batch)
        torch.cuda.synchronize()
        m_ms.append((time.perf_counter() - t0) * 1e3)
        m_launches.append(fa.launches)
        others = read()
        fa.launches = 0
        t0 = time.perf_counter()
        single, sopt, sm = s_step(single, sopt, batch)
        torch.cuda.synchronize()
        s_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append((float(mm["loss"]), float(sm["loss"]), fa.launches))
        if others:
            raise AssertionError(f"{tag} the mesh train step launched decoder kernels {others}")
    p_err = max(float((placed[k].full().detach() - p.detach()).abs().max())
                for k, p in single.named_parameters())
    l_err = max(abs(a - b) for a, b, _ in losses)
    want = 2 * 2 * tcfg.n_layers  # two data shards, forward + remat recompute per layer
    if not (l_err <= MESH_LOSS_ATOL and p_err <= MESH_PARAM_ATOL
            and all(n == want for n in m_launches)):
        raise AssertionError(f"{tag} starcoder2 mesh step: losses {losses}, params differ by "
                             f"{p_err}, flash launches per mesh step {m_launches} (want {want})")
    log(f"{tag} {power}: {tcfg.name} at full width, {tcfg.n_layers} layers, float32, "
        f"make_mesh_train_step over data=2 of [{card}] * 2 (FSDP tiles, each shard {Bt // 2} x "
        f"{St} tokens) vs make_train_step on one device, {n_steps} steps: losses (mesh, single) "
        f"{[(round(a, 6), round(b, 6)) for a, b, _ in losses]}, max diff {l_err:.3e} (atol "
        f"{MESH_LOSS_ATOL}); parameters after {n_steps} steps max abs diff {p_err:.3e} (atol "
        f"{MESH_PARAM_ATOL}); flash launches per step mesh {m_launches[-1]} (CUDA-core body, "
        f"float32), single {losses[-1][2]}; step ms mesh {[round(x, 1) for x in m_ms]}, single "
        f"{[round(x, 1) for x in s_ms]}")
    del single, sopt, placed, popt, batch
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the pipeline over [cuda:0] * 4 -------------------------------------------------------
    P, M, mb, d = 4, 6, 2, 16
    mesh_p = make_decode_mesh(f"pipe={P}", devices=[dev] * P)
    ws = torch.randn((P, d, d), generator=gen, device=dev) * 0.3
    x = torch.randn((M, mb, d), generator=gen, device=dev)
    out = pipeline_apply(lambda w, h: torch.tanh(h @ w), ws, x, mesh_p, axis="pipe")
    ref = x
    for s_ in range(P):
        ref = torch.tanh(ref @ ws[s_])
    pp_err = float((out - ref).abs().max())
    if not pp_err <= PIPE_ATOL:
        raise AssertionError(f"{tag} pipeline_apply vs sequential: {pp_err}")
    log(f"{tag} pipeline_apply P={P} M={M} microbatches of ({mb}, {d}) over [{card}] * {P}: "
        f"max abs diff {pp_err:.3e} from the sequential stages (atol {PIPE_ATOL}); bubble "
        f"fraction {bubble_fraction(P, M):.4f}")
    clock.lap("phase 28 lm mesh train and pipeline")
    return {"mesh prefill": pre_launches[1], "mesh train step": m_launches[-1]}


def position_ms(torch, fn):
    """``fn()`` with each model position's work in ``sharding.place.model_parts``
    (the computation of its slice, and on the first position the sum)
    bracketed by CUDA events: (fn's result, {grid position: ms})."""
    import contextlib

    from repro_torch.sharding import place

    real, marks = place.on_position, []

    @contextlib.contextmanager
    def timed(pos):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with real(pos):
            yield
        end.record()
        marks.append((tuple(pos), start, end))

    place.on_position = timed
    try:
        out = fn()
    finally:
        place.on_position = real
    torch.cuda.synchronize()
    ms: dict = {}
    for pos, start, end in marks:
        ms[pos] = ms.get(pos, 0.0) + start.elapsed_time(end)
    return out, ms


def tp_phases(torch, dev, counters, power: str, clock: PhaseClock) -> dict:
    """Phase 31 (tp): tensor parallelism over the ``model`` axis, meshes of
    the one card named n times (see the module docstring). Returns the
    flash launches of the split StarCoder2-3B prefill and the flash kernel's
    numbers at the per-position shapes."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch._unused import flash_attention as fa
    from repro_torch._unused.models import attention, lm, moe
    from repro_torch._unused.serve.serve_step import (greedy_generate, make_decode_step,
                                                      make_prefill_step)
    from repro_torch._unused.train.optimizer import AdamWConfig, adamw_init
    from repro_torch._unused.train.train_step import (make_mesh_train_step, make_train_step,
                                                      place_train_state)
    from repro_torch.launch.cost import WorkCounter
    from repro_torch.launch.mesh import DecodeMesh, make_local_mesh
    from repro_torch.sharding.rules import axis_rules

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    tag = "[31 tp]"
    gen = torch.Generator(device=dev).manual_seed(SEED + 31)
    shapes = []  # (Hkv_loc, G_loc) of each flash launch's queries
    real_flash = attention.flash_attention

    def seen(q, k, v, **kw):
        shapes.append((int(q.shape[2]), int(q.shape[3])))
        return real_flash(q, k, v, **kw)

    def mesh_of(model, data=1):
        return make_local_mesh(data=data, model=model, devices=[dev] * (data * model))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    attention.flash_attention = seen
    try:
        # ---- StarCoder2-3B at full depth, bf16, the serving layout over (1, 2) -----------
        full = get_config("starcoder2-3b")
        params = lm.init_params(full, generator=gen, device=dev)
        B, S = TP_PREFILL
        Bg, P, n_new = TP_GREEDY
        tokens = torch.randint(0, full.vocab, (B, S), generator=gen, device=dev)
        prompt = torch.randint(0, full.vocab, (Bg, P), generator=gen, device=dev)
        prefill = make_prefill_step(full)
        mesh2 = mesh_of(2)
        G = full.n_heads // full.n_kv_heads  # 12: G_loc over (1, 2); half of it over (1, 4)
        with axis_rules(mesh2):
            lay = lm.place_params(params, full, mesh2)
            views = (lay.groups[0][0]["l0"].mixer.wq.w.tiles[0, 1].data_ptr()
                     == params.groups[0][0]["l0"].mixer.wq.w[:, full.n_heads // 2:].data_ptr())
            prefill(lay, {"tokens": tokens[:, :256]})  # warm up
            zero()
            fa.launches = fa.tc_launches = 0
            shapes.clear()
            next2, pos_ms = position_ms(torch, lambda: prefill(lay, {"tokens": tokens}))
            pre_launches, pre_shapes, others = ((fa.launches, fa.tc_launches), list(shapes),
                                                read())
            pre_ms = statistics.median(timed(lambda: prefill(lay, {"tokens": tokens}))[1]
                                       for _ in range(3))
        prefill(params, {"tokens": tokens[:, :256]})
        next1 = prefill(params, {"tokens": tokens})
        one_ms = statistics.median(timed(lambda: prefill(params, {"tokens": tokens}))[1]
                                   for _ in range(3))
        want = 2 * full.n_layers
        if (pre_launches != (want, want) or pre_shapes != [(1, G)] * want or others
                or not views):
            raise AssertionError(f"{tag} starcoder2 split prefill: flash launches "
                                 f"{pre_launches} (want {want} on the tensor-core body), "
                                 f"(Hkv_loc, G_loc) {sorted(set(pre_shapes))}, decoder kernels "
                                 f"{others}, tiles are views {views}")
        meta_mesh = DecodeMesh([torch.device("meta")] * 2, (1, 2), ("data", "model"))
        meta = lm.init_params(full, device="meta")
        with axis_rules(meta_mesh), WorkCounter() as count:
            make_prefill_step(full)(lm.place_params(meta, full, meta_mesh), {
                "tokens": torch.empty((B, S), dtype=torch.int64, device="meta")})
        reduced = {pos: dict(t.collective_bytes) for pos, t in sorted(count.tallies.items())}
        flops = {pos: sum(t.flops.values()) for pos, t in sorted(count.tallies.items())}
        if any(set(c) != {"all-reduce"} for c in reduced.values()):
            raise AssertionError(f"{tag} counted collectives of the split prefill {reduced}: "
                                 f"want all-reduce only (no weight gathered)")
        log(f"{tag} {power}: {full.name} at full width and depth ({full.n_layers} layers), "
            f"random float32 weights, bf16 compute, the serving layout over data=1, model=2 of "
            f"[{dev}] * 2 (tiles are views of the weights: {views}): make_prefill_step on {B} x "
            f"{S} tokens, median of 3: {pre_ms:.1f} ms (one device {one_ms:.1f} ms); ms per "
            f"position (CUDA events around each position's slice, the first's sums included) "
            f"{ {k: round(v, 3) for k, v in pos_ms.items()} }; flash launches {pre_launches[0]} "
            f"({pre_launches[1]} on the tensor-core body), every one at (Hkv_loc, G_loc) = "
            f"{pre_shapes[0]}; counted per position on meta: FLOP "
            f"{ {k: f'{v:.6e}' for k, v in flops.items()} }, collective bytes {reduced}; next "
            f"tokens {next2.tolist()} (one device {next1.tolist()})")
        with axis_rules(mesh2):
            g2, g2_ms = timed(lambda: greedy_generate(lay, full, prompt, n_new))
        g1, g1_ms = timed(lambda: greedy_generate(params, full, prompt, n_new))
        steps = P + n_new
        log(f"{tag} {power}: {full.name} greedy_generate over (1, 2), bf16, {Bg} requests, "
            f"prompt {P}, {n_new} new tokens, the cache as kv_heads tiles: "
            f"{g2_ms / steps:.1f} ms a step (one device {g1_ms / steps:.1f} ms); "
            f"{int((g2 != g1).sum())} of {g2.numel()} tokens differ from one device's (bf16)")
        del lay, params, next1, next2, meta
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("phase 31 starcoder2 serving")

        # ---- 2 layers, float32, over (1, 2) and (1, 4) against (1, 1) ----------------------
        cfg2 = dataclasses.replace(full, n_layers=2, compute_dtype="float32")
        p2 = lm.init_params(cfg2, generator=gen, device=dev)
        with torch.no_grad():
            last1 = lm.apply_train(p2, {"tokens": tokens}, cfg2)[:, -1]
        gen1 = greedy_generate(p2, cfg2, prompt, n_new)
        for model in (2, 4):
            shapes.clear()
            with axis_rules(mesh_of(model)), torch.no_grad():
                lay2 = lm.place_params(p2, cfg2, mesh_of(model))
                lastm, m_ms = timed(lambda: lm.apply_train(lay2, {"tokens": tokens},
                                                           cfg2)[:, -1])
                genm = greedy_generate(lay2, cfg2, prompt, n_new)
            err = float((lastm - last1).abs().max())
            g_loc = G * 2 // model
            if not (shapes == [(1, g_loc)] * (model * cfg2.n_layers) and err <= TP_LOGIT_ATOL
                    and torch.equal(genm, gen1) and bool(torch.isfinite(lastm).all())):
                raise AssertionError(f"{tag} {cfg2.name} float32 over (1, {model}): flash "
                                     f"(Hkv_loc, G_loc) {shapes}, last logits differ by {err}, "
                                     f"greedy tokens equal {torch.equal(genm, gen1)}")
            how = ("kv heads split" if model == 2 else
                   "kv_heads 2 whole over 4 positions: each takes the kv head of its q heads")
            log(f"{tag} {power}: {cfg2.name} at full width, {cfg2.n_layers} layers, float32, "
                f"over (1, {model}) ({how}): flash launched per position at (Hkv_loc, G_loc) "
                f"= (1, {g_loc}), {len(shapes)} launches; last-position logits of {B} x {S} "
                f"tokens max abs diff {err:.3e} from (1, 1) (atol {TP_LOGIT_ATOL}), forward "
                f"{m_ms:.1f} ms; greedy tokens ({Bg} x {n_new}) equal to (1, 1)")
        del p2, lay2, last1, lastm
        gc.collect()
        torch.cuda.empty_cache()
        flash_split = [flash_at_prefill(torch, dev, gen, tag, f"{full.name} per position of "
                                        f"(1, {m})", power, B, S, 1, G * 2 // m,
                                        full.head_dim, full.sliding_window, want)
                       for m in (2, 4)]
        clock.lap("phase 31 starcoder2 float32 meshes")

        # ---- the mesh train step over (2, 2) against one device ---------------------------
        tcfg = dataclasses.replace(full, n_layers=2, compute_dtype="float32")
        Bt, St, n_steps = TP_TRAIN
        opt_cfg = AdamWConfig()  # lr 3e-6 at step 1 (warmup 100)
        single = lm.init_params(tcfg, generator=gen, device=dev).requires_grad_(True)
        mesh22 = mesh_of(2, data=2)
        placed, popt = place_train_state(single, tcfg, opt_cfg, mesh22)
        sopt = adamw_init(dict(single.named_parameters()), opt_cfg)
        s_step = make_train_step(tcfg, opt_cfg)
        m_step = make_mesh_train_step(tcfg, opt_cfg, mesh22)
        losses, m_ms, s_ms, m_launches = [], [], [], []
        for _ in range(n_steps):
            batch = {k: torch.randint(0, tcfg.vocab, (Bt, St), generator=gen, device=dev)
                     for k in ("tokens", "labels")}
            fa.launches = 0
            (placed, popt, mm), ms = timed(lambda: m_step(placed, popt, batch))
            m_ms.append(ms)
            m_launches.append(fa.launches)
            (single, sopt, sm), ms = timed(lambda: s_step(single, sopt, batch))
            s_ms.append(ms)
            losses.append((float(mm["loss"]), float(sm["loss"])))
        p_err = max(float((placed[k].full().detach() - p.detach()).abs().max())
                    for k, p in single.named_parameters())
        l_err = max(abs(a - b) for a, b in losses)
        want_launches = 2 * 2 * 2 * tcfg.n_layers  # data shards x positions x (forward, remat)
        if not (l_err <= MESH_LOSS_ATOL and p_err <= MESH_PARAM_ATOL
                and all(n == want_launches for n in m_launches)):
            raise AssertionError(f"{tag} mesh train step over (2, 2): losses {losses}, params "
                                 f"differ by {p_err}, flash launches {m_launches}")
        log(f"{tag} {power}: {tcfg.name} at full width, {tcfg.n_layers} layers, float32, "
            f"make_mesh_train_step over data=2, model=2 of [{dev}] * 4 (each data shard's "
            f"positions on their heads, MLP columns and vocabulary, tiles gathered along fsdp "
            f"only) vs make_train_step on one device, {n_steps} steps of {Bt} x {St}: losses "
            f"{[(round(a, 6), round(b, 6)) for a, b in losses]}, max diff {l_err:.3e} (atol "
            f"{MESH_LOSS_ATOL}); parameters max abs diff {p_err:.3e} (atol {MESH_PARAM_ATOL}); "
            f"flash launches per mesh step {m_launches[-1]}; step ms (2, 2) "
            f"{[round(x, 1) for x in m_ms]}, one device {[round(x, 1) for x in s_ms]}")
        del single, sopt, placed, popt, batch
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("phase 31 train step")

        # ---- Mixtral-8x22B at 2 layers: experts at rest (1, 4), TP within experts (1, 16) --
        mix = get_config("mixtral-8x22b")
        # capacity E/k: neither routing group (EP's whole batch, the dense path's rows)
        # drops an entry, so both paths compute the same function
        mcfg = dataclasses.replace(mix, n_layers=2, compute_dtype="float32",
                                   capacity_factor=mix.n_experts / mix.top_k)
        mp = lm.init_params(mcfg, generator=gen, device=dev)
        Bm, Sm, m_new = TP_MOE
        mtok = torch.randint(0, mcfg.vocab, (Bm, Sm), generator=gen, device=dev)
        prompt = torch.randint(0, mcfg.vocab, (Bg, P), generator=gen, device=dev)
        with axis_rules(mesh_of(1)), torch.no_grad():
            mlast1 = lm.apply_train(mp, {"tokens": mtok}, mcfg)[:, -1]
            mgen1 = greedy_generate(mp, mcfg, prompt, m_new)
        w1 = mp.groups[0][0]["l0"].ffn.wi
        for model in (4, 16):
            mesh = mesh_of(model)
            with axis_rules(mesh), torch.no_grad():
                mlay = lm.place_params(mp, mcfg, mesh)
                ep = moe._ep_enabled(mcfg)
                wi = mlay.groups[0][0]["l0"].ffn.wi
                f_loc = wi.tiles[0, 0].shape[-1]
                at_rest = all(wi.tiles[0, m].data_ptr() == (
                    w1[m * mcfg.n_experts // model] if ep else w1[:, :, m * f_loc:]).data_ptr()
                    for m in range(model))
                lastm, pre_ms = timed(lambda: lm.apply_train(mlay, {"tokens": mtok},
                                                             mcfg)[:, -1])
                step = make_decode_step(mcfg, P + m_new)
                cache = lm.init_cache(mcfg, Bg, P + m_new, torch.float32, device=dev)
                nxt, mem, step_ms = None, [], []
                for t in range(P + m_new):
                    tok = prompt[:, t:t + 1] if t < P else nxt[:, None]
                    (nxt, cache), ms = timed(lambda: step(mlay, tok, cache, t))
                    mem.append(torch.cuda.memory_allocated())
                    step_ms.append(ms)
                with WorkCounter() as count:
                    step(mlay, nxt[:, None], cache, P + m_new - 1)
                genm = greedy_generate(mlay, mcfg, prompt, m_new)
            gathered = sum(t.collective_bytes.get("all-gather", 0)
                           for t in count.tallies.values())
            err = float((lastm - mlast1).abs().max())
            grew = max(mem[1:]) - min(mem[1:])
            if not (bool(ep) == (model == 4) and at_rest and err <= TP_LOGIT_ATOL
                    and torch.equal(genm, mgen1) and grew <= TP_MEM_SLACK and gathered == 0):
                raise AssertionError(f"{tag} {mcfg.name} over (1, {model}): EP {ep}, tiles at "
                                     f"rest {at_rest}, last logits differ by {err}, greedy "
                                     f"tokens equal {torch.equal(genm, mgen1)}, allocated "
                                     f"bytes per step {sorted(set(mem))}, gathered {gathered}")
            how = (f"expert parallel, experts at rest ({mcfg.n_experts // model} a position, "
                   f"views of the weights)" if ep else
                   f"{mcfg.n_experts} experts do not divide {model}: tensor parallel within "
                   f"each expert, d_ff_expert {mcfg.d_ff_expert} -> {f_loc}, "
                   f"{mcfg.n_heads // model} heads a position, kv_heads {mcfg.n_kv_heads} whole")
            log(f"{tag} {power}: {mcfg.name} at full width, {mcfg.n_layers} layers, float32, "
                f"capacity factor {mcfg.capacity_factor} (no drops), over (1, {model}), {how}: "
                f"forward of {Bm} x {Sm} tokens {pre_ms:.1f} ms, last-position logits max abs "
                f"diff {err:.3e} from (1, 1) (atol {TP_LOGIT_ATOL}); {Bg} requests, {P} + "
                f"{m_new} decode steps, median {statistics.median(step_ms):.1f} ms a step, "
                f"{mem[-1] / 1e9:.3f} GB allocated, {grew} B apart over the steps from the "
                f"second (at most {TP_MEM_SLACK}); a counted step gathers {gathered} bytes; "
                f"greedy tokens equal to (1, 1)")
            del mlay, cache, lastm
            gc.collect()
            torch.cuda.empty_cache()
        del mp, w1, mlast1
        gc.collect()
        torch.cuda.empty_cache()
        clock.lap("phase 31 mixtral")
    finally:
        attention.flash_attention = real_flash
    return {"prefill": pre_launches[0], "flash": flash_split}


def tp_mixer_phases(torch, dev, counters, power: str, clock: PhaseClock) -> None:
    """Phase 32 (tp mixers): MLA, Mamba and RWKV-6's time mix split over the
    ``model`` axis, meshes of the one card named n times (see the module
    docstring)."""
    import dataclasses
    import gc

    from repro_torch.configs.base import get_config
    from repro_torch._unused.models import attention, blocks, lm, ssm
    from repro_torch._unused.serve.serve_step import greedy_generate, make_prefill_step
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.place import Placed
    from repro_torch.sharding.rules import axis_rules

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in float32
    torch.backends.cudnn.allow_tf32 = False
    zero, read = counter_fns(torch, counters)
    tag = "[32 tp mixers]"
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    splits = {"mla": attention.mla_heads_split, "mamba": ssm.mamba_split,
              "rwkv6": ssm.rwkv_heads_split}

    def mesh_of(model):
        return make_local_mesh(data=1, model=model, devices=[dev] * model)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # ---- one full-width float32 layer of each mixer over (1, n) against (1, 1) ------------
    B, S = TPM_LAYER
    for name, mixer, models in (("deepseek-v2-236b", "mla", (2, 4)),
                                ("jamba-v0.1-52b", "mamba", (2, 4)),
                                ("rwkv6-3b", "rwkv6", (2, 4, 8, 16))):
        cfg = dataclasses.replace(get_config(name), compute_dtype="float32")
        gi, key, desc = next((gi, f"l{i}", d) for gi, (pattern, _) in enumerate(cfg.layer_list)
                             for i, d in enumerate(pattern) if d.mixer == mixer)
        p = blocks._MIXER_INIT[mixer](cfg, gen=gen, device=dev)
        with torch.no_grad():  # no constant vectors: the mixes, bonus, groupnorm, skip, bias
            if mixer == "rwkv6":
                p.mu.uniform_(0, 1, generator=gen)
                p.u.normal_(generator=gen).mul_(0.5)
                p.ln_scale.normal_(generator=gen).mul_(0.2).add_(1)
                p.ln_bias.normal_(generator=gen).mul_(0.2)
                p.w0.uniform_(-6, -1, generator=gen)
            elif mixer == "mamba":
                p.D.normal_(generator=gen)
                p.conv_b.normal_(generator=gen).mul_(0.2)
        axes = dict(lm._flat(blocks._MIXER_AXES[mixer](cfg)))
        x = torch.randn((B, S, cfg.d_model), generator=gen, device=dev)
        pos = torch.arange(S, device=dev)
        xs = [torch.randn((B, 1, cfg.d_model), generator=gen, device=dev)
              for _ in range(TPM_DECODE)]

        def run(layer, model):
            def apply(x_, **kw):
                return blocks._apply_mixer(layer, x_, cfg, desc, causal=True,
                                           ctx_parallel=False, **kw)[0:2]

            with axis_rules(mesh_of(model)), torch.no_grad():
                apply(x[:, :128], positions=pos[:128], cache=None, cache_len=None)  # warm up
                ((out, _), pos_ms), pre_ms = timed(lambda: position_ms(torch, lambda: apply(
                    x, positions=pos, cache=None, cache_len=None)))
                cache = lm.init_cache(cfg, B, TPM_DECODE, torch.float32,
                                      device=dev)["groups"][gi][0][key]["mixer"]
                laid = sum(isinstance(t, Placed) for t in cache)
                outs, dec_ms = [], []
                for t in range(TPM_DECODE):
                    (o, cache), ms = timed(lambda: apply(xs[t], positions=pos[t:t + 1],
                                                         cache=cache, cache_len=t))
                    outs.append(o)
                    dec_ms.append(ms)
            states = [t.full() if isinstance(t, Placed) else t for t in cache]
            return out, torch.cat(outs, 1), states, pre_ms, pos_ms, dec_ms, laid

        one = run(p, 1)
        for model in models:
            mesh = mesh_of(model)
            with axis_rules(mesh):
                n = splits[mixer](cfg)
                layer = lm.place_module(p, axes, cfg, mesh)
            width = {"mla": cfg.n_heads, "mamba": cfg.mamba_d_inner,
                     "rwkv6": cfg.d_model // cfg.rwkv_head_dim}[mixer]
            want_n = model if width % model == 0 else 1
            out, dec, states, pre_ms, pos_ms, dec_ms, laid = run(layer, model)
            errs = (float((out - one[0]).abs().max()), float((dec - one[1]).abs().max()),
                    max(float((a - b).abs().max()) for a, b in zip(states, one[2])))
            if n == 1:  # the whole path: the one-device mixer, bit for bit, nothing laid
                ok = (torch.equal(out, one[0]) and torch.equal(dec, one[1]) and laid == 0
                      and not any(isinstance(t, Placed) for t in layer.parameters()))
                how = (f"{width} heads do not divide {model}: the whole path, bit-equal to "
                       f"(1, 1) {ok}")
            else:
                lead = {"mla": "wuq", "mamba": "in_proj", "rwkv6": "wr"}[mixer]
                views = (getattr(layer, lead).w.tiles[0, 1].data_ptr()  # position 1's columns
                         == getattr(p, lead).w[:, width // model:].data_ptr())
                ok = views and laid > 0 and max(errs) <= TP_LOGIT_ATOL
                what = f"d_inner {width}" if mixer == "mamba" else f"{width} heads"
                how = (f"{what} split {n} ways, tiles views of the weights {views}, "
                       f"{laid} cache leaves laid per position")
            if not (ok and n == want_n and all(e == e for e in errs)):
                raise AssertionError(f"{tag} {cfg.name} {mixer} over (1, {model}): {n} ways "
                                     f"(want {want_n}), prefill / decode / state max abs diff "
                                     f"{errs} (atol {TP_LOGIT_ATOL}), {how}")
            log(f"{tag} {power}: {cfg.name}'s {mixer} layer at full width, float32, over (1, "
                f"{model}) ({how}): prefill of {B} x {S} tokens {pre_ms:.1f} ms ((1, 1) "
                f"{one[3]:.1f} ms), ms per position "
                f"{ {k[1]: round(v, 3) for k, v in pos_ms.items()} }, max abs diff "
                f"{errs[0]:.3e} from (1, 1); {TPM_DECODE} decode steps from an empty cache: "
                f"median {statistics.median(dec_ms):.2f} ms a step ((1, 1) "
                f"{statistics.median(one[5]):.2f}), outputs {errs[1]:.3e} and states "
                f"{errs[2]:.3e} from (1, 1) (atol {TP_LOGIT_ATOL})")
            del layer, out, dec, states
        del p, one, x, xs
        free()
    clock.lap("phase 32 tp mixer layers")

    # ---- RWKV6-3B at full depth, bf16, the serving layout over (1, 4) ----------------------
    full = get_config("rwkv6-3b")
    params = lm.init_params(full, generator=gen, device=dev)
    Bp, Sp = TPM_RWKV_PREFILL
    tokens = torch.randint(0, full.vocab, (Bp, Sp), generator=gen, device=dev)
    prefill = make_prefill_step(full)
    mesh4 = mesh_of(4)
    with axis_rules(mesh4):
        lay = lm.place_params(params, full, mesh4)
        n = ssm.rwkv_heads_split(full)
        prefill(lay, {"tokens": tokens[:, :256]})  # warm up
        zero()
        (nxt, pos_ms), pre_ms = timed(lambda: position_ms(
            torch, lambda: prefill(lay, {"tokens": tokens})))
        others = read()
    if n != 4 or others:
        raise AssertionError(f"{tag} {full.name} serving prefill over (1, 4): heads split {n} "
                             f"ways, decoder kernels {others}")
    one_ms = MEASURED.get(f"{full.name} prefill_ms")
    mixers = {k[1]: round(v, 3) for k, v in pos_ms.items()}
    H = full.d_model // full.rwkv_head_dim
    log(f"{tag} {power}: {full.name} at full width and depth ({full.n_layers} layers), random "
        f"float32 weights, bf16 compute, the serving layout over (1, 4) ({H} heads, {H // 4} a "
        f"position): make_prefill_step on {Bp} x {Sp} tokens {pre_ms:.1f} ms (one device in "
        f"phase 25 of this run: "
        f"{'not measured' if one_ms is None else f'{one_ms:.1f} ms'}); ms per position by CUDA "
        f"events (its slices of the time mix and the channel mix, the first's sums and whole "
        f"work included) {mixers}; next tokens {nxt.tolist()}")
    del lay, params, tokens, nxt
    free()
    clock.lap("phase 32 rwkv6-3b serving")

    # ---- DeepSeek-V2 and RWKV6-3B at 2 layers, float32: greedy over (1, 4) vs (1, 1) -------
    Bg, P, n_new = TPM_GREEDY
    for name in ("deepseek-v2-236b", "rwkv6-3b"):
        base = get_config(name)
        kw = dict(n_layers=2, compute_dtype="float32")
        if base.n_experts:  # capacity E/k: EP over (1, 4) and over (1, 1) drop nothing
            kw["capacity_factor"] = base.n_experts / base.top_k
        cfg = dataclasses.replace(base, **kw)
        params = lm.init_params(cfg, generator=gen, device=dev)
        prompt = torch.randint(0, cfg.vocab, (Bg, P), generator=gen, device=dev)
        runs = {}
        for model in (1, 4):
            mesh = mesh_of(model)
            with axis_rules(mesh), torch.no_grad():
                lay = lm.place_params(params, cfg, mesh)
                last = lm.apply_train(lay, {"tokens": prompt}, cfg)[:, -1]
                toks, ms = timed(lambda: greedy_generate(lay, cfg, prompt, n_new))
                ways = sorted(blocks.split_mixers(cfg))
            runs[model] = (last, toks, ms, ways)
            del lay
        err = float((runs[4][0] - runs[1][0]).abs().max())
        if not (torch.equal(runs[4][1], runs[1][1]) and err <= TP_LOGIT_ATOL
                and runs[4][3] == [base.layer_list[0][0][0].mixer]):
            raise AssertionError(f"{tag} {cfg.name} at 2 layers over (1, 4): split mixers "
                                 f"{runs[4][3]}, last logits differ by {err}, greedy tokens "
                                 f"equal {torch.equal(runs[4][1], runs[1][1])}")
        steps = P + n_new
        log(f"{tag} {power}: {cfg.name} at full width, 2 layers, float32"
            f"{', capacity E/k' if base.n_experts else ''}, the serving layout over (1, 4) "
            f"(split: {runs[4][3]}): last-position logits of {Bg} x {P} tokens max abs diff "
            f"{err:.3e} from (1, 1) (atol {TP_LOGIT_ATOL}); greedy_generate ({Bg} requests, "
            f"prompt {P}, {n_new} new) equal to (1, 1); {runs[4][2] / steps:.1f} ms a step "
            f"((1, 1) {runs[1][2] / steps:.1f})")
        del params, runs
        free()
    clock.lap("phase 32 greedy")


class DryRuns:
    """The ``DRYRUNS`` of ``repro_torch.launch.dryrun``, one subprocess each
    at the lowest CPU priority with one thread, at most ``DRYRUN_AT_ONCE``
    at a time (they count on meta tensors and touch no card, and share the
    host with the phases' host clocks), in ``DRYRUNS`` order from two
    feeder threads; reports and output under ``build/dryrun/``. ``wait``
    collects them, ``stop`` kills what still runs and starts nothing more."""

    def __init__(self):
        root = Path(__file__).resolve().parent
        self.dir = root / "build" / "dryrun"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1"}
        self.root, self.t0 = root, time.perf_counter()
        self.todo = list(DRYRUNS)
        self.procs, self.rcs, self.stopped = {}, {}, False
        self.lock = threading.Lock()
        self.feeders = [threading.Thread(target=self._feed, daemon=True)
                        for _ in range(DRYRUN_AT_ONCE)]
        for t in self.feeders:
            t.start()

    def _name(self, label: str) -> str:
        return label.replace("MOE", DRYRUN_MOE).replace(" ", "_")

    def _feed(self) -> None:
        while True:
            with self.lock:
                if self.stopped or not self.todo:
                    return
                label, knobs, argv = self.todo.pop(0)
                argv = [a.replace("MOE", DRYRUN_MOE) for a in argv]
                if argv[0] != "--viterbi":
                    argv += ["--out", str(self.dir / f"{self._name(label)}.json")]
                with open(self.dir / f"{self._name(label)}.log", "w") as log_file:
                    proc = self.procs[label] = subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
                        cwd=self.root, env={**self.env, **knobs}, stdout=log_file,
                        stderr=subprocess.STDOUT, preexec_fn=lambda: os.nice(19))
            self.rcs[label] = proc.wait()

    def wait(self, timeout: float) -> dict:
        """Each run's report (the viterbi run: its single-pod int8 report),
        after waiting at most ``timeout`` seconds in all; a run that fails or
        has not finished raises."""
        deadline = time.perf_counter() + timeout
        for t in self.feeders:
            t.join(timeout=max(0.0, deadline - time.perf_counter()))
        reports = {}
        for label, _, _ in DRYRUNS:
            if label not in self.rcs:
                raise AssertionError(f"[29 dryrun] {label} has not finished after "
                                     f"{time.perf_counter() - self.t0:.0f} s")
            out = self.dir / f"{self._name(label)}.json"
            if label == "viterbi":
                out = self.root / "reports" / "torch_dryrun" / \
                    "viterbi-ccsds__stream_16m_int8__pod16x16.json"
            if self.rcs[label] or not out.exists():
                tail = (self.dir / f"{self._name(label)}.log").read_text()[-2000:]
                raise AssertionError(f"[29 dryrun] {label} exited {self.rcs[label]}: {tail}")
            reports[label.replace("MOE", DRYRUN_MOE)] = json.loads(out.read_text())
        return reports

    def stop(self) -> None:
        with self.lock:
            self.stopped = True
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def dryrun_phases(torch, dryruns: DryRuns, power: str, clock: PhaseClock) -> None:
    """Phase 29: the dry-runs' reports, and the work the earlier phases'
    timed calls do, counted on meta tensors (``launch/cost.py``) and
    divided by the times those phases measured.

    ``[29 dryrun]``: each ``DRYRUNS`` report's counted FLOPs, bytes,
    collective bytes and argument GB of its busiest mesh position; K1's and
    K2's counted work at 8,192 blocks of int8 CCSDS symbols equal to the
    bounds' inputs (``PERF.md`` §6 rows 1 and 4), and the decoder report's
    K1 and K2 equal to the same formulas at its lane shard's width.
    ``[29 roofline]``: phase 6's decode from framed blocks (4,194,304 bits,
    ``"cuda"``) and phase 17's StarCoder2-3B prefill (2 × 8192 tokens, 30
    flash launches of the band's FLOPs), each count's bound over the phase's
    time; a share above 1.0 fails."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.trellis import CCSDS_27
    from repro_torch.kernels.ops import pbvd_decode_blocks
    from repro_torch.launch.cost import WorkCounter
    from repro_torch._unused.models import lm
    from repro_torch._unused.serve.serve_step import make_prefill_step

    t0 = time.perf_counter()
    reports = dryruns.wait(timeout=240.0)
    for label, r in reports.items():
        c = r["count"]
        knobs = (f"REPRO_MOE_RULES={r['moe_rules']}, REPRO_REMAT={r['remat']}"
                 if "moe_rules" in r else "backend cuda")
        log(f"[29 dryrun] {label} ({r['arch']} × {r['shape']} × {r['mesh']}, {knobs}): "
            f"busiest position "
            f"{c['busiest_position']} of {c['positions_with_work']} with work: "
            f"{c['flops_per_device']:.6e} FLOP {c['flops_per_device_by_dtype']}, "
            f"{c['bytes_per_device']:.6e} B, collective {c['collective_bytes_per_device']} "
            f"(counts {c['collective_counts']}), args "
            f"{r['memory']['argument_size_in_bytes'] / 1e9:.3f} GB; dry-run {r['total_s']} s")
    want = {"acs_forward (K1)": k1_cost(CCSDS_27, 596, 8192, 1),
            "traceback (K2)": k2_cost(596, 8192, 42, 512)}
    blocks = torch.empty((596, 2, 8192), dtype=torch.int8, device="meta")
    with WorkCounter() as decode_count:
        pbvd_decode_blocks(blocks, CCSDS_27, decode_start=42, n_decode=512, backend="cuda")
    got = {k: (v["bytes"], v["ops"]) for k, v in decode_count.total().kernels.items()}
    vit = reports["viterbi"]["count"]["kernels_per_device"]
    shard = reports["viterbi"]["count"]["kernels_per_device"]["acs_forward (K1)"]["bytes"]
    width = 32768 // 16
    vit_want = {"acs_forward (K1)": k1_cost(CCSDS_27, 596, width, 1),
                "traceback (K2)": k2_cost(596, width, 42, 512)}
    if (got != want or {k: (v["bytes"], v["ops"]) for k, v in vit.items()} != vit_want
            or got["acs_forward (K1)"] != (50_921_472.0, 1_259_667_456.0)
            or got["traceback (K2)"][0] != 34_930_688.0):
        raise AssertionError(f"[29 dryrun] counted decoder work {got} (want {want}); the "
                             f"report's lane shard {vit} (want {vit_want})")
    log(f"[29 dryrun] counted at 8,192 blocks, R = 2, int8: K1 {got['acs_forward (K1)'][0]:.0f} "
        f"B and {got['acs_forward (K1)'][1]:.0f} int32 op, K2 {got['traceback (K2)'][0]:.0f} B: "
        f"the bounds' inputs (PERF.md §6 rows 1, 4); the stream_16m_int8 report's lane shard "
        f"({width} blocks) K1 {shard:.0f} B, equal to the same formulas")
    clock.lap("phase 29 dryrun")

    shares = []
    k1_b = got["acs_forward (K1)"]
    k2_b = got["traceback (K2)"]
    k1_bound = bound(*k1_b, INT32_OPS_PER_S)[0]
    k2_bound = bound(*k2_b, INT32_OPS_PER_S)[0]
    dec_bound = decode_count.total().bound_s() * 1e3
    shares += [("K1", k1_bound, MEASURED["k1_ms"]), ("K2", k2_bound, MEASURED["k2_ms"]),
               ("decode from framed blocks (phase 6's dispatch+K1+K2)", dec_bound,
                MEASURED["decode_ms"])]
    cfg = get_config("starcoder2-3b")
    params = lm.init_params(cfg, device="meta")  # float32 at rest, as phase 16's
    batch = {"tokens": torch.empty((LM_BATCH, LM_SEQ), dtype=torch.int64, device="meta")}
    with WorkCounter() as prefill_count:
        make_prefill_step(cfg)(params, batch)
    tot = prefill_count.total()
    flash = tot.kernels.get("flash_attention", {})
    want_flash = flash_cost(LM_BATCH, LM_SEQ, LM_SEQ, cfg.n_kv_heads,
                            cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, True,
                            cfg.sliding_window, 2)
    if (flash.get("launches") != cfg.n_layers or flash.get("kind") != "bf16"
            or flash["ops"] != cfg.n_layers * want_flash[1]):
        raise AssertionError(f"[29 roofline] counted prefill flash {flash}, want {cfg.n_layers} "
                             f"bf16 launches of {want_flash[1]:.6e} FLOP")
    flash_bound = bound(want_flash[0], want_flash[1], BF16_FLOPS_PER_S)[0]
    shares += [("flash_attention (one prefill launch)", flash_bound, MEASURED["flash_ms"]),
               ("StarCoder2-3B prefill (phase 17)", tot.bound_s() * 1e3, MEASURED["prefill_ms"])]
    log(f"[29 roofline] {power}: counted StarCoder2-3B prefill {LM_BATCH} x {LM_SEQ}: "
        f"{sum(tot.flops.values()):.6e} FLOP {dict(tot.flops)}, {tot.bytes:.6e} B; flash "
        f"{flash['launches']} launches of {want_flash[1]:.6e} FLOP (the band at phase 17's "
        f"shapes); decode: {dict(decode_count.total().flops)} op, {decode_count.bytes:.6e} B")
    for what, b_ms, t_ms in shares:
        share = b_ms / t_ms
        log(f"[29 roofline] {power}: {what}: counted bound {b_ms:.4f} ms over {t_ms:.4f} ms "
            f"measured = {share:.1%} of the roofline")
        if share > 1.0:
            raise AssertionError(f"[29 roofline] {what}: the bound {b_ms} ms is above the "
                                 f"measured {t_ms} ms: the count or the peak is wrong")
    log(f"[29 roofline] counted in {time.perf_counter() - t0:.1f} s (the dry-runs' wait "
        f"included)")
    clock.lap("phase 29 roofline")


def main() -> int:
    clock = PhaseClock()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing to check", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 2

    dryruns = DryRuns()  # CPU only: they run while the build and the card's phases do
    try:
        return checked_main(torch, clock, dryruns)
    finally:
        dryruns.stop()


def checked_main(torch, clock, dryruns) -> int:
    from repro_torch.core.channel import bpsk, transmit
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.encoder import encode
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.core.trellis import ConvCode
    from repro_torch.core.quantize import norm_interval
    from repro_torch.kernels import _build, acs, fused, traceback
    from repro_torch.kernels.ops import pbvd_decode_blocks

    dev = torch.device(DEVICE)
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[1 build] nvcc built {built} in {time.perf_counter() - t0:.2f} s "
        f"(flags {' '.join(_build.NVCC_FLAGS)})")

    clock.lap("phase 1 build")
    # ---- 2. K1 against its plain version ---------------------------------------
    ccsds = get_code_spec("ccsds").code
    k5 = ConvCode(polys=((1, 0, 0, 1, 1), (1, 1, 1, 0, 1)))  # (2,1,5), N = 16
    T = PBVDConfig().T
    k1_err = 0.0
    k1_cases = [
        ("ccsds main", ccsds, torch.int8, N_MAIN_BLOCKS),  # the main path's shapes
        ("ccsds", ccsds, torch.int8, 1024),
        ("ccsds float", ccsds, torch.float32, 256),
        ("is95-k9", get_code_spec("is95-k9").code, torch.int8, 256),
        ("lte-1/3", get_code_spec("lte-1/3").code, torch.int8, 256),
        ("ccsds ragged", ccsds, torch.int16, 1001),
        ("(2,1,5)", k5, torch.int8, 77),
    ]
    sp_keep = {}
    for label, code, dtype, B in k1_cases:
        if dtype == torch.float32:
            y = torch.randn((T, code.R, B), generator=gen, device=dev) * 2.0
        else:
            y = torch.randint(-127, 128, (T, code.R, B), generator=gen, device=dev).to(dtype)
        sp_k, pm_k = acs.acs_forward(y, code)
        torch.cuda.synchronize()
        sp_p, pm_p = acs.acs_forward_plain(y, code)
        torch.cuda.synchronize()
        if not torch.equal(sp_k, sp_p):
            bad = int((sp_k != sp_p).sum())
            raise AssertionError(f"K1 {label} {dtype}: {bad} survivor words differ")
        err = float((pm_k.double() - pm_p.double()).abs().max())
        if dtype == torch.float32:
            ok = torch.allclose(pm_k, pm_p, rtol=1e-6, atol=0.0)
        else:
            ok = torch.equal(pm_k, pm_p)
        if not ok:
            raise AssertionError(f"K1 {label} {dtype}: path metrics differ (max abs {err})")
        k1_err = max(k1_err, err)
        sp_keep[label] = (code, sp_k, pm_k)
        log(f"[2 K1] {label:13s} {str(dtype):14s} T={T} B={B}: sp equal, pm max abs err {err}")

    # every instantiated mother code at each S variant of the warp body, and
    # the runtime-table body; ragged, tiny and one-stage batches, odd T at
    # radix 4, the narrow modes over many normalization intervals. Each
    # launch is counted on the body the code chose.
    is95, lte = get_code_spec("is95-k9").code, get_code_spec("lte-1/3").code
    i8, i16, f32 = torch.int8, torch.int16, torch.float32
    body_cases = []  # label, code, symbol dtype, B, T, mode, radix, S
    for label, code in (("ccsds", ccsds), ("is95-k9", is95), ("lte-1/3", lte)):
        for S in acs.warp_states(code):
            body_cases += [(label, code, i8, N_MAIN_BLOCKS + 17, T, "f32", 2, S),
                           (label, code, i16, 5, T + 1, "i16", 4, S),
                           (label, code, i8, 1001, T, "i8", 2, S),
                           (label, code, i8, 300, 97, "i8", 4, S),
                           (label, code, f32, 33, 1, "f32", 2, S),
                           (label, code, f32, 40, T + 1, "f32", 4, S)]
    body_cases += [("(2,1,5)", k5, i16, 5, T + 1, "i16", 4, None),
                   ("(2,1,5)", k5, i8, N_MAIN_BLOCKS + 17, T, "f32", 2, None),
                   ("(2,1,5)", k5, f32, 33, 1, "f32", 2, None),
                   ("(2,1,5)", k5, i8, 300, 97, "i8", 2, None)]
    k1_err_r4 = 0.0
    for label, code, dtype, B, Tc, mode, radix, S in body_cases:
        body = acs.kernel_body(code)
        tag = (f"{label:8s} {body} body S={S} {str(dtype):13s} T={Tc} B={B} {mode} r{radix}")
        try:
            norm_every = norm_interval(code, mode, radix)
        except ValueError as err:
            log(f"[2 refused] {tag}: {err}")
            continue
        if dtype == f32:
            y2 = torch.randn((Tc, code.R, B), generator=gen, device=dev) * 2.0
        else:
            y2 = torch.randint(-127, 128, (Tc, code.R, B), generator=gen, device=dev).to(dtype)
        acs.launches = acs.table_launches = 0
        sp_k, pm_k = acs.acs_forward(y2, code, mode, radix, states_per_thread=S)
        torch.cuda.synchronize()
        if (acs.launches, acs.table_launches) != (1, int(body == "table")):
            raise AssertionError(f"K1 {tag}: launches {acs.launches}, table body "
                                 f"{acs.table_launches}")
        sp_p, pm_p = acs.acs_forward_plain(y2, code, mode, radix)
        if not torch.equal(sp_k, sp_p):
            raise AssertionError(f"K1 {tag}: {int((sp_k != sp_p).sum())} survivor words differ")
        if not torch.equal(pm_k, pm_p.to(pm_k.dtype)):
            raise AssertionError(f"K1 {tag}: path metrics differ")
        err = float((pm_k.double() - pm_p.double()).abs().max())
        if radix == 4:
            k1_err_r4 = max(k1_err_r4, err)
        else:
            k1_err = max(k1_err, err)
        n_norm = (Tc // (radix // 2)) // norm_every if norm_every else 0
        log(f"[2 K1] {tag}: sp and pm equal (launches {acs.launches}, table body "
            f"{acs.table_launches}; {n_norm} normalizations)")

    clock.lap("phase 2 K1")
    # ---- 3. K2 against its plain version ---------------------------------------
    L, D = PBVDConfig().L, PBVDConfig().D
    k2_err = 0.0
    for label in ("ccsds main", "ccsds", "is95-k9", "ccsds ragged", "(2,1,5)"):
        code, sp, pm = sp_keep[label]
        B = sp.shape[2]
        starts = {
            "zero": 0,
            "argmin": torch.argmin(pm, dim=0).to(torch.int32),
            "random": torch.randint(0, code.n_states, (B,), generator=gen, device=dev,
                                    dtype=torch.int32),
        }
        for policy, start in starts.items():
            bits_k = traceback.traceback(sp, code, L, D, start)
            torch.cuda.synchronize()
            bits_p = traceback.traceback_plain(sp, code, L, D, start)
            torch.cuda.synchronize()
            if not torch.equal(bits_k, bits_p):
                raise AssertionError(f"K2 {label} {policy}: {int((bits_k != bits_p).sum())} bits differ")
            k2_err = max(k2_err, float((bits_k - bits_p).abs().max()))
            log(f"[3 K2] {label:13s} start={policy:6s} B={B}: bits equal")
    # the staged walk at every W it is built for (N = 4 ... 1024 states): any
    # int32 words are a survivor history; ragged batches (the last warp part
    # filled), decode_start 0 and > 0, one-stage blocks; both routes where B
    # % 4 == 0 (TMA, the default there, and cp.async), cp.async elsewhere
    for n_states in (4, 32, 64, 128, 256, 512, 1024):
        code = ConvCode(polys=((1,) + (0,) * (n_states.bit_length() - 2) + (1,),
                               (1,) * n_states.bit_length()))
        W = max(1, n_states // 32)
        for Tc, B, ds, nd in ((T, N_MAIN_BLOCKS, L, D), (T, N_MAIN_BLOCKS + 17, L, D),
                              (T, 1001, 0, D), (97, 36, 30, 60), (97, 5, 30, 60), (1, 32, 0, 1),
                              (1, 33, 0, 1)):
            sp = torch.randint(-2 ** 31, 2 ** 31 - 1, (Tc, W, B), generator=gen, device=dev,
                               dtype=torch.int32)
            pm = torch.randint(0, 3, (n_states, B), generator=gen, device=dev)
            starts = {"zero": 0, "argmin": torch.argmin(pm, dim=0).to(torch.int32),
                      "random": torch.randint(0, n_states, (B,), generator=gen, device=dev,
                                              dtype=torch.int32)}
            routes = ("tma", "cp.async") if B % 4 == 0 else ("cp.async",)
            for policy, start in starts.items():
                bits_p = traceback.traceback_plain(sp, code, ds, nd, start)
                for route in routes:
                    traceback.launches = 0
                    bits_k = (traceback.traceback(sp, code, ds, nd, start) if route == routes[0]
                              else traceback._staged_walk(sp, code, ds, nd, start, route))
                    torch.cuda.synchronize()
                    if traceback.launches != 1 or not torch.equal(bits_k, bits_p):
                        raise AssertionError(
                            f"K2 {route} N={n_states} T={Tc} B={B} window [{ds}, {ds + nd}) "
                            f"{policy}: {int((bits_k != bits_p).sum())} bits differ, "
                            f"{traceback.launches} launches")
            log(f"[3 K2] staged walk N={n_states:4d} W={W:2d} ({traceback.stage_chunk(W)} "
                f"stages per slot) T={Tc} B={B} window [{ds}, {ds + nd}), {' and '.join(routes)}: "
                f"bits equal for zero, argmin and random starts")

    clock.lap("phase 3 K2")
    # ---- 4. main path ----------------------------------------------------------
    cfg = PBVDConfig()
    n_bits = N_MAIN_BLOCKS * cfg.D
    payload = torch.randint(0, 2, (n_bits,), generator=gen, device=dev, dtype=torch.int32)
    flushed = torch.cat([payload, payload.new_zeros(cfg.code.v)])
    coded = encode(flushed, cfg.code)
    y = transmit(gen, coded, EBN0_DB, cfg.codespec.rate)
    engine = DecoderEngine(cfg, device=dev)
    engine.decode(y[: 4 * cfg.D], 4 * cfg.D)  # first call loads the kernels
    torch.cuda.synchronize()
    acs.launches = acs.table_launches = traceback.launches = 0
    bits = engine.decode(y, n_bits)
    torch.cuda.synchronize()
    main_launches = {"acs": acs.launches, "traceback": traceback.launches}
    if min(main_launches.values()) < 1 or acs.table_launches:
        raise AssertionError(f"main path did not launch every kernel on the warp body: "
                             f"{main_launches}, table body {acs.table_launches}")
    ref_bits = DecoderEngine(PBVDConfig(backend="ref"), device=dev).decode(y, n_bits)
    if bits.shape != (n_bits,) or bits.dtype != torch.int32 or not torch.equal(bits, ref_bits):
        raise AssertionError("main path: backend='cuda' differs from backend='ref'")
    ber = float((bits != payload).double().mean())
    if ber > 1e-4:  # 8-bit soft decisions on this code give ~1e-5 at 4 dB
        raise AssertionError(f"BER {ber:.3e} at {EBN0_DB} dB is above 1e-4")
    noiseless = engine.decode(bpsk(coded), n_bits)
    n_err0 = int((noiseless != payload).sum())
    if n_err0:
        raise AssertionError(f"noiseless stream decoded with {n_err0} errors")
    log(f"[4 main] {n_bits} bits, CCSDS D={cfg.D} L={cfg.L} q={cfg.q}: cuda == ref bit for bit; "
        f"launches {main_launches}; BER at {EBN0_DB} dB = {ber:.3e} "
        f"({int((bits != payload).sum())} errors); noiseless errors = 0")

    clock.lap("phase 4 main")
    # ---- 5. serving path -------------------------------------------------------
    pay = torch.randint(0, 2, (N_STREAMS, STREAM_BITS), generator=gen, device=dev,
                        dtype=torch.int32)
    pay = torch.cat([pay, pay.new_zeros((N_STREAMS, cfg.code.v))], dim=1)
    ys = list(transmit(gen, encode(pay, cfg.code), EBN0_DB, cfg.codespec.rate))
    acs.launches = traceback.launches = 0
    batch = engine.decode_batch(ys, [STREAM_BITS] * N_STREAMS)
    torch.cuda.synchronize()
    batch_launches = {"acs": acs.launches, "traceback": traceback.launches}
    if batch_launches != {"acs": 1, "traceback": 1}:
        raise AssertionError(f"decode_batch launched {batch_launches}, expected one of each")
    for i, (yi, bi) in enumerate(zip(ys, batch)):
        if not torch.equal(bi, engine.decode(yi, STREAM_BITS)):
            raise AssertionError(f"decode_batch stream {i} differs from decode")
    ragged = [ys[0][:1000], ys[1][:5000], ys[2][:4096], ys[3]]
    ragged_bits = [700, None, 4096, 30000]
    for i, (yi, bi) in enumerate(zip(ragged, engine.decode_batch(ragged, ragged_bits))):
        if not torch.equal(bi, engine.decode(yi, ragged_bits[i])):
            raise AssertionError(f"ragged decode_batch stream {i} differs from decode")
    log(f"[5 serve] decode_batch {N_STREAMS} x {STREAM_BITS} bits == per-stream decode "
        f"(launches {batch_launches}); ragged fleet of 4 == per-stream decode")

    clock.lap("phase 5 serve")
    # ---- 6. times --------------------------------------------------------------
    blocks, n_blocks, _ = engine._frame_one(y, n_bits)
    sp, pm = acs.acs_forward(blocks, cfg.code)
    sp_p, pm_p = acs.acs_forward_plain(blocks, cfg.code)
    bits_k = traceback.traceback(sp, cfg.code, cfg.L, cfg.D, 0)
    if not (torch.equal(sp, sp_p) and torch.equal(pm, pm_p)
            and torch.equal(bits_k, traceback.traceback_plain(sp, cfg.code, cfg.L, cfg.D, 0))):
        raise AssertionError("kernels differ from their plain versions on the main path's blocks")
    k1_ms = cuda_ms(torch, lambda: acs.acs_forward(blocks, cfg.code), reps=20)
    k1_plain_ms = cuda_ms(torch, lambda: acs.acs_forward_plain(blocks, cfg.code), reps=3, warmup=1)
    k2_ms = cuda_ms(torch, lambda: traceback.traceback(sp, cfg.code, cfg.L, cfg.D, 0), reps=20)
    k2_plain_ms = cuda_ms(
        torch, lambda: traceback.traceback_plain(sp, cfg.code, cfg.L, cfg.D, 0), reps=3, warmup=1
    )
    frame_ms = wall_ms(torch, lambda: engine._frame_one(y, n_bits), reps=5)
    blocks_ms = wall_ms(torch, lambda: engine._decode_blocks(blocks, (n_blocks,)), reps=5)
    MEASURED.update(k1_ms=k1_ms, k2_ms=k2_ms, decode_ms=blocks_ms)
    dec_bits = engine._decode_blocks(blocks, (n_blocks,))
    unpack_ms = wall_ms(torch, lambda: dec_bits.t().reshape(-1)[:n_bits].contiguous(), reps=5)
    e2e_ms = wall_ms(torch, lambda: engine.decode(y, n_bits), reps=5)
    k1_bytes, k1_ops = k1_cost(cfg.code, cfg.T, n_blocks, blocks.element_size())
    k2_bytes, k2_ops = k2_cost(cfg.T, n_blocks, cfg.L, cfg.D)
    k1_bound, k1_by = bound(k1_bytes, k1_ops, INT32_OPS_PER_S)
    k2_bound, k2_by = bound(k2_bytes, k2_ops, INT32_OPS_PER_S)
    log(f"[6 times] K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms by "
        f"{k1_by}: {k1_bytes:.0f} B, {k1_ops:.0f} int32 op; {k1_bound / k1_ms:.1%} of the "
        f"bound; warp body, S={acs.warp_states(cfg.code)[0]})")
    for name_s, code_s in (("ccsds", cfg.code), ("lte-1/3", lte), ("is95-k9", is95)):
        y_s = blocks if code_s is cfg.code else torch.randint(
            -127, 128, (cfg.T, code_s.R, n_blocks), generator=gen, device=dev).to(torch.int8)
        nb_s, no_s = k1_cost(code_s, cfg.T, n_blocks, 1)
        b_s = bound(nb_s, no_s, INT32_OPS_PER_S)[0]
        for S in acs.warp_states(code_s):
            ms_s = cuda_ms(torch, lambda: acs.acs_forward(y_s, code_s, states_per_thread=S),
                           reps=20)
            log(f"[6 times] K1 {name_s} S={S} ({code_s.n_states // S} lanes per block, "
                f"{-(-n_blocks * code_s.n_states // S // 32)} warps): {ms_s:.4f} ms, bound "
                f"{b_s:.4f} ms, {b_s / ms_s:.1%} of it")
    k2_algo_bytes = k2_staged_bytes(cfg.T, n_blocks, cfg.L, cfg.D, -(-cfg.code.n_states // 32))
    log(f"[6 times] K2 (staged walk) {k2_ms:.4f} ms by event (plain {k2_plain_ms:.3f} ms, bound "
        f"{k2_bound:.4f} ms by {k2_by}: {k2_bytes:.0f} B, {k2_ops:.0f} int32 op; the staged "
        f"walk's own traffic, every word of each walked stage and the bits, {k2_algo_bytes:.0f} "
        f"B, {k2_algo_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms)")
    # the two routes that stage the words, in turns; device time under the profiler
    for route in ("tma", "cp.async", "cp.async", "tma"):
        walk = lambda: traceback._staged_walk(sp, cfg.code, cfg.L, cfg.D, 0, route)
        ev_ms = cuda_ms(torch, walk, reps=20)
        _, k2_prof, _ = device_profile(torch, lambda: [walk() for _ in range(20)])
        k2_dev = [(n, ms / c) for n, ms, c in k2_prof if "traceback" in n]
        log(f"[6 times] K2 {route:8s}: {ev_ms:.4f} ms by event; device time per launch under "
            f"the profiler: " + (", ".join(f"{n} {ms:.4f} ms" for n, ms in k2_dev)
                                  or "not measured"))
    log(f"[6 times] host phases: frame (check+quantize+frame) {frame_ms:.3f} ms, "
        f"dispatch+K1+argmin/start+K2 {blocks_ms:.3f} ms, unpack {unpack_ms:.3f} ms; "
        f"end to end {e2e_ms:.3f} ms")
    log(f"[6 times] decoded Mb/s: end to end {n_bits / e2e_ms / 1e3:.1f}, "
        f"on the device (K1+K2) {n_bits / (k1_ms + k2_ms) / 1e3:.1f}; "
        f"bytes per decoded bit: K1 {k1_bytes / n_bits:.3f} + K2 {k2_bytes / n_bits:.3f} = "
        f"{(k1_bytes + k2_bytes) / n_bits:.3f}")

    clock.lap("phase 6 times")
    # ---- 7. narrow modes, radix 4 and the fused kernel against plain -----------
    # label, code, symbol dtype, B, T, decode_start, n_decode, mode, radix, start
    cases = [
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "f32", 2, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "f32", 4, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "i8", 4, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "i16", 2, "zero"),
        ("ccsds", ccsds, i16, 1024, T, L, D, "i16", 4, "random"),
        ("ccsds float", ccsds, f32, 256, T + 1, L, D, "f32", 4, "random"),
        ("ccsds float", ccsds, f32, 256, T, L, D, "f32", 2, "random"),
        ("ccsds ragged", ccsds, i8, 1001, T + 1, L, D, "i8", 4, "random"),
        ("ccsds ragged", ccsds, i16, 1001, T, L, D, "i8", 2, "zero"),
        ("ccsds overhang", ccsds, i8, 300, 100, 8, 128, "i16", 4, "random"),
        ("is95-k9", is95, i8, 256, T, L, D, "i16", 4, "random"),
        ("is95-k9", is95, i16, 256, T + 1, L, D, "i8", 2, "zero"),
        ("is95-k9", is95, i8, 256, T, L, D, "f32", 2, "zero"),
        ("lte-1/3", lte, i8, 256, T + 1, L, D, "f32", 4, "random"),
        ("lte-1/3", lte, i8, 256, T, L, D, "i8", 4, "zero"),
        ("(2,1,5)", k5, i8, 77, T, L, D, "i16", 4, "random"),
        ("(2,1,5)", k5, i8, 77, T + 1, L, D, "i8", 2, "zero"),
        ("(2,1,5)", k5, i8, 77, T, L, D, "i8", 4, "zero"),  # refused by the budget
        ("is95-k9 long", is95, i8, 300, 4096 + 128, 64, 4096, "f32", 2, "random"),
        ("is95-k9 long", is95, i8, 300, 4096 + 129, 64, 4096, "i8", 4, "zero"),
        # G drops to 1: CTAs of 16 threads, one partly filled warp
        ("(2,1,5) long", k5, i8, 50, 8000, 64, 7904, "i16", 4, "random"),
    ]
    # the warp body's codes and S variants, and the runtime-table body
    for label, code in (("ccsds", ccsds), ("is95-k9", is95), ("lte-1/3", lte)):
        for S in acs.warp_states(code):
            cases += [(label, code, i8, N_MAIN_BLOCKS + 17, T, L, D, "f32", 2, "zero", S),
                      (label, code, i16, 5, T + 1, L, D, "i16", 4, "random", S),
                      (label, code, i8, 1001, T, L, D, "i8", 2, "random", S),
                      (label, code, f32, 33, 1, 0, 32, "f32", 4, "random", S),
                      (label, code, i8, 300, 97, 9, 64, "i8", 4, "zero", S)]
    cases += [("(2,1,5)", k5, i8, 5, 1, 0, 32, "i8", 4, "random", None),
              ("(2,1,5)", k5, i16, N_MAIN_BLOCKS + 17, T, L, D, "i16", 2, "zero", None)]
    fused_err = {2: 0.0, 4: 0.0}  # by radix; K1's radix-4 errors go to k1_err_r4
    for label, code, dtype, B, Tc, ds, nd, mode, radix, policy, *states in cases:
        S = states[0] if states else None
        body = acs.kernel_body(code)
        tag = (f"{label:14s} {body} S={S} {str(dtype):13s} T={Tc} B={B} {mode} r{radix} "
               f"start={policy}")
        try:
            norm_interval(code, mode, radix)
        except ValueError as err:
            log(f"[7 refused] {tag}: {err}")
            continue
        if dtype == f32:
            y7 = torch.randn((Tc, code.R, B), generator=gen, device=dev) * 2.0
        else:
            y7 = torch.randint(-127, 128, (Tc, code.R, B), generator=gen, device=dev).to(dtype)
        start = (torch.randint(0, code.n_states, (B,), generator=gen, device=dev,
                               dtype=torch.int32) if policy == "random" else None)
        if mode != "f32" or radix == 4:
            sp_k, pm_k = acs.acs_forward(y7, code, mode, radix, states_per_thread=S)
            torch.cuda.synchronize()
            sp_p, pm_p = acs.acs_forward_plain(y7, code, mode, radix)
            if not torch.equal(sp_k, sp_p):
                raise AssertionError(f"K1 {tag}: {int((sp_k != sp_p).sum())} survivor words differ")
            if not torch.equal(pm_k, pm_p.to(pm_k.dtype)):
                raise AssertionError(f"K1 {tag}: path metrics differ")
            err = float((pm_k.double() - pm_p.double()).abs().max())
            if radix == 4:
                k1_err_r4 = max(k1_err_r4, err)
            else:
                k1_err = max(k1_err, err)
        fused.launches = fused.table_launches = 0
        words_k = fused.pbvd_fused(y7, code, decode_start=ds, n_decode=nd, start_state=start,
                                   metric_mode=mode, radix=radix, states_per_thread=S)
        torch.cuda.synchronize()
        if (fused.launches, fused.table_launches) != (1, int(body == "table")):
            raise AssertionError(f"fused {tag}: launches {fused.launches}, table body "
                                 f"{fused.table_launches}")
        words_p = fused.pbvd_fused_plain(y7, code, decode_start=ds, n_decode=nd,
                                         start_state=start, metric_mode=mode, radix=radix)
        if not torch.equal(words_k, words_p):
            raise AssertionError(f"fused {tag}: {int((words_k != words_p).sum())} words differ")
        fused_err[radix] = max(fused_err[radix],
                               float((words_k.double() - words_p.double()).abs().max()))
        lanes = code.n_states // (S or acs.warp_states(code)[0]) if body == "warp" else None
        G, smem = fused.smem_plan(Tc, code.n_states, lanes=lanes)
        log(f"[7 fused] {tag}: words equal (G={G}, {smem} B shared)"
            + ("; K1 sp and pm equal" if mode != "f32" or radix == 4 else ""))

    clock.lap("phase 7 fused and narrow modes")
    # ---- 8. the fused main path ----------------------------------------------
    fcfg = PBVDConfig(backend="fused")
    fengine = DecoderEngine(fcfg, device=dev)
    fengine.decode(y[: 4 * cfg.D], 4 * cfg.D)
    torch.cuda.synchronize()
    acs.launches = traceback.launches = fused.launches = fused.table_launches = 0
    fbits = fengine.decode(y, n_bits)
    torch.cuda.synchronize()
    fused_launches = {"acs": acs.launches, "traceback": traceback.launches,
                      "fused": fused.launches}
    if fused_launches != {"acs": 0, "traceback": 0, "fused": 1} or fused.table_launches:
        raise AssertionError(f"fused main path launched {fused_launches}")
    if fbits.shape != (n_bits,) or not (torch.equal(fbits, ref_bits) and torch.equal(fbits, bits)):
        raise AssertionError("fused main path differs from backend='ref' or 'cuda'")
    i16_bits = DecoderEngine(PBVDConfig(backend="fused", metric_mode="i16"),
                             device=dev).decode(y, n_bits)
    if not torch.equal(i16_bits, fbits):
        raise AssertionError("fused i16 differs from f32")
    # the radix-4 paths, i8: the fused kernel's and K1's radix-4 branches
    i8r4 = dict(metric_mode="i8", acs_radix=4)
    i8_engine = DecoderEngine(PBVDConfig(backend="fused", **i8r4), device=dev)
    r4_engines = {"fused": i8_engine,
                  "cuda": DecoderEngine(PBVDConfig(backend="cuda", **i8r4), device=dev)}
    r4_bits, r4_launches = {}, {}
    for be, eng in r4_engines.items():
        acs.launches = traceback.launches = fused.launches = 0
        r4_bits[be] = eng.decode(y, n_bits)
        torch.cuda.synchronize()
        r4_launches[be] = {"acs": acs.launches, "traceback": traceback.launches,
                           "fused": fused.launches}
    if r4_launches != {"fused": {"acs": 0, "traceback": 0, "fused": 1},
                       "cuda": {"acs": 1, "traceback": 1, "fused": 0}}:
        raise AssertionError(f"i8 radix-4 paths launched {r4_launches}")
    i8_ref = DecoderEngine(PBVDConfig(backend="ref", **i8r4), device=dev).decode(y, n_bits)
    if not (torch.equal(r4_bits["fused"], i8_ref) and torch.equal(r4_bits["cuda"], i8_ref)):
        raise AssertionError("i8 radix 4: fused or cuda differs from backend='ref'")
    i8_bits = r4_bits["fused"]
    n_err0 = int((fengine.decode(bpsk(coded), n_bits) != payload).sum())
    n_err0 += int((i8_engine.decode(bpsk(coded), n_bits) != payload).sum())
    if n_err0:
        raise AssertionError(f"fused: noiseless stream decoded with {n_err0} errors")
    ber_i8 = float((i8_bits != payload).double().mean())
    log(f"[8 fused] {n_bits} bits: fused == ref == cuda bit for bit; launches {fused_launches}; "
        f"i16 == f32; i8 radix 4: fused == cuda == ref (launches {r4_launches}; BER at "
        f"{EBN0_DB} dB {ber_i8:.3e}, f32 {ber:.3e}); noiseless errors = 0 (f32 and i8 radix 4)")
    acs.launches = traceback.launches = fused.launches = 0
    fbatch = fengine.decode_batch(ys, [STREAM_BITS] * N_STREAMS)
    torch.cuda.synchronize()
    fbatch_launches = {"acs": acs.launches, "traceback": traceback.launches,
                       "fused": fused.launches}
    if fbatch_launches != {"acs": 0, "traceback": 0, "fused": 1}:
        raise AssertionError(f"fused decode_batch launched {fbatch_launches}")
    for i, (yi, bi) in enumerate(zip(ys, fbatch)):
        if not torch.equal(bi, fengine.decode(yi, STREAM_BITS)) or not torch.equal(bi, batch[i]):
            raise AssertionError(f"fused decode_batch stream {i} differs")
    log(f"[8 fused] decode_batch {N_STREAMS} x {STREAM_BITS} bits == per-stream decode == cuda "
        f"(launches {fbatch_launches})")

    clock.lap("phase 8 fused main")
    # ---- 9. times of the fused kernel, K1 radix 4 / i8 -------------------------
    i8_blocks = i8_engine._frame_one(y, n_bits)[0]
    fkw = dict(decode_start=cfg.L, n_decode=cfg.D)
    f_bytes, f_ops = fused_cost(cfg.code, cfg.T, n_blocks, blocks.element_size(), cfg.L, cfg.D)
    f_bound, f_by = bound(f_bytes, f_ops, INT32_OPS_PER_S)
    fused_ms = {}
    for mode, radix, blk in (("f32", 2, blocks), ("f32", 4, blocks), ("i8", 2, i8_blocks),
                             ("i8", 4, i8_blocks)):
        if not torch.equal(fused.pbvd_fused(blk, cfg.code, metric_mode=mode, radix=radix, **fkw),
                           fused.pbvd_fused_plain(blk, cfg.code, metric_mode=mode, radix=radix,
                                                  **fkw)):
            raise AssertionError(f"fused {mode} r{radix} differs from plain on the main blocks")
        fused_ms[mode, radix] = cuda_ms(
            torch, lambda: fused.pbvd_fused(blk, cfg.code, metric_mode=mode, radix=radix, **fkw),
            reps=20)
        log(f"[9 times] fused {mode} radix {radix}: {fused_ms[mode, radix]:.4f} ms "
            f"(bound {f_bound:.4f} ms by {f_by}: {f_bytes:.0f} B, {f_ops:.0f} int32 op; "
            f"{f_bound / fused_ms[mode, radix]:.1%} of the bound)")
    for S in acs.warp_states(cfg.code):
        lanes = cfg.code.n_states // S
        G, smem = fused.smem_plan(cfg.T, cfg.code.n_states, lanes=lanes)
        ctas, warps = fused.residency(G, smem, lanes)
        for mode, blk in (("f32", blocks), ("i8", i8_blocks)):
            ms_s = cuda_ms(torch, lambda: fused.pbvd_fused(blk, cfg.code, metric_mode=mode,
                                                           states_per_thread=S, **fkw), reps=20)
            log(f"[9 times] fused {mode} radix 2 S={S}: {ms_s:.4f} ms, {f_bound / ms_s:.1%} of "
                f"the bound; G={G} blocks per CTA ({G * lanes} threads), {smem} B shared, "
                f"{ctas} CTAs = {ctas * G} blocks = {warps} warps per SM by shared memory")
    fused_plain_ms = {r: cuda_ms(torch, lambda: fused.pbvd_fused_plain(blocks, cfg.code, radix=r,
                                                                      **fkw), reps=3, warmup=1)
                      for r in (2, 4)}
    k1_r4_ms = cuda_ms(torch, lambda: acs.acs_forward(blocks, cfg.code, radix=4), reps=20)
    k1_r4_plain_ms = cuda_ms(torch, lambda: acs.acs_forward_plain(blocks, cfg.code, radix=4),
                             reps=3, warmup=1)
    k1_i8_ms = cuda_ms(torch, lambda: acs.acs_forward(i8_blocks, cfg.code, "i8"), reps=20)
    k1_i8r4_ms = cuda_ms(torch, lambda: acs.acs_forward(i8_blocks, cfg.code, "i8", 4), reps=20)
    log(f"[9 times] fused plain radix 2 {fused_plain_ms[2]:.3f} ms, radix 4 "
        f"{fused_plain_ms[4]:.3f} ms; K1 radix 2 {k1_ms:.4f} ms, radix 4 {k1_r4_ms:.4f} ms "
        f"(plain {k1_r4_plain_ms:.3f} ms), i8 {k1_i8_ms:.4f} ms, i8 radix 4 {k1_i8r4_ms:.4f} ms "
        f"(bound {k1_bound:.4f} ms)")
    e2e = {"cuda": [], "fused": []}
    for be, eng in (("cuda", engine), ("fused", fengine), ("fused", fengine), ("cuda", engine)):
        e2e[be].append(wall_ms(torch, lambda: eng.decode(y, n_bits), reps=5))
    log(f"[9 times] end to end ms (in turns cuda, fused, fused, cuda): cuda {e2e['cuda']}, "
        f"fused {e2e['fused']}; decoded Mb/s: cuda "
        f"{n_bits / statistics.mean(e2e['cuda']) / 1e3:.1f}, fused "
        f"{n_bits / statistics.mean(e2e['fused']) / 1e3:.1f}; on the device: K1+K2 "
        f"{n_bits / (k1_ms + k2_ms) / 1e3:.1f}, fused {n_bits / fused_ms['f32', 2] / 1e3:.1f}; "
        f"bytes per decoded bit: fused {f_bytes / n_bits:.3f}")
    for be, eng in (("cuda", engine), ("fused", fengine)):
        eng.decode(y, n_bits)
        wall, kernels_p, busy = device_profile(
            torch, lambda: [eng.decode(y, n_bits) for _ in range(5)])
        if busy <= 0:
            log(f"[9 profile] {be}: the profiler saw no device time (not measured)")
            continue
        log(f"[9 profile] {be}, 5 decodes of {n_bits} bits: wall {wall:.3f} ms under the "
            f"profiler, device busy {busy:.3f} ms ({busy / wall:.1%}), idle "
            f"{1 - busy / wall:.1%}; top kernels: "
            + "; ".join(f"{n} {ms:.3f} ms × {c}" for n, ms, c in kernels_p))

    clock.lap("phase 9 fused times")
    # ---- 10. K1-matrix against its plain version ------------------------------
    mcases = [  # label, code, symbol dtype, B, T, mode, k
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, "f32", 2),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, "f32", 3),  # T mod 3 = 2
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, "f32", 4),
        ("ccsds", ccsds, i16, 1024, T + 1, "i16", 3),
        ("ccsds ragged", ccsds, i8, 1001, T + 1, "i8", 2),
        ("ccsds ragged", ccsds, i16, 1001, T + 3, "i8", 4),
        ("lte-1/3", lte, i8, 256, T, "f32", 2),
        ("lte-1/3", lte, i8, 256, T + 1, "i8", 2),
        ("lte-1/3", lte, i16, 256, T + 1, "i16", 1),
        ("is95-k9", is95, i8, 256, T + 3, "i16", 4),
        ("is95-k9", is95, i16, 256, T, "i8", 3),
        ("(2,1,5)", k5, i8, 77, T + 2, "i16", 3),
        ("(2,1,5)", k5, i8, 77, T, "i8", 2),  # refused by the budget
    ]
    # every mother code at every k built for it (validate_matrix_k and the
    # limit of 4), in f32 (int symbols), i16 and i8: T mod k != 0 in f32, T <
    # k in i16, T = 97 in i8, over B = 8192 + 17, 5, 33 and 1001; each on the
    # matrix warp body at its one S ((2,1,5) above on the runtime-table body)
    mothers = (("ccsds", ccsds), ("is95-k9", is95), ("lte-1/3", lte))
    bs = (N_MAIN_BLOCKS + 17, 5, 33, 1001)
    for label, code in mothers:
        for k in range(1, 5):
            try:
                code.validate_matrix_k(k)
            except ValueError:
                continue
            mcases += [(label, code, i8, bs[k % 4], T if T % k or k == 1 else T + 1, "f32", k),
                       (label, code, i16, bs[(k + 1) % 4], max(1, k - 1), "i16", k),
                       (label, code, i8, bs[(k + 2) % 4], 97, "i8", k)]
    mat_err = 0.0
    for label, code, dtype, B, Tc, mode, k in mcases:
        body = acs.kernel_body(code)
        S = acs.matrix_states(code, k) if body == "warp" else None
        tag = f"{label:13s} {body} body S={S} {str(dtype):11s} T={Tc} B={B} {mode} k={k}"
        try:
            norm_interval(code, mode, stages_per_step=k)
        except ValueError as err:
            log(f"[10 refused] {tag}: {err}")
            continue
        y10 = torch.randint(-127, 128, (Tc, code.R, B), generator=gen, device=dev).to(dtype)
        acs.launches = acs.matrix_launches = acs.matrix_table_launches = 0
        sp_k, pm_k = acs.acs_forward(y10, code, mode, impl="matrix", k=k)
        torch.cuda.synchronize()
        counts = (acs.launches, acs.matrix_launches, acs.matrix_table_launches)
        if counts != (0, 1, int(body == "table")):
            raise AssertionError(f"K1-matrix {tag}: launched K1 {acs.launches}, K1-matrix "
                                 f"{acs.matrix_launches}, on the table body "
                                 f"{acs.matrix_table_launches}")
        sp_p, pm_p = acs.acs_forward_plain(y10, code, mode, impl="matrix", matrix_k=k)
        if not torch.equal(sp_k, sp_p):
            raise AssertionError(f"K1-matrix {tag}: {int((sp_k != sp_p).sum())} words differ")
        if not torch.equal(pm_k, pm_p.to(pm_k.dtype)):
            raise AssertionError(f"K1-matrix {tag}: path metrics differ")
        mat_err = max(mat_err, float((pm_k.double() - pm_p.double()).abs().max()))
        log(f"[10 K1-matrix] {tag}: sp and pm equal; launches K1/K1-matrix/table body {counts}")
    yf = torch.randn((T, 2, 256), generator=gen, device=dev) * 2.0
    acs.launches = acs.matrix_launches = 0
    lowered = acs.acs_forward(yf, ccsds, impl="matrix", k=2)
    torch.cuda.synchronize()
    float_launches = (acs.launches, acs.matrix_launches)
    want = acs.acs_forward_plain(yf, ccsds)
    if float_launches != (1, 0) or not (torch.equal(lowered[0], want[0])
                                        and torch.allclose(lowered[1], want[1], rtol=1e-6,
                                                           atol=0.0)):
        raise AssertionError(f"float symbols with impl='matrix': launches {float_launches}")
    log(f"[10 K1-matrix] float32 symbols with impl='matrix' run the radix-2 butterfly, as the "
        f"reference lowers them: K1 launches {float_launches[0]}, K1-matrix {float_launches[1]}; "
        f"sp equal to the butterfly's plain version")

    clock.lap("phase 10 K1-matrix")
    # ---- 11. K2-prefix against its plain version ------------------------------
    def check_prefix(sp, code, ds, nd, start, tb, tag) -> float:
        """One K2-prefix launch (counted) against the plain version and the
        serial walk; returns the largest bit difference (0)."""
        traceback.prefix_launches = traceback.launches = 0
        bits_k = traceback.traceback_prefix(sp, code, ds, nd, start, tb)
        torch.cuda.synchronize()
        if (traceback.prefix_launches, traceback.launches) != (1, 0):
            raise AssertionError(f"K2-prefix {tag}: launches {traceback.prefix_launches}, "
                                 f"K2 {traceback.launches}")
        bits_p = traceback.traceback_prefix_plain(sp, code, ds, nd, start, tb)
        if not torch.equal(bits_k, bits_p):
            raise AssertionError(f"K2-prefix {tag}: {int((bits_k != bits_p).sum())} bits differ")
        if not torch.equal(bits_k, traceback.traceback_plain(sp, code, ds, nd, start)):
            raise AssertionError(f"K2-prefix {tag}: differs from the serial walk")
        log(f"[11 K2-prefix] {tag}: bits equal (and equal to the serial walk)")
        return float((bits_k - bits_p).abs().max())

    pre_err = 0.0
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label in ("ccsds main", "ccsds ragged", "is95-k9", "(2,1,5)"):
        code, sp, _ = sp_keep[label]
        B = sp.shape[2]
        start = torch.randint(0, code.n_states, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        for tb in (1, 7, 64, T + 5):
            for ds, nd in ((L, D), (0, D)):  # ds = 0: the first chunk is chunk 0
                geo = traceback.prefix_chunk_geometry(T, ds, nd, tb)
                tag = (f"{label:13s} W={sp.shape[1]} B={B} tb_chunk={tb} window [{ds}, "
                       f"{ds + nd}) (C, P, n_chunks, c_lo, c_hi) = {geo}")
                try:
                    traceback.prefix_smem_plan(code.n_states, geo[2] - geo[3], geo[4] - geo[3] + 1)
                except ValueError as err:
                    log(f"[11 refused] {tag}: {err}")
                    continue
                G11 = traceback.prefix_plan(code.n_states, T, ds, nd, tb, B, n_sms)[1]
                pre_err = max(pre_err, check_prefix(sp, code, ds, nd, start, tb, f"{tag} G={G11}"))

    # one case per size class of K2-prefix's CTA (G blocks, the largest power
    # of two up to 32 whose maps fit), each geometry planned at its class, at
    # a batch wide enough (G CTAs' worth per SM) that the plan keeps it
    k9 = is95
    for G_want in (1, 2, 4, 8, 16, 32):
        code = k9 if G_want < 32 else ccsds
        n_act = (traceback.SMEM_PER_CTA // G_want) // (4 * code.n_states) - 1
        Tc, ds, nd, tb = (n_act + 3, 3, min(20, n_act), 1) if G_want < 32 else (T, L, D, 64)
        geo = traceback.prefix_chunk_geometry(Tc, ds, nd, tb)
        G11, nbytes = traceback.prefix_smem_plan(code.n_states, geo[2] - geo[3],
                                                 geo[4] - geo[3] + 1)
        B = G_want * n_sms + 5
        if (G11, traceback.prefix_plan(code.n_states, Tc, ds, nd, tb, B, n_sms)[1]) != (G_want,) * 2:
            raise AssertionError(f"K2-prefix planned G={G11} for the class G={G_want}")
        W = -(-code.n_states // 32)
        sp_c = torch.randint(-2**31, 2**31 - 1, (Tc, W, B), generator=gen, device=dev,
                             dtype=torch.int32)
        start = torch.randint(0, code.n_states, (B,), generator=gen, device=dev,
                              dtype=torch.int32)
        pre_err = max(pre_err, check_prefix(
            sp_c, code, ds, nd, start, tb,
            f"size class G={G11} ({nbytes} B of maps per CTA) N={code.n_states} T={Tc} B={B} "
            f"tb_chunk={tb} window [{ds}, {ds + nd})"))

    # a prefix scratch that does not fit is refused before anything launches
    y_big = torch.randint(-127, 128, (T, 2, 64), generator=gen, device=dev).to(i8)
    for be, impl in (("cuda", "matrix"), ("cuda", "butterfly"), ("fused", "matrix")):
        acs.launches = acs.matrix_launches = fused.launches = 0
        try:
            pbvd_decode_blocks(y_big, is95, decode_start=L, n_decode=D, backend=be,
                               tb_mode="prefix", tb_chunk=1, acs_impl=impl)
        except ValueError as err:
            torch.cuda.synchronize()
            if (acs.launches, acs.matrix_launches, fused.launches) != (0, 0, 0):
                raise AssertionError(f"{be} {impl} launched a kernel before refusing")
            log(f"[11 refused] is95-k9 backend={be} acs_impl={impl} tb_chunk=1: refused before "
                f"any launch: {err}")
        else:
            raise AssertionError(f"{be} {impl} with tb_chunk=1 at K = 9 was not refused")

    clock.lap("phase 11 K2-prefix")
    # ---- 12. the fused kernel in prefix, matrix and both ------------------------
    # label, code, dtype, B, T, decode_start, n_decode, mode, tb_mode, impl, radix/k,
    # tb_chunk, start
    fcases = [
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "f32", "prefix", "butterfly", 2, 64, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "f32", "serial", "matrix", 2, 64, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "f32", "prefix", "matrix", 2, 64, "zero"),
        ("ccsds main", ccsds, i8, N_MAIN_BLOCKS, T, L, D, "i8", "prefix", "matrix", 3, 64, "zero"),
        ("ccsds ragged", ccsds, i16, 1001, T + 1, L, D, "i16", "prefix", "matrix", 4, 7, "random"),
        ("ccsds ragged", ccsds, i8, 1001, T + 1, L, D, "i8", "prefix", "butterfly", 4, 1, "random"),
        ("ccsds c_lo=0", ccsds, i8, 256, T, 0, D, "f32", "prefix", "butterfly", 2, 64, "random"),
        ("ccsds float", ccsds, f32, 256, T, L, D, "f32", "prefix", "matrix", 2, 16, "random"),
        ("ccsds overhang", ccsds, i8, 300, 100, 8, 128, "i8", "prefix", "matrix", 2, 13, "random"),
        ("is95-k9", is95, i8, 256, T, L, D, "i16", "prefix", "matrix", 4, 64, "random"),
        ("is95-k9", is95, i16, 256, T + 1, L, D, "i8", "serial", "matrix", 3, 64, "zero"),
        ("is95-k9", is95, i8, 256, T, L, D, "f32", "prefix", "butterfly", 2, T + 5, "random"),
        ("lte-1/3", lte, i8, 256, T + 1, L, D, "i8", "prefix", "matrix", 2, 7, "zero"),
        ("(2,1,5)", k5, i8, 77, T, L, D, "i16", "prefix", "matrix", 3, 1, "random"),
        ("is95-k9 long", is95, i8, 300, 4096 + 128, 64, 4096, "f32", "prefix", "butterfly", 2, 64, "random"),
        ("is95-k9 long", is95, i8, 300, 4096 + 129, 64, 4096, "i16", "prefix", "matrix", 2, 64, "zero"),
        ("is95-k9 long", is95, i8, 300, 4096 + 128, 64, 4096, "f32", "prefix", "butterfly", 2, 16, "zero"),  # refused
        ("(2,1,5)", k5, i16, 33, T + 1, L, D, "i8", "serial", "matrix", 2, 64, "random"),
    ]
    # the serial matrix variant on the matrix warp body: every mother code
    # at every built k, f32 (int symbols), i16 and i8 over int8/int16
    # symbols, ragged B and odd T; at half the decode depth (D / 2 = 256,
    # T = 340), since the plain version's host time grows with T
    D12 = D // 2
    T12 = T - D12
    for label, code in mothers:
        for k in range(1, 5):
            try:
                code.validate_matrix_k(k)
            except ValueError:
                continue
            fcases += [
                (label, code, i8, bs[k % 4], T12 + 1, L, D12, "f32", "serial", "matrix", k, 64,
                 "zero"),
                (label, code, i16, bs[(k + 1) % 4], T12 + 3, L, D12, "i16", "serial", "matrix", k,
                 64, "random"),
                (label, code, i8, bs[(k + 2) % 4], T12, L, D12, "i8", "serial", "matrix", k, 64,
                 "random")]
    # every prefix case of a mother code's butterfly at each S variant the
    # serial warp path builds (the matrix warp body has one S per (code, k))
    fruns = []
    for case in fcases:
        code, dtype, tbm, impl = case[1], case[2], case[8], case[9]
        butterfly = impl == "butterfly" or dtype == f32
        if tbm == "prefix" and butterfly and fused.kernel_body(code, tbm) == "warp":
            fruns += [(*case, S) for S in acs.warp_states(code)]
        else:
            fruns.append((*case, None))
    fused_new_err = {"matrix": 0.0, "prefix": 0.0}
    for (label, code, dtype, B, Tc, ds, nd, mode, tbm, impl, rk, tb, policy, S_run) in fruns:
        kw = dict(decode_start=ds, n_decode=nd, metric_mode=mode, tb_mode=tbm, tb_chunk=tb,
                  impl=impl, **({"k": rk} if impl == "matrix" else {"radix": rk}))
        tag = (f"{label:14s} {str(dtype):11s} T={Tc} B={B} {mode} {tbm}"
               f"{f' tb_chunk={tb}' if tbm == 'prefix' else ''} {impl} "
               f"{'k' if impl == 'matrix' else 'r'}={rk} start={policy}")
        if dtype == f32:
            y12 = torch.randn((Tc, code.R, B), generator=gen, device=dev) * 2.0
        else:
            y12 = torch.randint(-127, 128, (Tc, code.R, B), generator=gen, device=dev).to(dtype)
        start = (torch.randint(0, code.n_states, (B,), generator=gen, device=dev,
                               dtype=torch.int32) if policy == "random" else None)
        mk = rk if impl == "matrix" and dtype != f32 else 0
        fbody = fused.kernel_body(code, tbm)
        S = None
        if fbody == "warp":
            S = acs.matrix_states(code, mk) if mk else S_run or acs.warp_states(code)[0]
            kw["states_per_thread"] = S
        tag += f" ({fbody} body S={S})"
        try:
            if mk:
                norm_interval(code, mode, stages_per_step=mk)
            G, smem = fused.smem_plan(Tc, code.n_states, tbm, tb, decode_start=ds, n_decode=nd,
                                      matrix_k=mk, R=code.R,
                                      lanes=code.n_states // S if S else None)
        except ValueError as err:
            log(f"[12 refused] {tag}: {err}")
            continue
        fused.launches = fused.matrix_launches = fused.prefix_launches = 0
        fused.matrix_table_launches = fused.table_launches = 0
        words_k = fused.pbvd_fused(y12, code, start_state=start, **kw)
        torch.cuda.synchronize()
        body = (fused.launches, fused.matrix_launches, fused.prefix_launches,
                fused.matrix_table_launches, fused.table_launches)
        if body != (1, int(mk > 0), int(tbm == "prefix"), int(mk > 0 and fbody == "table"),
                    int(mk == 0 and fbody == "table")):
            raise AssertionError(f"fused {tag}: launches (all, matrix, prefix, matrix on the "
                                 f"table body, butterfly on the table body) = {body}")
        kw.pop("states_per_thread", None)
        words_p = fused.pbvd_fused_plain(y12, code, start_state=start, **kw)
        if not torch.equal(words_k, words_p):
            raise AssertionError(f"fused {tag}: {int((words_k != words_p).sum())} words differ")
        if tbm == "prefix" and not torch.equal(words_k, fused.pbvd_fused_plain(
                y12, code, start_state=start, **{**kw, "tb_mode": "serial"})):
            raise AssertionError(f"fused {tag}: differs from the serial walk")
        err = float((words_k.double() - words_p.double()).abs().max())
        for part, on in (("matrix", mk > 0), ("prefix", tbm == "prefix")):
            if on:
                fused_new_err[part] = max(fused_new_err[part], err)
        log(f"[12 fused] {tag}: words equal{' (and to the serial walk)' if tbm == 'prefix' else ''} "
            f"(G={G}, {smem} B shared; launches all/matrix/"
            f"prefix/matrix on the table body/butterfly on the table body {body})")

    clock.lap("phase 12 fused prefix/matrix")
    # ---- 13. the new main paths -------------------------------------------------
    variants = {"matrix+prefix": dict(acs_impl="matrix", acs_k=2, tb_mode="prefix"),
                "matrix": dict(acs_impl="matrix", acs_k=2),
                "prefix": dict(tb_mode="prefix")}
    new_engines, new_launches = {}, {}
    counters = (("acs", acs, "launches"), ("acs_matrix", acs, "matrix_launches"),
                ("acs_matrix_table", acs, "matrix_table_launches"),
                ("acs_table", acs, "table_launches"),
                ("traceback", traceback, "launches"),
                ("traceback_prefix", traceback, "prefix_launches"), ("fused", fused, "launches"),
                ("fused_matrix", fused, "matrix_launches"),
                ("fused_matrix_table", fused, "matrix_table_launches"),
                ("fused_prefix", fused, "prefix_launches"),
                ("fused_table", fused, "table_launches"))
    for vname, knobs in variants.items():
        for be in ("cuda", "fused"):
            eng = DecoderEngine(PBVDConfig(backend=be, **knobs), device=dev)
            eng.decode(y[: 4 * cfg.D], 4 * cfg.D)
            torch.cuda.synchronize()
            for _, mod, attr in counters:
                setattr(mod, attr, 0)
            got = eng.decode(y, n_bits)
            torch.cuda.synchronize()
            counts = {key: getattr(mod, attr) for key, mod, attr in counters}
            mat, pre = "acs_impl" in knobs, "tb_mode" in knobs
            want_counts = dict.fromkeys(counts, 0)
            if be == "cuda":
                want_counts.update({"acs_matrix" if mat else "acs": 1,
                                    "traceback_prefix" if pre else "traceback": 1})
            else:  # CCSDS: every variant on a warp body, the prefix walk on its lanes
                want_counts.update(fused=1, fused_matrix=int(mat), fused_prefix=int(pre))
            if counts != want_counts:
                raise AssertionError(f"{be} {vname} main path launched {counts}")
            if got.shape != (n_bits,) or not torch.equal(got, ref_bits):
                raise AssertionError(f"{be} {vname} main path differs from backend='ref'")
            new_engines[be, vname], new_launches[be, vname] = eng, counts
            log(f"[13 main] {n_bits} bits, {be} {vname} {knobs}: == ref (default config) bit "
                f"for bit; launches {({k: v for k, v in counts.items() if v})}")

    clock.lap("phase 13 new main paths")
    # ---- 14. times of the new kernels --------------------------------------------
    sym = blocks.element_size()
    log("[14 probe] the matrix warp body's one S per (code, k): " + "; ".join(
        f"{label} " + ", ".join(f"k={k} S={acs.matrix_states(code, k)}" for k in range(1, 5)
                                if k * code.R <= 8)
        for label, code in mothers))
    k1m_ms, k1m_plain_ms = {}, {}
    for k in (2, 3, 4):
        k1m_ms[k] = cuda_ms(torch, lambda: acs.acs_forward(blocks, cfg.code, impl="matrix", k=k),
                            reps=20)
        k1m_plain_ms[k] = cuda_ms(torch, lambda: acs.acs_forward_plain(
            blocks, cfg.code, impl="matrix", matrix_k=k), reps=3, warmup=1)
        nb_, no_ = k1_matrix_cost(cfg.code, cfg.T, n_blocks, sym, k)
        floor_ms = bound(nb_, no_, INT32_OPS_PER_S)[0]
        log(f"[14 times] K1-matrix k={k} (matrix warp body, S="
            f"{acs.matrix_states(cfg.code, k)}): {k1m_ms[k]:.4f} ms (plain "
            f"{k1m_plain_ms[k]:.3f} ms; bound {k1_bound:.4f} ms by {k1_by}, K1's function, "
            f"{k1_bound / k1m_ms[k]:.1%} of it; the algorithm's own floor {no_:.0f} int32 op, "
            f"{floor_ms:.4f} ms, {floor_ms / k1m_ms[k]:.1%} of it; K1 butterfly {k1_ms:.4f} ms)")
    tb64 = 64
    k2p_ms = cuda_ms(torch, lambda: traceback.traceback_prefix(sp_keep["ccsds main"][1], cfg.code,
                                                               cfg.L, cfg.D, 0, tb64), reps=20)
    k2p_plain_ms = cuda_ms(torch, lambda: traceback.traceback_prefix_plain(
        sp_keep["ccsds main"][1], cfg.code, cfg.L, cfg.D, 0, tb64), reps=3, warmup=1)
    p_bytes, p_ops = k2_prefix_cost(cfg.code, cfg.T, n_blocks, cfg.L, cfg.D, tb64)
    p_algo = bound(p_bytes, p_ops, INT32_OPS_PER_S)
    log(f"[14 times] K2-prefix tb_chunk={tb64}: {k2p_ms:.4f} ms (plain {k2p_plain_ms:.3f} ms, "
        f"bound {k2_bound:.4f} ms by {k2_by}, K2's function; the composed maps' own work "
        f"{p_bytes:.0f} B, {p_ops:.0f} int32 op, {p_algo[0]:.4f} ms by {p_algo[1]}; K2 serial "
        f"{k2_ms:.4f} ms)")
    G14 = traceback.prefix_plan(cfg.code.n_states, cfg.T, cfg.L, cfg.D, tb64, n_blocks, n_sms)[1]
    k2p_dev = kernel_device_ms(torch, lambda: traceback.traceback_prefix(
        sp_keep["ccsds main"][1], cfg.code, cfg.L, cfg.D, 0, tb64))
    log(f"[14 times] K2-prefix, lanes on blocks (G={G14} blocks per CTA): {k2p_dev} ms of "
        f"device time per launch under the profiler, {p_algo[0] / k2p_dev:.1%} of the "
        f"algorithm's floor ({p_algo[0]:.4f} ms)" if k2p_dev else
        "[14 times] K2-prefix: the profiler saw no device time (not measured)")
    fvar = {"prefix": dict(tb_mode="prefix"), "matrix": dict(impl="matrix", k=2),
            "matrix k=3": dict(impl="matrix", k=3),
            "matrix+prefix": dict(impl="matrix", k=2, tb_mode="prefix")}
    fnew_ms, fnew_plain_ms = {}, {}
    walk_ops = n_blocks * (cfg.T - cfg.L) * 6
    for vname, kw in fvar.items():
        fnew_ms[vname] = cuda_ms(torch, lambda: fused.pbvd_fused(blocks, cfg.code, **fkw, **kw),
                                 reps=20)
        fnew_plain_ms[vname] = cuda_ms(torch, lambda: fused.pbvd_fused_plain(
            blocks, cfg.code, **fkw, **kw), reps=3, warmup=1)
        acs_ops = (k1_matrix_cost(cfg.code, cfg.T, n_blocks, sym, kw["k"])[1] if "matrix" in vname
                   else k1_cost(cfg.code, cfg.T, n_blocks, sym)[1])
        ops = acs_ops + (p_ops if "prefix" in vname else walk_ops)
        algo = bound(f_bytes, ops, INT32_OPS_PER_S)
        body = fused.kernel_body(cfg.code, kw.get("tb_mode", "serial"))
        S14 = (acs.matrix_states(cfg.code, kw["k"]) if "matrix" in vname
               else acs.warp_states(cfg.code)[0])
        G14, smem14 = fused.smem_plan(cfg.T, cfg.code.n_states, kw.get("tb_mode", "serial"), tb64,
                                      lanes=cfg.code.n_states // S14, **fkw)
        body += (f" body S={S14}, G={G14}, {smem14} B shared, "
                 f"{fused.residency(G14, smem14, cfg.code.n_states // S14)[0] * G14} blocks "
                 f"resident per SM")
        log(f"[14 times] fused {vname} ({body}): {fnew_ms[vname]:.4f} ms (plain "
            f"{fnew_plain_ms[vname]:.3f} ms; bound {f_bound:.4f} ms by {f_by}, the fused "
            f"kernel's function, {f_bound / fnew_ms[vname]:.1%} of it; the chosen algorithms' "
            f"own work {ops:.0f} int32 op, {algo[0]:.4f} ms by {algo[1]}, "
            f"{algo[0] / fnew_ms[vname]:.1%} of it; fused serial butterfly "
            f"{fused_ms['f32', 2]:.4f} ms)")
    # serial against prefix at a few widths: where, if anywhere, the shorter
    # chain of the prefix walk wins on this card
    small_b = {}
    for Bs in (32, 264, n_blocks):
        sp_b = sp_keep["ccsds main"][1][:, :, :Bs].contiguous()
        y_b = blocks[:, :, :Bs].contiguous()
        small_b[Bs] = {
            "K2": cuda_ms(torch, lambda: traceback.traceback(sp_b, cfg.code, cfg.L, cfg.D, 0),
                          reps=20),
            "K2-prefix": cuda_ms(torch, lambda: traceback.traceback_prefix(
                sp_b, cfg.code, cfg.L, cfg.D, 0, tb64), reps=20),
            "fused serial": cuda_ms(torch, lambda: fused.pbvd_fused(y_b, cfg.code, **fkw),
                                    reps=20),
            "fused prefix": cuda_ms(torch, lambda: fused.pbvd_fused(
                y_b, cfg.code, tb_mode="prefix", **fkw), reps=20)}
        t = small_b[Bs]
        dev_ms = {k: kernel_device_ms(torch, fn) for k, fn in (
            ("K2", lambda: traceback.traceback(sp_b, cfg.code, cfg.L, cfg.D, 0)),
            ("K2-prefix", lambda: traceback.traceback_prefix(sp_b, cfg.code, cfg.L, cfg.D, 0,
                                                             tb64)),
            ("fused serial", lambda: fused.pbvd_fused(y_b, cfg.code, **fkw)),
            ("fused prefix", lambda: fused.pbvd_fused(y_b, cfg.code, tb_mode="prefix", **fkw)))}
        log(f"[14 small B] B={Bs} (K2-prefix G="
            f"{traceback.prefix_plan(cfg.code.n_states, cfg.T, cfg.L, cfg.D, tb64, Bs, n_sms)[1]}"
            f"), ms by event (device ms per launch under the profiler): K2 "
            f"{t['K2']:.4f} ({dev_ms['K2']}), K2-prefix {t['K2-prefix']:.4f} "
            f"({dev_ms['K2-prefix']}); fused serial {t['fused serial']:.4f} "
            f"({dev_ms['fused serial']}), fused prefix {t['fused prefix']:.4f} "
            f"({dev_ms['fused prefix']})")
    for vname in variants:
        e2e_new = {"cuda": [], "fused": []}
        for be in ("cuda", "fused", "fused", "cuda"):
            eng = new_engines[be, vname]
            e2e_new[be].append(wall_ms(torch, lambda: eng.decode(y, n_bits), reps=5))
        log(f"[14 times] end to end {vname}, ms in turns (cuda, fused, fused, cuda): cuda "
            f"{e2e_new['cuda']}, fused {e2e_new['fused']}; decoded Mb/s: cuda "
            f"{n_bits / statistics.mean(e2e_new['cuda']) / 1e3:.1f}, fused "
            f"{n_bits / statistics.mean(e2e_new['fused']) / 1e3:.1f}")
    for be in ("cuda", "fused"):  # the matrix paths: device-bound, unlike the default's
        eng = new_engines[be, "matrix"]
        wall, kernels_p, busy = device_profile(
            torch, lambda: [eng.decode(y, n_bits) for _ in range(5)])
        if busy <= 0:
            log(f"[14 profile] {be} matrix: the profiler saw no device time (not measured)")
            continue
        log(f"[14 profile] {be} matrix, 5 decodes of {n_bits} bits: wall {wall:.3f} ms under "
            f"the profiler, device busy {busy:.3f} ms ({busy / wall:.1%}), idle "
            f"{1 - busy / wall:.1%}; top kernels: "
            + "; ".join(f"{n} {ms:.3f} ms × {c}" for n, ms, c in kernels_p))

    clock.lap("phase 14 times")
    flash_rows = lm_phases(torch, dev, gen, [(mod, attr) for _, mod, attr in counters])
    clock.lap("phases 15-17 flash and StarCoder2-3B")
    streaming_phases(torch, dev, gen, counters, y, ref_bits)
    clock.lap("phases 18-19 streaming")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    power = smi.stdout.strip().splitlines()[0]
    serving_phases(torch, dev, gen, counters, power)
    clock.lap("phases 20-21 serving fabric")
    mesh_phases(torch, dev, counters, y, ref_bits, ys, batch, power)
    clock.lap("phase 22 mesh")
    ber_phases(torch, dev, counters, power)
    clock.lap("phase 23 ber")
    example_phases(power)
    clock.lap("phase 23 examples")
    card_phases(torch, dev, counters, power, clock)
    mixer_phases(torch, dev, counters, power, clock)
    encdec = encdec_phases(torch, dev, counters, power, clock)
    trained = train_phases(torch, dev, counters, power, clock)
    meshed = lm_mesh_phases(torch, dev, counters, power, clock)
    fleet_phases(torch, y, ref_bits, ys, power)
    clock.lap("phase 30 fleet")
    split = tp_phases(torch, dev, counters, power, clock)
    tp_mixer_phases(torch, dev, counters, power, clock)
    dryrun_phases(torch, dryruns, power, clock)  # last: the dry-runs have had the whole run
    # the flash launches on every LM path: StarCoder2-3B's prefill (its main path,
    # ``launches``), the enc-dec and VLM prefills, one training step and the Jamba mesh
    # prefill (the tensor-core body), and one float32 mesh train step (the CUDA-core body)
    flash_rows[0]["launches_by_path"] = {"starcoder2-3b prefill": flash_rows[0]["launches"],
                                         "seamless prefill": encdec["launches"]["seamless"],
                                         "pixtral prefill": encdec["launches"]["pixtral"],
                                         "starcoder2-3b train step": trained["train step"],
                                         "jamba-v0.1 mesh prefill (model=4)":
                                             meshed["mesh prefill"],
                                         "starcoder2-3b mesh train step (data=2, float32)":
                                             meshed["mesh train step"],
                                         "starcoder2-3b tp prefill (1, 2), per position":
                                             split["prefill"]}
    flash_rows[0]["tp_shapes"] = split["flash"]
    flash_rows[0]["seamless_shapes"] = encdec["seamless"]

    for mod in list(sys.modules):
        if mod == "jax" or mod.startswith(("jax.", "jaxlib")) or mod == "repro" or mod.startswith("repro."):
            raise AssertionError(f"the port imported {mod}")

    kernels = [
        dict(name="acs_forward (K1)", route="cuda", source="src/repro_torch/kernels/csrc/acs.cu",
             replaces="src/repro/kernels/acs.py:367", launches=main_launches["acs"],
             max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms, bound_ms=k1_bound,
             bound_by=k1_by, library_ms=None),
        dict(name="traceback (K2)", route="cuda", source="src/repro_torch/kernels/csrc/traceback.cu",
             replaces="src/repro/kernels/traceback.py:68", launches=main_launches["traceback"],
             max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain_ms, bound_ms=k2_bound,
             bound_by=k2_by, library_ms=None),
        dict(name="pbvd_fused", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
             replaces="src/repro/kernels/fused.py:327", launches=fused_launches["fused"],
             max_abs_err=fused_err[2], ms=fused_ms["f32", 2], plain_ms=fused_plain_ms[2],
             bound_ms=f_bound, bound_by=f_by, library_ms=None),
        # the radix-4 branches of the same two sources, timed at f32; their
        # launches are those of the i8 radix-4 main-path runs of phase 8
        dict(name="acs_forward (K1) radix 4", route="cuda",
             source="src/repro_torch/kernels/csrc/acs.cu",
             replaces="src/repro/kernels/acs.py:407", launches=r4_launches["cuda"]["acs"],
             max_abs_err=k1_err_r4, ms=k1_r4_ms, plain_ms=k1_r4_plain_ms, bound_ms=k1_bound,
             bound_by=k1_by, library_ms=None),
        dict(name="pbvd_fused radix 4", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
             replaces="src/repro/kernels/fused.py:92", launches=r4_launches["fused"]["fused"],
             max_abs_err=fused_err[4], ms=fused_ms["f32", 4], plain_ms=fused_plain_ms[4],
             bound_ms=f_bound, bound_by=f_by, library_ms=None),
        # the prefix and matrix rows, timed at the main shapes (k = 2, tb_chunk
        # = 64); their launches are those of the main paths that run them
        # (matrix: on the matrix warp body; prefix: matrix+prefix), and their
        # bounds those of the functions they compute (K1's, K2's, the fused
        # kernel's)
        dict(name="acs_forward_matrix (K1-matrix)", route="cuda",
             source="src/repro_torch/kernels/csrc/acs.cu",
             replaces="src/repro/kernels/acs.py:429",
             launches=new_launches["cuda", "matrix"]["acs_matrix"], max_abs_err=mat_err,
             ms=k1m_ms[2], plain_ms=k1m_plain_ms[2], bound_ms=k1_bound, bound_by=k1_by,
             library_ms=None),
        dict(name="traceback_prefix (K2-prefix)", route="cuda",
             source="src/repro_torch/kernels/csrc/traceback.cu",
             replaces="src/repro/kernels/traceback.py:254",
             launches=new_launches["cuda", "matrix+prefix"]["traceback_prefix"],
             max_abs_err=pre_err, ms=k2p_ms, plain_ms=k2p_plain_ms, bound_ms=k2_bound,
             bound_by=k2_by, library_ms=None),
        dict(name="pbvd_fused matrix", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
             replaces="src/repro/kernels/fused.py:177",
             launches=new_launches["fused", "matrix"]["fused_matrix"],
             max_abs_err=fused_new_err["matrix"], ms=fnew_ms["matrix"],
             plain_ms=fnew_plain_ms["matrix"], bound_ms=f_bound, bound_by=f_by,
             library_ms=None),
        dict(name="pbvd_fused prefix", route="cuda", source="src/repro_torch/kernels/csrc/fused.cu",
             replaces="src/repro/kernels/fused.py:414",
             launches=new_launches["fused", "matrix+prefix"]["fused_prefix"],
             max_abs_err=fused_new_err["prefix"], ms=fnew_ms["prefix"],
             plain_ms=fnew_plain_ms["prefix"], bound_ms=f_bound, bound_by=f_by,
             library_ms=None),
        *flash_rows,
    ]
    for row in kernels:  # the bound is the least time the card could take
        if row["bound_ms"] > row["ms"]:
            raise AssertionError(f"{row['name']}: {row['ms']} ms is below its bound "
                                 f"{row['bound_ms']} ms: the operation count or the peak is wrong")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(power, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--fleet-rank"]:  # one rank of phase 30, started by the phase
        sys.exit(fleet_rank(Path(sys.argv[2])))
    sys.exit(main())
