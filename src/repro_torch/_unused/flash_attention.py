"""Flash attention (GQA, causal, sliding window): wrapper, plain version, count.

The counterpart of ``repro._unused.flash_attention``. The CUDA kernel
``kernels/csrc/flash_attention.cu`` replaces the TPU kernel
``_flash_kernel`` (driven by ``flash_attention``): an online softmax over
blocks of keys in float32, with blocks outside the causal or windowed band
skipped. It has two bodies: bfloat16 inputs run the tensor-core body
(``wgmma`` on bf16 tiles fed by TMA, :func:`tc_tile_plan`), float32 inputs
the CUDA-core body (:func:`tile_plan`). :func:`flash_attention` has the
reference's signature and checks
(``S % q_chunk`` and ``T % kv_chunk`` raise the same ``ValueError``); the
TPU's ``q_chunk``/``kv_chunk`` are checked as the reference checks them, and
the CUDA kernel chooses its own tiles (:func:`tile_plan`). For a CPU tensor
it runs the plain version :func:`ref_mha` and casts to q's dtype; for a CUDA
tensor it launches the kernel or raises, never falling back; for a meta
tensor it launches nothing and reports the band's work to the work counter
(``launch/cost.py``). There is no
interpret mode: ``interpret`` is accepted and ignored.

:func:`band_blocks` and :func:`launch_args` are the kernel's block range and
argument list in Python, so the CPU tests reach them, and
:func:`tc_block_needs_mask` the tensor-core body's choice of the blocks it
masks. ``launches`` counts the kernel's launches, either body, and nothing
else; ``tc_launches`` those of them that ran the tensor-core body.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.launch import cost

__all__ = [
    "flash_attention",
    "ref_mha",
    "band_blocks",
    "launch_args",
    "tile_plan",
    "tc_tile_plan",
    "tc_block_needs_mask",
    "launches",
    "tc_launches",
    "NEG_INF",
]

NEG_INF = -1e30

#: launches of the CUDA kernel (either body) since the count was last set to 0
launches = 0
#: those of them that ran the tensor-core body (bfloat16 inputs)
tc_launches = 0

#: the kernel's tiles (csrc/flash_attention.cu: kRows, kKeys, kThreads)
ROWS_PER_CTA = 64
KEYS_PER_BLOCK = 64
THREADS = 256
#: head dims the kernel is built for, and its input dtypes by code
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMEM_PER_CTA = 232448
#: the tensor-core body's tiles (csrc/flash_attention.cu: kTcRows, kTcKeys,
#: kTcThreads, kTcStages): two consumer warpgroups of 64 rows and one
#: producer warp; a ring of K and V tiles
TC_ROWS_PER_CTA = 128
TC_KEYS_PER_BLOCK = KEYS_PER_BLOCK
TC_THREADS = 288
TC_STAGES = 4


def ref_mha(q, k, v, *, causal=True, window=None, scale=None):
    """Oracle: q (B,S,Hkv,G,dh), k/v (B,T,Hkv,dh) → (B,S,Hkv,G,dh), f32 math.

    One (batch, kv head) at a time, so that the (G, S, T) scores are the
    largest temporary.
    """
    B, S, Hkv, G, dh = q.shape
    T = k.shape[1]
    scale = scale or 1.0 / math.sqrt(dh)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    out = torch.empty((B, S, Hkv, G, v.shape[-1]), dtype=torch.float32, device=q.device)
    for b in range(B):
        for h in range(Hkv):
            s = torch.einsum("sgd,td->gst", q[b, :, h].float() * scale, k[b, :, h].float())
            s.masked_fill_(~mask, NEG_INF)
            p = torch.softmax(s, dim=-1)
            out[b, :, h] = torch.einsum("gst,td->sgd", p, v[b, :, h].float())
    return out


def tile_plan(B: int, S: int, Hkv: int, G: int, dh: int) -> tuple[tuple[int, int], int, int]:
    """(grid, threads, shared bytes per CTA) of a launch.

    A CTA takes 64 consecutive (position, group member) rows of one (batch,
    kv head) and walks 64-key blocks; it stages q, K and V as float32 with a
    row pitch of dh + 4, and the block's probabilities reuse the K tile.
    Head dims other than 16, 32, 64 and 128 raise ``ValueError``.
    """
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim in {HEAD_DIMS}, got {dh}")
    pitch = dh + 4
    k_tile = max(KEYS_PER_BLOCK * pitch, KEYS_PER_BLOCK * (ROWS_PER_CTA + 4))
    smem = 4 * (ROWS_PER_CTA * pitch + k_tile + KEYS_PER_BLOCK * pitch)
    assert smem <= _SMEM_PER_CTA
    grid = (-(-(S * G) // ROWS_PER_CTA), B * Hkv)
    return grid, THREADS, smem


def tc_tile_plan(B: int, S: int, Hkv: int, G: int, dh: int) -> tuple[tuple[int, int], int, int]:
    """(grid, threads, shared bytes per CTA) of a launch of the tensor-core body.

    A CTA takes 128 consecutive (position, group member) rows of one (batch,
    kv head): two consumer warpgroups of 64 rows and one producer warp. It
    holds Q (128 × dh bf16) and a ring of ``TC_STAGES`` K and V tiles of 64
    keys, plus 1 KB to align the swizzled tiles and 64 B of barriers. Head
    dims other than 16, 32, 64 and 128 raise ``ValueError``.
    """
    if dh not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim in {HEAD_DIMS}, got {dh}")
    smem = 2 * dh * (TC_ROWS_PER_CTA + 2 * TC_STAGES * TC_KEYS_PER_BLOCK) + 1024 + 64
    assert smem <= _SMEM_PER_CTA
    grid = (-(-(S * G) // TC_ROWS_PER_CTA), B * Hkv)
    return grid, TC_THREADS, smem


def band_blocks(row0: int, rows: int, G: int, T: int, causal: bool,
                window: int | None) -> tuple[int, int]:
    """The 64-key blocks [lo, hi) that rows [row0, row0 + rows) can see.

    Row R is query position R // G. With a window w, keys below
    p_lo - w + 1 are outside every row's band; when causal, keys above p_hi
    are. A row at p >= T + w - 1 sees no key: its softmax of equal -1e30
    scores averages V over all T keys (keys past T weigh 0 in the kernel),
    so a tile that holds one walks every block.
    ``csrc/flash_attention.cu::band_blocks`` computes the same for both
    bodies.
    """
    p_lo, p_hi = row0 // G, (row0 + rows - 1) // G
    if window and p_hi >= T + window - 1:
        return 0, -(-T // KEYS_PER_BLOCK)
    lo = max(0, p_lo - window + 1) if window else 0
    hi = min(T, p_hi + 1) if causal else T
    lo_blk = lo // KEYS_PER_BLOCK
    return lo_blk, (-(-hi // KEYS_PER_BLOCK) if hi > lo else lo_blk)


def tc_block_needs_mask(r0: int, n_rows: int, G: int, T: int, kb: int, causal: bool,
                        window: int | None) -> bool:
    """Whether the tensor-core body masks key block ``kb`` for the warpgroup
    of rows [r0, r0 + 64): unless every key of the block lies below T and
    inside every valid row's band (``csrc/flash_attention.cu``:
    ``block_needs_mask``)."""
    last = min(r0 + 64, n_rows) - 1
    if last < r0:
        return True
    p_lo, p_hi = r0 // G, last // G
    t0, t1 = kb * TC_KEYS_PER_BLOCK, (kb + 1) * TC_KEYS_PER_BLOCK - 1
    return t1 >= T or (causal and t1 > p_lo) or bool(window and t0 <= p_hi - window)


def launch_args(q, k, v, out, *, causal: bool, window: int | None, scale: float) -> tuple:
    """The arguments of ``flash_attention_fwd`` but the stream, after the
    checks the kernel needs: one device and one dtype (float32 or bfloat16),
    contiguous tensors aligned to 16 bytes, k and v of shape (B, T, Hkv, dh)
    and out of q's shape, a head dim the kernel is built for and a window of
    at least 1. Anything else raises ``ValueError``."""
    if q.dim() != 5 or k.dim() != 4:
        raise ValueError(f"q must be (B,S,Hkv,G,dh) and k, v (B,T,Hkv,dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    B, S, Hkv, G, dh = q.shape
    T = k.shape[1]
    if tuple(k.shape) != (B, T, Hkv, dh) or v.shape != k.shape or out.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"out {tuple(out.shape)} do not match")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"the flash kernel takes float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is {q.dtype} on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    (tc_tile_plan if q.dtype == torch.bfloat16 else tile_plan)(B, S, Hkv, G, dh)
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, T, Hkv, G, dh,
            _DTYPE_CODE[q.dtype], int(bool(causal)), -1 if window is None else int(window),
            float(scale))


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,  # (B, S, Hkv, G, dh)
    k: torch.Tensor,  # (B, T, Hkv, dh)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    scale: float | None = None,
    q_chunk: int = 256,
    kv_chunk: int = 256,
    interpret: bool = False,
) -> torch.Tensor:
    """Attention of q over k, v → (B, S, Hkv, G, dh) in q's dtype."""
    global launches, tc_launches
    B, S, Hkv, G, dh = q.shape
    T = k.shape[1]
    scale = scale or 1.0 / math.sqrt(dh)
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    if S % q_chunk or T % kv_chunk:
        raise ValueError(f"S={S} % {q_chunk} or T={T} % {kv_chunk} != 0")
    if q.device.type == "cpu":
        return ref_mha(q, k, v, causal=causal, window=window, scale=scale).to(q.dtype)
    if q.device.type == "meta":  # launches nothing; its work by the band, for the counter
        cost.kernel("flash_attention", *cost.flash_cost(
            B, S, T, Hkv, G, dh, causal, window, q.element_size()),
            "bf16" if q.dtype == torch.bfloat16 else "f32")
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CPU or CUDA tensors, got {q.device}")
    out = torch.empty_like(q)
    args = launch_args(q, k, v, out, causal=causal, window=window, scale=scale)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _lib().flash_attention_fwd(*args, stream)
    if rc:
        raise RuntimeError(f"flash_attention_fwd launch failed (error {rc})")
    launches += 1
    if q.dtype == torch.bfloat16:  # the C side sends bf16, and only bf16, to the tensor-core body
        tc_launches += 1
    return out
