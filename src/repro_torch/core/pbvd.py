"""Parallel Block-based Viterbi Decoder — configuration, framing and the
paper's throughput model (§III-A / eq. 7).

The counterpart of ``repro.core.pbvd``. The stream of received soft symbols
is framed into ``N_t`` parallel blocks of decode length ``D``, each extended
by ``M = L`` truncation stages on the left and ``L`` traceback stages on the
right. All blocks decode independently; on the GPU each parallel block is
one lane of the kernels' batch axis.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import (
    DEFAULT_ACS_K,
    DEFAULT_TB_CHUNK,
    backend_acs_impl,
    backend_acs_radix,
    backend_metric_modes,
    backend_start_policies,
    backend_tb_modes,
    check_code_limits,
    knob_error,
)

from .codespec import CodeSpec
from .quantize import (
    max_symbol_bits,
    metric_dtype_max,
    norm_interval,
    quantize_soft,
    u1_bytes,
    u2_bytes,
)
from .trellis import CCSDS_27, ConvCode

__all__ = [
    "PBVDConfig",
    "decode_stream",
    "decode_stream_sharded",
    "frame_stream",
    "throughput_model",
]


@dataclasses.dataclass(frozen=True)
class PBVDConfig:
    """Decoder configuration. Paper defaults: D=512, L=42 (≈6K), M=L.

    ``spec`` selects a :class:`~repro_torch.core.codespec.CodeSpec` (code +
    puncturing); when given it overrides ``code``. ``backend`` defaults to
    ``"cuda"``, the hand-written two-kernel path; ``"fused"`` runs the
    single kernel, ``"ref"`` the plain PyTorch oracle. Every knob is
    validated at construction against what the backend declares in the
    port's registry, with the reference's uniform :func:`knob_error`, and
    radix 4 is checked against the code (K ≥ 3) and the narrow modes'
    saturation budget (``norm_interval``) before anything runs.

    ``metric_mode`` ``"i16"``/``"i8"`` run the narrow normalized path-metric
    pipeline: the engine quantizes float symbols to ``effective_q`` bits.
    ``acs_radix=4`` runs two trellis stages per ACS step; the decoded bits
    equal radix 2's.

    ``tb_mode`` ``"serial"`` walks one stage per step; ``"prefix"`` composes
    ``tb_chunk``-stage survivor maps in parallel and walks ceil(T/tb_chunk)
    of them; ``"auto"`` resolves to the backend's declared mode (serial on
    all three). ``acs_impl="matrix"`` collapses ``acs_k`` stages into one
    (min,+) step (``acs_radix`` is then ignored); float symbols lower it to
    the radix-2 butterfly. Both are bit-exact to the defaults. ``acs_k`` is
    checked here against the code (1 ≤ k ≤ v, k·R ≤ 8) and, in the narrow
    modes, against the k-stage saturation budget. Last come the backend's
    kernel limits (``"cuda"`` and ``"fused"``: R ≤ 4, ``acs_k`` ≤ 4 under
    matrix, N ≤ 1024), refused with a ``ValueError`` naming the backend,
    the knob and the limit.
    """

    code: ConvCode = CCSDS_27
    D: int = 512  # decode block length
    L: int = 42  # traceback depth (= truncation length M)
    q: int | None = 8  # soft-symbol quantization bits; None → float32
    start_policy: Literal["zero", "argmin"] = "zero"
    backend: Literal["cuda", "fused", "ref"] = "cuda"
    spec: CodeSpec | None = None
    metric_mode: Literal["f32", "i16", "i8"] = "f32"
    tb_mode: Literal["serial", "prefix", "auto"] = "auto"
    tb_chunk: int = DEFAULT_TB_CHUNK  # prefix traceback chunk size
    acs_radix: Literal[2, 4] = 2
    acs_impl: Literal["butterfly", "matrix"] = "butterfly"
    acs_k: int = DEFAULT_ACS_K  # matrix-ACS stages per (min,+) step

    @property
    def T(self) -> int:  # stages per parallel block
        return self.D + 2 * self.L

    @property
    def codespec(self) -> CodeSpec:
        """The effective CodeSpec (wrapping ``code`` when none was given)."""
        if self.spec is not None:
            return self.spec
        return CodeSpec(name=f"(2,1,{self.code.K})" if self.code.R == 2 else "custom",
                        code=self.code)

    @property
    def effective_q(self) -> int | None:
        """Quantizer width the engine actually applies to float symbols.

        ``f32`` keeps ``q`` as configured; the narrow metric modes quantize
        unconditionally (integer metrics need integer symbols) and cap the
        width at the widest q whose worst-case metric fits the mode's dtype
        (:func:`~repro_torch.core.quantize.max_symbol_bits`).
        """
        if self.metric_mode == "f32":
            return self.q
        cap = max_symbol_bits(self.code, metric_dtype_max(self.metric_mode))
        return min(self.q or 8, cap)

    def quantize(self, y: torch.Tensor) -> torch.Tensor:
        """Quantize float soft symbols per the configured metric mode.

        ``f32``/``i16`` use the quantizer's default range. The coarse ``i8``
        quantizer (q = 3 for the registered codes) maps |y| = 2 to full
        scale, ``qmax / 2``, as the reference does.
        """
        q = self.effective_q
        if q is None:
            return y
        scale = ((1 << (q - 1)) - 1) / 2.0 if self.metric_mode == "i8" else None
        return quantize_soft(y, q, scale)

    def __post_init__(self):
        if self.D <= 0 or self.L < 0:
            raise ValueError("D must be positive, L non-negative")
        for knob, value, allowed in (
            ("start_policy", self.start_policy, backend_start_policies(self.backend)),
            ("metric_mode", self.metric_mode, backend_metric_modes(self.backend)),
            ("tb_mode", self.tb_mode, (*backend_tb_modes(self.backend), "auto")),
            ("acs_impl", self.acs_impl, backend_acs_impl(self.backend)),
            ("acs_radix", self.acs_radix, backend_acs_radix(self.backend)),
        ):
            if value not in allowed:
                raise knob_error(self.backend, knob, value, allowed)
        if self.tb_chunk < 1:
            raise ValueError(f"tb_chunk must be >= 1, got {self.tb_chunk}")
        if self.spec is not None and self.spec.code is not self.code:
            # keep cfg.code authoritative for kernel callers
            object.__setattr__(self, "code", self.spec.code)
        if self.acs_impl == "matrix":
            # the fusion depth's structural bounds, then the narrow modes'
            # budget for k unnormalized stages per step — at config time
            self.code.validate_matrix_k(self.acs_k)
            norm_interval(self.code, self.metric_mode, stages_per_step=self.acs_k)
        elif self.acs_radix == 4:
            if self.code.n_states < 4:
                raise ValueError(f"acs_radix=4 needs K >= 3 (got K={self.code.K})")
            # narrow modes: the saturation budget must absorb the fused
            # step's two unnormalized stages — fail at config time
            norm_interval(self.code, self.metric_mode, self.acs_radix)
        # last, so that what the reference refuses keeps its message
        check_code_limits(self.backend, self.code, self.acs_impl, self.acs_k)


def frame_stream(y: torch.Tensor, D: int, L: int, n_blocks: int) -> torch.Tensor:
    """Frame a symbol stream into overlapping parallel blocks.

    y: (..., n_sym, R) soft symbols → (..., T, R, N_t) with T = D + 2L. Block
    b covers global stages [bD - L, bD + D + L); out-of-range stages are zero
    (BM-neutral). Leading dimensions frame independent streams.
    """
    *lead, n_sym, R = y.shape
    T = D + 2 * L
    pad_tail = max(n_blocks * D + L - n_sym, 0)
    yp = F.pad(y, (0, 0, L, pad_tail))
    idx = torch.arange(T, device=y.device)[:, None] + torch.arange(n_blocks, device=y.device) * D
    blocks = yp.index_select(-2, idx.reshape(-1)).reshape(*lead, T, n_blocks, R)
    return blocks.transpose(-1, -2).contiguous()


def decode_stream(y, n_bits: int, cfg: PBVDConfig = PBVDConfig(), *, device=None) -> torch.Tensor:
    """Decode a soft-symbol stream. y: (n_sym, R) → (n_bits,) int32 bits.

    Thin wrapper over :class:`~repro_torch.core.engine.DecoderEngine`;
    ``device`` follows the engine's rule (``None`` means ``"cuda"``).
    """
    from .engine import DecoderEngine  # the engine imports this module

    return DecoderEngine(cfg, device=device).decode(y, n_bits)


def decode_stream_sharded(
    y,
    n_bits: int,
    cfg: PBVDConfig,
    mesh,
    *,
    block_axes: tuple[str, ...] | None = ("data",),
    shard_dispatch: str = "constraint",
) -> torch.Tensor:
    """Sharded stream decode: thin wrapper over a mesh-bound engine.

    ``mesh`` is a :class:`~repro_torch.launch.mesh.DecodeMesh`; the bits
    come back on its first device of this process (every rank's, on a mesh
    that spans processes). ``block_axes=None`` resolves the
    ``"blocks"`` logical-axis rule against the mesh; ``shard_dispatch`` picks
    the lane dispatch (see :class:`~repro_torch.core.engine.DecoderEngine`).
    """
    from .engine import DecoderEngine  # the engine imports this module

    engine = DecoderEngine(
        cfg, mesh=mesh, block_axes=block_axes, shard_dispatch=shard_dispatch
    )
    return engine.decode(y, n_bits)


def throughput_model(
    *,
    D: int,
    L: int,
    R: int,
    q: int | None,
    packed_out: bool,
    s_kernel_mbps: float,
    n_streams: int = 3,
    bandwidth_gbps: float = 8.0,
) -> float:
    """Paper eq. (7): decoding throughput in Mbps given kernel throughput S_k.

    ``bandwidth_gbps`` is the host↔device link (PCIe 2.0 ≈ 8 GB/s in the
    paper's GTX580 setup):

      T/P [bit/s] = N_s / ((1 + 2L/D)·U₁/B + N_s/S_k + U₂/B)

    with U in bytes/bit, B in bytes/s, S_k in bit/s.
    """
    B = bandwidth_gbps * 1e9  # bytes/s
    s_k = s_kernel_mbps * 1e6  # bit/s
    u1 = u1_bytes(R, q)
    u2 = u2_bytes(packed_out)
    denom = (1.0 + 2.0 * L / D) * u1 / B + n_streams / s_k + u2 / B
    return n_streams / denom / 1e6  # Mbps
