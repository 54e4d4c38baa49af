"""The one-shot decode path of the port: ``DecoderEngine``.

The counterpart of ``repro.core.engine.DecoderEngine`` without the mesh and
the streaming sessions (still to be ported):

* **codes** come from a :class:`~repro_torch.core.codespec.CodeSpec` —
  punctured streams are depunctured with BM-neutral zeros first;
* **backends** are looked up in the port's kernel registry through
  :func:`~repro_torch.kernels.ops.pbvd_decode_blocks`: ``"cuda"`` (K1 then
  K2), ``"fused"`` (one kernel) and ``"ref"`` (plain PyTorch);
* **metric modes** ``"f32"``/``"i16"``/``"i8"``: float symbols are
  quantized by ``cfg.quantize`` (``effective_q`` bits; the coarse i8
  scale) before framing, so the narrow pipelines never saturate;
* **batching across streams** is :meth:`DecoderEngine.decode_batch`: the
  framed blocks of many streams are concatenated along the lane axis and
  decoded in ONE launch of each kernel (one fused launch on ``"fused"``).
  The kernels mask the ragged lane edge, so no lanes are padded;
  per-stream bits equal sequential :meth:`DecoderEngine.decode` calls
  because parallel blocks never interact.

The engine runs on the GPU unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and with no CUDA device the engine refuses to start
(:class:`DeviceUnavailableError`) instead of carrying on on the CPU.
Inputs (numpy arrays or tensors) are moved to the engine's device; outputs
are int32 tensors there.
"""

from __future__ import annotations

import torch

from repro_torch.device import DeviceUnavailableError, resolve_device
from repro_torch.kernels.ops import pbvd_decode_blocks
from repro_torch.launch.faults import SymbolError, check_finite_symbols

from .codespec import CodeSpec
from .pbvd import PBVDConfig, frame_stream

__all__ = ["DecoderEngine", "DeviceUnavailableError", "resolve_device"]


class DecoderEngine:
    """Single entry point for PBVD decoding.

    Parameters
    ----------
    cfg: PBVDConfig — decode geometry (D, L), quantization, backend, code/spec.
    device: where the engine decodes; ``None`` means ``"cuda"``.
    """

    def __init__(self, cfg: PBVDConfig | None = None, *, device=None):
        self.cfg = cfg if cfg is not None else PBVDConfig()
        self.spec: CodeSpec = self.cfg.codespec
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ one-shot
    def decode(self, y, n_bits: int | None = None) -> torch.Tensor:
        """Decode a soft-symbol stream → (n_bits,) int32 bits.

        ``y`` is either a (n_stages, R) full-rate stream or, for a punctured
        spec, a 1-D stream of received (punctured) symbols, which is
        depunctured with BM-neutral zeros first. ``n_bits`` defaults to the
        number of full-rate stages in the stream.
        """
        blocks, n_blocks, n_bits = self._frame_one(y, n_bits)
        bits = self._decode_blocks(blocks, (n_blocks,))  # (D, n_blocks)
        return bits.t().reshape(-1)[:n_bits]

    # ------------------------------------------------------------------ batched
    def decode_batch(self, ys, n_bits_list=None) -> list[torch.Tensor]:
        """Decode many independent streams in ONE launch of each kernel.

        ``ys`` is a sequence of streams, each in any form :meth:`decode`
        accepts; ``n_bits_list`` gives each stream's payload length (or
        ``None`` entries / ``None`` for the stage-count default). Returns a
        list of (n_bits_i,) int32 tensors, bit-identical per stream to
        sequential ``decode()`` calls.
        """
        ys = [self._to_device(y) for y in ys]
        if not ys:
            return []
        if n_bits_list is None:
            n_bits_list = [None] * len(ys)
        if len(n_bits_list) != len(ys):
            raise ValueError(
                f"n_bits_list has {len(n_bits_list)} entries for {len(ys)} streams"
            )
        uniform = self._frame_uniform(ys, n_bits_list)
        if uniform is not None:
            packed, frame_counts, bit_counts = uniform
        else:
            framed = [self._frame_one(y, nb) for y, nb in zip(ys, n_bits_list)]
            frame_counts = tuple(k for _, k, _ in framed)
            bit_counts = tuple(nb for _, _, nb in framed)
            packed = torch.cat([b for b, _, _ in framed], dim=2)
        bits = self._decode_blocks(packed, frame_counts)  # (D, total)
        if uniform is not None:  # equal frames: one reshape, not S slices
            S, k, n_bits = len(ys), frame_counts[0], bit_counts[0]
            rows = bits.reshape(-1, S, k).permute(1, 2, 0).reshape(S, -1)
            return list(rows[:, :n_bits])
        out, lo = [], 0
        for k, n_bits in zip(frame_counts, bit_counts):
            out.append(bits[:, lo : lo + k].t().reshape(-1)[:n_bits])
            lo += k
        return out

    # ------------------------------------------------------------------ internals
    def _to_device(self, y) -> torch.Tensor:
        """Symbols as a tensor on the engine's device: floats as float32,
        integers other than int8/int16/int32 as int32 (the reference's
        array conversion)."""
        t = torch.as_tensor(y)
        if t.is_floating_point():
            t = t.to(torch.float32)
        elif t.dtype not in (torch.int8, torch.int16, torch.int32):
            t = t.to(torch.int32)
        return t.to(self.device)

    def _frame_one(self, y, n_bits: int | None):
        """Depuncture, quantize and frame one stream → (blocks, n_blocks, n_bits)."""
        y = self._to_full_rate(self._to_device(y))
        # reject NaN/Inf before framing: a non-finite symbol would corrupt
        # the path metrics of every lane coalesced into the launch
        check_finite_symbols(y, "DecoderEngine.decode")
        if n_bits is None:
            n_bits = int(y.shape[0])
        cfg = self.cfg
        n_blocks = -(-n_bits // cfg.D)
        if y.is_floating_point():
            y = cfg.quantize(y)  # already-integer inputs are pre-quantized
        return frame_stream(y, cfg.D, cfg.L, n_blocks), n_blocks, n_bits

    def _frame_uniform(self, ys: list[torch.Tensor], n_bits_list):
        """Fast path for same-shape stream fleets (the serving common case).

        Stacks the streams, quantizes once and frames all of them in one
        call. Returns ``None`` when streams differ in shape/dtype/length.
        """
        if len(ys) < 2:
            return None
        shapes = {tuple(y.shape) for y in ys}
        dtypes = {y.dtype for y in ys}
        if len(shapes) != 1 or len(dtypes) != 1 or len(set(n_bits_list)) != 1:
            return None
        for i, y in enumerate(ys):
            check_finite_symbols(y, f"DecoderEngine.decode_batch (stream {i})")
        y0 = torch.stack([self._to_full_rate(y) for y in ys])  # (S, n, R)
        S, n_sym, R = y0.shape
        n_bits = n_bits_list[0] if n_bits_list[0] is not None else n_sym
        cfg = self.cfg
        k = -(-n_bits // cfg.D)
        if y0.is_floating_point():
            y0 = cfg.quantize(y0)
        blocks = frame_stream(y0, cfg.D, cfg.L, k)  # (S, T, R, k)
        packed = blocks.permute(1, 2, 0, 3).reshape(cfg.T, R, S * k)
        return packed, (k,) * S, (n_bits,) * S

    def _to_full_rate(self, y: torch.Tensor) -> torch.Tensor:
        if y.dim() == 1:
            if not self.spec.is_punctured:
                raise SymbolError(
                    "1-D symbol stream given but the code spec is unpunctured; "
                    "pass (n_stages, R) soft symbols"
                )
            return self.spec.depuncture_stream(y)
        if y.shape[-1] != self.spec.code.R:
            raise SymbolError(f"stream rank {y.shape[-1]} != code R {self.spec.code.R}")
        return y

    def _decode_blocks(self, blocks: torch.Tensor, frame_counts: tuple[int, ...]):
        """(T, R, B) framed symbols → (D, sum(frame_counts)) bits."""
        cfg = self.cfg
        return pbvd_decode_blocks(
            blocks,
            self.spec.code,
            decode_start=cfg.L,
            n_decode=cfg.D,
            start_policy=cfg.start_policy,
            backend=cfg.backend,
            frame_counts=frame_counts,
            metric_mode=cfg.metric_mode,
            tb_mode=cfg.tb_mode,
            tb_chunk=cfg.tb_chunk,
            acs_radix=cfg.acs_radix,
            acs_impl=cfg.acs_impl,
            acs_k=cfg.acs_k,
        )
