#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of the repository

Phases, each printed on its own lines; any mismatch or exception exits
non-zero and prints no result:

1. build every kernel of ``src/repro_torch/kernels/csrc/`` with nvcc;
2. K1 (forward ACS) against its plain PyTorch version on the card, at the
   main path's shapes and for several codes, symbol dtypes and ragged batch
   widths: survivor words equal, path metrics equal (float32: allclose,
   rtol 1e-6, though the same add order makes them exact);
3. K2 (serial traceback) against its plain version: zero, argmin and random
   start states, bits equal;
4. the main path, ``DecoderEngine(PBVDConfig()).decode`` on a 4,194,304-bit
   CCSDS stream made on the card at Eb/N0 4 dB: equal to ``backend="ref"``
   bit for bit, both kernels launched, a noiseless stream decoded with 0
   errors, and the BER printed (and below 1e-4);
5. the serving path, ``decode_batch`` of 64 streams × 65,536 bits (and a
   small ragged fleet) equal to per-stream ``decode``;
6. times: each kernel's median CUDA-event time at the main-path shapes, its
   plain version's, its bound, decoded Mb/s end to end and on the device,
   bytes per decoded bit and the host phases.

The line before the last is the card's name and power limit; the last line
is ``{"ok": true, "device": {...}}``. Exits non-zero, with no result, when
torch finds no CUDA device or when the port's sources are missing.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016
N_MAIN_BLOCKS = 8192  # 8192 × D=512 = 4,194,304 decoded bits
EBN0_DB = 4.0
N_STREAMS, STREAM_BITS = 64, 65536

# H100 SXM peaks (NVIDIA data sheet): 3.35 TB/s HBM3. The sheet gives
# 67 TFLOP/s float32 outside the tensor cores, i.e. 132 SMs × 128 lanes × 2
# (FMA) × 1.98 GHz; a Hopper SM has 64 INT32 lanes, so the 32-bit integer
# ALU peak is 132 × 64 × 1.98e9 op/s. Rates assume the full 700 W limit.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


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


def k1_cost(code, T: int, B: int, sym_bytes: int) -> tuple[float, float]:
    """(bytes, operations) K1 must move and do: symbols in, survivor words and
    final metrics out; per stage and block 2^(R-1)·(R-1) folded-metric adds
    and, per state, two adds, a compare and a select."""
    W = -(-code.n_states // 32)
    nbytes = T * code.R * B * sym_bytes + T * W * B * 4 + code.n_states * B * 4
    ops = T * B * (4 * code.n_states + code.n_folded * (code.R - 1))
    return float(nbytes), float(ops)


def k2_cost(T: int, B: int, decode_start: int, n_decode: int) -> tuple[float, float]:
    """(bytes, operations) of the serial walk: one start state and one word per
    walked stage in, one bit word per decoded stage out; about six integer
    operations per walked stage."""
    walked = T - 1 - decode_start
    nbytes = B * 4 + B * walked * 4 + n_decode * B * 4
    ops = B * (T - decode_start) * 6
    return float(nbytes), float(ops)


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; nothing to check", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not under {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))

    from repro_torch.core.channel import bpsk, transmit
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.encoder import encode
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.core.trellis import ConvCode
    from repro_torch.kernels import _build, acs, traceback

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (count {torch.cuda.device_count()}), torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ---- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"[1 build] nvcc built {built} in {time.perf_counter() - t0:.2f} s "
        f"(flags {' '.join(_build.NVCC_FLAGS)})")

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

    # ---- 4. main path ----------------------------------------------------------
    cfg = PBVDConfig()
    n_bits = N_MAIN_BLOCKS * cfg.D
    payload = torch.randint(0, 2, (n_bits,), generator=gen, device=dev, dtype=torch.int32)
    flushed = torch.cat([payload, payload.new_zeros(cfg.code.v)])
    coded = encode(flushed, cfg.code)
    y = transmit(gen, coded, EBN0_DB, cfg.codespec.rate)
    engine = DecoderEngine(cfg)
    engine.decode(y[: 4 * cfg.D], 4 * cfg.D)  # first call loads the kernels
    torch.cuda.synchronize()
    acs.launches = traceback.launches = 0
    bits = engine.decode(y, n_bits)
    torch.cuda.synchronize()
    main_launches = {"acs": acs.launches, "traceback": traceback.launches}
    if min(main_launches.values()) < 1:
        raise AssertionError(f"main path did not launch every kernel: {main_launches}")
    ref_bits = DecoderEngine(PBVDConfig(backend="ref")).decode(y, n_bits)
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
    dec_bits = engine._decode_blocks(blocks, (n_blocks,))
    unpack_ms = wall_ms(torch, lambda: dec_bits.t().reshape(-1)[:n_bits].contiguous(), reps=5)
    e2e_ms = wall_ms(torch, lambda: engine.decode(y, n_bits), reps=5)
    k1_bytes, k1_ops = k1_cost(cfg.code, cfg.T, n_blocks, blocks.element_size())
    k2_bytes, k2_ops = k2_cost(cfg.T, n_blocks, cfg.L, cfg.D)
    k1_bound, k1_by = bound(k1_bytes, k1_ops, INT32_OPS_PER_S)
    k2_bound, k2_by = bound(k2_bytes, k2_ops, INT32_OPS_PER_S)
    log(f"[6 times] K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.3f} ms, bound {k1_bound:.4f} ms by "
        f"{k1_by}: {k1_bytes:.0f} B, {k1_ops:.0f} int32 op)")
    log(f"[6 times] K2 {k2_ms:.4f} ms (plain {k2_plain_ms:.3f} ms, bound {k2_bound:.4f} ms by "
        f"{k2_by}: {k2_bytes:.0f} B, {k2_ops:.0f} int32 op)")
    log(f"[6 times] host phases: frame (check+quantize+frame) {frame_ms:.3f} ms, "
        f"dispatch+K1+argmin/start+K2 {blocks_ms:.3f} ms, unpack {unpack_ms:.3f} ms; "
        f"end to end {e2e_ms:.3f} ms")
    log(f"[6 times] decoded Mb/s: end to end {n_bits / e2e_ms / 1e3:.1f}, "
        f"on the device (K1+K2) {n_bits / (k1_ms + k2_ms) / 1e3:.1f}; "
        f"bytes per decoded bit: K1 {k1_bytes / n_bits:.3f} + K2 {k2_bytes / n_bits:.3f} = "
        f"{(k1_bytes + k2_bytes) / n_bits:.3f}")

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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
