"""Time the port's decoder kernels and decode paths of a checkout on one GPU.

    python3 src/repro_torch/launch/kernel_times.py                # this checkout
    python3 src/repro_torch/launch/kernel_times.py --src OTHER/src
    python3 src/repro_torch/launch/kernel_times.py --turns OTHER/src

At the main shapes (CCSDS, D = 512, L = 42, T = 596, 8,192 parallel blocks,
int8 symbols made on the card from a fixed seed, zero start) it prints one
JSON line of CUDA-event medians in ms: K1 (radix 2, radix 4, i8), K2,
K2-prefix, K1-matrix (k = 2, 3, 4), the fused kernel (radix 2, radix 4,
i8, prefix, matrix at k = 2 and 3, prefix with matrix at k = 2), and
the host-clock medians of ``"cuda"`` and ``"fused"`` decodes of the
4,194,304-bit stream, at the default config, with ``acs_impl="matrix"``
and with ``tb_mode="prefix"``; the device time per launch under
``torch.profiler`` of K2, K2-prefix and the fused serial and prefix
variants at 8,192, 264 and 32 blocks; first, the wall time of building
``acs.cu`` and ``fused.cu`` (in parallel), then ``traceback.cu``, where
they were not built yet, else null. It calls only what every checkout of
the port since its prefix and matrix slice has, so it can time an older
tree: ``--src`` imports ``repro_torch`` from there. ``--turns OTHER/src``
runs OTHER and this checkout in separate processes, in the order OTHER,
this, this, OTHER, and prints each line with the card's name and power
limit, so that two versions are compared on one card. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

THIS_SRC = Path(__file__).resolve().parents[2]
SEED = 20261017
N_BLOCKS = 8192


def measure(src: Path) -> dict:
    sys.path.insert(0, str(src))
    import torch

    from repro_torch.core.channel import transmit
    from repro_torch.core.encoder import encode
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.kernels import _build, acs, fused, traceback

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: torch finds no CUDA device")
    t0 = time.perf_counter()
    built = _build.build_all(["acs", "fused"])
    build_s = time.perf_counter() - t0 if built else None
    t0 = time.perf_counter()
    built = _build.build_all(["traceback"])
    build_tb_s = time.perf_counter() - t0 if built else None
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cfg = PBVDConfig()
    code, n_bits = cfg.code, N_BLOCKS * cfg.D
    payload = torch.randint(0, 2, (n_bits,), generator=gen, device=dev, dtype=torch.int32)
    coded = encode(torch.cat([payload, payload.new_zeros(code.v)]), code)
    y = transmit(gen, coded, 4.0, cfg.codespec.rate)
    engines = {be: DecoderEngine(PBVDConfig(backend=be), device=dev) for be in ("cuda", "fused")}
    engines.update({f"{be} matrix": DecoderEngine(PBVDConfig(backend=be, acs_impl="matrix"),
                                                  device=dev) for be in ("cuda", "fused")})
    engines.update({f"{be} prefix": DecoderEngine(PBVDConfig(backend=be, tb_mode="prefix"),
                                                  device=dev) for be in ("cuda", "fused")})
    blocks = engines["cuda"]._frame_one(y, n_bits)[0]
    i8_blocks = DecoderEngine(PBVDConfig(metric_mode="i8"), device=dev)._frame_one(y, n_bits)[0]
    sp, _ = acs.acs_forward(blocks, code)
    fkw = dict(decode_start=cfg.L, n_decode=cfg.D)

    def cuda_ms(fn, reps=20):
        for _ in range(3):
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

    def device_ms(fn, reps=10):
        """Device time per launch of the decoder kernel ``fn`` launches (the
        profiler's kernels named traceback* or fused*), else None."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = count = 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            us = getattr(e, "self_cuda_time_total", 0) if us is None else us
            if us > 0 and ("traceback" in e.key or "fused" in e.key):
                total, count = total + us, count + e.count
        return total / count / 1e3 if count else None

    def wall_ms(fn, reps=7):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    out = {
        "K1": cuda_ms(lambda: acs.acs_forward(blocks, code)),
        "K1 radix 4": cuda_ms(lambda: acs.acs_forward(blocks, code, radix=4)),
        "K1 i8": cuda_ms(lambda: acs.acs_forward(i8_blocks, code, "i8")),
        "K2": cuda_ms(lambda: traceback.traceback(sp, code, cfg.L, cfg.D, 0)),
        "K2-prefix": cuda_ms(lambda: traceback.traceback_prefix(sp, code, cfg.L, cfg.D, 0, 64)),
        "K1-matrix k=2": cuda_ms(lambda: acs.acs_forward(blocks, code, impl="matrix", k=2)),
        "K1-matrix k=3": cuda_ms(lambda: acs.acs_forward(blocks, code, impl="matrix", k=3)),
        "K1-matrix k=4": cuda_ms(lambda: acs.acs_forward(blocks, code, impl="matrix", k=4)),
        "fused": cuda_ms(lambda: fused.pbvd_fused(blocks, code, **fkw)),
        "fused radix 4": cuda_ms(lambda: fused.pbvd_fused(blocks, code, radix=4, **fkw)),
        "fused i8": cuda_ms(lambda: fused.pbvd_fused(i8_blocks, code, metric_mode="i8", **fkw)),
        "fused prefix": cuda_ms(lambda: fused.pbvd_fused(blocks, code, tb_mode="prefix", **fkw)),
        "fused prefix matrix": cuda_ms(lambda: fused.pbvd_fused(blocks, code, tb_mode="prefix",
                                                                impl="matrix", k=2, **fkw)),
        "fused matrix": cuda_ms(lambda: fused.pbvd_fused(blocks, code, impl="matrix", k=2, **fkw)),
        "fused matrix k=3": cuda_ms(lambda: fused.pbvd_fused(blocks, code, impl="matrix", k=3,
                                                             **fkw)),
    }
    for be, eng in engines.items():
        out[f"{be} end to end"] = wall_ms(lambda: eng.decode(y, n_bits))
    # device time per launch under the profiler, serial against prefix, at
    # the main width and two small ones
    for B in (N_BLOCKS, 264, 32):
        sp_b, y_b = sp[:, :, :B].contiguous(), blocks[:, :, :B].contiguous()
        tag = "" if B == N_BLOCKS else f" B={B}"
        out[f"K2{tag} device"] = device_ms(lambda: traceback.traceback(sp_b, code, cfg.L, cfg.D, 0))
        out[f"K2-prefix{tag} device"] = device_ms(
            lambda: traceback.traceback_prefix(sp_b, code, cfg.L, cfg.D, 0, 64))
        out[f"fused{tag} device"] = device_ms(lambda: fused.pbvd_fused(y_b, code, **fkw))
        out[f"fused prefix{tag} device"] = device_ms(
            lambda: fused.pbvd_fused(y_b, code, tb_mode="prefix", **fkw))
    return {"build acs+fused s": build_s, "build traceback s": build_tb_s,
            **{k: v if v is None else round(v, 4) for k, v in out.items()}}


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=THIS_SRC, help="the src/ of the checkout to time")
    ap.add_argument("--turns", type=Path, metavar="OTHER_SRC",
                    help="time OTHER_SRC and this checkout in turns: other, this, this, other")
    args = ap.parse_args()
    if args.turns is None:
        print(json.dumps(measure(args.src.resolve())), flush=True)
        return 0
    print(f"card: {card()}", flush=True)
    for label, src in (("other", args.turns), ("this", THIS_SRC), ("this", THIS_SRC),
                       ("other", args.turns)):
        run = subprocess.run([sys.executable, __file__, "--src", str(src.resolve())],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stdout + run.stderr, file=sys.stderr)
            return run.returncode
        print(f"{label} {src}: {run.stdout.strip().splitlines()[-1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
