"""The perf iteration tables from the port's dry-run reports.

The counterpart of ``repro.launch.perf_report``: the same tables, over
``reports/torch_dryrun/`` (the defaults) and ``reports/torch_perf/`` (the
same cells under a knob). A missing report prints "—". The A/B reports are
dry-runs under the knobs (:data:`AB_RUNS`); ``--run`` makes the missing ones:

  REPRO_MOE_RULES=fsdp python -m repro_torch.launch.dryrun --arch deepseek-v2-236b \\
      --shape train_4k --out reports/torch_perf/deepseek__train_4k__moe_fsdp.json
  REPRO_MOE_RULES=fsdp ... --arch mixtral-8x22b --shape train_4k \\
      --out reports/torch_perf/mixtral__train_4k__moe_fsdp.json
  REPRO_REMAT=dots ... --arch qwen2.5-32b --shape train_4k \\
      --out reports/torch_perf/qwen__train_4k__remat_dots.json
  REPRO_SERVE_F32=1 ... --arch command-r-35b --shape decode_32k \\
      --out reports/torch_perf/commandr__decode_32k__serve_f32.json

The reference's "f32 gathers" half of its baselines is dropped: the port's
train step has no float32-gather variant (``REPRO_BF16_GATHER``).

Usage: PYTHONPATH=src python -m repro_torch.launch.perf_report [--run]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from repro_torch.launch.roofline import roofline_terms

ROOT = Path(__file__).resolve().parents[3] / "reports"

#: (knob, value, arch, shape, report under ROOT) of each A/B dry-run
AB_RUNS = [
    ("REPRO_MOE_RULES", "fsdp", "deepseek-v2-236b", "train_4k",
     "torch_perf/deepseek__train_4k__moe_fsdp.json"),
    ("REPRO_MOE_RULES", "fsdp", "mixtral-8x22b", "train_4k",
     "torch_perf/mixtral__train_4k__moe_fsdp.json"),
    ("REPRO_REMAT", "dots", "qwen2.5-32b", "train_4k", "torch_perf/qwen__train_4k__remat_dots.json"),
    ("REPRO_SERVE_F32", "1", "command-r-35b", "decode_32k",
     "torch_perf/commandr__decode_32k__serve_f32.json"),
]


def _terms(path: str):
    p = ROOT / path
    if not p.exists():
        return None
    r = json.loads(p.read_text())
    if r.get("status") != "ok":
        return None
    return roofline_terms(r)


def row(label, path, note=""):
    t = _terms(path)
    if t is None:
        return f"| {label} | — | — | — | — | — | {note} |"
    bound = max(t["t_compute_s"], t["t_memory_s"], t["t_collective_s"])
    return (
        f"| {label} | {t['t_compute_s']:.3g} | {t['t_memory_s']:.3g} | "
        f"{t['t_collective_s']:.3g} | **{bound:.3g}** "
        f"| not measured / {t.get('args_gb', '—')} | {note} |"
    )


HDR = ("| iteration | compute s | memory s | collective s | step bound s | temp/args GB/dev "
       "| notes |\n|---|---|---|---|---|---|---|")


def run_missing() -> None:
    """Make every A/B report of :data:`AB_RUNS` that is not there yet."""
    for knob, value, arch, shape, rel in AB_RUNS:
        out = ROOT / rel
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                        "--shape", shape, "--out", str(out)],
                       env={**os.environ, knob: value}, capture_output=True, check=False)
        print(f"{knob}={value} {arch} × {shape} → {rel}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--run", action="store_true", help="make the missing A/B reports first")
    if ap.parse_args(argv).run:
        run_missing()
    print("### Cell 1 — deepseek-v2-236b × train_4k (16×16)\n")
    print(HDR)
    print(row("baseline: FSDP-MoE (REPRO_MOE_RULES=fsdp)",
              "torch_perf/deepseek__train_4k__moe_fsdp.json",
              "experts gathered with their layer"))
    print(row("EP MoE (the port's default)", "torch_dryrun/deepseek-v2-236b__train_4k__pod16x16.json",
              "tokens to the expert shards and back"))
    print()
    print("### Cell 2 — command-r-35b × decode_32k (16×16)\n")
    print(HDR)
    print(row("f32-at-rest weights (REPRO_SERVE_F32=1)",
              "torch_perf/commandr__decode_32k__serve_f32.json", "ctx-parallel cache"))
    print(row("bf16-at-rest weights", "torch_dryrun/command-r-35b__decode_32k__pod16x16.json",
              "ctx-parallel cache"))
    print()
    print("### Extra measurements\n")
    print(HDR)
    print(row("mixtral train baseline (REPRO_MOE_RULES=fsdp)",
              "torch_perf/mixtral__train_4k__moe_fsdp.json", ""))
    print(row("mixtral train default", "torch_dryrun/mixtral-8x22b__train_4k__pod16x16.json",
              "E=8<16: hidden-TP fallback (no EP)"))
    print(row("qwen train (default remat=full)", "torch_dryrun/qwen2.5-32b__train_4k__pod16x16.json",
              ""))
    print(row("qwen train REPRO_REMAT=dots", "torch_perf/qwen__train_4k__remat_dots.json",
              "products' outputs saved"))
    print()
    print("### Cell 3 — viterbi-ccsds × stream_16m_int8 (16×16)\n")
    print(HDR)
    print(row("two-kernel int8 (K1 + K2, backend cuda)",
              "torch_dryrun/viterbi-ccsds__stream_16m_int8__pod16x16.json", "zero collectives"))


if __name__ == "__main__":
    main()
