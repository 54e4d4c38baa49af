"""Roofline analysis: three terms per (architecture × shape × mesh) from the
port's dry-run reports, on the H100's peaks.

The counterpart of ``repro.launch.roofline``:

  compute term    = Σ over dtypes of FLOPs_per_device / the dtype's peak
  memory term     = bytes_per_device / HBM bandwidth
  collective term = collective_bytes_per_device / link bandwidth

Hardware model: the H100 SXM (``launch/cost.py``, the figures behind
``chip_smoke.py``'s bounds): 989e12 bf16 dense tensor-core FLOP/s, 67e12
float32 FLOP/s outside the tensor cores, 132 × 64 × 1.98e9 int32 op/s,
3.35e12 B/s HBM3, and NVLink 4 at 450e9 B/s per direction for the
collective term. The decoder's lane split needs no link: each lane shard
decodes its own blocks. The reports' counts are the busiest mesh
position's (``launch/dryrun.py``), so they are divided by one card's rates.

``useful_*_ratio`` is the useful-work model's global traffic (a copy of the
reference's ``_useful_traffic_model``) over the count's global traffic, and
``roofline_fraction`` that ratio on the dominant term. A fraction above 1.0
would mean the count or the model is wrong: it is an error, not a result.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--reports DIR] [--md | --json]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.launch.cost import HBM_BYTES_PER_S, PEAKS

HBM_BW = HBM_BYTES_PER_S  # bytes/s / card
LINK_BW = 450e9  # bytes/s / direction (NVLink 4)

REPORTS = Path(__file__).resolve().parents[3] / "reports" / "torch_dryrun"

__all__ = ["HBM_BW", "LINK_BW", "PEAKS", "roofline_terms", "load_all", "to_markdown",
           "_useful_traffic_model"]


def _useful_traffic_model(report: dict) -> dict:
    """Modeled minimal global traffic for the step (roofline 'useful work'):

      train:   optimizer state + params + grads r/w (≈ 40·N bytes) — the
               irreducible weight traffic; activations excluded (remat-able)
      prefill: one bf16 read of active weights + KV write
      decode:  one bf16 read of active weights + one full cache read

    and the minimal collective traffic (FSDP grad reduce + param gather for
    train; per-layer TP combines for inference), used to judge the dominant
    term against a useful-work bound rather than raw peak.
    """
    from repro_torch.configs.base import SHAPES, get_config

    kind = report.get("kind", "train")
    if report["arch"] == "viterbi-ccsds":
        bits = report.get("bits_per_step", 0)
        # int8 symbols: (1+2L/D)·R bytes/bit in, 1/8 out; SP words 2×4B/stage
        return {"bytes": bits * (2.33 + 8 * 2 * 4 / 512.0), "collective": 0.0}
    cfg = get_config(report["arch"])
    shape = SHAPES.get(report["shape"])
    n_total = cfg.n_params_estimate
    n_active = cfg.n_active_params_estimate
    B = shape.global_batch if shape else 1
    S = shape.seq_len if shape else 0

    # decode-cache bytes (bf16)
    cache = 0.0
    if kind == "decode":
        per_layer = 0.0
        for pattern, repeat in cfg.layer_list:
            for d in pattern:
                if d.mixer == "gqa":
                    s_eff = min(S, cfg.sliding_window) if cfg.sliding_window else S
                    per_layer += 2 * B * s_eff * cfg.n_kv_heads * cfg.head_dim * 2
                elif d.mixer == "mla":
                    per_layer += B * S * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * 2
                elif d.mixer == "mamba":
                    per_layer += B * cfg.mamba_d_inner * (cfg.mamba_d_state + 3) * 4
                elif d.mixer == "rwkv6":
                    H = cfg.d_model // cfg.rwkv_head_dim
                    per_layer += B * H * cfg.rwkv_head_dim**2 * 4
            cache += per_layer * repeat
            per_layer = 0.0

    if kind == "train":
        bytes_ = 40.0 * n_total
        coll = 8.0 * n_total  # grad reduce-scatter (f32) + bf16 param all-gather
    elif kind == "prefill":
        bytes_ = 2.0 * n_active + B * S * cfg.d_model * 2
        coll = 2 * B * S * cfg.d_model * 2 * cfg.n_layers / 4  # TP activation combines
    else:
        bytes_ = 2.0 * n_active + cache
        coll = 2 * B * cfg.d_model * 2 * cfg.n_layers
    return {"bytes": bytes_, "collective": coll}


def roofline_terms(report: dict) -> dict | None:
    """The three terms of an ``ok`` report (``None`` otherwise). Raises
    ``ValueError`` where the useful share of the dominant term reads above
    1.0."""
    if report.get("status") != "ok" or "count" not in report:
        return None
    c = report["count"]
    t_compute = sum(v / PEAKS[k] for k, v in c["flops_per_device_by_dtype"].items())
    t_memory = c["bytes_per_device"] / HBM_BW
    t_coll = sum(c["collective_bytes_per_device"].values()) / LINK_BW
    dominant = max(("compute", t_compute), ("memory", t_memory), ("collective", t_coll),
                   key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_coll)
    model_flops = report.get("model_flops_global", 0.0)
    flops_global, bytes_global = c["flops_global"], c["bytes_global"]
    coll_global = sum(c["collective_bytes_global"].values())
    useful = _useful_traffic_model(report)

    compute_eff = (model_flops / flops_global) if (flops_global and model_flops) else None
    mem_eff = (useful["bytes"] / bytes_global) if bytes_global else None
    coll_eff = (useful["collective"] / coll_global) if coll_global else None
    frac = {"compute": compute_eff, "memory": mem_eff, "collective": coll_eff}[dominant]
    if frac is not None and frac > 1.0:
        raise ValueError(f"{report['arch']} × {report['shape']} × {report['mesh']}: the useful "
                         f"share of the {dominant} term reads {frac:.4g}, above 1.0: the count "
                         f"or the useful-work model is wrong")
    out = {
        "arch": report["arch"],
        "shape": report["shape"],
        "mesh": report["mesh"],
        "kind": report.get("kind", "?"),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "step_lower_bound_s": bound,
        "model_flops_global": model_flops,
        "counted_flops_global": flops_global,
        "useful_flops_ratio": compute_eff,
        "useful_bytes_ratio": mem_eff,
        "useful_collective_ratio": coll_eff,
        # efficiency on the DOMINANT resource: useful work / counted work.
        # 1.0 = the step is already at its useful-work roofline.
        "roofline_fraction": frac,
    }
    if "memory" in report:
        args = report["memory"].get("argument_size_in_bytes", 0)
        out["args_gb"] = round(args / 1e9, 2)
        out["temp_gb"] = None  # not measured: meta tensors have no temporaries
        out["hbm_gb_per_device"] = out["args_gb"]
    return out


def load_all(reports_dir: Path = REPORTS) -> list[dict]:
    rows = []
    for p in sorted(Path(reports_dir).glob("*.json")):
        r = json.loads(p.read_text())
        if r.get("status") == "skip":
            rows.append({"arch": r["arch"], "shape": r["shape"], "mesh": r["mesh"],
                         "dominant": "skip", "reason": r.get("reason", "")})
            continue
        try:
            t = roofline_terms(r)
        except ValueError as err:
            rows.append({"arch": r["arch"], "shape": r["shape"], "mesh": r.get("mesh", "?"),
                         "dominant": "error", "reason": str(err)})
            continue
        rows.append(t or {"arch": r.get("arch", "?"), "shape": r.get("shape", "?"),
                          "mesh": r.get("mesh", "?"), "dominant": r.get("status", "error")})
    return rows


def _fmt(x, nd=4):
    if x is None:
        return "—"
    if isinstance(x, float):
        return f"{x:.{nd}g}"
    return str(x)


def to_markdown(rows: list[dict]) -> str:
    hdr = (
        "| arch | shape | mesh | compute s | memory s | collective s | dominant | "
        "useful-FLOPs | roofline frac | args GB/dev |\n"
        "|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        lines.append(
            "| {arch} | {shape} | {mesh} | {tc} | {tm} | {tl} | **{dom}** | {uf} | {rf} | {hbm} |"
            .format(arch=r["arch"], shape=r["shape"], mesh=r["mesh"],
                    tc=_fmt(r.get("t_compute_s")), tm=_fmt(r.get("t_memory_s")),
                    tl=_fmt(r.get("t_collective_s")), dom=r.get("dominant", "?"),
                    uf=_fmt(r.get("useful_flops_ratio"), 3),
                    rf=_fmt(r.get("roofline_fraction"), 3),
                    hbm=_fmt(r.get("hbm_gb_per_device"))))
    return hdr + "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reports", default=str(REPORTS))
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = load_all(Path(args.reports))
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        print(to_markdown(rows))


if __name__ == "__main__":
    main()
