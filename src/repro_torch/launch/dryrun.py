"""Multi-pod dry-run of the port: the work of every (architecture × shape) cell.

The counterpart of ``repro.launch.dryrun``. Where the reference lowers and
compiles each cell against the production meshes (16×16, 256 chips; 2×16×16,
512 chips) and reads the compiled HLO, the port runs each cell's step, as
it would run on a mesh of that many devices, on meta tensors: the mesh is
``make_production_mesh`` over 256 (or 512) ``torch.device("meta")``
entries, nothing is allocated, and a :class:`~repro_torch.launch.cost.WorkCounter`
counts the work per mesh position (``launch/cost.py``).

* **train:** the state laid out by ``place_train_state`` (``Placed`` tiles
  of the parameters and AdamW moments) and one ``make_mesh_train_step``:
  each data shard's forward and backward, tensor-parallel over ``model``
  (each position gathers its slices of the split layers along ``fsdp``
  and computes with them; the rest gathered whole on the shard's first
  position), then the per-tile AdamW update.
* **prefill / decode:** the serving parameters (bf16 at rest unless
  ``REPRO_SERVE_F32=1``) in the serving layout (``lm.place_params``: the
  split layers' slices on their model positions, the rest on the mesh's
  first position), one ``make_prefill_step`` or ``make_decode_step`` under
  the rules; the decode cache laid per position where a mixer splits
  (``kv_heads`` tiles, MLA's latent replicas, Mamba's ``mlp`` and RWKV's
  ``heads`` tiles), and from 32,768 positions as sequence tiles over
  ``model`` (the context-parallel cache).
* **the decoder cells** (``--viterbi``): ``stream_16m_int8`` (32,768
  CCSDS blocks of int8 symbols, D = 512, L = 42) and ``stream_4m_f32``
  (8,192 of float32), laid over the mesh's block axes by ``lane_split``,
  decoded with ``backend="cuda"``, the backend the card runs (K1 then K2),
  not the reference's XLA ``"ref"`` artifact. ``pbvd_decode_blocks`` makes
  no host sync on this path, so nothing is skipped on meta.

**Per device** means the busiest mesh position, never the global count
divided by the chip count: after the split over ``model``, the first
position of a data shard, which computes its slices and what the rules
leave whole (norms, routers, the loss's reductions, MLA's latents and
RWKV-6's token-shift mixes and decay, heads or hidden dimensions that the
axis does not divide). Each report says so (``per_device``). The serving cells run the whole batch as the data
shards of one process: the norms and residuals of every shard run on the
mesh's first position. ``memory`` gives the argument bytes the busiest position
holds (its placed tiles, its data shard's rows, and on the first position
the serving parameters); meta tensors have no temporaries, so those are
"not measured".

Knobs: ``REPRO_MOE_RULES=fsdp`` takes expert parallelism away (``experts``
unsharded, the experts gathered with their layer);
``REPRO_REMAT=dots`` (``_unused/models/lm.py``) changes the train step's
recompute. The reference's ``REPRO_BF16_GATHER=0`` is dropped: the port's
train step has no float32-gather variant.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--resume] [--jobs N]
  python -m repro_torch.launch.dryrun --viterbi

``--all`` runs every cell in a subprocess of its own and writes one
JSON report per cell under ``reports/torch_dryrun/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[3]
REPORTS = ROOT / "reports" / "torch_dryrun"
VITERBI_CELLS = {"stream_16m_int8": 32768, "stream_4m_f32": 8192}
PER_DEVICE = ("the busiest mesh position after the split over the model axis: a data shard's "
              "first position, with its slices of the split layers and the unsplit work (norms, "
              "routers, MLA's latents, RWKV-6's token-shift mixes and decay, undivided "
              "dimensions)")


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _cell_report_path(arch: str, shape: str, multi_pod: bool, reports: Path = REPORTS) -> Path:
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    return reports / f"{arch}__{shape}__{mesh}.json"


def _meta_mesh(multi_pod: bool):
    import torch

    from repro_torch.launch.mesh import make_production_mesh

    return make_production_mesh(multi_pod=multi_pod,
                                devices=[torch.device("meta")] * (512 if multi_pod else 256))


def _rules(multi_pod: bool) -> dict:
    """The production rules, with ``REPRO_MOE_RULES=fsdp``'s override."""
    from repro_torch.sharding.rules import DEFAULT_RULES, SINGLE_POD_RULES

    base = DEFAULT_RULES if multi_pod else SINGLE_POD_RULES
    if os.environ.get("REPRO_MOE_RULES") == "fsdp":
        return dict(base, experts=None)
    return dict(base)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _position_bytes(trees, mesh, first: tuple, unplaced_at_first: float,
                    everywhere: float = 0.0) -> dict:
    """Argument bytes per mesh position: each ``Placed`` leaf's tile there,
    plain tensors on the first position, ``everywhere`` bytes at each."""
    import numpy as np

    from repro_torch.sharding.place import Placed, map_tree

    out = {idx: everywhere for idx in np.ndindex(mesh.devices.shape)}
    out[first] += unplaced_at_first

    def leaf(x):
        if isinstance(x, Placed):
            for pos in x.positions():
                out[pos] += _nbytes(x.tiles[pos])
        elif hasattr(x, "numel"):
            out[first] += _nbytes(x)
        return x

    for tree in trees:
        map_tree(leaf, tree)
    return out


def _count_section(counter) -> dict:
    pos, busy = counter.busiest()
    b, total = busy.as_dict(), counter.total().as_dict()
    return {
        "flops_per_device": b["flops"],
        "flops_per_device_by_dtype": b["flops_by_dtype"],
        "bytes_per_device": b["bytes"],
        "collective_bytes_per_device": b["collective_bytes"],
        "collective_counts": b["collective_counts"],
        "kernels_per_device": b["kernels"],
        "busiest_position": list(pos),
        "positions_with_work": len(counter.tallies),
        "flops_global": total["flops"],
        "bytes_global": total["bytes"],
        "collective_bytes_global": total["collective_bytes"],
    }


# ======================================================================================
# single-cell runner (executes inside the subprocess)
# ======================================================================================
def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    import torch

    from repro_torch.launch.cost import WorkCounter
    from repro_torch.launch.specs import ENCODER_CTX, SKIPS, input_specs, make_cell
    from repro_torch.sharding.rules import axis_rules
    from repro_torch._unused.models import lm
    from repro_torch._unused.serve.serve_step import (CTX_PARALLEL_THRESHOLD,
                                                      make_decode_step, make_prefill_step)
    from repro_torch._unused.train.optimizer import AdamWConfig
    from repro_torch._unused.train.train_step import make_mesh_train_step, place_train_state

    t0 = time.time()
    mesh_name = _mesh_name(multi_pod)
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name, "status": "skip",
                "reason": SKIPS[(arch, shape_name)]}

    cell = make_cell(arch, shape_name)
    cfg = cell.cfg
    mesh = _meta_mesh(multi_pod)
    first = (0,) * len(mesh.axis_names)
    rules = _rules(multi_pod)
    specs = input_specs(cell)
    B, S = cell.shape.global_batch, cell.shape.seq_len

    with axis_rules(mesh, rules) as lr:
        if cell.kind == "train":
            opt_cfg = AdamWConfig()
            params, opt = place_train_state(specs["params"], cfg, opt_cfg, mesh, rules=rules)
            del specs["params"]
            step = make_mesh_train_step(cfg, opt_cfg, mesh, rules=rules)
            batch_axes = lr.spec(("batch",), shape=(B,))[0]
            n_batch = 1
            for a in (batch_axes if isinstance(batch_axes, tuple) else (batch_axes,)):
                n_batch *= int(mesh.shape[a]) if a else 1
            arg_bytes = _position_bytes(
                [params, opt.m, opt.v], mesh, first, 0.0,
                everywhere=sum(map(_nbytes, specs["batch"].values())) / n_batch)
            with WorkCounter() as counter:
                step(params, opt, specs["batch"])
        elif cell.kind == "prefill":
            step = make_prefill_step(cfg)
            params = lm.place_params(specs["params"], cfg, mesh, rules)
            arg_bytes = _position_bytes([specs["batch"], dict(params.named_parameters())],
                                        mesh, first, 0.0)
            with WorkCounter() as counter:
                step(params, specs["batch"])
        else:  # decode: from 32,768 positions the cache as sequence tiles over the mesh
            specs["cache"] = lm.init_cache(cfg, B, S, dtype=torch.bfloat16, device="meta",
                                           cross_len=ENCODER_CTX if cfg.encdec else 0,
                                           ctx_parallel=S >= CTX_PARALLEL_THRESHOLD)
            step = make_decode_step(cfg, S)
            params = lm.place_params(specs["params"], cfg, mesh, rules)
            arg_bytes = _position_bytes([specs["cache"], specs["tokens"],
                                         dict(params.named_parameters())], mesh, first, 0.0)
            with WorkCounter() as counter:
                step(params, specs["tokens"], specs["cache"], specs["cache_len"])

    count = _count_section(counter)
    busiest = tuple(count["busiest_position"]) or first
    n_active = cfg.n_active_params_estimate
    tokens = B * S if cell.kind in ("train", "prefill") else B  # decode: one token a row
    model_flops = (6.0 if cell.kind == "train" else 2.0) * n_active * tokens
    return {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name,
        "n_chips": int(mesh.devices.size),
        "kind": cell.kind,
        "status": "ok",
        "remat": os.environ.get("REPRO_REMAT", "full"),
        "moe_rules": os.environ.get("REPRO_MOE_RULES", "ep"),
        "per_device": PER_DEVICE,
        "count": count,
        "memory": {
            "argument_size_in_bytes": int(arg_bytes.get(busiest, 0)),
            "argument_size_in_bytes_max": int(max(arg_bytes.values())),
            "temp_size_in_bytes": "not measured (meta tensors have no temporaries)",
        },
        "model_flops_global": model_flops,
        "tokens_per_step": tokens,
        "n_active_params": n_active,
        "total_s": round(time.time() - t0, 2),
    }


def _lane_positions(mesh, axes) -> list[tuple]:
    """The grid index of each lane shard's first position, in the order of
    ``sharding.smap.lane_shard_devices``."""
    import math

    import numpy as np

    names = list(mesh.axis_names)
    order = [names.index(a) for a in axes] + [i for i, a in enumerate(names) if a not in axes]
    grid = np.empty(mesh.devices.shape, dtype=object)
    for idx in np.ndindex(grid.shape):
        grid[idx] = idx
    n_shards = math.prod(int(mesh.shape[a]) for a in axes)
    return list(grid.transpose(order).reshape(n_shards, -1)[:, 0])


def run_viterbi_cell(variant: str, multi_pod: bool) -> dict:
    """The PBVD decoder as a data-plane workload on the same mesh."""
    import torch

    from repro_torch.core.trellis import CCSDS_27
    from repro_torch.kernels.ops import pbvd_decode_blocks
    from repro_torch.launch.cost import WorkCounter
    from repro_torch.sharding.rules import axis_rules, block_mesh_axes, on_position
    from repro_torch.sharding.smap import lane_shard_devices, lane_split

    t0 = time.time()
    mesh = _meta_mesh(multi_pod)
    D, L = 512, 42
    T = D + 2 * L
    n_blocks = VITERBI_CELLS[variant]
    dtype = torch.int8 if variant.endswith("int8") else torch.float32
    blocks = torch.empty((T, CCSDS_27.R, n_blocks), dtype=dtype, device="meta")
    axes = block_mesh_axes(mesh)
    positions = iter(_lane_positions(mesh, axes))

    def decode(part):
        with on_position(next(positions)):
            return pbvd_decode_blocks(part, CCSDS_27, decode_start=L, n_decode=D,
                                      backend="cuda")

    devices = lane_shard_devices(mesh, axes)
    with axis_rules(mesh), WorkCounter() as counter:
        bits = lane_split(decode, blocks, devices, out_device=torch.device("meta"))
    if tuple(bits.shape) != (D, n_blocks):
        raise AssertionError(f"decoded bits {tuple(bits.shape)}, want {(D, n_blocks)}")
    count = _count_section(counter)
    per_shard = _nbytes(blocks) // len(devices)
    return {
        "arch": "viterbi-ccsds",
        "shape": variant,
        "mesh": _mesh_name(multi_pod),
        "n_chips": int(mesh.devices.size),
        "kind": "decode_stream",
        "status": "ok",
        "backend": "cuda",
        "bits_per_step": D * n_blocks,
        "per_device": "the busiest mesh position: one lane shard's K1 and K2",
        "count": count,
        "memory": {"argument_size_in_bytes": int(per_shard),
                   "temp_size_in_bytes": "not measured (meta tensors have no temporaries)"},
        "total_s": round(time.time() - t0, 2),
    }


# ======================================================================================
# --all: every cell in a subprocess of its own
# ======================================================================================
def _run_subprocess(arch: str, shape: str, multi_pod: bool, timeout: int = 3000,
                    reports: Path = REPORTS) -> dict:
    out_path = _cell_report_path(arch, shape, multi_pod, reports)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", str(out_path)]
    if multi_pod:
        cmd.append("--multi-pod")
    t0 = time.time()
    try:
        out_path.unlink(missing_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout,
                              env=dict(os.environ))
        if out_path.exists():
            return json.loads(out_path.read_text())
        report = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
                  "status": "error", "error": (proc.stderr or proc.stdout or "")[-2000:],
                  "total_s": round(time.time() - t0, 2)}
    except subprocess.TimeoutExpired:
        report = {"arch": arch, "shape": shape, "mesh": _mesh_name(multi_pod),
                  "status": "timeout", "total_s": round(time.time() - t0, 2)}
    out_path.write_text(json.dumps(report, indent=2))
    return report


def _write(report: dict, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--viterbi", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--jobs", type=int, default=1, help="--all: cells run at once")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    if args.all:
        from repro_torch.configs.base import SHAPES, list_archs

        todo = []
        for mp in (False, True):
            for arch in list_archs():
                for shape in SHAPES:
                    path = _cell_report_path(arch, shape, mp)
                    if args.resume and path.exists():
                        if json.loads(path.read_text()).get("status") in ("ok", "skip"):
                            continue
                    todo.append((arch, shape, mp))

        def one(cell):
            r = _run_subprocess(*cell)
            print(f"[{r.get('status', '?'):7s}] {cell[0]} × {cell[1]} × {r.get('mesh')}  "
                  f"({r.get('total_s', '?')}s)", flush=True)

        with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
            list(pool.map(one, todo))
        return

    if args.viterbi:
        for mp in (False, True):
            for variant in VITERBI_CELLS:
                r = run_viterbi_cell(variant, mp)
                _write(r, _cell_report_path("viterbi-ccsds", variant, mp))
                print(f"[{r['status']:7s}] viterbi × {variant} × {r['mesh']} ({r['total_s']}s)",
                      flush=True)
        return

    try:
        if args.arch == "viterbi-ccsds":
            report = run_viterbi_cell(args.shape, args.multi_pod)
        else:
            report = run_cell(args.arch, args.shape, args.multi_pod)
    except Exception:  # noqa: BLE001  (--all records the failure)
        report = {"arch": args.arch, "shape": args.shape, "mesh": _mesh_name(args.multi_pod),
                  "status": "error", "error": traceback.format_exc()[-4000:]}
    text = json.dumps(report, indent=2)
    if args.out:
        _write(report, Path(args.out))
    print(text)
    sys.exit(0 if report.get("status") in ("ok", "skip") else 1)


if __name__ == "__main__":
    main()
