"""End-to-end training entry point: data pipeline → train step → checkpoints, with
crash recovery and (optional) failure injection to prove it.

    # ~100M-param-class model, a few hundred steps on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch starcoder2-3b --preset 100m --steps 300

    # fault-tolerance demo: inject a failure at step 40, watch it restore
    PYTHONPATH=src python -m repro_torch.launch.train --preset tiny --steps 60 \\
        --inject-failure-at 40 --ckpt-every 20

The counterpart of ``repro.launch.train`` with the reference's flags.
:class:`TrainLoop` takes a device or a mesh where the reference takes its
mesh, and runs its steps under ``axis_rules(mesh)`` as the reference does
(``None``: ``"cuda"``, which raises ``DeviceUnavailableError`` without a
GPU). A mesh of one device trains on that device with the one-device step;
a mesh of more devices (a :class:`~repro_torch.launch.mesh.DecodeMesh`
over a device list, one process; ``[cuda:0] * n`` splits one card) places
the parameters and AdamW state per the rules and runs
``make_mesh_train_step``: data-parallel over the ``batch`` rule's axes,
FSDP over ``data``, tensor parallelism (and MoE's expert-parallel
path) over ``model``. The CLI
trains over ``make_local_mesh()``: every CUDA device torch finds, or the
``--device`` given. ``--device cpu`` rehearses on the CPU, whose times
are the CPU's. Weights are drawn from a generator seeded with 42 on the
(first) device. Checkpoints hold ``{"params", "opt": (step, m, v)}`` in the
reference's layout (:func:`train_state_tree`, gathered from the tiles over
a mesh), so either package restores the other's, and a mesh run restores
into its tiles.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.interop import lm_named, lm_tree
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.sharding.place import Placed
from repro_torch.sharding.rules import axis_rules
from repro_torch._unused.models import lm
from repro_torch._unused.train.checkpoint import CheckpointManager
from repro_torch._unused.train.data import PrefetchPipeline, SyntheticLMStream
from repro_torch._unused.train.optimizer import AdamWConfig, OptState, adamw_init
from repro_torch._unused.train.train_step import (make_mesh_train_step, make_train_step,
                                                  place_train_state)

__all__ = ["TrainLoop", "main", "preset_config", "train_state_tree", "load_train_state"]

INIT_SEED = 42


def preset_config(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "full":
        return cfg
    if preset == "tiny":
        return cfg.reduced()
    if preset == "100m":  # ~100M params: a real training run that fits CPU/1 host
        return dataclasses.replace(
            cfg.reduced(),
            name=cfg.name + "-100m",
            n_layers=len(cfg.reduced().prefix) + len(cfg.reduced().pattern) * 4,
            d_model=512,
            n_heads=8,
            n_kv_heads=min(cfg.n_kv_heads, 4),
            head_dim=64,
            d_ff=2048,
            d_ff_dense=2048 if cfg.d_ff_dense else 0,
            vocab=32768,
        )
    raise ValueError(preset)


def _named(params) -> dict:
    return params if isinstance(params, dict) else dict(params.named_parameters())


def train_state_tree(params, opt_state: OptState, *, device="cpu") -> dict:
    """``{"params": ..., "opt": OptState(step, m, v)}`` in the reference's
    layout (:func:`~repro_torch.interop.lm_tree`), leaves on ``device``
    (``"meta"``: the shapes only, a tree to restore into). ``params`` is the
    module or a dict keyed by its names; :class:`Placed` leaves (a mesh
    run's tiles) are gathered, Mamba's ``in_proj`` back from
    ``lm.in_proj_layout``'s (d, 2, d_inner) to the reference's
    (d, 2·d_inner)."""
    def leaf(name, t):
        if not isinstance(t, Placed):
            return t.detach().to(device)
        if torch.device(device).type == "meta":
            out = torch.empty(t.shape, dtype=t.dtype, device="meta")
        else:
            out = t.full(device).detach()
        return out.flatten(1) if lm.is_in_proj(name) else out

    def tree(named):
        return lm_tree({k: leaf(k, t) for k, t in named.items()})

    return {"params": tree(_named(params)),
            "opt": OptState(opt_state.step.clone(), tree(opt_state.m), tree(opt_state.v))}


@torch.no_grad()
def load_train_state(tree: dict, params, opt_state: OptState) -> OptState:
    """Copy a restored :func:`train_state_tree` into ``params`` and the
    moments in place (into every tile of :class:`Placed` leaves); returns
    the state with the restored step."""
    for dst, src in ((_named(params), tree["params"]),
                     (opt_state.m, tree["opt"].m), (opt_state.v, tree["opt"].v)):
        for k, t in lm_named(src).items():
            dst[k].copy_(t.reshape(dst[k].shape))  # in_proj: lm.in_proj_layout's view
    return OptState(torch.as_tensor(tree["opt"].step, dtype=torch.int32), opt_state.m,
                    opt_state.v)


def _train_target(device):
    """(mesh or None, the device the loop draws its weights on)."""
    if hasattr(device, "devices"):  # a DecodeMesh
        return device, device.devices.flat[0]
    return None, resolve_device(device, user="TrainLoop")


class TrainLoop:
    """Training loop with checkpoint/restore-on-failure semantics."""

    def __init__(
        self,
        cfg,
        opt_cfg: AdamWConfig,
        device=None,
        *,
        ckpt_dir: str | Path,
        global_batch: int = 8,
        seq_len: int = 128,
        ckpt_every: int = 50,
        compress_grads: bool = False,
        straggler_timeout: float | None = None,
    ):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.mesh, self.device = _train_target(device)
        self.ckpt = CheckpointManager(ckpt_dir, keep=3)
        self.ckpt_every = ckpt_every
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.stream = SyntheticLMStream(cfg.vocab, seq_len, global_batch)
        self.pipeline = PrefetchPipeline(self.stream, depth=2)
        self.straggler_timeout = straggler_timeout
        self.metrics_log: list[dict] = []
        self.sharded = self.mesh is not None and self.mesh.size > 1
        if self.sharded:
            self.step_fn = make_mesh_train_step(cfg, opt_cfg, self.mesh,
                                                compress_grads=compress_grads)
        else:
            self.step_fn = make_train_step(cfg, opt_cfg, compress_grads=compress_grads)
        self._init()

    def _rules(self):
        return contextlib.nullcontext() if self.mesh is None else axis_rules(self.mesh)

    def _init(self) -> None:
        gen = torch.Generator(device=self.device).manual_seed(INIT_SEED)
        self.params = lm.init_params(self.cfg, generator=gen, device=self.device)
        if self.sharded:
            self.params, self.opt_state = place_train_state(self.params, self.cfg,
                                                            self.opt_cfg, self.mesh)
        else:
            self.params.requires_grad_(True)
            self.opt_state = adamw_init(dict(self.params.named_parameters()), self.opt_cfg)
        self.step = 0

    # ---- checkpoint plumbing ---------------------------------------------------------
    def _save(self, blocking: bool = False):
        self.ckpt.save(self.step, train_state_tree(self.params, self.opt_state),
                       blocking=blocking)

    def _restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        like = train_state_tree(self.params, self.opt_state, device="meta")
        self.opt_state = load_train_state(self.ckpt.restore(latest, like), self.params,
                                          self.opt_state)
        self.step = latest
        return True

    # ---- main loop ---------------------------------------------------------------------
    def run(self, n_steps: int, *, inject_failure_at: int | None = None, max_restarts: int = 3):
        restarts = 0
        while self.step < n_steps:
            try:
                self._run_until(n_steps, inject_failure_at if restarts == 0 else None)
            except RuntimeError as e:
                if restarts >= max_restarts:
                    raise
                restarts += 1
                print(f"[train] failure at step {self.step}: {e}; restoring…", flush=True)
                self.ckpt.wait()
                if not self._restore():
                    print("[train] no checkpoint — restarting from init", flush=True)
                    self._init()
        self.ckpt.wait()
        return self.metrics_log

    def _run_until(self, n_steps: int, inject_failure_at: int | None):
        with self._rules():
            self._steps(n_steps, inject_failure_at)

    def _steps(self, n_steps: int, inject_failure_at: int | None):
        while self.step < n_steps:
            if inject_failure_at is not None and self.step == inject_failure_at:
                inject_failure_at = None
                raise RuntimeError("injected node failure")
            batch = self.pipeline.next_batch(timeout=self.straggler_timeout)
            batch = {k: torch.as_tensor(np.asarray(v, np.int64), device=self.device)
                     for k, v in batch.items()}
            t0 = time.time()
            self.params, self.opt_state, metrics = self.step_fn(self.params, self.opt_state,
                                                                batch)
            self.step += 1
            if self.step % self.ckpt_every == 0:
                self._save(blocking=False)
            if self.step % 10 == 0 or self.step == n_steps:
                loss = float(metrics["loss"])
                dt = time.time() - t0
                rec = {
                    "step": self.step, "loss": round(loss, 4),
                    "grad_norm": round(float(metrics["grad_norm"]), 3),
                    "step_s": round(dt, 3),
                    "tok_s": round(self.global_batch * self.seq_len / dt, 1),
                }
                self.metrics_log.append(rec)
                print(f"[train] {rec}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--straggler-timeout", type=float, default=None)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu for a rehearsal")
    args = ap.parse_args()

    cfg = preset_config(args.arch, args.preset)
    mesh = make_local_mesh(devices=None if args.device is None else [args.device])
    loop = TrainLoop(
        cfg,
        AdamWConfig(total_steps=args.steps, warmup_steps=max(args.steps // 20, 5)),
        mesh,
        ckpt_dir=args.ckpt_dir,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_every=args.ckpt_every,
        compress_grads=args.compress_grads,
        straggler_timeout=args.straggler_timeout,
    )
    try:
        log = loop.run(args.steps, inject_failure_at=args.inject_failure_at)
    finally:
        loop.pipeline.close()
    first, last = log[0], log[-1]
    where = (torch.cuda.get_device_name(loop.device) if loop.device.type == "cuda"
             else "CPU")
    print(f"[train] done on {where}: loss {first['loss']} → {last['loss']} over {args.steps} "
          f"steps")


if __name__ == "__main__":
    main()
