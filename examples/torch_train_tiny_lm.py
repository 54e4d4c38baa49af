"""End-to-end training on the PyTorch/CUDA port: a ~100M-param-class LM for a
few hundred steps through the whole training stack — data pipeline with
prefetch, the train step (bf16 compute, per-layer remat, the flash kernel
forward), AdamW, async checkpoints, failure recovery.

    PYTHONPATH=src python examples/torch_train_tiny_lm.py --steps 300
    PYTHONPATH=src python examples/torch_train_tiny_lm.py --device cpu --preset tiny --steps 20

The counterpart of ``examples/train_tiny_lm.py``: like it, the loop trains
over ``make_local_mesh()`` under its rules, every CUDA device torch finds
(one card: the one-device step), or the ``--device`` given (``--device
cpu``: a rehearsal on the CPU). It checks that the loss fell.
"""

import argparse
import tempfile
from pathlib import Path

from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.train import TrainLoop, preset_config
from repro_torch._unused.models import lm
from repro_torch._unused.train.optimizer import AdamWConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--preset", default="100m", choices=["tiny", "100m"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(Path(tempfile.gettempdir()) / "repro_torch_tiny_lm"))
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu for a rehearsal")
    args = ap.parse_args()

    cfg = preset_config(args.arch, args.preset)
    n_params = lm.param_count(cfg)
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"batch {args.global_batch} × seq {args.seq_len}, {args.steps} steps")

    loop = TrainLoop(
        cfg,
        AdamWConfig(lr=1e-3, total_steps=args.steps, warmup_steps=max(args.steps // 20, 5)),
        make_local_mesh(devices=None if args.device is None else [args.device]),
        ckpt_dir=args.ckpt_dir,
        global_batch=args.global_batch,
        seq_len=args.seq_len,
        ckpt_every=100,
    )
    try:
        log = loop.run(args.steps)
        print(f"loss: {log[0]['loss']} → {log[-1]['loss']}")
        if not log[-1]["loss"] < log[0]["loss"]:
            raise SystemExit("loss did not decrease")
    finally:
        loop.pipeline.close()


if __name__ == "__main__":
    main()
