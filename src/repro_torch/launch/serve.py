"""Serving driver: batched greedy decoding through the port's LM path.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b --preset full \\
        --batch 4 --new-tokens 64

The counterpart of ``repro.launch.serve`` with the same flags and the same
default ``--arch`` (``rwkv6-3b``). Like the reference, it runs its steps
under ``axis_rules(make_local_mesh())``, here a ``(1, 1)`` mesh of the one
device it serves on, so a MoE card (Mixtral-8x22B, DeepSeek-V2, Jamba-v0.1)
routes through the expert-parallel path, whose routing group is the whole
batch, as the reference's CLI does. ``--arch`` takes every card the port has
(``configs.base.list_archs()``: ``starcoder2-3b``, ``qwen2.5-32b``,
``minitron-8b``, ``command-r-35b``, ``mixtral-8x22b``,
``deepseek-v2-236b``, ``jamba-v0.1-52b``, ``rwkv6-3b``,
``seamless-m4t-medium`` and ``pixtral-12b``, which take the reference's
branches: no frames and no cross cache, so Seamless's cross-attention
attends to the token itself, and the prompt has no patches); at ``--preset
full`` the card's float32 weights must fit the card's memory. Weights are
random, drawn on the device from a generator seeded with 0. The prompt is
fed token by token through the decode step, then ``--new-tokens`` steps are
timed on the card (host clock around work that ends in a synchronize).
``--device cpu`` runs a rehearsal on the CPU, whose time is the CPU's.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch._unused.models import lm
from repro_torch._unused.serve.serve_step import make_decode_step
from repro_torch.sharding.rules import axis_rules

__all__ = ["main", "generate"]


def generate(cfg, params, prompt: torch.Tensor, new_tokens: int, mesh):
    """The CLI's loop: under ``axis_rules(mesh)``, on the serving layout of
    ``params`` (``lm.place_params``: itself on a mesh without a ``model``
    axis of more than one position), feed ``prompt`` (B, P)
    token by token through the decode step, then take ``new_tokens``
    greedy steps. Returns (the new tokens (B, new_tokens) int32, the
    seconds of the greedy steps, each run ending in a synchronize on a
    card)."""
    dev = prompt.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    B, P = prompt.shape
    s_max = P + new_tokens
    with axis_rules(mesh):
        params = lm.place_params(params, cfg, mesh)
        step = make_decode_step(cfg, s_max)
        cache = lm.init_cache(cfg, B, s_max, device=dev, ctx_parallel=step.ctx_parallel)
        for t in range(P):
            nxt, cache = step(params, prompt[:, t : t + 1], cache, t)
        sync()
        t0 = time.perf_counter()
        tok = nxt[:, None]
        outs = []
        for t in range(new_tokens):
            outs.append(tok)
            nxt, cache = step(params, tok, cache, P + t)
            tok = nxt[:, None]
        sync()
    return torch.cat(outs, dim=1), time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-3b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu for a rehearsal")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.preset == "tiny":
        cfg = cfg.reduced()
    dev = resolve_device(args.device, user="serve")
    rng = np.random.default_rng(0)

    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)), device=dev)
    _, dt = generate(cfg, params, prompt, args.new_tokens, make_local_mesh(devices=[dev]))

    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    total = args.batch * args.new_tokens
    print(f"[serve] {cfg.name} on {where}: {total} tokens in {dt*1e3:.0f} ms "
          f"→ {total/dt:.0f} tok/s ({dt/args.new_tokens*1e3:.1f} ms/step)")


if __name__ == "__main__":
    main()
