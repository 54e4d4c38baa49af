"""Batched serving demo on the PyTorch/CUDA port: cached decode through the
port's serve step, including a sliding-window model (rolling cache), an RNN
(state cache) and a mixture-of-experts model.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cuda] [--new-tokens 48]

The counterpart of ``examples/serve_lm.py``: ``starcoder2-3b``,
``rwkv6-3b`` and ``mixtral-8x22b`` at their ``reduced()`` size with random
weights from a generator seeded with 0, the prompt fed token by token
through ``make_decode_step`` and ``--new-tokens`` greedy steps timed (a
synchronize ends the timed work on the card).
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch._unused.models import lm
from repro_torch._unused.serve.serve_step import make_decode_step

ARCHS = ("starcoder2-3b", "rwkv6-3b", "mixtral-8x22b")


def serve(arch: str, dev: torch.device, n_new: int = 48, batch: int = 4) -> torch.Tensor:
    cfg = get_config(arch).reduced()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, 8)), device=dev)
    s_max = prompt.shape[1] + n_new
    cache = lm.init_cache(cfg, batch, s_max, device=dev)
    step = make_decode_step(cfg, s_max)

    # prefill token by token, as the reference's demo does
    for t in range(prompt.shape[1]):
        nxt, cache = step(params, prompt[:, t : t + 1], cache, t)
    sync()
    t0 = time.perf_counter()
    out = []
    tok = nxt[:, None]
    for t in range(n_new):
        out.append(tok)
        nxt, cache = step(params, tok, cache, prompt.shape[1] + t)
        tok = nxt[:, None]
    sync()
    dt = time.perf_counter() - t0
    toks = torch.cat(out, dim=1)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    kind = "KV ring" if cfg.sliding_window else "state" if cfg.family == "ssm" else "KV"
    ffn = f", MoE {cfg.n_experts} experts top-{cfg.top_k}" if cfg.n_experts else ""
    print(f"{arch:22s} generated {batch}×{n_new} tokens in {dt*1e3:.0f} ms "
          f"({batch*n_new/dt:.0f} tok/s on {where}) — cache kinds: {kind}{ffn}", flush=True)
    return toks


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--new-tokens", type=int, default=48)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device, user="torch_serve_lm")
    for arch in ARCHS:
        serve(arch, dev, n_new=args.new_tokens)


if __name__ == "__main__":
    main()
