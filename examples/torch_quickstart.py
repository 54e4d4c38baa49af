"""Quickstart on the PyTorch/CUDA port: decode a noisy CCSDS (2,1,7) stream.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda] [--backend cuda] \\
        [--bits 100000]

The counterpart of ``examples/quickstart.py`` on the port's engine. It walks
the paper's pipeline on one device: encode → BPSK+AWGN → 8-bit quantize and
pack (the packed H2D format) → parallel-block framing → decode through the
chosen backend (``"cuda"``: K1 then K2; ``"fused"``: one kernel; ``"ref"``:
plain PyTorch) → BER check; then it re-decodes the same stream in 20 chunks
through a streaming session (bit-exact to the one-shot decode) and at the
punctured rate 3/4. ``--device cpu`` runs the kernels' plain versions.
Times are taken around work that ends in a synchronize on the card, after
one warm-up decode that loads the kernels.
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.channel import transmit
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode, terminate
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.quantize import pack_words, quantize_soft, u1_bytes, unpack_words
from repro_torch.device import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--backend", default="cuda", choices=["cuda", "fused", "ref"])
    ap.add_argument("--bits", type=int, default=100_000)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device, user="torch_quickstart")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "CPU"
    spec = get_code_spec("ccsds")
    code = spec.code
    n_bits = args.bits
    ebn0_db = 4.0
    print(f"CCSDS (2,1,7): K={code.K}, R=1/{code.R}, {code.n_states} states, "
          f"{code.n_groups} butterfly groups (paper Table II); device {where}, "
          f"backend {args.backend!r}")

    # --- transmit ------------------------------------------------------------------
    rng = np.random.default_rng(0)
    payload = torch.as_tensor(rng.integers(0, 2, n_bits), device=dev)
    coded = encode(torch.as_tensor(terminate(payload.cpu().numpy(), code), device=dev), code)
    gen = torch.Generator(device=dev).manual_seed(1)
    y = transmit(gen, coded, ebn0_db, spec.rate)
    print(f"transmitted {n_bits} bits at Eb/N0 = {ebn0_db} dB")

    # --- the paper's packed H2D format ------------------------------------------------
    yq = quantize_soft(y, q=8)
    packed = pack_words(yq.reshape(-1), q=8)
    unpacked = unpack_words(packed, q=8, per_axis_len=yq.numel()).reshape(yq.shape)
    assert torch.equal(unpacked, yq.to(torch.int32))
    print(f"8-bit packed input: {packed.numel() * 4} bytes "
          f"(U1 = {u1_bytes(code.R, 8)} B/symbol vs {u1_bytes(code.R, None)} float32)")

    # --- one-shot decode through the engine -----------------------------------------
    engine = DecoderEngine(PBVDConfig(spec=spec, D=512, L=42, q=8, backend=args.backend),
                           device=dev)
    engine.decode(y[: 4 * engine.cfg.D], 4 * engine.cfg.D)  # warm-up: loads the kernels
    sync()
    t0 = time.perf_counter()
    decoded = engine.decode(y, n_bits)
    sync()
    dt = time.perf_counter() - t0
    n_blocks = -(-n_bits // engine.cfg.D)
    n_err = int((decoded != payload).sum())
    ber = n_err / n_bits
    print(f"decoded {n_blocks} parallel blocks (D={engine.cfg.D}, L={engine.cfg.L}) "
          f"in {dt*1e3:.2f} ms → {n_bits/dt/1e6:.2f} Mbps ({where}, end to end from "
          f"symbols on the device)")
    print(f"BER = {ber:.2e}  ({n_err} errors)")
    assert ber < 1e-3, f"BER {ber:.2e} at {ebn0_db} dB"
    from_packed = engine.decode(unpacked.to(torch.int8), n_bits)
    assert torch.equal(from_packed, decoded)
    print("decode of the unpacked 8-bit words: bit-exact to the float decode: True")

    # --- the same stream, chunk by chunk through a streaming session -----------------
    sess = engine.session()
    chunks = np.array_split(y.cpu().numpy(), 20)
    t0 = time.perf_counter()
    outs = [sess.decode(c) for c in chunks]
    outs.append(sess.finish(n_bits))
    sync()
    dt_s = time.perf_counter() - t0
    streamed = torch.cat(outs)
    exact = torch.equal(streamed, decoded)
    print(f"streaming session: {len(chunks)} chunks from host memory in {dt_s*1e3:.1f} ms "
          f"({where}) → bit-exact to one-shot: {exact}")
    assert exact, "the streamed bits differ from the one-shot decode"

    # --- punctured rate 3/4 from the same mother code --------------------------------
    spec34 = get_code_spec("ccsds-3/4")
    tx = spec34.puncture_stream(coded)
    y34 = transmit(gen, tx, ebn0_db + 1.5, spec34.rate)
    eng34 = DecoderEngine(PBVDConfig(spec=spec34, D=512, L=42, q=8, backend=args.backend),
                          device=dev)
    dec34 = eng34.decode(y34, n_bits)
    ber34 = float((dec34 != payload).double().mean())
    print(f"punctured rate {spec34.rate:.2f}: {tx.shape[0]} symbols "
          f"(vs {coded.shape[0]*code.R} unpunctured), BER = {ber34:.2e} at "
          f"Eb/N0 = {ebn0_db + 1.5} dB")


if __name__ == "__main__":
    main()
