"""The port's examples, each on ``--device cpu`` at a tiny size in a
subprocess (the kernels' plain versions run there), and the serve CLI over
every card the port has.

Each example runs under a wrapper that afterwards refuses any module of JAX
or of the JAX package in ``sys.modules``: the examples use the port alone.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.configs.base import list_archs

ROOT = Path(__file__).resolve().parent.parent
_WRAP = """
import runpy, sys
path, *argv = sys.argv[1:]
sys.argv = [path, *argv]
runpy.run_path(path, run_name="__main__")
bad = [m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "jaxlib", "repro."))]
assert not bad, f"the example imported {bad[:5]}"
"""


def _run(example: str, *args: str) -> list[str]:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run([sys.executable, "-c", _WRAP, str(ROOT / "examples" / example), *args],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout.splitlines()


def test_quickstart_on_the_cpu():
    out = _run("torch_quickstart.py", "--device", "cpu", "--bits", "8192")
    text = "\n".join(out)
    assert "device CPU, backend 'cuda'" in out[0]
    assert "BER = " in text and "(CPU, end to end" in text
    assert "bit-exact to one-shot: True" in text
    assert "punctured rate 0.75" in out[-1]


def test_ber_sweep_on_the_cpu():
    out = _run("torch_ber_sweep.py", "--device", "cpu", "--bits", "2048", "--depths", "14", "42",
               "--ebn0", "2.0", "4.0", "--seed", "3")
    assert out[0].startswith("code ccsds: K=7, rate=0.500; soft (q=8)")
    rows = [line.split() for line in out[2:4]]
    assert [r[0] for r in rows] == ["2.0", "4.0"] and all(len(r) == 4 for r in rows)
    bers = [[float(x) for x in r[2:]] for r in rows]
    assert all(0.0 <= b < 0.5 for row in bers for b in row)


def test_ber_sweep_hard_punctured_fused_on_the_cpu():
    out = _run("torch_ber_sweep.py", "--device", "cpu", "--bits", "2048", "--depths", "42",
               "--ebn0", "5.0", "--code", "ccsds-3/4", "--hard", "--backend", "fused")
    assert "rate=0.750; hard decisions, backend 'fused'" in out[0]
    assert out[2].split()[0] == "5.0"


def test_serve_lm_on_the_cpu():
    out = _run("torch_serve_lm.py", "--device", "cpu", "--new-tokens", "4")
    assert out[0].startswith("starcoder2-3b") and "generated 4×4 tokens" in out[0]
    assert out[1].startswith("rwkv6-3b") and "generated 4×4 tokens" in out[1]
    assert "cache kinds: state" in out[1]
    assert out[2].startswith("mixtral-8x22b") and "MoE 4 experts top-2" in out[2]


def test_train_tiny_lm_on_the_cpu(tmp_path):
    out = _run("torch_train_tiny_lm.py", "--device", "cpu", "--preset", "tiny", "--steps", "20",
               "--global-batch", "4", "--seq-len", "32", "--ckpt-dir", str(tmp_path))
    assert out[0].startswith("training starcoder2-3b-reduced:") and "20 steps" in out[0]
    assert out[-1].startswith("loss: ")


@pytest.mark.parametrize("arch", list_archs())
def test_serve_cli_takes_every_ported_card(arch, monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", ["serve", "--arch", arch, "--device", "cpu", "--batch", "2",
                                     "--prompt-len", "3", "--new-tokens", "2"])
    serve.main()
    assert f"[serve] {arch}-reduced on CPU: 4 tokens" in capsys.readouterr().out
