"""The port's GPipe pipeline (``launch/pp.py``) on the CPU.

The reference's ``test_pipeline_parallel_matches_sequential``
(``tests/test_distributed.py``) at its shapes, P = 4 stages and M = 6
microbatches of (2, 16) over ``["cpu"] * 4``, to 1e-5, plus other stage
and microbatch counts, stage parameters held in a dict, a pipe axis
beside another mesh axis, and the bubble fraction against the reference's.
"""

import numpy as np
import pytest
import torch

from repro.launch import pp as j_pp
from repro_torch.launch import pp
from repro_torch.launch.mesh import make_decode_mesh

ATOL = 1e-5


def _stage(w, h):
    return torch.tanh(h @ w)


def _sequential(ws, x):
    ref = x
    for s in range(ws.shape[0]):
        ref = torch.tanh(ref @ ws[s])
    return ref


@pytest.mark.parametrize("P,M", [(4, 6), (4, 2), (2, 5), (1, 3)])
def test_pipeline_matches_sequential(P, M):
    mesh = make_decode_mesh(f"pipe={P}", devices=["cpu"] * P)
    mb, d = 2, 16
    rng = np.random.default_rng(0)
    ws = torch.as_tensor(rng.normal(size=(P, d, d)).astype(np.float32) * 0.3)
    x = torch.as_tensor(rng.normal(size=(M, mb, d)).astype(np.float32))
    out = pp.pipeline_apply(_stage, ws, x, mesh, axis="pipe")
    assert out.shape == (M, mb, d)
    torch.testing.assert_close(out, _sequential(ws, x), atol=ATOL, rtol=0)


def test_pipeline_stage_tree_and_other_axes():
    """Stage parameters as a dict of stacked leaves, on a data=2, pipe=3 mesh
    (stage s on the pipe axis's s-th device, data index 0)."""
    mesh = make_decode_mesh("data=2,pipe=3", devices=["cpu"] * 6)
    rng = np.random.default_rng(1)
    params = {"w": torch.as_tensor(rng.normal(size=(3, 8, 8)).astype(np.float32) * 0.3),
              "b": torch.as_tensor(rng.normal(size=(3, 8)).astype(np.float32))}
    x = torch.as_tensor(rng.normal(size=(5, 4, 8)).astype(np.float32))
    out = pp.pipeline_apply(lambda p, h: torch.tanh(h @ p["w"] + p["b"]), params, x, mesh)
    ref = x
    for s in range(3):
        ref = torch.tanh(ref @ params["w"][s] + params["b"][s])
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("P,M", [(4, 6), (1, 8), (8, 1), (16, 64)])
def test_bubble_fraction(P, M):
    assert pp.bubble_fraction(P, M) == j_pp.bubble_fraction(P, M)
    assert abs(pp.bubble_fraction(4, 6) - 1 / 3) < 1e-12
