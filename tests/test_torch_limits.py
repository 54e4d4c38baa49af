"""The CUDA backends' kernel size limits, refused at the config, on the CPU.

``"cuda"`` and ``"fused"`` declare in the port's registry what their
kernels take: code rank R <= 4, ``acs_k`` <= 4 under ``acs_impl="matrix"``
and at most 1024 trellis states. ``PBVDConfig`` and ``pbvd_decode_blocks``
refuse anything beyond with a ``ValueError`` that names the backend, the
knob and the limit, before any kernel launches (on a CPU tensor the
backends would otherwise run their plain versions and succeed). ``"ref"``
keeps the reference's own limits: it takes each of these codes, and its
decoded bits equal the JAX reference's ``backend="ref"`` on the same numpy
inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.pbvd import PBVDConfig as JConfig
from repro.core.trellis import ConvCode as JConvCode
from repro.kernels.ops import pbvd_decode_blocks as j_decode_blocks
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused, traceback
from repro_torch.kernels.ops import backend_limits, pbvd_decode_blocks

# (label, polys, knobs, the knob the message names, its limit)
CASES = [
    ("R = 5", ((1, 1, 1), (1, 0, 1), (1, 1, 0), (0, 1, 1), (1, 1, 1)), {}, "code rank R", 4),
    ("acs_k = 5", ((1, 0, 1, 1, 0, 1),), dict(acs_impl="matrix", acs_k=5), "acs_k", 4),
    ("N = 2048", ((1,) + (0,) * 10 + (1,), (1,) * 12), {}, "n_states", 1024),
]
COUNTERS = ((acs, "launches"), (acs, "matrix_launches"), (acs, "table_launches"),
            (traceback, "launches"), (traceback, "prefix_launches"), (fused, "launches"))


def test_registry_declares_the_limits():
    for be in ("cuda", "fused"):
        assert backend_limits(be) == dict(rank=4, matrix_k=4, states=1024)
    assert backend_limits("ref") == dict(rank=None, matrix_k=None, states=None)


@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("label,polys,knobs,knob,limit", CASES, ids=[c[0] for c in CASES])
def test_cuda_backends_refuse_beyond_their_limits(label, polys, knobs, knob, limit, backend):
    code = ConvCode(polys=polys)
    pattern = rf"backend '{backend}' does not support {knob}=\d+: its kernels take {knob} <= {limit}"
    with pytest.raises(ValueError, match=pattern):
        PBVDConfig(backend=backend, code=code, **knobs)
    for mod, attr in COUNTERS:
        setattr(mod, attr, 0)
    y = torch.zeros((12, code.R, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match=pattern):
        pbvd_decode_blocks(y, code, decode_start=2, n_decode=8, backend=backend, **knobs)
    assert all(getattr(mod, attr) == 0 for mod, attr in COUNTERS)


@pytest.mark.parametrize("label,polys,knobs,knob,limit", CASES, ids=[c[0] for c in CASES])
def test_ref_takes_what_the_reference_takes(label, polys, knobs, knob, limit):
    code, jcode = ConvCode(polys=polys), JConvCode(polys=polys)
    cfg, jcfg = PBVDConfig(backend="ref", code=code, **knobs), JConfig(backend="ref", code=jcode,
                                                                         **knobs)
    assert (cfg.acs_impl, cfg.acs_k) == (jcfg.acs_impl, jcfg.acs_k)
    y = np.random.default_rng(16).integers(-7, 8, (12, code.R, 3)).astype(np.int8)
    got = pbvd_decode_blocks(torch.as_tensor(y), code, decode_start=2, n_decode=8,
                             backend="ref", start_policy="argmin", **knobs)
    want = j_decode_blocks(jnp.asarray(y), jcode, decode_start=2, n_decode=8, backend="ref",
                           start_policy="argmin", **knobs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_limits_come_after_the_references_own_checks():
    """Where the reference refuses too, its message wins: k·R > 8 on the
    rate-1/5 code is the reference's refusal, not the rank limit."""
    polys = CASES[0][1]
    with pytest.raises(ValueError) as want:
        JConfig(backend="ref", code=JConvCode(polys=polys), acs_impl="matrix", acs_k=2)
    for be in ("cuda", "fused"):
        with pytest.raises(ValueError) as got:
            PBVDConfig(backend=be, code=ConvCode(polys=polys), acs_impl="matrix", acs_k=2)
        assert str(got.value) == str(want.value)
