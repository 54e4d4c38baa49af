"""The port's dry-run cells and input specs against the JAX reference's.

``configs.base.SHAPES``, ``launch.specs`` (``iter_cells``, ``SKIPS``,
``LONG_OK``, ``ENCODER_CTX``) and ``input_specs``: for every architecture
and one cell of each kind, every parameter, batch and cache leaf of the
port's meta tensors has the shape and dtype of the reference's
``ShapeDtypeStruct`` of the same name (the reference's stacked layers
unstacked as ``interop.lm_named`` unstacks them; exact). The decode step's
``cache_len`` is a Python int in the port (a host index there), where the
reference takes an int32 scalar.
"""

import jax
import pytest
import torch

from repro.configs import base as j_base
from repro.launch import specs as j_specs
from repro_torch.configs import base
from repro_torch.interop import _leaves, _stacks
from repro_torch.launch import specs

ARCHS = base.list_archs()
KINDS = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}


def test_shapes_are_the_references():
    assert base.SHAPES == {k: base.ShapeSpec(v.name, v.seq_len, v.global_batch, v.kind)
                           for k, v in j_base.SHAPES.items()}
    assert set(base.__all__) >= {"ShapeSpec", "SHAPES"}


def test_cells_and_skips_are_the_references():
    assert ARCHS == j_base.list_archs()
    cells = [(c.arch, c.shape.name, c.kind) for c in specs.iter_cells()]
    j_cells = [(c.arch, c.shape.name, c.kind) for c in j_specs.iter_cells()]
    assert cells == j_cells
    assert len(list(specs.iter_cells(include_skips=True))) == len(ARCHS) * len(base.SHAPES)
    assert specs.SKIPS == j_specs.SKIPS
    assert specs.LONG_OK == j_specs.LONG_OK and specs.ENCODER_CTX == j_specs.ENCODER_CTX
    assert str(specs.make_cell("rwkv6-3b", "long_500k")) == "rwkv6-3b×long_500k"


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _key(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    raise TypeError(entry)


def _ref_params(tree) -> dict:
    """The reference's parameter SDS tree by the port's names (stacked
    layers unstacked, as ``interop.lm_named`` does with arrays)."""
    out = {}
    for key, sub in tree.items():
        if key not in ("groups", "encoder"):
            out.update({n: (tuple(s.shape), _dt(s.dtype)) for n, s in _leaves(sub, f"{key}.")})
    for prefix, group in _stacks(tree):
        for name, s in _leaves(group):
            for r in range(s.shape[0]):
                out[f"{prefix}{r}.{name}"] = (tuple(s.shape[1:]), _dt(s.dtype))
    return out


def _ref_cache(cache) -> dict:
    out = {}
    for gi, group in enumerate(cache["groups"]):
        for path, s in jax.tree_util.tree_flatten_with_path(group)[0]:
            name = ".".join(_key(p) for p in path)
            for r in range(s.shape[0]):
                out[f"groups.{gi}.{r}.{name}"] = (tuple(s.shape[1:]), _dt(s.dtype))
    return out


def _port_tree(tree, prefix="") -> dict:
    out = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: (tuple(tree.shape), _dt(tree.dtype))}
    for k, v in items:
        if v is not None:
            out.update(_port_tree(v, f"{prefix}{k}."))
    return out


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_are_the_references(arch, kind):
    cell, j_cell = specs.make_cell(arch, KINDS[kind]), j_specs.make_cell(arch, KINDS[kind])
    got, want = specs.input_specs(cell), j_specs.input_specs(j_cell)
    params = {n: (tuple(p.shape), _dt(p.dtype)) for n, p in got["params"].named_parameters()}
    assert all(p.device.type == "meta" for p in got["params"].parameters())
    assert params == _ref_params(want["params"])
    if kind == "decode":
        assert _port_tree(got["tokens"]) == _port_tree(
            torch.empty(want["tokens"].shape, dtype=torch.int32))
        assert _port_tree(got["cache"]) == _ref_cache(want["cache"])
        assert got["cache_len"] == cell.shape.seq_len - 1 and want["cache_len"].shape == ()
    else:
        batch = {k: (tuple(v.shape), _dt(v.dtype)) for k, v in want["batch"].items()}
        assert _port_tree(got["batch"]) == batch


def test_serve_f32_keeps_float32_weights(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_F32", "1")
    got = specs.input_specs(specs.make_cell("starcoder2-3b", "prefill_32k"))
    assert {p.dtype for p in got["params"].parameters()} == {torch.float32}
