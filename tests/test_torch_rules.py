"""The port's logical-axis rules and placement against the reference, on the CPU.

Specs: for every registered card and every parameter leaf at the card's
full shapes (``torch.device("meta")`` for the port, ``jax.eval_shape`` for
the reference), ``LogicalRules.spec`` equals the reference's on the
``(16, 16)``, ``(2, 16, 16)`` and ``(2, 2)`` meshes under both rule sets;
so does every cache leaf's, with and without ``ctx_parallel``. Meshes are
shape-only stand-ins (the reference's rules accept any object with
``axis_names`` and ``shape``). The reference stacks a group's layers on a
leading axis whose logical axis is ``None``; the port keeps one entry per
layer, so the reference's spec without its first entry is held against
each layer's. The reference's rule tests (``tests/test_sharding_rules.py``)
are cases here, its property test included. Placement (``place_tree``,
``gather_tree``, ``reshard``, ``CheckpointManager.restore(shardings=)``)
round-trips bit for bit over meshes of ``["cpu"] * n``; the production
mesh is built over ``["cpu"] * 256`` and ``* 512``; the distributed start
over a one-process gloo world on ``localhost``.
"""

import socket

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import get_config as j_get_config
from repro._unused.models import lm as j_lm
from repro.sharding import rules as j_rules
from repro_torch.configs.base import get_config, list_archs
from repro_torch.device import DeviceUnavailableError
from repro_torch.launch import elastic
from repro_torch.launch import mesh as t_mesh
from repro_torch._unused.models import lm
from repro_torch._unused.train.checkpoint import CheckpointManager
from repro_torch.sharding import place as t_place
from repro_torch.sharding import rules as t_rules
from repro_torch.sharding.rules import LogicalRules, PartitionSpec


class FakeMesh:
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {
    "16x16": FakeMesh({"data": 16, "model": 16}),
    "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
    "2x2": FakeMesh({"data": 2, "model": 2}),
}
RULE_SETS = {"default": "DEFAULT_RULES", "single_pod": "SINGLE_POD_RULES"}
ARCHS = list_archs()
CACHE_B, CACHE_S = 32, 32768  # a serving batch at the context-parallel threshold


def test_rule_tables_are_the_reference():
    assert t_rules.DEFAULT_RULES == j_rules.DEFAULT_RULES
    assert t_rules.SINGLE_POD_RULES == j_rules.SINGLE_POD_RULES


def _stacked(path) -> tuple[str, str] | None:
    """(the port's prefix, the rest of the name) of a reference leaf under a
    stacked group or the encoder, else None."""
    keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
    if keys[0] == "groups":
        return f"groups.{keys[1]}", ".".join(keys[2:])
    if keys[0] == "encoder":
        return "encoder", ".".join(keys[1:])
    return None


def _ref_leaves(sds, axes):
    flat_s = jax.tree_util.tree_leaves_with_path(sds)
    flat_a = jax.tree.leaves(axes, is_leaf=lambda a: type(a) is tuple)
    assert len(flat_s) == len(flat_a)
    return [(path, s.shape, a) for (path, s), a in zip(flat_s, flat_a)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    named = dict(lm.init_params(cfg, device="meta").named_parameters())
    axes = lm.param_axes(cfg)
    assert set(axes) == set(named)
    sds = jax.eval_shape(lambda k: j_lm.init_params(k, jcfg), jax.random.PRNGKey(0))
    leaves = _ref_leaves(sds, j_lm.param_axes(jcfg))
    seen = 0
    for rset in RULE_SETS.values():
        jr = j_rules.LogicalRules(MESHES[mesh], getattr(j_rules, rset))
        tr = LogicalRules(MESHES[mesh], getattr(t_rules, rset))
        for path, shape, a in leaves:
            want = tuple(jr.spec(a, shape=shape))
            stacked = _stacked(path)
            if stacked is None:
                names = [".".join(str(p.key) for p in path)]
            else:
                assert want[0] is None
                want = want[1:]
                names = [f"{stacked[0]}.{r}.{stacked[1]}" for r in range(shape[0])]
            for name in names:
                got = tr.spec(axes[name], shape=tuple(named[name].shape))
                assert isinstance(got, PartitionSpec)
                assert tuple(got) == want, (name, got, want)
                seen += 1
    assert seen == 2 * len(named)


def _port_cache_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _port_cache_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _port_cache_leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _port_cache_leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


@pytest.mark.parametrize("ctx_parallel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_reference(arch, ctx_parallel):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    cross = 64 if cfg.encdec else 0
    cache = lm.init_cache(cfg, CACHE_B, CACHE_S, device="meta", cross_len=cross)
    port = dict(_port_cache_leaves(cache))
    # plain tuples are the axes tree's leaves, so it flattens to the same names
    port_axes = dict(_port_cache_leaves(lm.cache_axes(cfg, ctx_parallel=ctx_parallel,
                                                      cross=bool(cross))))
    assert set(port_axes) == set(port)
    sds = jax.eval_shape(lambda: j_lm.init_cache(jcfg, CACHE_B, CACHE_S, cross_len=cross))
    j_axes = j_lm.cache_axes(jcfg, ctx_parallel=ctx_parallel, cross=bool(cross))
    flat_s = jax.tree_util.tree_leaves_with_path(sds)
    flat_a = jax.tree.leaves(j_axes, is_leaf=lambda a: type(a) is tuple)
    assert len(flat_s) == len(flat_a)
    seen = 0
    for mesh in MESHES.values():
        for rset in RULE_SETS.values():
            jr = j_rules.LogicalRules(mesh, getattr(j_rules, rset))
            tr = LogicalRules(mesh, getattr(t_rules, rset))
            for (path, s), a in zip(flat_s, flat_a):
                keys = [str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                        for p in path]
                want = tuple(jr.spec(a, shape=s.shape))
                assert keys[0] == "groups" and want[0] is None
                for r in range(s.shape[0]):
                    name = ".".join(["groups", keys[1], str(r), *keys[2:]])
                    got = tr.spec(port_axes[name], shape=tuple(port[name].shape))
                    assert tuple(got) == want[1:], (name, got, want)
                    seen += 1
    assert seen == len(MESHES) * len(RULE_SETS) * len(port)
    if ctx_parallel and cfg.n_heads:
        assert any("seq_ctx" in a for a in port_axes.values()) == any(
            d.mixer in ("gqa", "mla") for pattern, _ in cfg.layer_list for d in pattern)


# ---- the reference's rule tests, each a case held against the reference --------------------
FULL = MESHES["2x16x16"]
RULE_CASES = [
    ("basic batch", FULL, "DEFAULT_RULES", ("batch", None), None),
    ("basic fsdp mlp", FULL, "DEFAULT_RULES", ("fsdp", "mlp"), None),
    ("kv 8 on 16 replicates", FULL, "DEFAULT_RULES", ("fsdp", "kv_heads", None), (4096, 8, 128)),
    ("40 heads replicate", FULL, "DEFAULT_RULES", ("fsdp", "heads", None), (5120, 40, 128)),
    ("48 heads shard", FULL, "DEFAULT_RULES", ("fsdp", "heads", None), (6144, 48, 128)),
    ("batch 16: pod only", FULL, "DEFAULT_RULES", ("batch", None), (16, 128)),
    ("batch 1 replicates", FULL, "DEFAULT_RULES", ("batch", None), (1, 128)),
    ("deepseek EP", FULL, "DEFAULT_RULES", ("experts", "fsdp", "expert_mlp"), (160, 5120, 1536)),
    ("mixtral TP fallback", FULL, "DEFAULT_RULES", ("experts", "fsdp", "expert_mlp"),
     (8, 6144, 16384)),
    ("pod missing drops batch", MESHES["2x2"], "DEFAULT_RULES", ("batch", None), None),
    ("single pod batch", MESHES["2x2"], "SINGLE_POD_RULES", ("batch", None), None),
    ("seq_ctx on model", MESHES["2x2"], "SINGLE_POD_RULES", ("batch", "seq_ctx", "kv_heads", None),
     (4, 32768, 8, 128)),
]
EXPECTED = {
    "basic batch": (("pod", "data"), None),
    "basic fsdp mlp": ("data", "model"),
    "kv 8 on 16 replicates": ("data", None, None),
    "40 heads replicate": ("data", None, None),
    "48 heads shard": ("data", "model", None),
    "batch 16: pod only": ("pod", None),
    "batch 1 replicates": (None, None),
    "deepseek EP": ("model", "data", None),
    "mixtral TP fallback": (None, "data", "model"),
    "pod missing drops batch": (None, None),
    "single pod batch": ("data", None),
    "seq_ctx on model": ("data", "model", None, None),
}


@pytest.mark.parametrize("label,mesh,rset,axes,shape", RULE_CASES, ids=[c[0] for c in RULE_CASES])
def test_rule_cases_equal_the_reference(label, mesh, rset, axes, shape):
    got = LogicalRules(mesh, getattr(t_rules, rset)).spec(axes, shape=shape)
    want = j_rules.LogicalRules(mesh, getattr(j_rules, rset)).spec(axes, shape=shape)
    assert tuple(got) == tuple(want) == EXPECTED[label]


@given(st.integers(1, 8).map(lambda x: 2 ** x),
       st.sampled_from(["heads", "kv_heads", "mlp", "vocab"]))
@settings(max_examples=40, deadline=None)
def test_property_spec_always_divides(dim, axis):
    """The reference's property test, held against the reference as well:
    any spec produced with shape info tiles the dimension exactly."""
    r = LogicalRules(FULL, t_rules.DEFAULT_RULES)
    spec = r.spec((axis,), shape=(dim,))
    assert tuple(spec) == tuple(j_rules.LogicalRules(FULL, j_rules.DEFAULT_RULES).spec(
        (axis,), shape=(dim,)))
    part = spec[0]
    if part is None:
        return
    axes = (part,) if isinstance(part, str) else part
    assert dim % int(np.prod([FULL.shape[a] for a in axes])) == 0


# ---- the rule context ------------------------------------------------------------------
def test_rule_context_and_shard_are_value_noops():
    mesh = t_mesh.make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    x = torch.arange(12.0).reshape(3, 4)
    assert t_rules.current_rules() is None
    assert t_rules.logical_to_spec(("batch", "mlp")) == PartitionSpec()
    assert t_rules.named_sharding(("batch",)) is None
    assert t_rules.shard(x, ("batch", "mlp")) is x
    with t_rules.axis_rules(mesh) as r:
        assert t_rules.current_rules() is r and r.rules["batch"] == "data"
        assert t_rules.logical_to_spec(("batch", "mlp")) == PartitionSpec("data", "model")
        ns = t_rules.named_sharding(("batch", "mlp"))
        assert ns.spec == PartitionSpec("data", "model") and ns.mesh is mesh
        assert t_rules.shard(x, ("batch", "mlp")) is x
        with t_rules.axis_rules(mesh, {"batch": "model"}) as inner:
            assert t_rules.current_rules() is inner
        assert t_rules.current_rules() is r
    assert t_rules.current_rules() is None


def test_named_sharding_tiles():
    mesh = t_mesh.make_decode_mesh("pod=2,data=2,model=2", devices=["cpu"] * 8)
    ns = t_rules.NamedSharding(mesh, PartitionSpec(("pod", "data"), None, "model"))
    assert ns.shard_shape((8, 3, 6)) == (2, 3, 3)
    assert ns.indices((8, 3, 6), (1, 0, 1)) == (slice(4, 6), slice(0, 3), slice(3, 6))
    assert ns.block((0, 1, 0), 3) == (1, 0, 0)
    tiles = ns.devices_indices_map((8, 3, 6))
    assert len(tiles) == 8 and tiles[1, 0, 1] == (torch.device("cpu"), ns.indices((8, 3, 6),
                                                                                  (1, 0, 1)))
    with pytest.raises(ValueError, match="does not split 4 ways"):
        ns.shard_shape((6, 3, 6))


# ---- placement --------------------------------------------------------------------------
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.as_tensor(rng.normal(size=(8, 6)).astype(np.float32)),
            "sub": {"b": torch.as_tensor(rng.normal(size=(6,)).astype(np.float32)),
                    "e": torch.as_tensor(rng.integers(0, 9, (4, 2, 8)))},
            "layers": [torch.as_tensor(rng.normal(size=(2, 4)).astype(np.float32))]}


AXES = {"w": ("fsdp", "mlp"), "sub": {"b": ("mlp",), "e": ("experts", None, "fsdp")},
        "layers": [(None, "heads")]}


def _equal(a, b):
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(
        _port_cache_leaves(a), _port_cache_leaves(b)))


def test_place_and_gather_round_trip():
    tree = _tree()
    mesh = t_mesh.make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    sh = t_rules.tree_shardings(tree, AXES, LogicalRules(mesh, t_rules.SINGLE_POD_RULES))
    assert sh["w"].spec == PartitionSpec("data", "model")
    assert sh["sub"]["e"].spec == PartitionSpec("model", None, "data")
    placed = t_place.place_tree(tree, sh)
    w = placed["w"]
    assert w.tiles.shape == (2, 2) and tuple(w.tiles[1, 0].shape) == (4, 3)
    assert torch.equal(w.tiles[1, 1], tree["w"][4:, 3:])
    assert w.tiles[0, 0].data_ptr() == tree["w"].data_ptr()  # a view on the source's device
    assert len(placed["sub"]["b"].blocks()) == 2  # split over model, replicated over data
    assert _equal(t_place.gather_tree(placed, "cpu"), tree)
    copied = t_place.place(tree["w"], sh["w"], copy=True)
    assert copied.tiles[0, 0].data_ptr() != tree["w"].data_ptr()
    copied.copy_(tree["w"] * 2)
    assert torch.equal(copied.full(), tree["w"] * 2)
    with pytest.raises(ValueError, match="axes"):
        t_rules.tree_shardings(tree, {**AXES, "w": {"x": ("fsdp",)}}, LogicalRules(
            mesh, t_rules.SINGLE_POD_RULES))


def test_reshard_round_trips_bit_equal():
    tree = _tree(1)
    a = t_mesh.make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    b = t_mesh.make_decode_mesh("pod=2,data=2,model=2", devices=["cpu"] * 8)
    on_a = elastic.reshard(tree, AXES, a)
    on_b = elastic.reshard(on_a, AXES, b)
    assert on_b["w"].sharding.spec == PartitionSpec("data", "model")  # fsdp → data
    assert on_b["sub"]["e"].tiles.shape == (2, 2, 2)
    back = elastic.reshard(on_b, AXES, a, rules_map=t_rules.SINGLE_POD_RULES)
    assert _equal(t_place.gather_tree(back, "cpu"), tree)
    assert _equal(t_place.gather_tree(on_b, "cpu"), tree)


def test_restore_with_shardings_round_trips_bit_equal(tmp_path):
    tree = _tree(2)
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, tree)
    mesh = t_mesh.make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    sh = t_rules.tree_shardings(tree, AXES, LogicalRules(mesh, t_rules.SINGLE_POD_RULES))
    sh["layers"] = [None]  # a leaf restored as a plain tensor
    got = mgr.restore(3, tree, shardings=sh)
    assert isinstance(got["w"], t_place.Placed) and isinstance(got["layers"][0], torch.Tensor)
    assert _equal(t_place.gather_tree(got, "cpu"), tree)


def test_lm_params_place_and_gather():
    cfg = get_config("mixtral-8x22b").reduced()
    model = lm.init_params(cfg, device="cpu")
    named = {k: p.detach() for k, p in model.named_parameters()}
    mesh = t_mesh.make_local_mesh(data=2, model=2, devices=["cpu"] * 4)
    sh = t_rules.tree_shardings(named, lm.param_axes(cfg), LogicalRules(
        mesh, t_rules.SINGLE_POD_RULES))
    placed = t_place.place_tree(named, sh)
    wi = placed["groups.0.0.l0.ffn.wi"]
    assert wi.sharding.spec == PartitionSpec("model", "data", None)  # 4 experts over 2
    assert all(torch.equal(t_place.gather_tree(placed)[k], v) for k, v in named.items())


# ---- meshes -----------------------------------------------------------------------------
@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    mesh = t_mesh.make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * (n + 3))
    assert mesh.size == n
    assert dict(mesh.shape) == ({"pod": 2, "data": 16, "model": 16} if multi_pod
                                else {"data": 16, "model": 16})
    with pytest.raises(ValueError, match=f"needs {n} devices, only {n - 1}"):
        t_mesh.make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * (n - 1))
    if not torch.cuda.is_available():  # devices=None: every CUDA device; none is refused
        with pytest.raises(DeviceUnavailableError):
            t_mesh.make_production_mesh(multi_pod=multi_pod)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_maybe_init_distributed(monkeypatch):
    import torch.distributed as dist

    for key in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert t_mesh.maybe_init_distributed() is False
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert t_mesh.maybe_init_distributed() is False  # RANK missing
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    try:
        assert t_mesh.maybe_init_distributed() is True
        assert dist.is_initialized() and dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
