"""Carry a reference decoder configuration across to the port.

The decoder has no weights: its parameters are the code and the config.
:func:`convert_config` builds the port's :class:`PBVDConfig` from plain
values (numpy arrays and scalars), so a caller holding a configuration of
the JAX package can describe it without the port importing that package:

    fields = dict(polys=np.array(cfg.spec.code.polys), puncture=..., D=cfg.D,
                  L=cfg.L, q=cfg.q, start_policy=cfg.start_policy,
                  metric_mode=cfg.metric_mode, acs_radix=cfg.acs_radix,
                  backend=cfg.backend, tb_mode=cfg.tb_mode,
                  tb_chunk=cfg.tb_chunk, acs_impl=cfg.acs_impl,
                  acs_k=cfg.acs_k)

``backend`` is the reference's name and maps to the port's counterpart:
``"pallas"`` → ``"cuda"``, ``"ref"`` → ``"ref"``, ``"fused"`` → ``"fused"``.
:func:`config_fields` is the inverse.

The LM path has weights: :func:`convert_lm_params` carries the reference's
parameter pytree, with every leaf a numpy array, into the port's modules.
:func:`lm_named` and :func:`lm_tree` map between that pytree and the port's
parameter names both ways (a training checkpoint is written in the
reference's layout).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codespec import CodeSpec, available_code_specs, get_code_spec
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.trellis import ConvCode
from repro_torch.device import resolve_device

__all__ = ["convert_config", "config_fields", "convert_lm_params", "lm_named", "lm_tree"]

_KEYS = ("polys", "puncture", "D", "L", "q", "start_policy", "metric_mode")
#: the reference's backend names → the port's
BACKENDS = {"pallas": "cuda", "ref": "ref", "fused": "fused"}


def _spec_for(code: ConvCode, puncture) -> CodeSpec:
    """The registered spec with this code and puncturing, else a custom one."""
    for name in available_code_specs():
        spec = get_code_spec(name)
        if spec.code == code and spec.puncture == puncture:
            return spec
    return CodeSpec(name="custom", code=code, puncture=puncture)


def convert_config(fields: dict) -> PBVDConfig:
    """Plain-valued reference config → the port's ``PBVDConfig``.

    ``fields`` holds ``polys`` ((R, K) int array of generator bits, input tap
    first), ``puncture`` ((R, period) 0/1 array or ``None``), ``D``, ``L``,
    ``q`` (``None`` for float symbols), ``start_policy`` and ``metric_mode``;
    optionally ``acs_radix``, ``tb_mode``, ``tb_chunk``, ``acs_impl`` and
    ``acs_k`` (absent: the config's defaults) and ``backend`` (the
    reference's name, see :data:`BACKENDS`; absent means the port's default).
    """
    missing = [k for k in _KEYS if k not in fields]
    if missing:
        raise KeyError(f"config fields missing {missing}; expected {_KEYS}")
    polys = tuple(tuple(int(b) for b in row) for row in np.asarray(fields["polys"]))
    puncture = fields["puncture"]
    if puncture is not None:
        puncture = tuple(tuple(int(b) for b in row) for row in np.asarray(puncture))
    spec = _spec_for(ConvCode(polys=polys), puncture)
    q = fields["q"]
    extra = {}
    for key, cast in (("acs_radix", int), ("tb_mode", str), ("tb_chunk", int),
                      ("acs_impl", str), ("acs_k", int)):
        if key in fields:
            extra[key] = cast(fields[key])
    if "backend" in fields:
        try:
            extra["backend"] = BACKENDS[str(fields["backend"])]
        except KeyError:
            raise KeyError(
                f"reference backend {fields['backend']!r} has no counterpart in the port; "
                f"known: {tuple(BACKENDS)}"
            ) from None
    return PBVDConfig(
        spec=spec,
        D=int(fields["D"]),
        L=int(fields["L"]),
        q=None if q is None else int(q),
        start_policy=str(fields["start_policy"]),
        metric_mode=str(fields["metric_mode"]),
        **extra,
    )


def config_fields(cfg: PBVDConfig) -> dict:
    """The port's config → the plain values :func:`convert_config` takes."""
    spec = cfg.codespec
    return dict(
        polys=np.asarray(spec.code.polys, dtype=np.int64),
        puncture=None if spec.puncture is None else np.asarray(spec.puncture, dtype=np.int64),
        D=cfg.D,
        L=cfg.L,
        q=cfg.q,
        start_policy=cfg.start_policy,
        metric_mode=cfg.metric_mode,
        acs_radix=cfg.acs_radix,
        tb_mode=cfg.tb_mode,
        tb_chunk=cfg.tb_chunk,
        acs_impl=cfg.acs_impl,
        acs_k=cfg.acs_k,
        backend={port: ref for ref, port in BACKENDS.items()}[cfg.backend],
    )


def _leaves(tree: dict, prefix: str = ""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


#: the reference's stacked subtrees (a leading scan axis over layers)
def _stacks(tree: dict):
    yield from ((f"groups.{gi}.", group) for gi, group in enumerate(tree["groups"]))
    if "encoder" in tree:
        yield "encoder.", tree["encoder"]


def lm_named(tree: dict) -> dict[str, torch.Tensor]:
    """The reference's LM pytree (numpy or tensor leaves) → the port's
    parameter names: ``embed``, ``final_norm``, ``lm_head``, ``enc_norm``
    (and any other top-level subtree) keep their paths; the leaves of ``groups[gi]`` and
    ``encoder``, stacked on a leading layer axis, become
    ``groups.{gi}.{r}.…`` and ``encoder.{r}.…``."""
    state = {}
    for key, sub in tree.items():
        if key not in ("groups", "encoder"):
            for name, leaf in _leaves(sub, f"{key}."):
                state[name] = torch.as_tensor(np.array(leaf))
    for prefix, group in _stacks(tree):
        for name, leaf in _leaves(group):
            leaf = torch.as_tensor(np.array(leaf))
            for r in range(leaf.shape[0]):
                state[f"{prefix}{r}.{name}"] = leaf[r].clone()
    return state


def lm_tree(named) -> dict:
    """The inverse of :func:`lm_named`: tensors keyed by the port's
    parameter names (``named_parameters()``, or an optimizer moment keyed
    the same) → the reference's pytree, each group's and the encoder's
    layers stacked on axis 0 (``torch.stack``, on the tensors' device)."""
    tree: dict = {}
    stacked: dict = {}
    for name, t in dict(named).items():
        parts = name.split(".")
        if parts[0] == "groups":
            gi, r, parts = int(parts[1]), int(parts[2]), parts[3:]
            node = stacked.setdefault(("groups", gi), {})
        elif parts[0] == "encoder":
            r, parts = int(parts[1]), parts[2:]
            node = stacked.setdefault(("encoder",), {})
        else:
            node, r = tree, None
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        if r is None:
            node[parts[-1]] = t
        else:
            node.setdefault(parts[-1], {})[r] = t

    def stack(node):
        if all(isinstance(k, int) for k in node):
            return torch.stack([node[r] for r in range(len(node))])
        return {k: stack(v) for k, v in node.items()}

    groups = sorted(k[1] for k in stacked if k[0] == "groups")
    tree["groups"] = [stack(stacked["groups", gi]) for gi in groups]
    if ("encoder",) in stacked:
        tree["encoder"] = stack(stacked["encoder",])
    return tree


def convert_lm_params(params: dict, cfg, device=None):
    """The reference's LM parameter pytree (numpy leaves) → the port's
    :class:`~repro_torch._unused.models.lm.LM` on ``device`` (``None``:
    ``"cuda"``).

    ``params["groups"][gi]`` leaves carry a leading ``repeat`` axis (the
    reference scans over it); layer r of the group becomes
    ``groups[gi][r]``, and layer r of an enc-dec ``encoder`` becomes
    ``encoder[r]`` (its ``enc_norm`` and each decoder block's ``norm_x`` and
    ``cross`` keep their names). A tied model has no ``lm_head``. A MoE
    layer's ``ffn`` leaves (``router.w``, ``wi``, ``wg``, ``wo`` and, with
    shared experts, ``shared.{wi,wg,wo}.w``) keep their names, as do the
    leaves of the MLA, Mamba and RWKV mixers and the RWKV channel mix that
    are not a ``Dense``'s ``w`` (``q_norm.scale``, ``conv_w``, ``A_log``,
    ``mu``, ``u``, ...). Every parameter of the port must be matched by one
    leaf, and no leaf may be left over.
    """
    from repro_torch._unused.models import lm

    dev = resolve_device(device, user="convert_lm_params")
    model = lm.init_params(cfg, device="meta")
    model.load_state_dict(lm_named(params), strict=True, assign=True)
    return model.to(dev)
