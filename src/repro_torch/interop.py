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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.codespec import CodeSpec, available_code_specs, get_code_spec
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.trellis import ConvCode
from repro_torch.device import resolve_device

__all__ = ["convert_config", "config_fields", "convert_lm_params"]

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


def convert_lm_params(params: dict, cfg, device=None):
    """The reference's LM parameter pytree (numpy leaves) → the port's
    :class:`~repro_torch._unused.models.lm.LM` on ``device`` (``None``:
    ``"cuda"``).

    ``params["groups"][gi]`` leaves carry a leading ``repeat`` axis (the
    reference scans over it); layer r of the group becomes
    ``groups[gi][r]``. A tied model has no ``lm_head``. A MoE layer's
    ``ffn`` leaves (``router.w``, ``wi``, ``wg``, ``wo`` and, with shared
    experts, ``shared.{wi,wg,wo}.w``) keep their names, as do the leaves of
    the MLA, Mamba and RWKV mixers and the RWKV channel mix that are not a
    ``Dense``'s ``w`` (``q_norm.scale``, ``conv_w``, ``A_log``, ``mu``,
    ``u``, ...). Every parameter of the port must be matched by one leaf,
    and no leaf may be left over.
    """
    from repro_torch._unused.models import lm

    dev = resolve_device(device, user="convert_lm_params")
    model = lm.init_params(cfg, device="meta")
    state = {}
    for key in ("embed", "final_norm", "lm_head"):
        if key in params:
            for name, leaf in _leaves(params[key], f"{key}."):
                state[name] = torch.tensor(np.array(leaf))
    for gi, group in enumerate(params["groups"]):
        for name, leaf in _leaves(group):
            leaf = np.array(leaf)
            for r in range(leaf.shape[0]):
                state[f"groups.{gi}.{r}.{name}"] = torch.tensor(leaf[r])
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(dev)
