"""The ``"blocks"`` logical-axis rule of the decoder, after
``repro.sharding.rules``.

The reference maps logical axis names to mesh axes for the LM as well; the
decoder needs only the parallel-block (lane) axis, ``"blocks"``, which the
default multi-pod rule set shards over ``("pod", "data")`` and the
single-pod one over ``"data"``.
"""

from __future__ import annotations

__all__ = ["DEFAULT_RULES", "SINGLE_POD_RULES", "block_mesh_axes"]

# logical axis name → mesh axis (or tuple of mesh axes)
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "blocks": ("pod", "data"),  # PBVD parallel blocks
}

SINGLE_POD_RULES = dict(DEFAULT_RULES, blocks="data")


def block_mesh_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the PBVD ``blocks`` logical axis maps to on ``mesh``.

    Resolves the ``"blocks"`` rule (``("pod", "data")`` multi-pod,
    ``"data"`` single-pod) and drops axes the mesh does not have — the
    engine's default ``block_axes`` when bound to a mesh without an explicit
    override (``DecoderEngine(cfg, mesh=m, block_axes=None)``).
    """
    rules = DEFAULT_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    m = rules["blocks"]
    axes = (m,) if isinstance(m, str) else tuple(m or ())
    resolved = tuple(a for a in axes if a in mesh.axis_names)
    if not resolved:
        raise ValueError(
            f"no 'blocks' rule axis {axes} exists on mesh axes "
            f"{tuple(mesh.axis_names)}; pass block_axes explicitly"
        )
    return resolved
