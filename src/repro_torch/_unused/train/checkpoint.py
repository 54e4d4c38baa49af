"""Fault-tolerant checkpointing, in the reference's on-disk format.

The counterpart of ``repro._unused.train.checkpoint``; its file logic is a
copy, so a checkpoint written by either package restores in the other:

  * atomic: writes go to ``step_N.tmp/`` and are renamed only after the
    manifest is fsynced — a crash mid-save never corrupts the latest
    checkpoint;
  * every leaf is its own ``leaf_NNNNN.npy``, in the order in which JAX
    flattens the same tree (dict keys sorted, lists and named tuples in
    order), and the manifest records each leaf's path key (``a/b/0/c``),
    shape and dtype;
  * keep-N rotation + ``latest`` pointer file;
  * async: ``save_async`` copies the tree to the host, then hands it to a
    writer thread, so the caller blocks only for the device→host copy.

Trees are dicts, lists, tuples and named tuples whose leaves are tensors,
numpy arrays or numbers. Restore is crash-tolerant (a missing or partial
``.tmp`` directory is ignored; it reads the newest complete manifest) and
refuses a checkpoint whose leaves do not match the tree it restores into.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_with_paths", "unflatten"]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path key, leaf)] in JAX's flattening order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_namedtuple(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), x) for i, x in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for key, sub in items:
        out += flatten_with_paths(sub, f"{prefix}/{key}" if prefix else key)
    return out


def unflatten(tree, leaves: list):
    """``tree``'s structure with its leaves replaced, in the order of
    :func:`flatten_with_paths`."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            done = {k: build(node[k]) for k in sorted(node)}
            return {k: done[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(x) for x in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(x) for x in node)
        return next(it)

    return build(tree)


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # ---- save -----------------------------------------------------------------------
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> None:
        host = [(key, _host(leaf)) for key, leaf in flatten_with_paths(tree)]
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._thread = threading.Thread(target=self._write_safe, args=(step, host))
            self._thread.start()

    def save_async(self, step: int, tree: Any) -> None:
        self.save(step, tree, blocking=False)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_safe(self, step: int, host) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # noqa: BLE001 — re-raised by wait()
            self._error = e

    def _write(self, step: int, host: list[tuple[str, np.ndarray]]) -> None:
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": []}
        for i, (key, arr) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
            )
        with open(tmp / "manifest.json", "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
        (self.dir / "latest").write_text(str(step))
        self._rotate()

    def _rotate(self) -> None:
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---- restore ---------------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None, like: Any, *, shardings: Any | None = None) -> Any:
        """Restore into the structure of ``like`` (values replaced by CPU
        tensors of the file's dtype). With ``shardings`` (a tree of
        :class:`~repro_torch.sharding.rules.NamedSharding` mirroring
        ``like``, ``None`` where a leaf stays a tensor) the leaves are placed
        over the mesh (``sharding.place.place``), as the reference's
        ``device_put`` per leaf does. A leaf count or a shape that differs
        from ``like``'s raises ``ValueError``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = flatten_with_paths(like)
        if len(manifest["leaves"]) != len(flat_like):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, expected {len(flat_like)}"
            )
        arrays = []
        for entry, (key, leaf) in zip(manifest["leaves"], flat_like):
            want = tuple(getattr(leaf, "shape", np.shape(leaf)))
            if tuple(entry["shape"]) != want:
                raise ValueError(f"checkpoint leaf {entry['key']} has shape {entry['shape']}, "
                                 f"expected {list(want)} for {key}")
            arrays.append(torch.from_numpy(np.load(d / entry["file"])))
        if shardings is not None:
            from repro_torch.sharding.place import place

            flat_sh = [s for _, s in flatten_with_paths(shardings)]
            if len(flat_sh) != len(arrays):
                raise ValueError(f"shardings has {len(flat_sh)} leaves, expected {len(arrays)}")
            arrays = [a if s is None else place(a, s) for a, s in zip(arrays, flat_sh)]
        return unflatten(like, arrays)
