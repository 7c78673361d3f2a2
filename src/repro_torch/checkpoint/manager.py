"""Checkpointing with atomic manifests (PyTorch port of
``repro/checkpoint/manager.py``), on the reference's layout, so that a
checkpoint either package writes the other restores::

    ckpt_dir/
      step_00000123/
        manifest.json        # leaf names, files, shapes, dtypes; extras (data cursor, step)
        arrays/NNNNN.npy     # one file per tree leaf
      LATEST                 # atomically updated pointer

A tree is nested dicts, lists and tuples of numpy arrays or tensors
(``repro_torch.tree``): leaves come in the reference's order (dict keys
sorted) under its names (``params/stages/0/mixer/wq``). The trainer saves
its state in the reference's layout (``models.convert``: each stage's
leaves stacked on a leading axis). A bfloat16 tensor is written as a
float32 file, which is exact and needs no bfloat16 type in numpy.

* **Atomicity** — a step directory is written under ``.tmp`` and renamed;
  ``LATEST`` is only updated after the rename, so a crash mid-save leaves
  the previous checkpoint intact.
* **Restart** — ``manager.restore_latest()`` returns (tree, extras) or
  None; the trainer resumes from (params, optimizer state, data cursor).
* **Retention** — the ``keep`` most recent steps are kept, older ones
  deleted after a successful save.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves_with_names, tree_map

__all__ = ["save_tree", "restore_tree", "CheckpointManager"]


def _to_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _numpy_dtype(leaf: Any) -> np.dtype:
    """The dtype a leaf restores to: a tensor's numpy counterpart (float32
    for bfloat16), an array's own."""
    if isinstance(leaf, torch.Tensor):
        return np.dtype(np.float32) if leaf.dtype == torch.bfloat16 else \
            torch.empty((), dtype=leaf.dtype).numpy().dtype
    return np.asarray(leaf).dtype


def save_tree(tree: Any, directory: Path, extras: Optional[Dict] = None) -> None:
    directory = Path(directory)
    tmp = directory.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    (tmp / "arrays").mkdir(parents=True)
    manifest = {"leaves": [], "extras": extras or {}, "time": time.time()}
    for i, (name, val) in enumerate(tree_leaves_with_names(tree)):
        arr = _to_numpy(val)
        fname = f"{i:05d}.npy"
        np.save(tmp / "arrays" / fname, arr)
        manifest["leaves"].append(
            {"name": name, "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype)}
        )
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if directory.exists():
        shutil.rmtree(directory)
    os.rename(tmp, directory)


def restore_tree(tree_like: Any, directory: Path) -> Tuple[Any, Dict]:
    """Restore into the structure of ``tree_like``: a tree of numpy arrays,
    each cast to its ``tree_like`` leaf's dtype (a tensor leaf's numpy
    counterpart). The leaf count, names and shapes must match the
    checkpoint's."""
    directory = Path(directory)
    manifest = json.loads((directory / "manifest.json").read_text())
    leaves = tree_leaves_with_names(tree_like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target tree has {len(leaves)}"
        )
    vals = {}
    for (name, like), meta in zip(leaves, manifest["leaves"]):
        if name != meta["name"]:
            raise ValueError(f"checkpoint leaf {meta['name']!r} where the tree has {name!r}")
        if list(like.shape) != meta["shape"]:
            raise ValueError(
                f"leaf {name}: checkpoint shape {meta['shape']} != {tuple(like.shape)}"
            )
        vals[name] = np.load(directory / "arrays" / meta["file"]).astype(_numpy_dtype(like))
    restored = iter(vals.values())  # tree_map visits the leaves in this order
    return tree_map(lambda _: next(restored), tree_like), manifest["extras"]


class CheckpointManager:
    def __init__(self, root: Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def save(self, step: int, tree: Any, extras: Optional[Dict] = None) -> None:
        save_tree(tree, self._step_dir(step), extras={**(extras or {}), "step": step})
        (self.root / "LATEST.tmp").write_text(str(step))
        os.replace(self.root / "LATEST.tmp", self.root / "LATEST")
        self._gc()

    def latest_step(self) -> Optional[int]:
        p = self.root / "LATEST"
        if not p.exists():
            return None
        return int(p.read_text().strip())

    def restore_latest(self, tree_like: Any) -> Optional[Tuple[Any, Dict]]:
        step = self.latest_step()
        if step is None:
            return None
        return restore_tree(tree_like, self._step_dir(step))

    def _gc(self) -> None:
        steps = sorted(
            int(p.name.split("_")[1]) for p in self.root.glob("step_*")
            if p.is_dir()
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
