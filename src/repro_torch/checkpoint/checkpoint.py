"""Fault-tolerant checkpointing, in the reference's on-disk layout.

* **atomic** — write ``step_<N>.tmp/``, sync, rename to ``step_<N>/``; a
  crash mid-write never leaves a directory ``latest_step`` would pick up.
* **restartable** — ``latest_step`` finds the newest complete checkpoint;
  the train loop resumes from (params, opt state, step), and the data
  pipeline regenerates batches from the step.
* **layout** — ``shard_0.npz`` holds every leaf whole, keyed by its tree
  path (``params/layers/3/ln1/scale``), and ``manifest.json`` the step and
  each key's shape and dtype.  numpy has no bfloat16, so bf16 leaves are
  stored as float32 (exact) and cast back on restore.

* **elastic** — ``save`` of a state placed on a mesh (one tree a
  position, with its ``mesh`` and ``shardings``) writes the whole leaves,
  joined back along every axis (``sharding.unplace_tree``);
  ``restore_resharded`` restores the whole leaves and places them on a
  mesh by per-leaf specs, whatever mesh wrote them: the layout on disk
  holds no sharding.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves_with_paths, tree_map_with_path


def _host(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def save(ckpt_dir, step: int, tree: Any, *, process_index: int = 0,
         mesh=None, shardings: Any = None) -> Path:
    """Write ``tree`` as checkpoint ``step``.  A tree placed on a mesh (a
    list with one tree a position) needs its ``mesh`` and ``shardings``
    (the specs it was placed by): its leaves are joined whole first."""
    if isinstance(tree, list):
        if mesh is None or shardings is None:
            raise ValueError("a state placed on a mesh (one tree a "
                             "position) is saved with its mesh= and "
                             "shardings=")
        from repro_torch.distributed.sharding import unplace_tree

        tree = unplace_tree(mesh, tree, shardings, device="cpu")
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    tmp.mkdir(parents=True, exist_ok=True)
    flat = leaves_with_paths(tree)
    arrays = {k: _host(v) for k, v in flat}
    np.savez(tmp / f"shard_{process_index}.npz", **arrays)
    manifest = {"step": step, "keys": {
        k: {"shape": list(v.shape), "dtype": str(v.dtype).replace("torch.", "")}
        for k, v in flat}}
    with open(tmp / "manifest.json", "w") as f:
        json.dump(manifest, f)
    os.sync()
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic on POSIX
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = []
    for p in ckpt_dir.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and (p / "manifest.json").exists():
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def restore(ckpt_dir, step: int, like: Any, *, process_index: int = 0) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each
    leaf takes the dtype and device of ``like``'s leaf at the same path
    (values ignored).  Raises on a missing key or a shape mismatch."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    with np.load(d / f"shard_{process_index}.npz") as data:
        missing = [k for k, _ in leaves_with_paths(like) if k not in data.files]
        if missing:
            raise ValueError(f"checkpoint at step {step} missing keys: "
                             f"{sorted(missing)[:5]}")

        def one(path, ref):
            arr = data[path]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"{path}: checkpoint shape {arr.shape} != "
                                 f"expected {tuple(ref.shape)}")
            return torch.from_numpy(np.array(arr)).to(device=ref.device,
                                                      dtype=ref.dtype)

        return tree_map_with_path(one, like)


def restore_resharded(ckpt_dir, step: int, like: Any, shardings: Any, *,
                      mesh, copy: bool = False) -> Any:
    """Elastic restore: load the whole leaves into ``like``'s structure,
    then place them on ``mesh`` by ``shardings`` (a tree of specs in that
    structure, e.g. ``param_shardings``).  Returns one tree a position,
    each leaf that position's block (``sharding.place_tree``; ``copy``
    gives every position storage of its own, for a step that updates in
    place).  The reference's ``NamedSharding``s carry their mesh; the
    port's specs do not, so the mesh is an argument."""
    from repro_torch.distributed.sharding import place_tree

    return place_tree(mesh, restore(ckpt_dir, step, like), shardings,
                      copy=copy)
