"""Mesh construction for the launchers, tests and examples.

Functions, not module-level constants: importing this module touches no
device.  ``make_production_mesh`` (the reference's 16 x 16 and 2 x 16 x 16
meshes of 256 and 512 positions) comes with the dry-run slice, which
plans for that many devices without them.
"""

from __future__ import annotations

from repro_torch.distributed.mesh import Mesh, make_mesh


def data_axes_of(mesh: Mesh) -> tuple:
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def make_dev_mesh(n_data: int = 1, n_model: int = 1, *, device: str = "cuda",
                  shards_per_device: int = 1) -> Mesh:
    """Small ("data", "model") mesh for tests and examples: on the GPUs by
    default, ``shards_per_device`` positions on each (eight shards on one
    card: ``make_dev_mesh(8, shards_per_device=8)``), or on the CPU with
    ``device="cpu"`` and ``shards_per_device`` the mesh's size."""
    return make_mesh({"data": n_data, "model": n_model}, device=device,
                     shards_per_device=shards_per_device)
