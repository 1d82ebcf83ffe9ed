"""Mesh construction for the launchers, the dry run, tests and examples.

Functions, not module-level constants: importing this module touches no
device.  ``make_production_mesh`` builds the reference's production
meshes, 16 x 16 and 2 x 16 x 16 positions, on the meta device: the dry
run plans for 256 or 512 devices without them.
"""

from __future__ import annotations

from repro_torch.distributed.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16 x 16 = 256 positions a pod, ("data", "model"); 2 pods = 512,
    ("pod", "data", "model"); every position on the meta device (no
    memory, no stream)."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    return make_mesh(shape, device="meta")


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
