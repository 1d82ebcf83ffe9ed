"""Parallelism over a device mesh: the mesh and its collectives
(``mesh.py``) and GPipe over a mesh axis (``pipeline.py``)."""

from repro_torch.distributed.mesh import (  # noqa: F401
    Mesh,
    all_gather,
    all_to_all,
    axis_index,
    make_mesh,
    place,
    ppermute,
    psum,
    replicate,
    shard,
    take,
    unshard,
)
from repro_torch.distributed.pipeline import (  # noqa: F401
    best_microbatch_count,
    gpipe,
    pipeline_bubble_fraction,
)
