"""Parallelism over a device mesh: the mesh and its collectives
(``mesh.py``), GPipe over a mesh axis (``pipeline.py``), and the sharding
rules and placement of whole trees (``sharding.py``)."""

from repro_torch.distributed.mesh import (  # noqa: F401
    Mesh,
    all_gather,
    all_gather_cat,
    all_to_all,
    axis_index,
    join,
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
from repro_torch.distributed.sharding import (  # noqa: F401
    ShardingCtx,
    param_shardings,
    place_tree,
    serve_state_sharding,
    validate_serve_mesh,
)
