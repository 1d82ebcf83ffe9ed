"""One production cell of the port's dry run at full size, on the CPU:
tinyllama-1.1b's decode_32k on the multi-pod mesh (2 x 16 x 16 = 512 meta
positions), the real serve step on every position.

* status ok on 512 chips within 60 s (the process's one-time imports
  made before the clock starts);
* the argument bytes of a position equal the per-device shard bytes of the
  reference's specs (``NamedSharding(...).shard_shape`` on an abstract
  mesh of the same axes; nothing compiled), the KV cache's sequence split
  over the model axis as the reference splits it (the port's
  sequence-parallel decode attention reads a block a position), but for
  one stated difference: the port's cache position is int64 where the
  reference's is int32;
* the step launched the matmul kernel on every position, made no flash
  call (decode attends through the matmul kernel) and ran its
  collectives.
"""

import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro_torch.launch.dryrun import dryrun_cell  # noqa: E402


def _reference_bytes():
    """(params, state with the port's difference applied, batch): the
    reference's per-device bytes on the multi-pod mesh."""
    from jax.sharding import AbstractMesh, NamedSharding

    from repro.configs import SHAPES, get_config
    from repro.data.pipeline import make_batch_specs
    from repro.distributed.sharding import (batch_sharding, param_shardings,
                                            state_sharding)
    from repro.models import build_model
    from repro.models.common import dtype_of
    from repro.models.transformer import _use_scan

    mesh = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    data = ("pod", "data")
    cfg, shape = get_config("tinyllama-1.1b"), SHAPES["decode_32k"]
    model = build_model(cfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    state = jax.eval_shape(lambda: model.init_decode_state(
        shape.global_batch, shape.seq_len))
    batch = make_batch_specs(cfg, shape, dtype_of(cfg.dtype))
    trees = [(params, param_shardings(params, mesh, data_axes=())),
             (state, state_sharding(state, mesh, data_axes=data,
                                    scanned=_use_scan(cfg))),
             (batch, batch_sharding(batch, mesh, data))]
    out = []
    for tree, specs in trees:
        total = 0
        shards = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, NamedSharding))
        for (path, leaf), sh in zip(
                jax.tree_util.tree_leaves_with_path(tree), shards):
            n = math.prod(sh.shard_shape(leaf.shape)) * \
                np.dtype(leaf.dtype).itemsize
            key = jax.tree_util.keystr(path)
            if key == "['pos']":
                n *= 2  # int64 in the port, int32 in the reference
            total += n
        out.append(total)
    return out


def test_multipod_decode_cell_fits_the_reference_specs():
    # a process's one-time import, not the cell's work: FakeTensorMode
    # (the params' shapes) loads torch._dynamo, about 2 s here
    import torch._dynamo  # noqa: F401

    t0 = time.perf_counter()
    rec = dryrun_cell("tinyllama-1.1b", "decode_32k", multi_pod=True,
                      probe=False, verbose=False)
    wall = time.perf_counter() - t0
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert rec["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert wall < 60.0, f"the cell took {wall:.1f} s"
    params, state, batch = _reference_bytes()
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] == params + state + batch
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["output_bytes"]
    calls = rec["kernel_calls"]
    assert sum(n for k, n in calls.items() if k.startswith("matmul")) \
        % 512 == 0
    assert not any(k.startswith("flash") for k in calls)
    assert rec["collective_bytes"]["all-reduce"] > 0
