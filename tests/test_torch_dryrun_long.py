"""The dry run's skip rule runs what it keeps: rwkv6-3b's long_500k cell
(one sequence of 524,288 positions, a decode step against its recurrent
state) on the pod mesh's 256 meta positions, at full size, on the CPU.

The batch of 1 divides no data axis, so it stays whole on every position
(the reference's ``batch_sharding``); the recurrent state is a
position's whole (1, H, N, N) per layer.  gemma-2b's long_500k is
skipped as pure full attention (``tests/test_torch_dryrun.py``).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch.dryrun import dryrun_cell  # noqa: E402


def test_rwkv6_long_500k_runs_on_the_pod():
    cfg = get_config("rwkv6-3b")
    rec = dryrun_cell("rwkv6-3b", "long_500k", multi_pod=False, probe=False,
                      verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert rec["cell"] == "rwkv6-3b/long_500k/pod"
    shape = SHAPES["long_500k"]
    # the whole batch on every position: one token, int32
    h, n = cfg.d_model // cfg.rnn_head_dim, cfg.rnn_head_dim
    states = cfg.n_layers * (4 * h * n * n + 2 * 2 * cfg.d_model)
    mem = rec["memory_analysis"]
    assert mem["argument_bytes"] > states + 4 * shape.global_batch
    assert mem["peak_bytes"] < 80e9
    assert sum(v for k, v in rec["kernel_calls"].items()
               if k.startswith("matmul")) % 256 == 0
    assert not any(k.startswith("wkv") for k in rec["kernel_calls"])
