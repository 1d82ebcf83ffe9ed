"""Topology-aware multi-process serving front end.

    topology.py   host CPU discovery (sysfs / lscpu / flat fallback) and
                  SMT/NUMA-aware affinity planning — one physical core
                  reserved for the engine thread
    workers.py    pinned intake (validate + pre-process) and emission
                  (stream assembly + detok) worker processes over bounded
                  IPC queues, spawned (never forked: the parent holds CUDA
                  state); crash => respawn, then typed FAILED, every
                  request still terminal
    stream.py     per-request incremental token streams published at
                  macro-step boundaries (zero added device syncs)

Worker count and message coalescing are priced by the ``serve_ipc``
calibrated cost site (the eleventh), ledgered predicted-vs-measured.
None of these modules imports torch: spawned workers import them.
"""

from repro_torch.serving.frontend.stream import (StreamBroken, StreamEvent,
                                                 TokenStream)
from repro_torch.serving.frontend.topology import (AffinityPlan,
                                                   HostTopology, LogicalCPU,
                                                   apply_affinity, discover,
                                                   flat_topology, from_lscpu,
                                                   from_sysfs,
                                                   parse_cpu_list,
                                                   plan_affinity)
from repro_torch.serving.frontend.workers import (FrontendConfig,
                                                  FrontendError,
                                                  FrontendStream,
                                                  ServingFrontend)

__all__ = [
    "AffinityPlan",
    "FrontendConfig",
    "FrontendError",
    "FrontendStream",
    "HostTopology",
    "LogicalCPU",
    "ServingFrontend",
    "StreamBroken",
    "StreamEvent",
    "TokenStream",
    "apply_affinity",
    "discover",
    "flat_topology",
    "from_lscpu",
    "from_sysfs",
    "parse_cpu_list",
    "plan_affinity",
]
