"""Host CPU topology discovery and SMT/NUMA-aware affinity planning.

The paper's thesis is that core allocation must be "managed to the root
level": which PHYSICAL core a host worker lands on is a first-order cost,
because two hyperthreads of one core share execution ports and L1/L2, and
cores on different NUMA nodes pay remote-memory latency for the IPC queues
between them.  This module turns the kernel's view of the machine
(`/sys/devices/system/cpu` sysfs tree, or parsed ``lscpu -p`` output) into
an explicit :class:`HostTopology` — logical CPUs grouped into SMT sibling
sets, physical cores, sockets, and NUMA nodes — and plans affinity masks
for the serving front end:

* the ENGINE thread gets one dedicated physical core (both of its SMT
  siblings, so nothing else is scheduled onto the core's second thread);
* each intake/emission WORKER gets whole physical cores from the
  remainder, round-robined across NUMA nodes so queue traffic spreads.

Everything degrades gracefully: hosts without sysfs (macOS), containers
that mask it, and kernels without ``sched_setaffinity`` all fall back to a
flat single-socket topology / no-op pinning, so the front end still runs —
it just loses placement control.  Pure stdlib, no torch and no device:
worker processes import this module under a spawn context.  Names and
behaviour are the reference's (``repro.serving.frontend.topology``), held
equal case by case by ``tests/test_torch_frontend_topology.py``.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple


def parse_cpu_list(text: str) -> List[int]:
    """Parse a kernel cpulist string (``"0-3,8,10-11"``) into sorted ids."""
    out: List[int] = []
    text = text.strip()
    if not text:
        return out
    for part in text.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return sorted(set(out))


@dataclasses.dataclass(frozen=True)
class LogicalCPU:
    """One schedulable hardware thread as the kernel numbers it."""

    cpu: int                 # logical id (what sched_setaffinity takes)
    core: int                # physical core id (SMT siblings share it)
    socket: int              # physical package id
    node: int                # NUMA node id


@dataclasses.dataclass(frozen=True)
class HostTopology:
    """Immutable snapshot of the host's CPU layout.

    ``cpus`` is sorted by logical id.  ``source`` records where the
    snapshot came from (``sysfs`` | ``lscpu`` | ``flat``) so reports and
    tests can tell a real discovery from the fallback.
    """

    cpus: Tuple[LogicalCPU, ...]
    source: str = "sysfs"

    # ------------------------------------------------------------- views --
    @property
    def n_logical(self) -> int:
        return len(self.cpus)

    @property
    def sockets(self) -> Tuple[int, ...]:
        return tuple(sorted({c.socket for c in self.cpus}))

    @property
    def numa_nodes(self) -> Tuple[int, ...]:
        return tuple(sorted({c.node for c in self.cpus}))

    @property
    def smt_enabled(self) -> bool:
        return any(len(sibs) > 1 for sibs in self.cores().values())

    def cores(self) -> Dict[Tuple[int, int], Tuple[int, ...]]:
        """Physical cores as ``(socket, core) -> sorted logical ids``."""
        out: Dict[Tuple[int, int], List[int]] = {}
        for c in self.cpus:
            out.setdefault((c.socket, c.core), []).append(c.cpu)
        return {k: tuple(sorted(v)) for k, v in out.items()}

    @property
    def n_physical_cores(self) -> int:
        return len(self.cores())

    def core_node(self, key: Tuple[int, int]) -> int:
        """NUMA node of a physical core (its first thread's node)."""
        for c in self.cpus:
            if (c.socket, c.core) == key:
                return c.node
        raise KeyError(key)

    def describe(self) -> str:
        return (f"{self.n_logical} logical / {self.n_physical_cores} "
                f"physical cores, {len(self.sockets)} socket(s), "
                f"{len(self.numa_nodes)} NUMA node(s), "
                f"SMT {'on' if self.smt_enabled else 'off'} "
                f"[{self.source}]")


# ---------------------------------------------------------------------------
# Discovery: sysfs -> lscpu text -> flat fallback
# ---------------------------------------------------------------------------

def _read_int(path: str, default: int = 0) -> int:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return default


def from_sysfs(root: str = "/sys") -> Optional[HostTopology]:
    """Parse ``<root>/devices/system/cpu``.  Returns None when the tree is
    absent or unreadable (macOS, masked containers)."""
    base = os.path.join(root, "devices", "system", "cpu")
    try:
        names = os.listdir(base)
    except OSError:
        return None
    cpu_ids = sorted(int(m.group(1)) for n in names
                     if (m := re.fullmatch(r"cpu(\d+)", n)))
    if not cpu_ids:
        return None
    # online mask, when present, trims hotplugged-off cpus
    online_path = os.path.join(base, "online")
    if os.path.exists(online_path):
        try:
            with open(online_path) as f:
                online = set(parse_cpu_list(f.read()))
            cpu_ids = [c for c in cpu_ids if c in online]
        except (OSError, ValueError):
            pass
    # NUMA: node*/cpulist is authoritative; missing tree -> all node 0
    node_of: Dict[int, int] = {}
    node_base = os.path.join(root, "devices", "system", "node")
    try:
        for n in os.listdir(node_base):
            m = re.fullmatch(r"node(\d+)", n)
            if not m:
                continue
            try:
                with open(os.path.join(node_base, n, "cpulist")) as f:
                    for cpu in parse_cpu_list(f.read()):
                        node_of[cpu] = int(m.group(1))
            except (OSError, ValueError):
                continue
    except OSError:
        pass
    cpus = []
    for cpu in cpu_ids:
        topo = os.path.join(base, f"cpu{cpu}", "topology")
        if not os.path.isdir(topo):
            return None  # no per-cpu topology -> treat sysfs as unusable
        cpus.append(LogicalCPU(
            cpu=cpu,
            core=_read_int(os.path.join(topo, "core_id"), default=cpu),
            socket=_read_int(os.path.join(topo, "physical_package_id")),
            node=node_of.get(cpu, 0),
        ))
    return HostTopology(cpus=tuple(cpus), source="sysfs")


def from_lscpu(text: str) -> Optional[HostTopology]:
    """Parse ``lscpu -p=CPU,CORE,SOCKET,NODE`` output (comment lines start
    with ``#``; NODE may be empty on non-NUMA hosts)."""
    cpus = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fields = line.split(",")
        if len(fields) < 3:
            return None
        try:
            cpu, core, socket = (int(fields[0]), int(fields[1]),
                                 int(fields[2]))
            node = int(fields[3]) if len(fields) > 3 and fields[3] else 0
        except ValueError:
            return None
        cpus.append(LogicalCPU(cpu=cpu, core=core, socket=socket, node=node))
    if not cpus:
        return None
    cpus.sort(key=lambda c: c.cpu)
    return HostTopology(cpus=tuple(cpus), source="lscpu")


def flat_topology(n: Optional[int] = None) -> HostTopology:
    """Fallback: every logical CPU its own single-thread core on one
    socket/node.  Placement still round-robins; SMT awareness is moot."""
    if n is None:
        n = os.cpu_count() or 1
    cpus = tuple(LogicalCPU(cpu=i, core=i, socket=0, node=0)
                 for i in range(n))
    return HostTopology(cpus=cpus, source="flat")


def discover(sysfs_root: str = "/sys",
             lscpu_output: Optional[str] = None) -> HostTopology:
    """Best available topology: sysfs, else the provided lscpu text, else a
    flat fallback sized by ``os.cpu_count()``.  Never raises."""
    topo = from_sysfs(sysfs_root)
    if topo is not None:
        return topo
    if lscpu_output is not None:
        topo = from_lscpu(lscpu_output)
        if topo is not None:
            return topo
    return flat_topology()


# ---------------------------------------------------------------------------
# Affinity planning + application
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AffinityPlan:
    """Pinning plan for one front-end deployment.

    ``engine_cpus`` is the reserved physical core's FULL SMT sibling set —
    pinning the engine to both threads keeps the OS from scheduling a
    worker onto the core's second thread.  ``worker_cpus[i]`` is worker
    ``i``'s mask (whole physical cores, possibly shared between workers
    when the host has fewer spare cores than workers).
    """

    engine_cpus: FrozenSet[int]
    worker_cpus: Tuple[FrozenSet[int], ...]

    @property
    def n_workers(self) -> int:
        return len(self.worker_cpus)


def plan_affinity(topo: HostTopology, n_workers: int,
                  reserve_engine_core: bool = True) -> AffinityPlan:
    """Assign whole physical cores: one reserved for the engine thread,
    the rest round-robined to workers grouped by NUMA node (consecutive
    workers land on different nodes only when one node runs dry — keeping
    a worker's core and its queue pages on one node beats spreading).

    Degenerate hosts are handled: with a single physical core, engine and
    workers share it (pinning is then a no-op placement-wise but still
    keeps masks valid); with fewer spare cores than workers, cores are
    reused round-robin.
    """
    if n_workers < 1:
        raise ValueError(f"n_workers must be >= 1, got {n_workers}")
    cores = topo.cores()
    # deterministic order: NUMA node, then socket, then core id
    order = sorted(cores, key=lambda k: (topo.core_node(k), k))
    engine_key = order[0]
    engine_cpus = frozenset(cores[engine_key])
    spare = [k for k in order[1:]] or [engine_key]
    worker_masks: List[FrozenSet[int]] = []
    for i in range(n_workers):
        key = spare[i % len(spare)]
        worker_masks.append(frozenset(cores[key]))
    if not reserve_engine_core:
        engine_cpus = frozenset(c.cpu for c in topo.cpus)
    return AffinityPlan(engine_cpus=engine_cpus,
                        worker_cpus=tuple(worker_masks))


def apply_affinity(cpus: Sequence[int], pid: int = 0) -> bool:
    """Pin ``pid`` (0 = calling process) to ``cpus``.  Returns True when
    the mask took effect, False when the platform has no
    ``sched_setaffinity`` (macOS) or the kernel refuses it (restricted
    containers) — callers treat False as "run unpinned", never an error."""
    setaff = getattr(os, "sched_setaffinity", None)
    if setaff is None or not cpus:
        return False
    try:
        setaff(pid, set(int(c) for c in cpus))
        return True
    except (OSError, ValueError):
        return False
