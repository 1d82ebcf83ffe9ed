"""The port's host topology module against the reference's.

The 21 tests of ``tests/test_frontend_topology.py`` become 21 cases here.
Each case runs once through ``repro.serving.frontend.topology`` and once
through ``repro_torch.serving.frontend.topology``, on the same fake sysfs
tree (rebuilt under a fresh directory for each package), the same
``lscpu -p`` text and the same patched ``os.sched_setaffinity``; it
asserts the reference test's own checks on each, and the two packages'
results (plain tuples, dicts and sets) must be equal:

* cpulist parsing, every input of the reference's table;
* sysfs parsing: one socket, SMT sibling grouping, two NUMA nodes, the
  online mask, absent and partial trees;
* ``lscpu -p`` parsing: siblings, an empty NODE field, malformed input;
* ``discover()``: sysfs before lscpu text before the flat fallback;
* ``plan_affinity``: the engine's whole core, disjoint workers,
  round-robin reuse, one NUMA node per worker, a one-core host, no
  reserve, zero workers refused;
* ``apply_affinity``: a missing or refused syscall, an empty mask, a
  success passing a set of ints.
"""

import dataclasses
import os

import pytest

pytest.importorskip("jax")  # the reference package imports it

from repro.serving.frontend import topology as j_topo  # noqa: E402
from repro_torch.serving.frontend import topology as t_topo  # noqa: E402

_LSCPU = """\
# The following is the parsable format, which can be fed to other
# programs. Each different item in every column has an unique ID
# CPU,Core,Socket,Node
0,0,0,0
1,1,0,0
2,0,0,0
3,1,0,0
"""


def _plain(topo):
    """A HostTopology (either package's) as plain tuples, or None."""
    return None if topo is None else dataclasses.astuple(topo)


def _plan(plan):
    return (sorted(plan.engine_cpus), [sorted(m) for m in plan.worker_cpus])


def _sysfs_tree(root, cpus, nodes=None, online=None):
    """Build ``<root>/devices/system/{cpu,node}`` from (cpu, core, socket)
    triples + optional node->cpulist map + optional online mask."""
    base = root / "devices" / "system" / "cpu"
    for cpu, core, socket in cpus:
        topo = base / f"cpu{cpu}" / "topology"
        topo.mkdir(parents=True)
        (topo / "core_id").write_text(f"{core}\n")
        (topo / "physical_package_id").write_text(f"{socket}\n")
    if online is not None:
        (base / "online").write_text(online + "\n")
    for node, cpulist in (nodes or {}).items():
        d = root / "devices" / "system" / "node" / f"node{node}"
        d.mkdir(parents=True)
        (d / "cpulist").write_text(cpulist + "\n")
    return str(root)


def _smt_topo(m, n_cores=4, threads=2):
    cpus = tuple(m.LogicalCPU(cpu=c * threads + t, core=c, socket=0, node=0)
                 for c in range(n_cores) for t in range(threads))
    return m.HostTopology(cpus=cpus, source="sysfs")


# --- the 21 cases: each takes (module, tmp dir, monkeypatch), asserts the
# reference test's checks and returns what the packages must agree on ---

def parse_cpu_list(m, tmp, mp):
    table = [("0-3,8,10-11", [0, 1, 2, 3, 8, 10, 11]), ("2", [2]),
             ("0-2,1", [0, 1, 2]), ("3,1", [1, 3]), ("0-1,\n", [0, 1]),
             ("", []), ("  ", [])]
    got = [m.parse_cpu_list(text) for text, _ in table]
    assert got == [want for _, want in table]
    return got


def sysfs_single_socket_no_smt(m, tmp, mp):
    topo = m.from_sysfs(_sysfs_tree(tmp, [(i, i, 0) for i in range(4)]))
    assert topo is not None and topo.source == "sysfs"
    assert (topo.n_logical, topo.n_physical_cores) == (4, 4)
    assert topo.sockets == (0,) and topo.numa_nodes == (0,)
    assert not topo.smt_enabled
    return _plain(topo), topo.describe()


def sysfs_smt_sibling_grouping(m, tmp, mp):
    topo = m.from_sysfs(_sysfs_tree(tmp, [(i, i % 4, 0) for i in range(8)]))
    assert (topo.n_logical, topo.n_physical_cores) == (8, 4)
    assert topo.smt_enabled
    assert topo.cores() == {(0, c): (c, c + 4) for c in range(4)}
    return _plain(topo), topo.cores(), topo.describe()


def sysfs_multi_numa(m, tmp, mp):
    cpus = [(cpu, (cpu // 2) % 2, cpu // 4) for cpu in range(8)]
    topo = m.from_sysfs(_sysfs_tree(tmp, cpus, nodes={0: "0-3", 1: "4-7"}))
    assert topo.numa_nodes == (0, 1) and topo.sockets == (0, 1)
    assert topo.n_physical_cores == 4
    assert (topo.core_node((0, 0)), topo.core_node((1, 0))) == (0, 1)
    assert {c.node for c in topo.cpus if c.cpu < 4} == {0}
    assert {c.node for c in topo.cpus if c.cpu >= 4} == {1}
    return _plain(topo), topo.describe()


def sysfs_online_mask_trims_offline_cpus(m, tmp, mp):
    topo = m.from_sysfs(_sysfs_tree(tmp, [(i, i, 0) for i in range(4)],
                                    online="0-2"))
    assert [c.cpu for c in topo.cpus] == [0, 1, 2]
    return _plain(topo)


def sysfs_absent_or_partial_tree_returns_none(m, tmp, mp):
    absent = m.from_sysfs(str(tmp / "nope"))
    (tmp / "devices" / "system" / "cpu" / "cpu0").mkdir(parents=True)
    partial = m.from_sysfs(str(tmp))
    assert absent is None and partial is None
    return absent, partial


def lscpu_parses_and_groups_siblings(m, tmp, mp):
    topo = m.from_lscpu(_LSCPU)
    assert topo is not None and topo.source == "lscpu"
    assert (topo.n_logical, topo.n_physical_cores) == (4, 2)
    assert topo.smt_enabled
    assert topo.cores() == {(0, 0): (0, 2), (0, 1): (1, 3)}
    return _plain(topo), topo.cores()


def lscpu_empty_node_field_is_node_zero(m, tmp, mp):
    topo = m.from_lscpu("0,0,0,\n1,1,0,\n")
    assert topo is not None and topo.numa_nodes == (0,)
    return _plain(topo)


def lscpu_malformed_returns_none(m, tmp, mp):
    got = [m.from_lscpu(text) for text in
           ("", "# only comments\n", "0,zero,0,0\n", "0,0\n")]
    assert got == [None] * 4
    return got


def discover_prefers_sysfs_over_lscpu(m, tmp, mp):
    topo = m.discover(sysfs_root=_sysfs_tree(tmp, [(0, 0, 0), (1, 1, 0)]),
                      lscpu_output=_LSCPU)
    assert topo.source == "sysfs" and topo.n_logical == 2
    return _plain(topo)


def discover_falls_back_to_lscpu_then_flat(m, tmp, mp):
    missing = str(tmp / "no-sysfs")
    lscpu = m.discover(sysfs_root=missing, lscpu_output=_LSCPU)
    flat = m.discover(sysfs_root=missing)
    assert lscpu.source == "lscpu" and flat.source == "flat"
    assert flat.n_logical == (os.cpu_count() or 1)
    assert not flat.smt_enabled
    return _plain(lscpu), _plain(flat)


def plan_reserves_full_engine_core_and_disjoint_workers(m, tmp, mp):
    topo = _smt_topo(m, n_cores=4)
    plan = m.plan_affinity(topo, n_workers=3)
    whole = set(map(frozenset, topo.cores().values()))
    assert plan.engine_cpus in whole and len(plan.engine_cpus) == 2
    assert plan.n_workers == 3
    for mask in plan.worker_cpus:
        assert mask in whole and not (mask & plan.engine_cpus)
    return _plan(plan)


def plan_round_robins_when_workers_outnumber_spare_cores(m, tmp, mp):
    plan = m.plan_affinity(_smt_topo(m, n_cores=3), n_workers=5)
    w = plan.worker_cpus
    assert plan.n_workers == 5
    assert all(not (mask & plan.engine_cpus) for mask in w)
    assert w[0] == w[2] == w[4] and w[1] == w[3] and w[0] != w[1]
    return _plan(plan)


def plan_numa_spread_keeps_worker_on_one_node(m, tmp, mp):
    cpus = tuple(m.LogicalCPU(cpu=i, core=i % 2, socket=i // 2, node=i // 2)
                 for i in range(4))
    topo = m.HostTopology(cpus=cpus, source="sysfs")
    plan = m.plan_affinity(topo, n_workers=3)
    for mask in plan.worker_cpus:
        assert len({c.node for c in topo.cpus if c.cpu in mask}) == 1
    return _plan(plan)


def plan_single_core_host_shares_the_core(m, tmp, mp):
    plan = m.plan_affinity(_smt_topo(m, n_cores=1), n_workers=2)
    assert plan.engine_cpus == frozenset({0, 1})
    assert all(mask == plan.engine_cpus for mask in plan.worker_cpus)
    return _plan(plan)


def plan_no_reserve_widens_engine_mask(m, tmp, mp):
    topo = _smt_topo(m, n_cores=4)
    plan = m.plan_affinity(topo, n_workers=1, reserve_engine_core=False)
    assert plan.engine_cpus == frozenset(c.cpu for c in topo.cpus)
    return _plan(plan)


def plan_rejects_zero_workers(m, tmp, mp):
    with pytest.raises(ValueError) as err:
        m.plan_affinity(_smt_topo(m), n_workers=0)
    return str(err.value)


def apply_affinity_missing_syscall_returns_false(m, tmp, mp):
    mp.delattr(m.os, "sched_setaffinity", raising=False)
    got = m.apply_affinity([0])
    assert got is False
    return got


def apply_affinity_refused_returns_false(m, tmp, mp):
    def refuse(pid, cpus):
        raise OSError("containers say no")
    mp.setattr(m.os, "sched_setaffinity", refuse, raising=False)
    got = m.apply_affinity([0, 1])
    assert got is False
    return got


def apply_affinity_empty_mask_is_a_noop(m, tmp, mp):
    got = m.apply_affinity([])
    assert got is False
    return got


def apply_affinity_success_passes_int_set(m, tmp, mp):
    calls = {}

    def fake(pid, cpus):
        calls["pid"], calls["cpus"] = pid, cpus

    mp.setattr(m.os, "sched_setaffinity", fake, raising=False)
    got = m.apply_affinity([1, 2, 2], pid=0)
    assert got is True and calls == {"pid": 0, "cpus": {1, 2}}
    return got, calls


CASES = [
    parse_cpu_list,
    sysfs_single_socket_no_smt,
    sysfs_smt_sibling_grouping,
    sysfs_multi_numa,
    sysfs_online_mask_trims_offline_cpus,
    sysfs_absent_or_partial_tree_returns_none,
    lscpu_parses_and_groups_siblings,
    lscpu_empty_node_field_is_node_zero,
    lscpu_malformed_returns_none,
    discover_prefers_sysfs_over_lscpu,
    discover_falls_back_to_lscpu_then_flat,
    plan_reserves_full_engine_core_and_disjoint_workers,
    plan_round_robins_when_workers_outnumber_spare_cores,
    plan_numa_spread_keeps_worker_on_one_node,
    plan_single_core_host_shares_the_core,
    plan_no_reserve_widens_engine_mask,
    plan_rejects_zero_workers,
    apply_affinity_missing_syscall_returns_false,
    apply_affinity_refused_returns_false,
    apply_affinity_empty_mask_is_a_noop,
    apply_affinity_success_passes_int_set,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_topology_case_agrees_with_reference(case, tmp_path, monkeypatch):
    results = []
    for name, module in (("reference", j_topo), ("port", t_topo)):
        root = tmp_path / name
        root.mkdir()
        with monkeypatch.context() as mp:
            results.append(case(module, root, mp))
    assert results[1] == results[0]


def test_port_topology_is_pure_stdlib():
    """Spawned workers import it: it may import nothing of torch, numpy,
    jax or the reference."""
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(t_topo))
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert roots <= {"__future__", "dataclasses", "os", "re", "typing"}
