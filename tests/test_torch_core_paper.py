"""The rest of the paper's core on one device, port against reference.

* ``matmul_chain``: the same product (rtol = atol = 1e-4 in fp32, as the
  reference's own test; only the summation order differs) and the same
  number of ``matmul`` decisions in the ledger;
* ``fork_join``: the chosen branch is returned, the other never called;
* ``analyze_dependencies`` on a ``torch.fx`` graph against the reference's
  on the jaxpr, for functions whose graphs correspond node for equation:
  the same work and span (rtol 1e-9), and the reference's own assertions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch  # noqa: E402
from repro.core import analyze_dependencies as j_analyze  # noqa: E402
from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.core.dispatch import matmul_chain as j_matmul_chain  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.hw import HardwareSpec as JSpec  # noqa: E402
from repro_torch.core import analyze_dependencies, fork_join  # noqa: E402
from repro_torch.core import matmul_chain  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402


@pytest.mark.parametrize("shapes", [
    [(8, 32), (32, 4), (4, 64), (64, 16)],
    [(16, 8), (8, 8), (8, 64), (64, 2), (2, 32)],
])
def test_matmul_chain_matches_reference(shapes):
    rng = np.random.default_rng(len(shapes))
    mats = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    jeng = JCostEngine(hw=JSpec.from_dict(V5E.to_dict()))
    eng = CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))
    want = j_matmul_chain([jnp.asarray(m) for m in mats], engine=jeng)
    got = matmul_chain([torch.from_numpy(m) for m in mats], engine=eng)
    assert got.shape == (shapes[0][0], shapes[-1][1])
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-4, atol=1e-4)
    rows = [e for e in eng.ledger.entries if e.site == "matmul"]
    jrows = [e for e in jeng.ledger.entries if e.site == "matmul"]
    assert len(rows) == len(jrows) == len(shapes) - 1
    assert [r.query for r in rows] == [r.query for r in jrows]
    assert {r.choice for r in rows} == {"serial"}


def test_matmul_chain_mesh_raises():
    """A mesh that is not a ``repro_torch.distributed.Mesh`` is refused
    (the chain over a real one: tests/test_torch_sharded_dispatch.py)."""
    a = torch.ones((4, 4))
    with pytest.raises(TypeError, match="Mesh"):
        matmul_chain([a, a], mesh=object())


def test_fork_join_returns_the_chosen_branch_only():
    calls = []
    serial = lambda: calls.append("serial") or "s"  # noqa: E731
    parallel = lambda: calls.append("parallel") or "p"  # noqa: E731
    assert fork_join(serial, parallel, parallel_wins=True)() == "p"
    assert fork_join(serial, parallel, parallel_wins=False)() == "s"
    assert calls == ["parallel", "serial"]


def _chain(mm):
    def chain(x):
        for _ in range(8):
            x = mm(x, x)
        return x
    return chain


# (name, reference function, port function, example shape, reference check)
CASES = [
    ("chain", _chain(jnp.matmul), _chain(torch.matmul), (32, 32),
     lambda rep: rep.parallelism < 1.5),
    ("branches", lambda x: sum(jnp.dot(x + i, x) for i in range(8)),
     lambda x: sum((x + i) @ x for i in range(8)), (32, 32),
     lambda rep: rep.parallelism > 4.0),
    ("sort", lambda x: jax.lax.sort(x), lambda x: torch.sort(x).values,
     (4, 64), lambda rep: rep.parallelism == 1.0),
    ("sum", lambda x: x.sum(), lambda x: x.sum(), (32, 32),
     lambda rep: rep.parallelism == 1.0),
]


@pytest.mark.parametrize("name,jfn,fn,shape,check", CASES,
                         ids=[c[0] for c in CASES])
def test_analyze_dependencies_matches_reference(name, jfn, fn, shape, check):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = j_analyze(jfn, jnp.asarray(x))
    got = analyze_dependencies(fn, torch.from_numpy(x))
    assert got.total_flops == pytest.approx(want.total_flops, rel=1e-9)
    assert got.critical_flops == pytest.approx(want.critical_flops, rel=1e-9)
    assert got.parallelism == pytest.approx(want.parallelism, rel=1e-9)
    assert check(got) and check(want)
    assert got.sufficient_for(1) and "parallelism=" in got.summary()


def test_dependency_counts_loop_work():
    """A Python loop unrolls in the fx graph (the reference's test uses a
    16-step scan): its work is 16 products."""
    def looped(x):
        c = x
        for _ in range(16):
            c = c @ x
        return c

    x = torch.ones((32, 32))
    one = analyze_dependencies(lambda x: x @ x, x)
    rep = analyze_dependencies(looped, x)
    assert rep.total_flops >= 14 * one.total_flops
    assert rep.n_eqns == 16 and rep.by_primitive == {
        "matmul": 16 * one.total_flops}
    jrep = j_analyze(lambda x: jax.lax.scan(
        lambda c, _: (c @ x, None), x, None, length=16)[0], jnp.ones((32, 32)))
    assert rep.total_flops == pytest.approx(jrep.total_flops, rel=1e-9)


def test_dependency_modules_and_sort_projections():
    """An ``nn.Linear`` leaf costs its product, and the ``values``/index
    projections of a sort cost nothing."""
    lin = torch.nn.Linear(16, 8, bias=False)
    rep = analyze_dependencies(lin, torch.ones((4, 16)))
    assert rep.total_flops == 2 * 4 * 16 * 8 and rep.n_eqns == 1
    rep = analyze_dependencies(lambda x: torch.sort(x)[0] + 1.0,
                               torch.ones(64))
    assert rep.by_primitive["getitem"] == 0.0
    assert rep.total_flops == 64 * 6 + 64


def test_paper_core_is_exported_lazily():
    for name in ("distributed_sort", "fork_join", "matmul_chain",
                 "analyze_dependencies", "adaptive_matmul"):
        assert name in repro_torch.__all__
        assert getattr(repro_torch, name) is getattr(repro_torch.core, name)
