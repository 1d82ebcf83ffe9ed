"""The port's sample sort over a mesh against the reference's.

The reference (``repro.core.sort.distributed_sort`` with
``force_parallel=True``) runs once for this file, in a subprocess with 8
forced host devices on an ``AxisType.Auto`` mesh (``torch_mesh_reference``;
its ``shard_map`` bodies under ``jax.jit``, which computes the same thing
in a fraction of the eager time); the port runs on an 8-position CPU mesh
(``make_mesh(..., device="cpu", shards_per_device=8)``) on the same
inputs, with ``local_sort`` ``"torch"`` and ``"kernel"`` (the bitonic
kernel's plain version on the CPU).  Inputs: the reference test's N(0, 1)
at n = 4096; its skewed input (exponential, 137 zeros, 500 times 3.3; n
= 3637, not a multiple of 8, so the shards carry +inf padding and neither
a shard nor a bucket is a power of 2: the wrapper's padding trap); N(0, 1)
at n = 4000 (a multiple of 8, buckets of 4000).

* ``left``, ``right``, ``sampled``: the sorted output, the splitters and
  the per-position counts equal to the reference's;
* ``mean``: the splitters within 1e-6 x max|x| (another summation order;
  a shard's mean cancels to near zero, so its rounding is relative to the
  values summed), the counts equal on these inputs;
* ``random``: the output exact and the counts summing to n (the port
  draws its index from a ``torch.Generator`` seeded by (17, rank));
* the reference test's property: ``sampled`` no worse than ``left``,
  ``right`` and ``random`` in imbalance, ``left`` or ``right`` above 1.5;
* the decision at chips = 8 and its measured ledger row, priced as the
  reference's engine prices it;
* ``examples/torch_distributed_sort.py`` at CPU size;
* on a CUDA card (marked ``cuda``): eight shards on one GPU, each on its
  own stream, every output bit for bit ``torch.sort``'s.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from torch_mesh_reference import needs_reference, run_reference

torch = pytest.importorskip("torch")

from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.sort import (  # noqa: E402
    PIVOT_STRATEGIES,
    _local_sort,
    _select_splitters,
    distributed_sort,
)
from repro_torch.distributed import make_mesh, shard  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CHIPS = 8
INPUTS = ("normal4096", "skewed3637", "normal4000")

_REFERENCE = """
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.core import sort as sort_lib

# the same shard_map, compiled once a call instead of run op by op
sort_lib.shard_map = lambda *a, **k: jax.jit(shard_map(*a, **k))
mesh = auto_mesh((8,), ("data",))
k0 = jax.random.PRNGKey(0)
inputs = {
    "normal4096": jax.random.normal(jax.random.PRNGKey(3), (4096,)),
    "skewed3637": jnp.concatenate([jnp.exp(jax.random.normal(k0, (3000,))),
                                   jnp.zeros(137), jnp.ones(500) * 3.3]),
    "normal4000": jax.random.normal(jax.random.PRNGKey(5), (4000,)),
}
for name, x in inputs.items():
    OUT[name + "/x"] = x
    n = x.shape[0]
    xp = jnp.pad(x, (0, (-n) % 8), constant_values=jnp.inf)
    n_local = xp.shape[0] // 8
    for pivot in sort_lib.PIVOT_STRATEGIES:
        out, rep = sort_lib.distributed_sort(x, mesh, "data", pivot=pivot,
                                             force_parallel=True)
        assert rep.strategy == "sample_sort"
        OUT[f"{name}/{pivot}/out"] = out
        OUT[f"{name}/{pivot}/counts"] = rep.counts

        def body(xl, pivot=pivot):
            xs = jnp.sort(xl.reshape(-1))
            return sort_lib._select_splitters(xs, pivot, "data", 8,
                                              n_local)[None]

        spl = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                                out_specs=P("data", None)))(xp)
        OUT[f"{name}/{pivot}/splitters"] = spl
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(_REFERENCE,
                         tmp_path_factory.mktemp("ref") / "sort.npz")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"data": CHIPS}, device="cpu", shards_per_device=CHIPS)


def _port_splitters(mesh, x, pivot, local_sort):
    n = x.shape[0]
    pad = (-n) % CHIPS
    xp = torch.cat([x, x.new_full((pad,), float("inf"))])
    xs = mesh.map(lambda v: _local_sort(v, local_sort),
                  shard(mesh, "data", xp, 0))
    return _select_splitters(mesh, "data", xs, pivot, CHIPS,
                             xp.shape[0] // CHIPS)


@needs_reference
@pytest.mark.parametrize("local_sort", ["torch", "kernel"])
@pytest.mark.parametrize("pivot", PIVOT_STRATEGIES)
@pytest.mark.parametrize("name", INPUTS)
def test_sample_sort_matches_reference(reference, mesh, name, pivot,
                                       local_sort):
    x_np = reference[f"{name}/x"]
    x = torch.from_numpy(x_np)
    n = x_np.shape[0]
    got, rep = distributed_sort(x, mesh, "data", pivot=pivot,
                                force_parallel=True, local_sort=local_sort)
    assert rep.strategy == "sample_sort" and rep.chips == CHIPS
    np.testing.assert_array_equal(got.numpy(), np.sort(x_np))
    np.testing.assert_array_equal(got.numpy(),
                                  reference[f"{name}/{pivot}/out"])
    counts = rep.counts.numpy()
    assert counts.sum() == n
    want_counts = reference[f"{name}/{pivot}/counts"]
    want_spl = reference[f"{name}/{pivot}/splitters"]
    assert (want_spl == want_spl[0]).all()  # agreed on every device
    spl = _port_splitters(mesh, x, pivot, local_sort)
    assert all(torch.equal(s, spl[0]) for s in spl)
    if pivot == "random":
        return  # another generator: only the output and the total hold
    np.testing.assert_array_equal(counts, want_counts)
    if pivot == "mean":
        # a shard's mean is a sum that cancels to near zero, so its error
        # is relative to the values summed, not to the mean
        np.testing.assert_allclose(spl[0].numpy(), want_spl[0], rtol=0,
                                   atol=1e-6 * np.abs(x_np).max())
    else:
        np.testing.assert_array_equal(spl[0].numpy(), want_spl[0])


@needs_reference
@pytest.mark.parametrize("local_sort", ["torch", "kernel"])
def test_sampled_pivot_balances_best(reference, mesh, local_sort):
    """The reference test's property (paper Table 3), on the port."""
    x = torch.from_numpy(reference["normal4096/x"])
    imb = {p: distributed_sort(x, mesh, pivot=p, force_parallel=True,
                               local_sort=local_sort)[1].imbalance
           for p in PIVOT_STRATEGIES}
    assert imb["sampled"] <= min(imb["left"], imb["right"],
                                 imb["random"]) + 1e-6
    assert imb["left"] > 1.5 or imb["right"] > 1.5


def test_bucket_of_odd_length_through_the_kernel_wrapper(mesh):
    """The received bucket (chips x n_local = 8 x 125 = 1000, +inf padded)
    is not a power of 2: the wrapper's own padding would turn +inf into
    the dtype's maximum.  The output and the counts stay exact."""
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        1000).astype(np.float32))
    for pivot in PIVOT_STRATEGIES:
        got, rep = distributed_sort(x, mesh, pivot=pivot,
                                    force_parallel=True, local_sort="kernel")
        _, want = distributed_sort(x, mesh, pivot=pivot, force_parallel=True)
        assert torch.equal(got, torch.sort(x).values), pivot
        assert torch.equal(rep.counts, want.counts), pivot
        assert int(rep.counts.sum()) == 1000


def test_sample_sort_rejects_integers_and_foreign_meshes(mesh):
    with pytest.raises(TypeError, match="floating"):
        distributed_sort(torch.arange(64, dtype=torch.int32), mesh,
                         force_parallel=True)
    with pytest.raises(TypeError, match="Mesh"):
        distributed_sort(torch.ones(8), mesh=object())


def test_decision_and_ledger_at_eight_chips(mesh):
    """Without force_parallel the engine decides at chips = 8 (a small n
    stays serial, as in the reference's example); ``measure=True`` adds the
    measured time to that row."""
    eng = CostEngine(hw=HardwareSpec.from_dict(H100.to_dict()))
    x = torch.arange(100.0).flip(0)
    got, rep = distributed_sort(x, mesh, engine=eng, measure=True)
    assert rep.strategy == "serial" and rep.chips == CHIPS
    assert torch.equal(got, torch.arange(100.0))
    got, rep = distributed_sort(torch.flip(torch.arange(4096.0), [0]), mesh,
                                engine=eng, measure=True,
                                force_parallel=True)
    assert rep.strategy == "sample_sort"
    rows = [e for e in eng.ledger.entries if e.site == "sort"]
    assert len(rows) == 4 and all(r.query["chips"] == CHIPS for r in rows)
    measured = [r for r in rows if r.measured_s is not None]
    assert len(measured) == 2  # the decision rows; force_parallel ran
    assert all(r.measured_s > 0 for r in measured)


@needs_reference
def test_decision_priced_as_the_reference(mesh):
    """The ledger rows of a serial decision at chips = 8 equal the
    reference's (which reads only the mesh's shape to decide)."""
    import types

    import jax.numpy as jnp
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.core.sort import distributed_sort as j_distributed_sort
    from repro.hw import HardwareSpec as JSpec

    fields = H100.to_dict()
    jeng = JCostEngine(hw=JSpec.from_dict(fields))
    eng = CostEngine(hw=HardwareSpec.from_dict(fields))
    jmesh = types.SimpleNamespace(shape={"data": CHIPS})
    for n in (100, 2000):
        x = np.arange(n, dtype=np.float32)[::-1].copy()
        _, jrep = j_distributed_sort(jnp.asarray(x), jmesh, engine=jeng)
        _, rep = distributed_sort(torch.from_numpy(x), mesh, engine=eng)
        assert rep.strategy == jrep.strategy == "serial"
    rows, jrows = eng.ledger.entries, jeng.ledger.entries
    assert [r.choice for r in rows] == [r.choice for r in jrows]
    for r, w in zip(rows, jrows):
        assert r.query["chips"] == w.query["chips"] == CHIPS
        assert r.predicted_s == pytest.approx(w.predicted_s, rel=1e-9)
    for n in (1 << 20, 1 << 26):
        want = jeng.decide_sort(n, chips=CHIPS, dtype_bytes=4)
        got = eng.decide_sort(n, chips=CHIPS, dtype_bytes=4)
        assert got.choice == want.choice
        assert got.predicted.total == pytest.approx(want.predicted.total,
                                                    rel=1e-9)


def test_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_distributed_sort", REPO / "examples" /
        "torch_distributed_sort.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--n", "4000"])
    out = capsys.readouterr().out
    for pivot in PIVOT_STRATEGIES:
        assert f"{pivot:>10s}     True" in out
    assert "n=100 -> serial" in out


@pytest.mark.cuda
def test_sample_sort_on_eight_shards_of_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_sample_sort.py`")
    from repro_torch.kernels.bitonic_sort import LAUNCHES

    mesh = make_mesh({"data": CHIPS}, shards_per_device=CHIPS)
    assert len(set(mesh.streams)) == CHIPS
    g = torch.Generator(device="cuda").manual_seed(0)
    normal = torch.randn(1 << 20, generator=g, device="cuda") * 1e4
    skewed = torch.cat([torch.exp(torch.randn(30001, generator=g,
                                              device="cuda")),
                        torch.zeros(1370, device="cuda"),
                        torch.full((5000,), 3.3, device="cuda")])
    for x in (normal, skewed):
        want = torch.sort(x).values
        for pivot in PIVOT_STRATEGIES:
            before = LAUNCHES.count
            got, rep = distributed_sort(x, mesh, pivot=pivot,
                                        force_parallel=True,
                                        local_sort="kernel")
            assert LAUNCHES.count - before == 2 * CHIPS
            assert got.is_cuda and torch.equal(got, want), pivot
            assert int(rep.counts.sum()) == x.numel()
