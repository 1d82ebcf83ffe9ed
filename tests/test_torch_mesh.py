"""The port's device mesh, its collectives, the Runtime's mesh and the
planner over a mesh.

* ``make_mesh``: positions share a device only when asked
  (``shards_per_device``), a shape needing more devices than exist
  raises, coordinates and groups are row-major as in a jax mesh;
* the collectives on a 2 x 4 CPU mesh, over each axis, against their
  definitions (``lax.all_gather`` not tiled, ``lax.all_to_all`` split and
  joined on axis 0 tiled, ``lax.psum``, ``lax.ppermute`` with zeros where
  nothing arrives, ``lax.axis_index``), outputs never aliasing inputs;
  ``shard`` / ``unshard`` / ``replicate`` / ``take`` round trips;
* ``launch.mesh``: ``make_dev_mesh`` and ``data_axes_of``;
* ``Runtime.mesh_shape`` / ``Runtime.mesh`` (``RuntimeConfig.mesh_shape``):
  the default shape, and a shape that needs more devices than exist
  raising, as the reference's serve path does;
* ``plan_model`` against the reference's for every configuration at
  meshes {"data": 8, "model": 1}, {"data": 2, "model": 4} and
  {"data": 16, "model": 16}, at a train and a decode shape, on the same
  hardware spec: the same decisions, seconds (rtol 1e-9), overrides (the
  port's tuples of axis names) and HBM verdict;
* on a CUDA card (marked ``cuda``): eight positions on one GPU, one
  stream each; tensors made on one position's stream and read through
  every collective on the others' come out right even when the writer's
  memory is freed and reused at once (the fences and ``record_stream``).
"""

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.configs import SHAPES, ShapeSpec, get_config  # noqa: E402
from repro_torch.configs import list_configs  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.planner import plan_model  # noqa: E402
from repro_torch.distributed import (  # noqa: E402
    Mesh,
    all_gather,
    all_to_all,
    axis_index,
    make_mesh,
    ppermute,
    psum,
    replicate,
    shard,
    take,
    unshard,
)
from repro_torch.hw import H100, HardwareSpec  # noqa: E402
from repro_torch.launch.mesh import data_axes_of, make_dev_mesh  # noqa: E402

from torch_mesh_reference import needs_reference  # noqa: E402

PLAN_MESHES = [{"data": 8, "model": 1}, {"data": 2, "model": 4},
               {"data": 16, "model": 16}]
PLAN_SHAPES = [SHAPES["train_4k"], SHAPES["decode_32k"]]


@pytest.fixture(scope="module")
def mesh24():
    return make_mesh({"data": 2, "model": 4}, device="cpu",
                     shards_per_device=8)


def _inputs(mesh, shape=(8, 3)):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(shape, generator=g) for _ in range(mesh.size)]


def test_make_mesh_shares_a_device_only_when_asked():
    with pytest.raises(ValueError, match="needs 8 cpu device"):
        make_mesh({"data": 8}, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        make_mesh({"data": 8}, device="cpu", shards_per_device=3)
    one = make_mesh({"data": 1}, device="cpu")
    assert one.size == 1 and one.devices == (torch.device("cpu"),)
    m = make_mesh({"data": 8}, device="cpu", shards_per_device=8)
    assert m.devices == (torch.device("cpu"),) * 8
    assert m.streams == (None,) * 8
    with pytest.raises(ValueError, match="positions"):
        Mesh({"data": 2}, [torch.device("cpu")])
    with pytest.raises(ValueError, match="no axis"):
        m.groups("model")


def test_coordinates_and_groups_are_row_major(mesh24):
    assert mesh24.shape == {"data": 2, "model": 4}
    assert [mesh24.coords(i) for i in (0, 3, 4, 7)] == \
        [(0, 0), (0, 3), (1, 0), (1, 3)]
    assert mesh24.groups("model") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert mesh24.groups("data") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert axis_index(mesh24, "model") == [0, 1, 2, 3, 0, 1, 2, 3]
    assert axis_index(mesh24, "data") == [0, 0, 0, 0, 1, 1, 1, 1]


@pytest.mark.parametrize("axis", ["data", "model"])
def test_all_gather_and_psum_match_their_definitions(mesh24, axis):
    xs = _inputs(mesh24)
    gathered = all_gather(mesh24, axis, xs)
    summed = psum(mesh24, axis, xs)
    for group in mesh24.groups(axis):
        want_g = torch.stack([xs[i] for i in group])
        want_s = xs[group[0]].clone()
        for i in group[1:]:
            want_s += xs[i]
        for j in group:
            assert torch.equal(gathered[j], want_g)
            assert torch.equal(summed[j], want_s)
            assert summed[j].data_ptr() != xs[j].data_ptr()
    assert len({summed[j].data_ptr() for j in range(8)}) == 8


@pytest.mark.parametrize("axis", ["data", "model"])
def test_all_to_all_matches_its_definition(mesh24, axis):
    n = mesh24.shape[axis]
    xs = _inputs(mesh24, (n * 3, 5))
    got = all_to_all(mesh24, axis, xs)
    for group in mesh24.groups(axis):
        for r, j in enumerate(group):
            want = torch.cat([xs[i][r * 3:(r + 1) * 3] for i in group])
            assert torch.equal(got[j], want)
    with pytest.raises(ValueError, match="blocks"):
        all_to_all(mesh24, axis, _inputs(mesh24, (n * 3 + 1, 5)))


@pytest.mark.parametrize("axis", ["data", "model"])
def test_ppermute_matches_its_definition(mesh24, axis):
    n = mesh24.shape[axis]
    xs = _inputs(mesh24)
    shift = [(i, (i + 1) % n) for i in range(n)]
    partial = [(0, n - 1)]
    for perm in (shift, partial):
        got = ppermute(mesh24, axis, xs, perm)
        sender = {d: s for s, d in perm}
        for group in mesh24.groups(axis):
            for r, j in enumerate(group):
                if r in sender:
                    assert torch.equal(got[j], xs[group[sender[r]]])
                    assert got[j].data_ptr() != xs[group[sender[r]]].data_ptr()
                else:
                    assert torch.equal(got[j], torch.zeros_like(xs[j]))
    with pytest.raises(ValueError, match="permutation"):
        ppermute(mesh24, axis, xs, [(0, 1), (1, 1)])


def test_shard_unshard_replicate_take(mesh24):
    x = torch.arange(48.0).reshape(4, 12)
    for axis, dim in (("model", 0), ("model", 1), ("data", 1)):
        pieces = shard(mesh24, axis, x, dim)
        n = mesh24.shape[axis]
        for i, p in enumerate(pieces):
            r = mesh24.axis_index(axis, i)
            assert torch.equal(p, x.chunk(n, dim)[r]) and p.is_contiguous()
        assert torch.equal(unshard(mesh24, axis, pieces, dim), x)
    with pytest.raises(ValueError, match="split"):
        shard(mesh24, "model", torch.ones(6), 0)
    reps = replicate(mesh24, x)
    assert all(torch.equal(r, x) for r in reps)
    assert torch.equal(take(mesh24, reps, 5), x)


def test_dev_mesh_and_data_axes():
    m = make_dev_mesh(4, 2, device="cpu", shards_per_device=8)
    assert m.shape == {"data": 4, "model": 2}
    assert data_axes_of(m) == ("data",)
    pod = Mesh({"pod": 2, "data": 2, "model": 2}, ["cpu"] * 8)
    assert data_axes_of(pod) == ("pod", "data")
    with pytest.raises(ValueError, match="needs"):
        make_dev_mesh(2, device="cpu")


def test_runtime_mesh_shape_and_mesh():
    rt = repro_torch.Runtime(device="cpu")
    assert rt.mesh_shape() == {"data": 1, "model": 1}
    assert rt.mesh.shape == {"data": 1, "model": 1} and rt.mesh is rt.mesh
    assert rt.mesh.devices == (torch.device("cpu"),)
    cfg = repro_torch.RuntimeConfig(mesh_shape={"data": 2, "model": 4})
    rt = repro_torch.Runtime(cfg, device="cpu")
    assert rt.mesh_shape() == {"data": 2, "model": 4}
    # the plan takes the configured shape; the mesh needs 8 devices
    plan = rt.plan(get_config("tinyllama-1.1b"), SHAPES["train_4k"])
    want = plan_model(get_config("tinyllama-1.1b"), SHAPES["train_4k"],
                      {"data": 2, "model": 4})
    assert [(d.site, d.choice) for d in plan.decisions] == \
        [(d.site, d.choice) for d in want.decisions]
    with pytest.raises(ValueError, match="needs 8 cpu device"):
        rt.mesh


@needs_reference
@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=lambda s: s.name)
@pytest.mark.parametrize("mesh_shape", PLAN_MESHES,
                         ids=lambda m: "x".join(map(str, m.values())))
@pytest.mark.parametrize("arch", list_configs())
def test_plan_over_a_mesh_matches_reference(arch, mesh_shape, shape):
    from repro.configs import get_config as j_get_config
    from repro.configs.base import ShapeSpec as JShapeSpec
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.core.planner import plan_model as j_plan_model
    from repro.hw import HardwareSpec as JSpec

    fields = H100.to_dict()
    want = j_plan_model(j_get_config(arch), JShapeSpec(*vars(shape).values()),
                        mesh_shape,
                        engine=JCostEngine(hw=JSpec.from_dict(fields)))
    eng = CostEngine(hw=HardwareSpec.from_dict(fields))
    got = plan_model(get_config(arch), ShapeSpec(*vars(shape).values()),
                     mesh_shape, engine=eng)
    assert [(d.site, d.choice, d.reason) for d in got.decisions] == \
        [(d.site, d.choice, d.reason) for d in want.decisions]
    for g, w in zip(got.decisions, want.decisions):
        assert g.tp_cost == pytest.approx(w.tp_cost, rel=1e-9)
        assert g.rep_cost == pytest.approx(w.rep_cost, rel=1e-9)
    assert got.overrides == {k: tuple(v) for k, v in want.overrides.items()}
    assert (got.rnn_chunk, got.attn_chunk, got.fits_hbm) == \
        (want.rnn_chunk, want.attn_chunk, want.fits_hbm)
    assert got.hbm_per_chip == pytest.approx(want.hbm_per_chip, rel=1e-12)


@pytest.mark.cuda
def test_collectives_fence_the_streams_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_mesh.py`")
    mesh = make_mesh({"data": 2, "model": 4}, shards_per_device=8)
    assert len(set(mesh.streams)) == 8
    n = 1 << 22
    for _ in range(3):
        # each position's tensor is made on its own stream, behind a long
        # product, then read by the collectives on the others' streams
        xs = []
        for i in range(8):
            with mesh.on(i):
                w = torch.randn(2048, 2048, device="cuda")
                w = w @ w  # keeps the stream busy
                xs.append(torch.full((n,), float(i), device="cuda")
                          + 0 * w[0, 0])
        sums = psum(mesh, "model", xs)
        moved = all_to_all(mesh, "model", xs)
        hops = ppermute(mesh, "model", xs, [(0, 1), (1, 2), (2, 3), (3, 0)])
        del xs  # the writers' memory goes back to the allocator at once
        for i in range(8):
            with mesh.on(i):
                torch.full((n,), -1.0, device="cuda")  # may reuse it
        torch.cuda.synchronize()
        for group in mesh.groups("model"):
            total = float(sum(group))
            for r, j in enumerate(group):
                assert bool((sums[j] == total).all())
                want = torch.cat([torch.full((n // 4,), float(i))
                                  for i in group])
                assert torch.equal(moved[j].cpu(), want)
                src = group[(r - 1) % 4]
                assert bool((hops[j] == float(src)).all())
