"""The port's sort domain against the reference, on the same numpy inputs.

* ``repro_torch.kernels.ops.sort`` (on CPU tensors: the bitonic network's
  plain version, ``kernels/ref.py::bitonic_sort_ref``) against the
  reference's Pallas kernel (``repro.kernels.ops.sort``, interpret mode):
  exactly equal, as a sort must be;
* ``repro_torch.core.distributed_sort`` against ``repro.core.
  distributed_sort``: the same output, report and ledger rows, with the
  port's ``local_sort`` ``"torch"``/``"kernel"`` standing for the
  reference's ``"xla"``/``"pallas"``;
* on a CUDA card (marked ``cuda``; skipped elsewhere), the kernel
  (``csrc/bitonic_sort.cu``) exactly equal to its plain version and to
  ``torch.sort``.
"""

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro_torch.core import distributed_sort  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.bitonic_sort import (  # noqa: E402
    LAUNCHES,
    TILE,
    bitonic_sort_cuda,
    grid_launches,
)

try:  # the reference; a card machine without jax runs only the cuda test
    import jax.numpy as jnp
    from repro.core import distributed_sort as j_distributed_sort
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.hw import V5E
    from repro.hw import HardwareSpec as JSpec
    from repro.kernels import ops as jops
except ImportError:
    jops = None

needs_reference = pytest.mark.skipif(
    jops is None, reason="needs jax and the reference package")


def _both(x: np.ndarray):
    """(reference ops.sort in interpret mode, port ops.sort on the CPU)."""
    want = np.asarray(jops.sort(jnp.asarray(x), interpret=True))
    launches = LAUNCHES.count
    got = ops.sort(torch.from_numpy(x))
    assert LAUNCHES.count == launches  # CPU tensors never launch the kernel
    return want, got.numpy()


@needs_reference
@pytest.mark.parametrize("n", [8, 64, 100, 128, 257, 1024])
def test_sort_matches_reference_kernel(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32)
    want, got = _both(x)
    assert got.shape == (n,) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


@needs_reference
@pytest.mark.parametrize("rows", [1, 2, 8, 16])
def test_sort_rows_match_reference_kernel(rows):
    x = np.random.default_rng(rows).standard_normal((rows, 64)).astype(
        np.float32)
    want, got = _both(x)
    assert got.shape == (rows, 64)
    np.testing.assert_array_equal(got, want)


@needs_reference
def test_sort_int32_matches_reference_kernel():
    x = np.random.default_rng(7).integers(-1000, 1000, 100).astype(np.int32)
    want, got = _both(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.sort(x))


@needs_reference
def test_sort_duplicates_and_presorted():
    dup = np.asarray([3.0, 3.0, 1.0, 1.0, 2.0, 2.0, 0.0, 0.0], np.float32)
    want, got = _both(dup)
    np.testing.assert_array_equal(got, want)
    ramp = np.arange(32, dtype=np.float32)
    want, got = _both(ramp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ramp)


@needs_reference
@given(st.lists(st.floats(min_value=-1e6, max_value=1e6, allow_nan=False,
                          allow_subnormal=False, width=32),
                min_size=1, max_size=200))
@settings(max_examples=25, deadline=None)
def test_sort_property_matches_reference(values):
    want, got = _both(np.asarray(values, np.float32))
    np.testing.assert_array_equal(got, want)


@needs_reference
def test_sort_npad_matches_reference():
    for n in range(1, 2049):
        assert ops._sort_npad(n) == jops._sort_npad(n), n


@needs_reference
def test_inf_sorts_after_the_padding_as_in_the_reference():
    """Padding uses the dtype's largest finite value, so with n not a power
    of 2 an input +inf sorts after the pad and is stripped: the output holds
    finfo.max in its place.  The contract is finite input; the port keeps
    the reference's behaviour."""
    x = np.asarray([np.inf, 1.0, -2.0], np.float32)
    want, got = _both(x)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, [-2.0, 1.0, np.finfo(np.float32).max])
    pow2 = np.asarray([np.inf, 1.0, -2.0, 0.5, 3.0, 0.0, 9.0, -1.0],
                      np.float32)  # n_pad == n: no pad, +inf survives
    want, got = _both(pow2)
    np.testing.assert_array_equal(got, want)
    assert got[-1] == np.inf


@pytest.mark.parametrize("shape,dtype", [
    ((1, 2), torch.float32), ((3, 64), torch.float32),
    ((2, 1024), torch.int32), ((5, 256), torch.float64)])
def test_bitonic_network_equals_sort_ref(shape, dtype):
    g = torch.Generator().manual_seed(shape[1])
    x = (torch.randn(shape, generator=g) * 100).to(dtype)
    assert torch.equal(ref.bitonic_sort_ref(x), ref.sort_ref(x))


def _flat_network(x: torch.Tensor) -> torch.Tensor:
    """The network as the kernel indexes it: on the flattened (rows, n)
    array, pair q of stage (k, j) joins element p = 2q - (q & (j - 1)) and
    p + j, in the direction of p's index within its row, p & (n - 1)."""
    rows, n = x.shape
    x = x.reshape(-1).clone()
    q = torch.arange(x.numel() // 2)
    k = 2
    while k <= n:
        j = k // 2
        while j >= 1:
            p = 2 * q - (q & (j - 1))
            a, b = x[p], x[p + j]
            up = ((p & (n - 1)) & k) == 0
            lo, hi = torch.where(b < a, b, a), torch.where(b < a, a, b)
            x[p], x[p + j] = torch.where(up, lo, hi), torch.where(up, hi, lo)
            j //= 2
        k *= 2
    return x.reshape(rows, n)


@pytest.mark.parametrize("rows,n", [(3, 1024), (1, 64), (4, 8)])
def test_kernel_index_arithmetic(rows, n):
    """The kernel's pair indexing and its row-relative direction bit, over
    several rows in one flat array, give the network's result."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn((rows, n), generator=g)
    assert torch.equal(_flat_network(x), ref.sort_ref(x))


def test_grid_launches_follow_the_tile_split():
    assert TILE == 4096
    assert grid_launches(8) == grid_launches(TILE) == 1
    assert grid_launches(2 * TILE) == 3  # tiles, one global j, finish
    assert grid_launches(1 << 26) == 120


def test_cuda_wrapper_refuses_cpu_tensors():
    """A CPU tensor never reaches the kernel's wrapper by mistake: it
    raises instead of running the plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_sort_cuda(torch.ones((2, 8)))


def _engines(fields):
    return (JCostEngine(hw=JSpec.from_dict(fields)),
            CostEngine(hw=HardwareSpec.from_dict(fields)))


@needs_reference
@pytest.mark.parametrize("spec", ["v5e", "h100"])
@pytest.mark.parametrize("local_sort,j_local_sort", [("torch", "xla"),
                                                      ("kernel", "pallas")])
def test_distributed_sort_matches_reference(local_sort, j_local_sort, spec):
    x = np.random.default_rng(300).standard_normal(300).astype(np.float32)
    jeng, eng = _engines((V5E if spec == "v5e" else H100).to_dict())
    want, jrep = j_distributed_sort(jnp.asarray(x), engine=jeng,
                                    local_sort=j_local_sort)
    got, rep = distributed_sort(torch.from_numpy(x), engine=eng,
                                local_sort=local_sort)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (rep.strategy, rep.pivot, rep.n, rep.chips) == (
        jrep.strategy, jrep.pivot, jrep.n, jrep.chips) == (
        "serial", "sampled", 300, 1)
    assert rep.counts is None and rep.imbalance == jrep.imbalance == 1.0
    (row,), (jrow,) = eng.ledger.entries, jeng.ledger.entries
    assert row.site == jrow.site == "sort"
    assert row.choice == jrow.choice == "serial"
    assert row.predicted_s == pytest.approx(jrow.predicted_s, rel=1e-9)
    assert row.measured_s is None


@needs_reference
def test_distributed_sort_measure_attaches_the_time():
    x = np.random.default_rng(5).standard_normal(2000).astype(np.float32)
    jeng, eng = _engines(H100.to_dict())
    j_distributed_sort(jnp.asarray(x), engine=jeng, measure=True,
                       local_sort="pallas")
    got, _ = distributed_sort(torch.from_numpy(x), engine=eng, measure=True,
                              local_sort="kernel")
    np.testing.assert_array_equal(got.numpy(), np.sort(x))
    rows, jrows = eng.ledger.entries, jeng.ledger.entries
    assert [e.site for e in rows] == [e.site for e in jrows] == ["sort"] * 2
    assert rows[1].measured_s is not None and rows[1].measured_s > 0
    assert rows[1].predicted_s == pytest.approx(jrows[1].predicted_s,
                                                rel=1e-9)


def test_distributed_sort_mesh_and_unknown_local_sort_raise():
    x = torch.ones(8)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        distributed_sort(x, mesh=object())
    with pytest.raises(ValueError, match="local_sort"):
        distributed_sort(x, local_sort="pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_sort.py`")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape in ((4, 4096), (1 << 20,), (8, 100)):
        x = torch.randn(shape, generator=gen, device="cuda") * 1000
        x = x.to(dtype)
        padded = ops._sort_pad(x.view(-1, shape[-1]))
        calls, grids = LAUNCHES.count, LAUNCHES.grids
        got = bitonic_sort_cuda(padded)
        assert LAUNCHES.count == calls + 1
        assert LAUNCHES.grids == grids + grid_launches(padded.shape[1])
        assert torch.equal(got, ref.bitonic_sort_ref(padded)), shape
        assert torch.equal(got, ref.sort_ref(padded)), shape
        assert torch.equal(ops.sort(x), ref.sort_ref(x)), shape
    with pytest.raises(ValueError, match="CUDA"):
        bitonic_sort_cuda(torch.ones((2, 8), dtype=dtype))
