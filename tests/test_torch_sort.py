"""The port's sort domain against the reference, on the same numpy inputs.

* ``repro_torch.kernels.ops.sort`` (on CPU tensors: the bitonic network's
  plain version, ``kernels/ref.py::bitonic_sort_ref``) against the
  reference's Pallas kernel (``repro.kernels.ops.sort``, interpret mode):
  exactly equal, as a sort must be;
* ``repro_torch.core.distributed_sort`` against ``repro.core.
  distributed_sort``: the same output, report and ledger rows, with the
  port's ``local_sort`` ``"torch"``/``"kernel"`` standing for the
  reference's ``"xla"``/``"pallas"``;
* the kernel's schedule (``bitonic_sort.passes``) emulated in plain torch
  with each pass kind's index arithmetic (block passes: the tile, its
  padded shared-memory words, each thread's register window and the
  exchanges between windows; global passes: each thread's register group),
  at small tiles and windows, equal to the network bit for bit;
* on a CUDA card (marked ``cuda``; skipped elsewhere), the kernel
  (``csrc/bitonic_sort.cu``) exactly equal to its plain version and to
  ``torch.sort``, and bit for bit to its plain version on hard inputs.
"""

import itertools
from pathlib import Path

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
    LOG_E,
    LOG_GROUP,
    TILE,
    bitonic_sort_cuda,
    grid_launches,
    passes,
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


def test_grid_launches_follow_the_tile_split():
    """One launch a pass: the first block pass, then for each k > TILE the
    groups of up to LOG_GROUP global stages and one finishing block
    pass."""
    assert (TILE, LOG_E, LOG_GROUP) == (1 << 14, 5, 6)
    assert grid_launches(8) == grid_launches(TILE) == 1
    assert grid_launches(2 * TILE) == 3  # first, one global group, finish
    assert [grid_launches(1 << s) for s in (17, 20, 24, 26)] == [7, 13, 25,
                                                                 31]


def _network(n):
    return [(k, j) for k in (1 << a for a in range(1, n.bit_length()))
            for j in (1 << b for b in range(k.bit_length() - 2, -1, -1))]


@pytest.mark.parametrize("tile,group", [(TILE, LOG_GROUP), (64, 2), (32, 5)])
@pytest.mark.parametrize("n", [2, 8, 32, 1 << 10, 1 << 14, 1 << 15, 1 << 21,
                               1 << 26])
def test_passes_concatenate_to_the_network(n, tile, group):
    got = passes(n, tile, group)
    assert [st for _, sts in got for st in sts] == _network(n)
    assert got[0][0] == "block"
    for kind, sts in got:
        (k,) = {k for k, _ in sts} if kind == "global" else (sts[0][0],)
        if kind == "global":  # up to group consecutive stages j >= tile
            assert 1 <= len(sts) <= group and sts[-1][1] >= tile
            assert [j for _, j in sts] == [sts[0][1] >> i
                                           for i in range(len(sts))]
        elif k > tile:  # a finishing pass: every j < tile of its k
            assert sts == [(k, tile >> i) for i in range(1, tile.bit_length())]


def _pad(e):
    """Shared-memory word of tile element e (``pad`` in the source): one
    word of padding after every 32."""
    return e + (e >> 5)


def _block_tile(rows, n, tile, log_e):
    """The launcher's tile: ``tile``, or T / n whole rows where n < T (all
    the rows there are, rounded up to a power of 2), at least 2^log_e."""
    if n >= tile:
        return tile
    r = 1
    while r < rows and r * n < tile:
        r *= 2
    return max(r * n, 1 << log_e)


def _order(a, b, up):
    """``order``: each element by its own comparison with its partner."""
    return torch.where((b < a) == up, b, a), torch.where((a < b) == up, b, a)


def _register_stages(r, stages, lo, up, reg_k):
    """``register_stages``: the stages on r (..., threads, E), register i
    holding element base + (i << lo); a pair ascends where ``up`` (per
    thread) and (i & reg_k) == 0."""
    e = r.shape[-1]
    i = torch.arange(e)
    for _, j in stages:
        s = j.bit_length() - 1 - lo
        assert 0 <= s and 1 << s < e  # the stage's bit lies in the window
        low = i[(i & (1 << s)) == 0]
        asc = up[..., None] & ((low & reg_k) == 0)
        r[..., low], r[..., low | (1 << s)] = _order(
            r[..., low], r[..., low | (1 << s)], asc)


def _block_pass(x, rows, n, stages, tile, log_e):
    """``first_block_pass`` / ``finish_block_pass`` on the flat array x:
    each tile filled into padded shared memory, the stages run window by
    window in registers with an exchange where the window moves, then
    drained.  Returns the number of windows loaded a tile."""
    e_count = 1 << log_e
    tile = _block_tile(rows, n, tile, log_e)
    total = x.numel()
    tiles = -(-total // tile)
    buf = torch.zeros(tiles * tile, dtype=x.dtype)  # beyond the last row
    buf[:total] = x
    words = _pad(torch.arange(tile))
    smem = torch.empty((tiles, _pad(tile)), dtype=x.dtype)
    smem[:, words] = buf.view(tiles, tile)
    t, i = torch.arange(tile // e_count), torch.arange(e_count)
    tb = (torch.arange(tiles) * tile) & (n - 1)
    cur, loads, r, at = None, 0, None, None
    for k, group in itertools.groupby(stages, key=lambda st: st[0]):
        group = list(group)
        kk = 0 if k == n else k
        h = group[0][1].bit_length() - 1  # the top j bit
        assert h == min(k, tile).bit_length() - 2
        while h >= 0:
            lo = max(h - (log_e - 1), 0)
            run = [st for st in group if st[1] >= 1 << lo]
            group = group[len(run):]
            assert [j for _, j in run] == [1 << b for b in range(h, lo - 1,
                                                                 -1)]
            tbase = (t & ((1 << lo) - 1)) | ((t >> lo) << (lo + log_e))
            if lo != cur:
                if cur is not None:
                    smem[:, at] = r
                at = _pad(tbase)[:, None] + _pad(i << lo)  # pad(tbase | i<<lo)
                r, cur, loads = smem[:, at], lo, loads + 1
            up = ((tb[:, None] | tbase[None, :]) & kk) == 0
            _register_stages(r, run, lo, up, (kk >> lo) & (e_count - 1))
            h = lo - 1
        assert not group
    smem[:, at] = r
    x.copy_(smem[:, words].reshape(-1)[:total])
    return loads


def _global_pass(x, n, stages, log_g):
    """``global_pass``: thread q holds the 2^log_g elements p + (i << lo),
    window [lo, top], and runs the group's stages from the top."""
    (k,) = {k for k, _ in stages}
    kk = 0 if k == n else k
    top = stages[0][1].bit_length() - 1
    lo = top - (log_g - 1)
    q = torch.arange(x.numel() >> log_g)
    p = (q & ((1 << lo) - 1)) | ((q >> lo) << (lo + log_g))
    at = p[:, None] + (torch.arange(1 << log_g) << lo)
    r = x[at]
    _register_stages(r, stages, lo, (p & kk) == 0, 0)
    x[at] = r


def _emulate(x, tile, log_e, log_g):
    """The kernel's schedule on (rows, n), pass by pass, block passes with
    2^log_e registers a thread, global ones with 2^log_g; also the windows
    each block pass loaded a tile."""
    rows, n = x.shape
    flat = x.reshape(-1).clone()
    windows = []
    for kind, stages in passes(n, tile, log_g):
        if kind == "block":
            windows.append(_block_pass(flat, rows, n, stages, tile, log_e))
        else:
            _global_pass(flat, n, stages, log_g)
    return flat.reshape(rows, n), windows


def _hard(rows, n, dtype, seed):
    """Values the network must order as the plain version does, bit for
    bit: duplicates, -0.0 beside +0.0, +-inf and NaN (float32), the int32
    extremes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(-4, 5, (rows, n), generator=g)
    if dtype == torch.int32:
        ends = torch.tensor([-2**31, 2**31 - 1], dtype=torch.int32)
        x = x.to(torch.int32)
        pick = torch.randint(0, 8, (rows, n), generator=g)
        return torch.where(pick < 2, ends[pick.clamp(max=1)], x)
    x = x.to(torch.float32)
    x = torch.where(x == 0, torch.where(torch.rand((rows, n), generator=g)
                                        < 0.5, -0.0, 0.0), x)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"),
                            -float("nan")])
    pick = torch.randint(0, 16, (rows, n), generator=g)
    return torch.where(pick < 4, special[pick.clamp(max=3)], x)


def _bits(x):
    return x.view(torch.int32)


@pytest.mark.parametrize("tile,log_e,log_g,rows,n", [
    (64, 2, 2, 1, 32), (64, 2, 2, 3, 16), (64, 2, 2, 5, 2),
    (64, 2, 2, 1, 64), (64, 2, 2, 2, 128), (64, 2, 2, 1, 512),
    (64, 2, 3, 3, 1024), (128, 3, 3, 1, 1 << 14), (128, 3, 4, 7, 32),
    (32, 5, 5, 3, 8), (32, 5, 5, 2, 256),
    (TILE, LOG_E, LOG_GROUP, 3, 1 << 12),
    (TILE, LOG_E, LOG_GROUP, 1, 1 << 17)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_emulated_schedule_is_the_network(tile, log_e, log_g, rows, n,
                                          dtype):
    """The schedule with each pass kind's index arithmetic equals the plain
    network bit for bit: n across the tile boundary (512 at (64, 2, 2),
    1024 at (64, 2, 3) and 2^14 at (128, 3, 3) have a k whose global
    stages end in a short group after a full one), several rows to a tile,
    several tiles to a row."""
    x = _hard(rows, n, dtype, n + rows)
    got, _ = _emulate(x, tile, log_e, log_g)
    assert torch.equal(_bits(got), _bits(ref.bitonic_sort_ref(x)))


@pytest.mark.parametrize("rows,n", [(3, 1024), (1, 64), (4, 8)])
def test_kernel_index_arithmetic(rows, n):
    """The kernel's own index arithmetic, at its tile and register counts,
    over several rows in one flat array, gives the network's result."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn((rows, n), generator=g)
    got, _ = _emulate(x, TILE, LOG_E, LOG_GROUP)
    assert torch.equal(got, ref.sort_ref(x))


def test_constants_match_the_source():
    """TILE, LOG_E and LOG_GROUP are the source's kTile, kLogE and its
    default SORT_LOG_GROUP, as the launcher computes the schedule."""
    src = (Path(ops.__file__).parents[1] / "csrc" /
           "bitonic_sort.cu").read_text()
    assert f"#define SORT_LOG_TILE {TILE.bit_length() - 1}\n" in src
    assert f"#define SORT_LOG_GROUP {LOG_GROUP}\n" in src
    assert f"constexpr int kLogE = {LOG_E};" in src


def test_emulated_windows_match_the_source_note():
    """A full first tile loads 23 register windows (all k <= 32 in one,
    two for k = 64 ... 1024, three above), a finishing pass three."""
    x = _hard(1, 2 * TILE, torch.float32, 3)
    got, windows = _emulate(x, TILE, LOG_E, LOG_GROUP)
    assert windows == [23, 3]
    assert torch.equal(_bits(got), _bits(ref.bitonic_sort_ref(x)))


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
    """What is not a mesh is refused (the sample sort over a real one:
    tests/test_torch_sample_sort.py), and so is an unknown local sort."""
    x = torch.ones(8)
    with pytest.raises(TypeError, match="Mesh"):
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


def _card_hard_inputs(dtype):
    """(name, (rows, n) CUDA tensor) of the card test: hard values, sorted
    and reversed rows, at n = 2, T/2, T, 2T, the first n with a k whose
    global stages end in a short group after a full one, several rows
    below and above the tile, and a view not 16-byte aligned."""
    short = TILE << (LOG_GROUP + 1)  # k = 2^21: 7 global stages, 6 + 1
    assert [len(st) for kind, st in passes(short)
            if kind == "global"][-2:] == [LOG_GROUP, 1]
    cases = []
    for rows, n in [(1, 2), (1, TILE // 2), (1, TILE), (1, 2 * TILE),
                    (1, short), (3, TILE // 4), (3, 2 * TILE)]:
        x = _hard(rows, n, dtype, n + rows).cuda()
        cases.append((f"hard ({rows}, {n})", x))
    ramp = torch.arange(1 << 16, device="cuda").to(dtype).view(1, -1)
    cases += [("sorted (1, 65536)", ramp), ("reversed (1, 65536)",
                                              ramp.flip(1).contiguous())]
    # a view 4 bytes past an allocation: the tile fill's element path
    buf = _hard(1, 2 * TILE + 1, dtype, 5).cuda().view(-1)
    cases.append(("misaligned (1, 2T)", buf[1:].view(1, -1)))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.int32])
def test_kernel_matches_plain_on_hard_inputs_on_card(dtype):
    """Bit for bit (compared as int32: -0.0 is not +0.0, NaN is itself) the
    plain network on the card, with one CUDA launch a pass; torch.sort
    beside them where every value is finite (its order of NaN and of -0.0
    and +0.0 is not the network's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_sort.py`")
    for name, x in _card_hard_inputs(dtype):
        grids = LAUNCHES.grids
        got = bitonic_sort_cuda(x)
        assert LAUNCHES.grids == grids + grid_launches(x.shape[1]), name
        assert torch.equal(_bits(got), _bits(ref.bitonic_sort_ref(x))), name
        if dtype == torch.int32 or torch.isfinite(x).all():
            assert torch.equal(got, torch.sort(x, dim=-1).values), name
