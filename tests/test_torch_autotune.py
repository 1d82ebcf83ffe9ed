"""The port's kernel autotuner against the reference's, and its Hopper
candidate spaces, on the CPU.

* the reference's nine tuner tests (tests/test_autotune.py) side by side:
  the reference's ``Autotuner`` and the port's get the same ``TuneSpec``
  and the same injected deterministic ``bench``; their configs, sources,
  trials, speedups, cache entries and ledger rows (site, config,
  predicted, measured, note) must be equal, and equal to what the
  reference's test asserts; plus a candidate that fails among ones that
  do not;
* per family: the prior is the kernel's fixed choice (``tile_n(n)``, the
  sort's (14, 6), WKV's chunk of 64); every candidate passes the
  shared-memory filter and its formula (and flash's tensor-core kernels,
  which have one instantiation and no family, fit); M is absent from the
  matmul's key (M = 1 and M = 4096 give one key), B and S from WKV's;
  ``fmt_config`` is stable;
* with no tuner in scope a kernel takes its fixed choice, reading no
  cache and building no Runtime (so a calibrating default Runtime, whose
  probes launch kernels, does not recurse);
* a default Runtime's tuner never measures and never writes the cache;
  ``RuntimeConfig.autotune`` and ``REPRO_AUTOTUNE``; two Runtimes keep
  their own tuners, in one thread and in two; ``Runtime.train`` runs its
  kernels under its own, and ``Runtime.serve`` under a watchdog hands
  it to the worker thread;
* ``chunk=None`` gives ``ops.wkv`` the chunk of 64 on the CPU;
* the ``cuda``-marked tests hold every candidate config's output against
  the plain version on a card, and skip elsewhere.
"""

import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.costs import autotune as pa  # noqa: E402
from repro_torch.core.costs.ledger import OverheadLedger  # noqa: E402
from repro_torch.kernels import bitonic_sort as bs  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops, ref, tuning  # noqa: E402
from repro_torch.kernels import wkv as wkv_k  # noqa: E402

try:  # the reference; a card machine without jax runs only the cuda tests
    from repro.core.costs import autotune as ra
    from repro.core.costs.ledger import OverheadLedger as RefLedger
except ImportError:
    ra = None

needs_reference = pytest.mark.skipif(
    ra is None, reason="needs jax and the reference package")
needs_card = pytest.mark.skipif(
    not torch.cuda.is_available(),
    reason="needs an NVIDIA GPU (CUDA); on a card run `python -m pytest "
           "--noconftest -m cuda tests/test_torch_autotune.py`")

FAKE_TIMES = {1: 3e-4, 2: 2e-4, 4: 1e-4}


@pytest.fixture(autouse=True)
def cpu_default_runtime(monkeypatch):
    """A tuner without a ledger records into the default Runtime's, which
    here must be on the CPU (without a card the default asks for one)."""
    import repro_torch
    from repro_torch import runtime as port_runtime

    monkeypatch.setattr(port_runtime, "_default_runtime",
                        repro_torch.Runtime(device="cpu"))


def _spec(mod, key="fam/k1", prior_b=1, cands=None):
    cands = tuple(mod.Candidate({"b": b}, prior_s=t, vmem_bytes=0)
                  for b, t in FAKE_TIMES.items()) if cands is None else cands
    return mod.TuneSpec("fam", key, {"b": prior_b}, cands,
                        make_runner=lambda cfg: (lambda: cfg),
                        query=(("shape", "k1"),))


def _fake_bench(runner, reps):
    return FAKE_TIMES[runner()["b"]]


def _boom_bench(runner, reps):
    raise AssertionError("bench must not run")


def _pair(tmp_path, **kw):
    """(reference tuner, port tuner) with the same arguments, each with a
    cache directory of its own."""
    return (ra.Autotuner(cache_dir=tmp_path / "ref", **kw),
            pa.Autotuner(cache_dir=tmp_path / "port", **kw))


def _fields(res):
    return (res.key, res.family, res.config, res.source, res.measured_s,
            res.prior_config, res.prior_predicted_s, res.prior_measured_s,
            res.trials, res.speedup_vs_prior)


def _rows(ledger):
    return [(e.site, e.choice, e.predicted_s, e.measured_s, e.note)
            for e in ledger.entries]


def _payload(tuner):
    return json.loads(tuner.cache_path.read_text())


def _both(tmp_path, scenario, **kw):
    """Run ``scenario(mod, tuner)`` on each side; the results' fields must
    be equal.  Returns the port's result."""
    rt, pt = _pair(tmp_path, **kw)
    want, got = scenario(ra, rt), scenario(pa, pt)
    assert _fields(got) == _fields(want)
    return got, rt, pt


# ---------------------------------------------------------------------------
# The reference's nine tuner tests, side by side
# ---------------------------------------------------------------------------


@needs_reference
def test_measured_tune_picks_fastest_and_persists(tmp_path):
    res, rt, pt = _both(tmp_path, lambda m, t: t.tune(_spec(m)),
                        measure=True, fingerprint="fp-a", bench=_fake_bench)
    assert res.source == "measured"
    assert res.config == {"b": 4}
    assert res.measured_s == FAKE_TIMES[4]
    assert res.prior_config == {"b": 1}
    assert res.prior_measured_s == FAKE_TIMES[1]
    assert res.speedup_vs_prior == pytest.approx(3.0)
    assert pt.cache_path.name == rt.cache_path.name == "autotune-fp-a.json"
    assert _payload(pt) == _payload(rt)
    assert _payload(pt)["entries"]["fam/k1"]["config"] == {"b": 4}


@needs_reference
def test_warm_cache_is_measurement_free(tmp_path):
    rt, pt = _pair(tmp_path, measure=True, fingerprint="fp-a",
                   bench=_fake_bench)
    rt.tune(_spec(ra))
    pt.tune(_spec(pa))
    warm = [mod.Autotuner(cache_dir=t.cache_dir, measure=True,
                          fingerprint="fp-a", bench=_boom_bench)
            for mod, t in ((ra, rt), (pa, pt))]
    want, got = (w.tune(_spec(mod)) for w, mod in zip(warm, (ra, pa)))
    assert _fields(got) == _fields(want)
    assert got.source == "cache" and got.config == {"b": 4}
    assert got.speedup_vs_prior == pytest.approx(3.0)
    assert warm[0].bench_calls == warm[1].bench_calls == 0


@needs_reference
def test_cache_misses_on_new_key_and_invalidates_on_fingerprint(tmp_path):
    rt, pt = _pair(tmp_path, measure=True, fingerprint="fp-a",
                   bench=_fake_bench)
    rt.tune(_spec(ra))
    pt.tune(_spec(pa))
    for fp, key in (("fp-a", "fam/k2"), ("fp-b", "fam/k1")):
        want, got = (mod.Autotuner(cache_dir=t.cache_dir, measure=False,
                                   fingerprint=fp, bench=_boom_bench)
                     .tune(_spec(mod, key=key))
                     for mod, t in ((ra, rt), (pa, pt)))
        assert _fields(got) == _fields(want)
        assert got.source == "prior"


@needs_reference
def test_cached_config_outside_candidate_space_is_rejected(tmp_path):
    rt, pt = _pair(tmp_path, measure=True, fingerprint="fp-a",
                   bench=_fake_bench)
    rt.tune(_spec(ra))
    pt.tune(_spec(pa))
    results = []
    for mod, t in ((ra, rt), (pa, pt)):
        spec = _spec(mod)
        shrunk = mod.TuneSpec(spec.family, spec.key, {"b": 1},
                              spec.candidates[:2],
                              make_runner=spec.make_runner)
        results.append(mod.Autotuner(
            cache_dir=t.cache_dir, measure=False, fingerprint="fp-a",
            bench=_boom_bench).tune(shrunk))
    want, got = results
    assert _fields(got) == _fields(want)
    assert got.source == "prior" and got.config == {"b": 1}


@needs_reference
def test_memoized_second_call_does_not_rebench(tmp_path):
    def twice(mod, t):
        t.tune(_spec(mod))
        calls = t.bench_calls
        res = t.tune(_spec(mod))
        assert t.bench_calls == calls == len(FAKE_TIMES)
        return res

    res, _, _ = _both(tmp_path, twice, measure=True, fingerprint="fp-a",
                      bench=_fake_bench)
    assert res.source == "measured"


@needs_reference
def test_prior_only_never_measures_or_persists(tmp_path):
    res, rt, pt = _both(tmp_path, lambda m, t: t.tune(_spec(m, prior_b=2)),
                        measure=False, fingerprint="fp-a",
                        bench=_boom_bench)
    assert res.source == "prior" and res.config == {"b": 2}
    assert res.measured_s is None
    assert not rt.cache_path.exists() and not pt.cache_path.exists()


@needs_reference
def test_failing_candidates_fall_back_to_prior(tmp_path):
    def broken_bench(runner, reps):
        raise RuntimeError("backend exploded")

    res, _, _ = _both(tmp_path, lambda m, t: t.tune(_spec(m)), measure=True,
                      fingerprint="fp-a", bench=broken_bench)
    assert res.source == "prior" and res.config == {"b": 1}


@needs_reference
def test_measured_tune_records_prior_and_tuned_ledger_rows(tmp_path):
    ledgers = (RefLedger(), OverheadLedger())
    tuners = [mod.Autotuner(cache_dir=tmp_path / name, measure=True,
                            fingerprint="fp-a", bench=_fake_bench,
                            ledger=led)
              for mod, name, led in ((ra, "ref", ledgers[0]),
                                     (pa, "port", ledgers[1]))]
    for mod, t in zip((ra, pa), tuners):
        t.tune(_spec(mod))
    assert _rows(ledgers[1]) == _rows(ledgers[0])
    assert [e.note for e in ledgers[1].entries] == ["prior", "tuned"]
    assert all(e.site == "autotune" and e.measured_s is not None
               for e in ledgers[1].entries)
    prior, tuned = ledgers[1].entries
    assert tuned.measured_s <= prior.measured_s
    assert [e.query for e in ledgers[1].entries] == \
        [e.query for e in ledgers[0].entries]


@needs_reference
def test_default_tuner_is_prior_only(monkeypatch):
    from repro_torch import runtime as port_runtime

    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    assert ra.Autotuner().measure is pa.Autotuner().measure is False
    with pytest.warns(DeprecationWarning):  # the back-compat shims
        assert isinstance(ra.get_tuner(), ra.Autotuner)
    with pytest.warns(DeprecationWarning):
        tuner = pa.get_tuner()
    assert isinstance(tuner, pa.Autotuner) and tuner.measure is False
    assert tuner is port_runtime.default_runtime().tuner


@needs_reference
def test_a_failing_candidate_is_skipped_among_good_ones(tmp_path):
    def flaky_bench(runner, reps):
        b = runner()["b"]
        if b == 4:
            raise RuntimeError("out of shared memory")
        return FAKE_TIMES[b]

    res, rt, pt = _both(tmp_path, lambda m, t: t.tune(_spec(m)),
                        measure=True, fingerprint="fp-a", bench=flaky_bench)
    assert res.source == "measured" and res.config == {"b": 2}
    assert [t.get("error") for t in res.trials] == [
        "RuntimeError('out of shared memory')", None, None]
    assert _payload(pt) == _payload(rt)


# ---------------------------------------------------------------------------
# The families' candidate spaces
# ---------------------------------------------------------------------------

BUDGET = tuning.vmem_budget()
TINYLLAMA_NK = [(2048, 2048), (256, 2048), (5632, 2048), (2048, 5632),
                (32000, 2048), (96, 64), (64, 96), (1, 2048), (4096, 4096)]
DTYPES = [(torch.bfloat16, torch.bfloat16, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16, torch.float32),
          (torch.float32, torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.float32, torch.bfloat16),
          (torch.float32, torch.float32, torch.float32)]


def _prior_only(tmp_path, **kw):
    return pa.Autotuner(cache_dir=tmp_path, measure=False, fingerprint="fp",
                        bench=_boom_bench, **kw)


@pytest.mark.parametrize("dtypes", DTYPES, ids=lambda d: "x".join(
    str(x)[6:] for x in d))
def test_matmul_prior_is_tile_n_and_candidates_fit(dtypes, tmp_path):
    a_dt, b_dt, out_dt = dtypes
    path = mm.choose_path(a_dt, b_dt)
    t = _prior_only(tmp_path)
    for n, k in TINYLLAMA_NK:
        prior, cands = tuning.matmul_candidates(path, n, k, a_dt, b_dt,
                                                out_dt)
        assert prior == {"tile_n": mm.tile_n(n)}
        want = (64, 128) if path != "fma" else (mm.tile_n(n),)
        assert tuple(c.config["tile_n"] for c in cands) == want
        for c in cands:
            assert c.vmem_bytes <= BUDGET and c.prior_s > 0
            if path != "fma":
                assert c.vmem_bytes == mm.tc_smem_bytes(
                    c.config["tile_n"], path == "split")
        res = tuning.tune_matmul(a_dt, b_dt, out_dt, n, k, tuner=t)
        assert res.source == "prior" and res.config == prior
        assert tuning.matmul_tile(a_dt, b_dt, out_dt, n, k, t) == \
            mm.tile_n(n)
    assert t.bench_calls == 0


def test_matmul_shared_memory_formula():
    """``tc_smem_bytes`` is ``matmul.cu``'s TcShape: stages of 24 or 32 KB
    in a 96 KB ring (two CTAs an SM), 40 or 48 KB in 200 KB on the split
    path, + 1024 to align and two barriers a stage."""
    assert mm.tc_smem_bytes(64, False) == 1024 + 4 * 24576 + 64
    assert mm.tc_smem_bytes(128, False) == 1024 + 3 * 32768 + 48
    assert mm.tc_smem_bytes(64, True) == 1024 + 5 * 40960 + 80
    assert mm.tc_smem_bytes(128, True) == 1024 + 4 * 49152 + 64
    assert 2 * mm.tc_smem_bytes(64, False) <= tuning.SM_SMEM


def test_matmul_key_never_holds_m(tmp_path):
    """M = 1 and M = 4096 (and a 4-D batch) resolve through one key: the
    tile is a function of the dtypes, N and K, so a row's bits do not
    depend on the rows beside it."""
    t = _prior_only(tmp_path)
    b = torch.zeros((2048, 5632), dtype=torch.bfloat16)
    tiles = {m: ops.tile_for(torch.zeros((m, 2048), dtype=torch.bfloat16),
                             b, tuner=t) for m in (1, 4096)}
    tiles["4-D"] = ops.tile_for(
        torch.zeros((2, 3, 7, 2048), dtype=torch.bfloat16),
        torch.zeros((2, 3, 2048, 5632), dtype=torch.bfloat16), tuner=t)
    assert set(tiles.values()) == {mm.tile_n(5632)}
    keys = list(t.results())
    assert len(keys) == 1 and "4096" not in keys[0]
    assert keys[0].startswith("matmul/tensor_core/bfloat16/n5632/k2048/")


@pytest.mark.parametrize("hd", fa.TC_HEAD_DIMS)
def test_flash_tc_kernels_fit_the_budget(hd):
    """Flash has one instantiation per (dtype, hd) and no tuner family;
    its tensor-core kernels' shared memory (what chip_smoke.py holds
    against the runtime) fits a CTA."""
    smem = fa.tc_smem_bytes(hd)
    assert set(smem) == {"forward", "dq", "dkv"}
    assert all(0 < v <= BUDGET for v in smem.values())
    assert not hasattr(tuning, "tune_flash")


def test_flash_shared_memory_formulas():
    """The tensor-core kernels' tiles, as ``flash_attention.cu`` sizes
    them: hd 96 on the hd-128 tiles, hd 256's 64-row kv stages."""
    # Q (128 x 64 bf16) + 3 stages of K and V (128 x 64) + 7 barriers
    assert fa.tc_smem_bytes(64)["forward"] == 1024 + 16384 + 3 * 2 * 16384 \
        + 56
    assert fa.tc_smem_bytes(96) == fa.tc_smem_bytes(128)
    # Q (128 x 256) + 2 stages of K and V (64 x 256) + 5 barriers
    assert fa.tc_smem_bytes(256)["forward"] == 1024 + 65536 \
        + 2 * 2 * 32768 + 40


@pytest.mark.parametrize("n", [1 << 17, 1 << 20, 1 << 26, 1 << 10])
def test_sort_prior_and_candidates(n, tmp_path):
    prior, cands = tuning.sort_candidates(1, n, 4)
    assert prior == {"log_tile": 14, "log_group": 6}
    assert (bs.LOG_TILE, bs.LOG_GROUP, bs.TILE) == (14, 6, 1 << 14)
    assert cands[0].config == prior
    assert 1 < len(cands) <= tuning.SORT_MAX_CANDIDATES
    assert len({tuple(sorted(c.config.items())) for c in cands}) == len(cands)
    for c in cands:
        lt, lg = c.config["log_tile"], c.config["log_group"]
        assert lt in (13, 14, 15) and lg in (5, 6)
        assert bs.config_ok(lt, lg)
        assert c.vmem_bytes == bs.smem_bytes(lt, 4) <= BUDGET
    res = tuning.tune_sort(1, n, torch.float32, tuner=_prior_only(tmp_path))
    assert res.source == "prior" and res.config == prior


def test_sort_builds_and_their_limits():
    """The static_asserts ``config_ok`` mirrors, the port's own build
    taking no macros, and the schedule a build gives."""
    assert bs.defines() == () and bs.defines(14, 6) == ()
    assert bs.defines(15, 5) == ("SORT_LOG_TILE=15", "SORT_LOG_GROUP=5")
    for lt, lg in ((16, 6), (9, 6), (15, 7), (14, 0)):
        assert not bs.config_ok(lt, lg)
        with pytest.raises(ValueError):
            bs.defines(lt, lg)
    assert bs.smem_bytes(14, 4) == 67_584  # 66 KiB with the padding
    assert bs.grid_launches(1 << 26) == 31
    assert bs.grid_launches(1 << 26, 1 << 15, 5) == len(
        bs.passes(1 << 26, 1 << 15, 5))
    assert bs.grid_launches(1 << 17, 1 << 13, 6) > bs.grid_launches(1 << 17)


@pytest.mark.parametrize("grad", [False, True])
def test_wkv_prior_and_candidates(grad, tmp_path):
    for dtype in (torch.bfloat16, torch.float32):
        for n in wkv_k.HEAD_SIZES:
            prior, cands = tuning.wkv_candidates(40, n, dtype, grad)
            assert prior == {"chunk": 64}
            assert [c.config["chunk"] for c in cands] == list(wkv_k.CHUNKS)
            for c in cands:
                smem = wkv_k.smem_bytes(dtype, c.config["chunk"], n)
                assert c.vmem_bytes == max(smem.values()) <= BUDGET
    res = tuning.tune_wkv(40, 64, torch.bfloat16, grad,
                          tuner=_prior_only(tmp_path))
    assert res.source == "prior" and res.config == {"chunk": 64}


class _PinnedChunk(pa.Autotuner):
    """Answers every WKV lookup with one chunk."""

    def __init__(self, tmp_path, chunk):
        super().__init__(cache_dir=tmp_path, fingerprint="fp",
                         bench=_boom_bench)
        self.chunk = chunk

    def tune(self, spec):
        return pa.TuneResult(spec.key, spec.family, {"chunk": self.chunk},
                             "pinned", None, dict(spec.prior), None, None)


def test_wkv_key_never_holds_b_or_s(tmp_path):
    """WKV's chunk is a function of H, N, the dtype and the gradient, not
    of the batch or the tokens: a row served alone and in a batch of
    longer rows (static against continuous serving) gets one chunk, even
    from a tuner that picks a chunk other than 64."""
    t = _prior_only(tmp_path)
    shapes = [(1, 7, 40, 64), (8, 2048, 40, 64), (3, 300, 40, 64)]
    for shape in shapes:
        assert ops.wkv_chunk_for(torch.zeros(shape), False, t) == 64
    keys = list(t.results())
    assert len(keys) == 1 and keys[0].startswith("wkv/h40/n64/float32/g0/")
    pinned = _PinnedChunk(tmp_path, 32)
    assert {ops.wkv_chunk_for(torch.zeros(s), True, pinned)
            for s in shapes} == {32}
    assert len(pinned._memo) == 1


def test_wkv_shared_memory_formula():
    """``wkv.cu``'s sizes at its largest instantiation (chunk 64, N 64):
    the per-chunk tiles are 64 x 65 fp32, and the backward's fits the
    227 KB its static_assert holds it to."""
    sm = wkv_k.smem_bytes(torch.bfloat16, 64, 64)
    assert sm["wkv_fwd_out"] == 4 * (6 * 64 * 65 + 64 + 4 * 64)
    assert sm["wkv_bwd_chunk"] <= 232_448
    assert sm["wkv_state forward"] == 2 * (64 * 64 * 2 + 64 * 64 * 4
                                           + 64 * 16 * 2) + 64 * 4
    assert sm["wkv_state backward"] > sm["wkv_state forward"]


@needs_reference
def test_fmt_config_is_stable():
    for config in ({"tile_n": 64}, {"log_tile": 14, "log_group": 6},
                   {"log_group": 6, "log_tile": 14},
                   {"stages": 2, "block_q": 128, "block_kv": 64}):
        assert pa.fmt_config(config) == ra.fmt_config(config)
    assert pa.fmt_config({"log_group": 6, "log_tile": 14}) == \
        "log_group=6,log_tile=14"


def test_spec_keys_carry_the_library_hash(tmp_path):
    """An edited kernel source renames its library, so its tuned configs
    miss the cache."""
    from repro_torch.kernels import build

    t = _prior_only(tmp_path)
    for res, lib in ((tuning.tune_sort(1, 1 << 20, torch.float32, tuner=t),
                      "bitonic_sort"),
                     (tuning.tune_wkv(40, 64, torch.bfloat16, True,
                                      tuner=t), "wkv"),
                     (tuning.tune_matmul(torch.bfloat16, torch.bfloat16,
                                         torch.bfloat16, 2048, 2048,
                                         tuner=t), "matmul")):
        digest = build.library_path(lib).stem.rsplit("-", 1)[1]
        assert f"/lib-{digest}/hw-h100-sxm" in res.key


# ---------------------------------------------------------------------------
# The Runtime's tuner
# ---------------------------------------------------------------------------


def test_default_runtime_tuner_never_measures_or_writes(tmp_path):
    import repro_torch

    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(cache_dir=tmp_path),
                             device="cpu")
    t = rt.tuner
    t._bench = _boom_bench
    assert t.measure is False and t.cache_dir == tmp_path
    assert t.ledger is rt.ledger and t.hw is rt.hw
    with tuning.using(t):
        assert tuning.resolve() is t
        assert tuning.matmul_tile(torch.bfloat16, torch.bfloat16,
                                  torch.bfloat16, 5632, 2048) == 128
        assert tuning.sort_config(1, 1 << 20, torch.float32) == (14, 6)
        assert tuning.wkv_chunk(40, 64, torch.bfloat16, True) == 64
    assert {r.source for r in t.results().values()} == {"prior"}
    assert t.bench_calls == 0
    assert list(tmp_path.iterdir()) == []
    assert not [e for e in rt.ledger.entries if e.site == "autotune"]


def test_runtime_config_autotune_and_env(tmp_path):
    import repro_torch
    from repro_torch import RuntimeConfig

    assert RuntimeConfig().autotune is False
    assert RuntimeConfig.from_env({}).autotune is False
    assert RuntimeConfig.from_env({"REPRO_AUTOTUNE": "1"}).autotune is True
    assert RuntimeConfig.from_env({"REPRO_AUTOTUNE": "0"}).autotune is False
    cfg = RuntimeConfig.from_env({"REPRO_AUTOTUNE": "1",
                                  "REPRO_COST_CACHE": str(tmp_path)})
    rt = repro_torch.Runtime(cfg, device="cpu")
    assert rt.tuner.measure is True and rt.tuner.cache_dir == tmp_path
    assert rt.tuner.cache_path.name.startswith("autotune-cpu-")


def test_two_runtimes_keep_their_own_tuners(tmp_path):
    import repro_torch

    a = repro_torch.Runtime(repro_torch.RuntimeConfig(cache_dir=tmp_path),
                            device="cpu")
    b = repro_torch.Runtime(repro_torch.RuntimeConfig(cache_dir=tmp_path,
                                                      autotune=True),
                            device="cpu")
    assert a.tuner is not b.tuner and a.ledger is not b.ledger
    assert (a.tuner.measure, b.tuner.measure) == (False, True)
    tuning.tune_wkv(4, 16, torch.float32, False, tuner=a.tuner)
    assert a.tuner.results() and not b.tuner.results()
    with tuning.using(a.tuner):
        with tuning.using(b.tuner):
            assert tuning.resolve() is b.tuner
        assert tuning.resolve() is a.tuner
    assert tuning.resolve(b.tuner) is b.tuner


def test_train_runs_under_the_runtime_tuner(monkeypatch):
    """``Runtime.train`` runs every kernel call under its own tuner (here
    seen from the matmul's plain version, which the CPU takes)."""
    import repro_torch
    from repro_torch.configs import get_config

    seen = set()
    plain = ops.matmul_fused_ref

    def spy(*args, **kwargs):
        seen.add(tuning.active())
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "matmul_fused_ref", spy)
    rt = repro_torch.Runtime(device="cpu")
    rt.train(get_config("tinyllama-1.1b").reduced(), steps=1, batch=1,
             seq=8, log_every=0)
    assert seen == {rt.tuner}
    assert tuning.active() is None


def test_backward_and_recompute_keep_the_forward_tuner(monkeypatch,
                                                       tmp_path):
    """On a card autograd runs the backward, and a checkpoint's
    recomputation, on a worker thread of its own, outside the caller's
    tuner: the matmul's backward is handed the tuner its forward resolved,
    and the recomputation runs under it (here the backward runs on
    another thread, as it does there)."""
    import threading

    from torch.utils.checkpoint import checkpoint

    t = _prior_only(tmp_path)
    seen = []
    real = ops._matmul

    def spy(a, b, bias, activation, out_dtype, tuner=None):
        seen.append(tuning.resolve(tuner))
        return real(a, b, bias, activation, out_dtype, tuner)

    monkeypatch.setattr(ops, "_matmul", spy)
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((4, 8), generator=gen, requires_grad=True)
    b = torch.randn((8, 6), generator=gen, requires_grad=True)
    with tuning.using(t):
        y = checkpoint(lambda x, w: ops.matmul(x, w, activation="silu"), a,
                       b, use_reentrant=False,
                       context_fn=tuning.recompute_contexts)
    worker = threading.Thread(target=lambda: y.sum().backward())
    worker.start()
    worker.join(30)
    # forward, its recomputation, and the backward's z, dA and dB
    assert len(seen) == 5 and set(seen) == {t}
    assert a.grad is not None and b.grad is not None


def test_two_threads_keep_their_own_tuners(tmp_path):
    """Two Runtimes serving or training in two threads: each thread's
    lookups go to its own tuner, and a block that ends removes its own
    entry, not the other thread's."""
    import threading

    a, b = (_prior_only(tmp_path / x) for x in "ab")
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    seen = {}

    def run_a():
        with tuning.using(a):
            a_in.set()
            b_in.wait(5)
            seen["a"] = tuning.resolve()
        a_out.set()

    def run_b():
        a_in.wait(5)
        with tuning.using(b):
            b_in.set()
            a_out.wait(5)  # A's block has ended
            seen["b"] = tuning.resolve()
            tuning.matmul_tile(torch.bfloat16, torch.bfloat16,
                               torch.bfloat16, 2048, 2048)
        seen["b after"] = tuning.active()

    threads = [threading.Thread(target=f) for f in (run_a, run_b)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    assert seen == {"a": a, "b": b, "b after": None}
    assert b.results() and not a.results()
    assert tuning.active() is None and tuning.resolve() is tuning.FIXED


def test_serve_watchdog_worker_runs_under_the_runtime_tuner(monkeypatch):
    """Under a watchdog the serving engine runs each device step on a
    worker thread; that thread is handed the Runtime's tuner."""
    import threading

    import numpy as np

    import repro_torch
    from repro_torch.configs import get_config

    seen = set()
    plain = ops.matmul_fused_ref

    def spy(*args, **kwargs):
        seen.add((threading.current_thread() is threading.main_thread(),
                  tuning.active()))
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "matmul_fused_ref", spy)
    cfg = get_config("tinyllama-1.1b").reduced()
    prompt = np.random.default_rng(0).integers(1, cfg.vocab_size, 8)
    rt = repro_torch.Runtime(device="cpu")
    rt.serve(cfg, [repro_torch.Request("r0", prompt, 3)], slots=1,
             max_len=16, eos_id=-1, macro_step=1, watchdog_ms=5000)
    assert (False, rt.tuner) in seen
    assert {t for _, t in seen} == {rt.tuner}


def test_no_tuner_in_scope_takes_the_fixed_choice(monkeypatch, tmp_path):
    """With no tuner passed and none in scope, a lookup answers with the
    kernel's fixed choice: no cache read, no measurement, no Runtime."""
    from repro_torch import runtime as port_runtime

    def no_runtime():
        raise AssertionError("a kernel lookup built a Runtime")

    def no_cache():
        raise AssertionError("the fixed choice read a cache")

    monkeypatch.setattr(port_runtime, "default_runtime", no_runtime)
    monkeypatch.setattr(tuning.FIXED, "_load_store", no_cache)
    assert tuning.resolve() is tuning.FIXED
    assert tuning.matmul_tile(torch.bfloat16, torch.bfloat16,
                              torch.bfloat16, 256, 2048) == mm.tile_n(256)
    assert tuning.sort_config(1, 1 << 20, torch.float32) == (14, 6)
    assert tuning.wkv_chunk(40, 64, torch.bfloat16, True) == 64
    assert tuning.FIXED.bench_calls == 0


def test_calibrating_default_runtime_does_not_recurse(monkeypatch, tmp_path):
    """``REPRO_CALIBRATE=1`` with a cold cache: building the default
    Runtime calibrates, and calibration's matmul probe resolves a tile.
    That lookup takes the fixed choice; it does not build the default
    Runtime again (here the probe is the lookup its CUDA path makes)."""
    from repro_torch import runtime as port_runtime
    from repro_torch.core.costs.engine import CostEngine

    probed = []

    def calibrated(base, *, ledger=None, corrections=None, **kw):
        a = torch.zeros((1024, 1024))
        probed.append((ops.tile_for(a, a), tuning.resolve()))
        return CostEngine(hw=base, ledger=ledger, corrections=corrections)

    monkeypatch.setenv("REPRO_CALIBRATE", "1")
    monkeypatch.setenv("REPRO_COST_CACHE", str(tmp_path))
    monkeypatch.setattr(CostEngine, "calibrated", staticmethod(calibrated))
    monkeypatch.setattr(port_runtime, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(port_runtime, "_default_runtime", None)
    rt = port_runtime.default_runtime()
    assert rt.config.calibrate
    assert probed == [(mm.tile_n(1024), tuning.FIXED)]
    assert port_runtime.default_runtime() is rt


def test_wkv_chunk_none_is_64_on_the_cpu():
    gen = torch.Generator().manual_seed(0)
    r, k, v = (torch.randn((2, 40, 3, 16), generator=gen) for _ in range(3))
    logw = -torch.exp(-2.0 + torch.randn((2, 40, 3, 16), generator=gen))
    u = 0.1 * torch.randn((3, 16), generator=gen)
    got = ops.wkv(r, k, v, logw, u)
    want = ops.wkv(r, k, v, logw, u, chunk=64)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


# ---------------------------------------------------------------------------
# On the card: every candidate config against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("tile", mm.TILES)
def test_matmul_tiles_match_plain_on_card(tile):
    gen = torch.Generator(device="cuda").manual_seed(tile)
    a = torch.randn((300, 2048), generator=gen, device="cuda")
    b = torch.randn((2048, 2000), generator=gen, device="cuda") / 2048 ** 0.5
    for a_dt, b_dt, out_dt in DTYPES[:4]:
        x, w = a.to(a_dt), b.to(b_dt)
        got = mm.matmul_cuda(x, w, out_dtype=out_dt, tile=tile)
        want = ref.matmul_fused_ref(x, w, out_dtype=out_dt)
        err = (got.float() - want.float()).abs().max().item()
        tol = tuning.MATMUL_TOL[out_dt] * want.float().abs().max().item()
        assert err <= tol, (a_dt, b_dt, out_dt)
        row = mm.matmul_cuda(x[7:8], w, out_dtype=out_dt, tile=tile)
        assert torch.equal(got[7:8], row)  # batch-invariant at this tile


@pytest.mark.cuda
@needs_card
def test_sort_candidates_match_plain_on_card():
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in (1 << 17, 1 << 20):
        _, cands = tuning.sort_candidates(1, n, 4)
        x = torch.randn((1, n), generator=gen, device="cuda")
        want = ref.bitonic_sort_ref(x)
        for c in cands:
            got = bs.bitonic_sort_cuda(x, c.config["log_tile"],
                                       c.config["log_group"])
            assert torch.equal(got, want), c.config


@pytest.mark.cuda
@needs_card
@pytest.mark.parametrize("chunk", wkv_k.CHUNKS)
def test_wkv_chunks_match_plain_on_card(chunk):
    gen = torch.Generator(device="cuda").manual_seed(chunk)
    shape = (2, 300, 4, 64)
    r, k, v = (torch.randn(shape, generator=gen, device="cuda")
               for _ in range(3))
    logw = -torch.exp(-2.0 + torch.randn(shape, generator=gen,
                                         device="cuda"))
    u = 0.1 * torch.randn((4, 64), generator=gen, device="cuda")
    out, state, _ = wkv_k.wkv_fwd_cuda(r, k, v, logw, u, chunk)
    p_out, p_state, _ = ref.wkv_fwd_plain(r, k, v, logw, u, chunk,
                                          wkv_k.SUBCHUNK)
    for got, want in ((out, p_out), (state, p_state)):
        err = (got - want).abs().max().item()
        assert err <= tuning.WKV_F32_TOL * want.abs().max().item()


@pytest.mark.cuda
@needs_card
def test_measured_tune_on_card(tmp_path):
    """A measuring tuner on the card: every matmul, sort and WKV
    candidate runs (none fails), two ledger rows, and a second tuner on
    the same cache measures nothing and returns the same configs."""
    led = OverheadLedger()
    t = pa.Autotuner(cache_dir=tmp_path, measure=True, ledger=led)
    got = [tuning.tune_matmul(torch.bfloat16, torch.bfloat16,
                              torch.bfloat16, 2048, 2048, tuner=t),
           tuning.tune_sort(1, 1 << 17, torch.float32, tuner=t),
           tuning.tune_wkv(4, 64, torch.bfloat16, True, tuner=t)]
    for res in got:
        assert res.source == "measured"
        assert all(tr["seconds"] is not None for tr in res.trials), res.trials
    assert len([e for e in led.entries if e.site == "autotune"]) == 6
    warm = pa.Autotuner(cache_dir=tmp_path, measure=True)
    again = [tuning.tune_matmul(torch.bfloat16, torch.bfloat16,
                                torch.bfloat16, 2048, 2048, tuner=warm),
             tuning.tune_sort(1, 1 << 17, torch.float32, tuner=warm),
             tuning.tune_wkv(4, 64, torch.bfloat16, True, tuner=warm)]
    assert warm.bench_calls == 0
    assert [r.config for r in again] == [r.config for r in got]
