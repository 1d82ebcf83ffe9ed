"""The port's closed-loop cost corrections against the reference's, on the
CPU: each of ``tests/test_corrections.py``'s 16 cases runs on both
packages' ``CorrectionState``, ``CostEngine``, ``OverheadLedger``,
``Runtime`` and ``RuntimeConfig`` with the same inputs, the two are held
equal (factors, events, verdicts, drift rows), and the reference test's
assertions hold on the port.  The port's engines are priced on the
reference's default hardware spec where a verdict or a prediction is
compared; the admit flip is also checked on the port's own H100 spec.

The persistence cases use a ``tmp_path`` cache directory.  The port's
calibration times a CUDA card, which the CPU has not: there its probes
are replaced by fixed values, so what is tested is the cache (the spec
and the factors riding in the fingerprint-keyed entry), as in the
reference.  ``RuntimeConfig.from_env`` reads ``REPRO_CORRECTIONS=1``, and
``auto_recalibrate`` runs ``maybe_recalibrate`` once a served trace has
drained.
"""

from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core.costs as jcosts  # noqa: E402
import repro.runtime as jruntime  # noqa: E402
import repro_torch.core.costs as costs  # noqa: E402
import repro_torch.runtime as runtime  # noqa: E402
from repro.core.costs.engine import CostQuery as JCostQuery  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro_torch.core.costs import calibration  # noqa: E402
from repro_torch.core.costs.engine import CostQuery  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402

REF = SimpleNamespace(
    name="ref", CorrectionState=jcosts.CorrectionState,
    engine=lambda **kw: jcosts.CostEngine(**kw), CostQuery=JCostQuery,
    Runtime=jruntime.Runtime, RuntimeConfig=jruntime.RuntimeConfig,
    cfg_kw={})
PORT = SimpleNamespace(
    name="port", CorrectionState=costs.CorrectionState,
    engine=lambda **kw: costs.CostEngine(
        hw=HardwareSpec.from_dict(V5E.to_dict()), **kw),
    CostQuery=CostQuery, Runtime=runtime.Runtime,
    RuntimeConfig=runtime.RuntimeConfig, cfg_kw={"device": "cpu"})


def both(scenario):
    """Run ``scenario(pkg)`` on the reference and on the port and require
    equal observations; returns the port's."""
    ref, port = scenario(REF), scenario(PORT)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# CorrectionState guardrails
# ---------------------------------------------------------------------------


def test_warmup_keeps_factor_at_one_until_min_measurements():
    def scenario(P):
        cs = P.CorrectionState(min_measurements=3)
        seen = []
        for _ in range(3):
            cs.update("sort", 2.0)
            seen.append(cs.factor("sort"))
        return seen

    seen = both(scenario)
    assert seen[:2] == [1.0, 1.0]
    assert seen[2] == pytest.approx(2.0)


def test_factor_clamps_exactly_at_band_edges():
    def scenario(P):
        cs = P.CorrectionState(alpha=1.0, min_measurements=1,
                               max_correction=8.0)
        cs.update("hot", 1e6)
        cs2 = P.CorrectionState(alpha=1.0, min_measurements=1,
                                max_correction=8.0)
        cs2.update("cold", 1e-6)
        return cs.factor("hot"), cs2.factor("cold")

    hot, cold = both(scenario)
    assert hot == 8.0          # exactly the edge, not beyond
    assert cold == 1.0 / 8.0


def test_invalidation_fires_exactly_on_ratio_crossings():
    def scenario(P):
        cs = P.CorrectionState(alpha=1.0, min_measurements=1,
                               invalidate_ratio=1.5)
        return [cs.update("s", r) for r in (1.4, 1.6, 1.7, 1.05)]

    assert both(scenario) == [[], ["invalidate"], [], ["invalidate"]]


def test_rollback_after_full_window_of_harmful_correction():
    def scenario(P):
        cs = P.CorrectionState(alpha=1.0, min_measurements=1,
                               regret_window=4)
        cs.update("s", 4.0)                      # learn x4 from one row
        learned = cs.factor("s")
        events = []
        for _ in range(5):                       # accurate rows, harming
            events += cs.update("s", 1.0, applied_factor=4.0)
            if "rollback" in events:
                break
        st = cs.site("s")
        return learned, events, cs.factor("s"), st.rollbacks, st.n

    learned, events, factor, rollbacks, n = both(scenario)
    assert learned == pytest.approx(4.0)
    assert "rollback" in events
    assert factor == 1.0                         # reset and re-warming
    assert rollbacks == 1 and n == 0


def test_rollback_needs_a_full_window_and_an_applied_factor():
    def scenario(P):
        cs = P.CorrectionState(alpha=1.0, min_measurements=1,
                               regret_window=4)
        events = [cs.update("s", r, applied_factor=1.0)
                  for r in (3.0, 0.3, 3.0, 0.3, 3.0)]
        return events, cs.site("s").rollbacks

    events, rollbacks = both(scenario)
    assert all("rollback" not in e for e in events)
    assert rollbacks == 0


def test_state_roundtrips_through_dict_payload():
    def scenario(P):
        cs = P.CorrectionState(alpha=1.0, min_measurements=1)
        cs.update("a", 2.0)
        cs.update("b", 0.5)
        cs2 = P.CorrectionState(min_measurements=1)
        cs2.load(cs.to_dict())
        loaded = (cs2.factor("a"), cs2.factor("b"))
        cs2.load(None)                           # tolerated: no-op
        cs2.load({"bad": {"log_ewma": "nope"}})  # malformed entry skipped
        return (cs.factor("a"), cs.factor("b")), loaded, cs2.factor("a")

    orig, loaded, after = both(scenario)
    assert loaded == pytest.approx(orig)
    assert after == pytest.approx(orig[0])


# ---------------------------------------------------------------------------
# Engine integration: uniform scaling, ledgered correction, invalidation
# ---------------------------------------------------------------------------


def _scan_query(P, seq=512):
    return P.CostQuery.make("scan_chunk", (seq, 1, 4, 64))


def test_engine_applies_factor_uniformly_and_ledgers_it():
    def scenario(P):
        plain = P.engine()
        eng = P.engine(corrections=P.CorrectionState())
        q = _scan_query(P)
        want = plain.query(q, record=False).choice
        for _ in range(4):                       # machine 2x the model
            dec = eng.query(q)
            eng.record_measured(dec, 2.0 * dec.predicted_s / dec.correction)
        dec = eng.query(q)
        raw = plain.query(q, record=False).predicted.total
        return dict(want=want, choice=dec.choice, correction=dec.correction,
                    factor=eng.corrections.factor("scan_chunk"),
                    total=dec.predicted.total, raw=raw,
                    ledgered=eng.ledger.entries[-1].correction)

    o = both(scenario)
    assert o["correction"] == pytest.approx(o["factor"])
    assert o["correction"] > 1.0
    assert o["choice"] == o["want"]              # the verdict cannot move
    assert o["total"] == pytest.approx(o["raw"] * o["correction"])
    assert o["ledgered"] == pytest.approx(o["correction"])


def test_invalidation_drops_cached_verdicts():
    def scenario(P):
        eng = P.engine(corrections=P.CorrectionState(
            alpha=1.0, min_measurements=1, invalidate_ratio=1.5))
        q = _scan_query(P)
        d1 = eng.query(q)
        memo = eng.query(q) is d1                # memoized
        dec = eng.query(q)
        eng.record_measured(dec, 3.0 * dec.predicted_s)   # 3x: crosses 1.5
        d2 = eng.query(q)
        return memo, eng.cache_invalidations, d2 is not d1, d2.correction

    memo, invalidations, fresh, correction = both(scenario)
    assert memo and invalidations >= 1 and fresh
    assert correction == pytest.approx(3.0)


def _admit_flip(P, engine):
    kw = dict(prompt_len=64, new_tokens=16, n_slots=4,
              flops_per_token=1e6, weight_bytes=1e6, kv_bytes_per_slot=1e4)
    plain = engine()
    probe = P.CostQuery.make("serve_admit", (2,), **kw)
    admit_s = plain.query(probe, record=False).baseline.total
    # slack fits the raw prediction but NOT the corrected (2x) one
    q = P.CostQuery.make("serve_admit", (2,), slack_us=admit_s * 1.5e6,
                         **kw)
    before = plain.query(q, record=False).choice
    eng = engine(corrections=P.CorrectionState(alpha=1.0,
                                               min_measurements=1))
    eng.corrections.update("serve_admit", 2.0)
    return before, eng.query(q, record=False).choice


def test_serve_admit_flips_shed_under_correction():
    verdicts = both(lambda P: _admit_flip(P, P.engine))
    assert verdicts == ("admit", "shed")
    # and on the port's own spec (the H100 data sheet)
    assert _admit_flip(PORT, costs.CostEngine) == ("admit", "shed")


def test_measurement_noise_hook_perturbs_recorded_rows():
    def scenario(P):
        eng = P.engine()
        eng.measurement_noise = lambda site: 2.0
        dec = eng.query(P.CostQuery.make("sort", (1000,)))
        return eng.record_measured(dec, 1e-3).measured_s

    assert both(scenario) == pytest.approx(2e-3)


def test_perturb_hw_swaps_spec_and_drops_cache():
    def scenario(P):
        eng = P.engine()
        q = _scan_query(P)
        d1 = eng.query(q)
        old = eng.hw.kernel_launch_s
        eng.perturb_hw(kernel_launch_s=old * 4)
        return (eng.hw.kernel_launch_s / old, eng.perturbed_fields,
                eng.query(q) is not d1)

    ratio, perturbed, dropped = both(scenario)
    assert ratio == pytest.approx(4.0)
    assert list(perturbed) == ["kernel_launch_s"]
    assert dropped                               # cache dropped with spec


# ---------------------------------------------------------------------------
# Drift semantics: raw trips, corrections resolve, overrides flow through
# ---------------------------------------------------------------------------


def test_raw_drift_resolved_by_correction_and_gate_behavior():
    def scenario(P):
        eng = P.engine(corrections=P.CorrectionState(alpha=1.0,
                                                     min_measurements=1))
        q = P.CostQuery.make("sort", (1000,))
        for _ in range(8):                       # machine 5x the model
            dec = eng.query(q)
            eng.record_measured(dec, 5.0 * dec.predicted_s / dec.correction)
        row = eng.drift_report()["sort"]
        eng.assert_drift_resolved()              # drift absorbed
        bare = P.engine()                        # no corrections
        for _ in range(8):
            dec = bare.query(q)
            bare.record_measured(dec, 5.0 * dec.predicted_s)
        with pytest.raises(AssertionError,
                           match="unresolved calibration drift"):
            bare.assert_drift_resolved()
        return row

    row = both(scenario)
    assert row["drifting"]                       # RAW ratio out of band
    assert row["raw_ratio"] == pytest.approx(5.0, rel=0.05)
    assert row["resolved"]                       # the factor absorbs it
    assert row["correction"] == pytest.approx(5.0, rel=0.05)


def test_runtime_config_drift_overrides_reach_ledger_and_report():
    def scenario(P):
        rt = P.Runtime(P.RuntimeConfig(
            drift_window=10, drift_threshold=3.0,
            drift_overrides={"sort": {"threshold": 1.5, "window": 5}},
            **P.cfg_kw))
        configs = (rt.ledger.drift_config("sort"),
                   rt.ledger.drift_config("matmul"))
        for kind, shape in (("sort", (1000,)),
                            ("scan_chunk", (512, 1, 4, 64))):
            for _ in range(6):                   # 2x: over 1.5, under 3.0
                dec = rt.engine.query(P.CostQuery.make(kind, shape))
                rt.engine.record_measured(dec, 2.0 * dec.predicted_s)
        drift = rt.engine.drift_report()
        report = rt.ledger.report()
        return configs, {s: (d["drifting"], d["threshold"])
                         for s, d in drift.items()}, (
                             "sort" in report, "calibration drift" in report)

    configs, drift, in_report = both(scenario)
    assert configs == ({"window": 5, "threshold": 1.5},
                       {"window": 10, "threshold": 3.0})
    assert drift["sort"] == (True, 1.5)          # tight per-site band trips
    assert not drift["scan_chunk"][0]            # session default holds
    assert in_report == (True, True)


# ---------------------------------------------------------------------------
# Persistence: factors ride the fingerprint-keyed calibration cache
# ---------------------------------------------------------------------------


@pytest.fixture
def cpu_probes(monkeypatch):
    """The port's calibration with its card probes replaced by fixed
    values: the CPU has no card to time, and these cases test the cache."""
    fixed = dict(kernel_launch_s=4e-6, host_sync_s=2e-5,
                 prefix_lookup_s=1e-7, hbm_bw=2.5e12, peak_flops_f32=5e13,
                 peak_flops_bf16=6e14, collective_base_s=None,
                 ici_bw_per_link=None, ipc_round_trip_s=5e-5,
                 ipc_bytes_per_s=2e9)
    monkeypatch.setattr(calibration, "_require_cuda",
                        lambda device: torch.device(device))
    monkeypatch.setattr(
        calibration, "run_probe_fields",
        lambda fields, base=None, **kw: {k: fixed[k] for k in fields
                                         if k in fixed})


def _seed_scan_factor(P, eng, ratio=2.0, rows=4):
    for _ in range(rows):
        dec = eng.query(_scan_query(P))
        eng.record_measured(dec, ratio * dec.predicted_s / dec.correction)
    return eng.corrections.factor("scan_chunk")


def test_corrections_persist_across_engine_rebuild(tmp_path, cpu_probes):
    def calibrated(P, path):
        kw = {"device": "cpu"} if P is PORT else {}
        mod = costs if P is PORT else jcosts
        return mod.CostEngine.calibrated(cache_dir=path, matmul_order=128,
                                         corrections=P.CorrectionState(),
                                         **kw)

    def scenario(P):
        path = tmp_path / P.name
        eng = calibrated(P, path)
        learned = _seed_scan_factor(P, eng)
        saved = eng.save_state() is not None
        eng2 = calibrated(P, path)
        return (learned, saved, eng2.corrections.factor("scan_chunk"),
                eng2.hw == eng.hw)

    learned, saved, restored, same_hw = both(scenario)
    assert learned > 1.0 and saved
    assert restored == pytest.approx(learned)
    assert same_hw                               # same fingerprint-keyed spec


def test_corrections_survive_runtime_restart(tmp_path, cpu_probes):
    def scenario(P):
        cfg = P.RuntimeConfig(calibrate=True, corrections=True,
                              cache_dir=tmp_path / P.name, **P.cfg_kw)
        rt = P.Runtime(cfg)
        learned = _seed_scan_factor(P, rt.engine)
        rt.engine.save_state()
        rt2 = P.Runtime(cfg)                     # fresh session, same cache
        return learned, rt2.engine.corrections.factor("scan_chunk")

    learned, restored = both(scenario)
    assert learned > 1.0
    assert restored == pytest.approx(learned)
    # the port's cache entry is the calibration's, under the given directory
    assert list((tmp_path / "port").glob("*.json"))


def test_uncalibrated_save_state_is_a_noop():
    both(lambda P: P.engine(corrections=P.CorrectionState()).save_state()
         is None)
    assert costs.CostEngine(
        corrections=costs.CorrectionState()).save_state() is None


# ---------------------------------------------------------------------------
# The port's RuntimeConfig wiring
# ---------------------------------------------------------------------------


def test_runtime_config_reads_corrections_from_env_and_wires_them():
    cfg = runtime.RuntimeConfig.from_env({"REPRO_CORRECTIONS": "1"},
                                         device="cpu")
    jcfg = jruntime.RuntimeConfig.from_env({"REPRO_CORRECTIONS": "1"})
    assert cfg.corrections is jcfg.corrections is True
    for field in ("corrections", "auto_recalibrate", "drift_window",
                  "drift_threshold", "drift_overrides"):
        assert getattr(runtime.RuntimeConfig(), field) == \
            getattr(jruntime.RuntimeConfig(), field)
    rt = runtime.Runtime(cfg)
    assert isinstance(rt.engine.corrections, costs.CorrectionState)
    assert rt.ledger.on_measurement == rt.engine._on_measurement
    assert runtime.Runtime(device="cpu").engine.corrections is None


def test_runtime_serve_recalibrates_at_the_drain_boundary(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serving import Request

    cfg = get_config("tinyllama-1.1b").reduced()
    rng = np.random.default_rng(0)
    trace = [Request(f"r{i}", rng.integers(1, cfg.vocab_size, (6,)), 3)
             for i in range(2)]
    calls = []
    for auto in (False, True):
        rt = runtime.Runtime(runtime.RuntimeConfig(
            device="cpu", corrections=True, auto_recalibrate=auto))
        monkeypatch.setattr(rt.engine, "maybe_recalibrate",
                            lambda **kw: calls.append(auto) or {})
        res = rt.serve(cfg, trace, slots=2, eos_id=-1)
        assert res.report.state_counts() == {"COMPLETED": 2}
        # the serve rows went through the correction loop
        assert rt.engine.corrections.sites()
    assert calls == [True]
