"""Chaos harness for the closed-loop cost engine: prove the ledger loop
heals.  Perturb the hardware spec, inject timing noise into measured rows,
and require decisions at three serve sites to return to their unperturbed
verdicts within a bounded number of ledgered measurements, with the
token-identity anchor intact throughout.

Stages (every gate a count, a verdict comparison or a ratio of same-run
numbers; never a wall-clock constant):

  calibrate  a fresh Runtime calibrates the card into a suite-private
             cache (corrections on, tight per-site drift bands through
             ``RuntimeConfig.drift_overrides``); that spec is the truth
             (measured now: the re-probes below must find the machine as
             it stands).
             Calibration times the card, so on the CPU the truth is the
             H100 data sheet held as the suite's own cache entry, and a
             re-probe reads it back (a probe without noise): the CPU run
             checks the loop's logic, the card run its measurements
  search     for serve_macro, serve (prefill_chunk) and serve_ipc, a query
             whose verdict flips under the 4x perturbation yet is stable
             under per-field wobble, and a drift-driver query whose
             predicted cost inflates >= 2x
  perturb    ``engine.perturb_hw``: host_sync_s, kernel_launch_s and
             ipc_round_trip_s x4; ``engine.measurement_noise`` lognormal
  reconverge rounds of decision + measured row per site;
             ``maybe_recalibrate`` re-probes the perturbed fields; fails
             unless all three verdicts return within MEASUREMENT_BUDGET rows
  rollback   a harmful factor planted on a healthy site must roll back
  serve      dense / paged / sharded / front-end serves with the loop live,
             token-identical to the static baseline (on the session's
             device: reduced tinyllama on the CPU, full-width tinyllama at
             CUT_LAYERS layers in bf16 on the card, the sharded run as
             ``serving_bench.sharded_row`` serves it)
  respawn    intake workers hard-killed and healed; the emission worker
             killed mid-stream and its transcript replayed
  restart    a second Runtime on the same cache inherits the healed spec
             and the surviving correction factors

The results land under the ``"chaos"`` key of ``<out>/serving.json`` (the
other suites' keys kept).
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.benches.common import (CUT_LAYERS, bench_config,
                                        load_json, model_and_params,
                                        out_dir, session, write_json)
from repro_torch.core.costs import CostEngine, CostQuery
from repro_torch.core.costs.calibration import (CalibrationResult,
                                                load_calibration,
                                                save_calibration)
from repro_torch.core.costs.corrections import CorrectionState
from repro_torch.core.costs.ledger import OverheadLedger
from repro_torch.hw import H100
from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace

BENCH_JSON = "serving.json"

REQUESTS = 4
PROMPT_LEN = 8
MAX_NEW = 6
SLOTS = 2
SHARD_DEVICES = 8

PERTURB = 4.0               # spec-field perturbation factor
PERTURBED_FIELDS = ("host_sync_s", "kernel_launch_s", "ipc_round_trip_s")
NOISE_SIGMA = 0.08          # lognormal sigma on measured rows
DRIFT_BAND = 1.8            # per-site drift threshold override (chaos sites)
MEASUREMENT_BUDGET = 60     # ledgered rows allowed before convergence
ROWS_PER_ROUND = 2
MAX_ROUNDS = 8
RECAL_MIN_ROWS = 3

# the three audited sites and the spec fields their heal must touch
CHAOS_SITES = ("serve_macro", "serve", "serve_ipc")


def _trace(cfg, seed=0):
    return synthetic_trace(
        REQUESTS, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=seed)


# ---------------------------------------------------------------------------
# flip-query search (pure analytic model, no device work)
# ---------------------------------------------------------------------------

_ENGINES = {}


def _verdict(spec, q) -> str:
    eng = _ENGINES.get(spec)
    if eng is None:
        eng = _ENGINES[spec] = CostEngine(hw=spec)
    return eng.query(q, record=False).choice


def _cost_of(spec, q, choice: str) -> float:
    """Predicted cost of executing ``choice`` for query ``q`` on ``spec``
    (the sweep prices every candidate, so the chosen-or-not cost is
    always on the decision)."""
    eng = _ENGINES.get(spec)
    if eng is None:
        eng = _ENGINES[spec] = CostEngine(hw=spec)
    dec = eng.query(q, record=False)
    for cb in (dec.predicted,) + tuple(dec.alternatives):
        if cb.strategy == choice:
            return cb.total
    return dec.predicted.total


def _candidate_queries(site: str, hw):
    """Flip/driver candidate grids for ``site``, SCALE-FREE: the compute,
    memory and validation magnitudes are derived from the calibrated spec
    so the balance points the search needs exist whatever the backend
    measured (a CPU host calibrates peak_flops/hbm_bw orders of magnitude
    below the datasheet)."""
    from repro_torch.core.costs.model import OverheadModel

    model = OverheadModel(hw=hw)
    launch = hw.kernel_launch_s
    peak_eff = hw.peak_flops_bf16 * model.mxu_eff
    bw_eff = hw.hbm_bw * model.mem_eff
    if site == "serve_macro":
        # both perturbed fields scale together, so a flip needs RAGGED
        # remaining budgets (waste per extra lockstep launch) balanced
        # against the once-per-macro sync amortization by a per-step
        # compute/memory term of the same order as the launch itself
        batch = 8
        raggeds = [(r,) + (8,) * (batch - 1) for r in (3, 5, 6, 7)]
        raggeds += [(r, r) + (8,) * (batch - 2) for r in (5, 6, 7)]
        for rem, mem_x, comp_x in itertools.product(
                raggeds, (0.3, 0.8, 1.6, 2.6, 5.0), (0.0, 0.8, 2.0)):
            yield CostQuery.make(
                "serve_macro", (batch,), remaining=rem,
                candidates=(1, 2, 4, 8),
                flops_per_token=comp_x * launch * peak_eff / batch,
                weight_bytes=mem_x * launch * bw_eff,
                kv_bytes_per_slot=0)
    elif site == "serve":
        # optimal chunk ~ sqrt(plen * launch / (active * per_token)): put
        # the per-token compute at launch/g so the optimum sits between
        # the candidate chunks and moves when the launch cost does
        for plen, act, g, mem_x in itertools.product(
                (64, 256), (2, 4, 8), (2, 8, 32, 128), (0.0, 0.5)):
            yield CostQuery.make(
                "serve", (plen,), op="prefill_chunk", active_decodes=act,
                candidates=(1, 4, 16, 64),
                flops_per_token=launch * peak_eff / g,
                weight_bytes=mem_x * launch * bw_eff)
    elif site == "serve_ipc":
        # inline vs worker pipeline: validation cost in units of the
        # calibrated round trip puts the crossover inside the grid
        rt_us = hw.ipc_round_trip_s * 1e6
        for n, vx, mb in itertools.product(
                (4, 16, 64, 256), (0.25, 0.5, 1, 2, 4, 8, 16),
                (256, 4096)):
            yield CostQuery.make(
                "serve_ipc", (n,), op="workers", candidates=(1, 2, 4),
                msg_bytes=mb, validate_us=vx * rt_us)
    else:
        raise ValueError(site)


def _wobble_specs(truth_hw, fields, w_lo=0.7, w_hi=1.45):
    """One spec per (field, factor): the truth spec with that single field
    scaled.  A verdict stable across all of them is robust to the probe
    variance a recalibration will actually land with."""
    specs = []
    for f in fields:
        for w in (w_lo, w_hi):
            specs.append(dataclasses.replace(
                truth_hw, **{f: getattr(truth_hw, f) * w}))
    return specs


def _find_flip(site, truth_hw, pert_hw, sensitive_fields):
    """A query whose verdict differs between truth and perturbed specs and
    is wobble-stable on the truth side."""
    for wobble in (_wobble_specs(truth_hw, sensitive_fields),
                   _wobble_specs(truth_hw, sensitive_fields, 0.85, 1.18)):
        for q in _candidate_queries(site, truth_hw):
            want = _verdict(truth_hw, q)
            if _verdict(pert_hw, q) == want:
                continue
            if all(_verdict(spec, q) == want for spec in wobble):
                return q, want
    raise AssertionError(
        f"chaos search: no wobble-stable flip query found for site {site!r} "
        f"under a {PERTURB}x perturbation — the cost model lost its "
        f"sensitivity to {sensitive_fields}")


def _find_driver(site, truth_hw, pert_hw):
    """A query whose PERTURBED prediction (for the perturbed verdict)
    inflates >= 2x over the truth cost of the same choice: its measured
    rows push the raw drift ratio out of the chaos band."""
    best, best_ratio = None, 0.0
    for q in _candidate_queries(site, truth_hw):
        if site == "serve_ipc":
            q = CostQuery.make(
                "serve_ipc", q.shape, op="workers",
                candidates=q.param("candidates"),
                msg_bytes=q.param("msg_bytes"),
                validate_us=q.param("validate_us"), override="frontend")
        choice = _verdict(pert_hw, q)
        truth_cost = _cost_of(truth_hw, q, choice)
        if truth_cost <= 0:
            continue
        ratio = _cost_of(pert_hw, q, choice) / truth_cost
        if ratio > best_ratio:
            best, best_ratio = q, ratio
        if ratio >= 2.0:
            return q
    raise AssertionError(
        f"chaos search: no drift-driver query for site {site!r} "
        f"(best inflation x{best_ratio:.2f} < 2.0)")


# ---------------------------------------------------------------------------
# the session: the card calibrated, or the CPU's data sheet
# ---------------------------------------------------------------------------

CPU_FINGERPRINT = "cpu-datasheet"


class _SpecProbeEngine(CostEngine):
    """The CPU's engine: a re-probe reads the unperturbed data sheet."""

    def probe_fields(self, fields, *, matmul_order: int = 1024) -> dict:
        return {f: getattr(H100, f) for f in fields}


def _session(rt_cfg: RuntimeConfig, device: str) -> Runtime:
    """A calibrated Runtime on the card; on the CPU one whose calibration
    entry (the H100 data sheet, then whatever the suite heals it to) lives
    in ``rt_cfg.cache_dir``."""
    if device == "cuda":
        return Runtime(rt_cfg, device="cuda")
    path = Path(rt_cfg.cache_dir) / f"{CPU_FINGERPRINT}.json"
    cached = load_calibration(path, fingerprint=CPU_FINGERPRINT)
    if cached is None:
        save_calibration(path, H100, fingerprint=CPU_FINGERPRINT,
                         measurements={})
        cached = {"spec": H100, "corrections": {}}
    cal = CalibrationResult(cached["spec"], CPU_FINGERPRINT, True, {},
                            corrections=cached.get("corrections", {}),
                            path=path, device="cpu")
    ledger = OverheadLedger(drift_window=rt_cfg.drift_window,
                            drift_threshold=rt_cfg.drift_threshold,
                            drift_overrides=rt_cfg.drift_overrides)
    engine = _SpecProbeEngine(hw=cal.spec, calibration=cal, ledger=ledger,
                              corrections=CorrectionState())
    engine.corrections.load(cal.corrections)
    return Runtime(rt_cfg, device="cpu", engine=engine)


# ---------------------------------------------------------------------------
# front-end crash drill (direct, no engine: the respawn path itself)
# ---------------------------------------------------------------------------

def _respawn_drill() -> dict:
    from repro_torch.serving.frontend.workers import (FrontendConfig,
                                                   ServingFrontend)

    fe = ServingFrontend(FrontendConfig(workers=2, respawn=2),
                         max_len=PROMPT_LEN + MAX_NEW)
    fe.start()
    try:
        def subs(tag, n=4):
            return [{"rid": f"{tag}{i}", "prompt": list(range(1, 1 + 4)),
                     "max_new_tokens": 2} for i in range(n)]

        ok, failed = fe.submit(subs("a"))
        if failed or len(ok) != 4:
            raise AssertionError(f"respawn drill baseline: {failed}")
        fe.kill_intake_workers()
        ok2, failed2 = fe.submit(subs("b"))
        if failed2 or len(ok2) != 4:
            raise AssertionError(
                f"respawn drill: crashed intake workers were not healed "
                f"(validated {len(ok2)}, failures {failed2})")
        intake_respawns = fe.respawns
        if intake_respawns < 1:
            raise AssertionError("respawn drill: no intake respawn counted")

        stream = fe.stream()
        stream.publish("b0", (11, 12), False, 0.0)
        stream.publish("b1", (21,), False, 0.0)
        fe.kill_emission_worker()
        stream.publish("b0", (13,), True, 0.1)   # respawn + replay here
        stream.publish("b1", (22,), True, 0.1)
        transcript = fe.finish()
        if fe.respawns <= intake_respawns:
            raise AssertionError("respawn drill: no emission respawn counted")
        if transcript["b0"]["tokens"] != [11, 12, 13] \
                or transcript["b1"]["tokens"] != [21, 22]:
            raise AssertionError(
                f"respawn drill: transcript lost tokens across the emission "
                f"crash: { {r: t['tokens'] for r, t in transcript.items()} }")
        return {"respawns": fe.respawns, "transcript_intact": True}
    finally:
        fe.close()


# ---------------------------------------------------------------------------
# the suite
# ---------------------------------------------------------------------------

def run(csv=True, runtime=None, out=None, smoke: bool = True,
        check_recovery: bool = False, model=None, params=None):
    """``model``/``params``: the serve stage's (the tests pass the
    reference's parameters); else random from seed 0."""
    caller = session(runtime)
    out = out_dir(out)
    dev = caller.device
    path = out / BENCH_JSON
    t0 = time.perf_counter()

    def elapsed() -> str:  # the stage's end, seconds into the suite
        return f",t_s={time.perf_counter() - t0:.1f}"

    cache = Path(tempfile.mkdtemp(prefix="chaos-", dir=out))
    overrides = {s: {"threshold": DRIFT_BAND} for s in CHAOS_SITES}
    rt_cfg = RuntimeConfig(calibrate=dev.type == "cuda", corrections=True,
                           cache_dir=cache, drift_overrides=overrides)
    rt = _session(rt_cfg, dev.type)
    engine = rt.engine
    truth_hw = engine.hw
    print(f"chaos_bench,stage=calibrate,device={dev.type},cache={cache},"
          f"host_sync_us={truth_hw.host_sync_s*1e6:.1f},"
          f"kernel_launch_us={truth_hw.kernel_launch_s*1e6:.1f},"
          f"ipc_rt_us={truth_hw.ipc_round_trip_s*1e6:.1f}{elapsed()}")

    # --- search (on the analytic model only; nothing ledgered yet) ---
    pert_hw = dataclasses.replace(
        truth_hw, **{f: getattr(truth_hw, f) * PERTURB
                     for f in PERTURBED_FIELDS})
    # wobble over EVERY field a recalibration of that site may touch
    # (hw.SITE_FIELDS), not just the perturbed ones — re-probed fields land
    # near truth, not on it, and the flip verdict must survive that
    from repro_torch.hw import SITE_FIELDS
    site_fields = {s: tuple(SITE_FIELDS[s]) for s in CHAOS_SITES}
    flips = {s: _find_flip(s, truth_hw, pert_hw, site_fields[s])
             for s in CHAOS_SITES}
    drivers = {s: _find_driver(s, truth_hw, pert_hw) for s in CHAOS_SITES}
    for s, (q, want) in flips.items():
        print(f"chaos_bench,stage=search,site={s},truth_verdict={want},"
              f"perturbed_verdict={_verdict(pert_hw, q)}")

    # --- perturb: the spec lies by 4x, the clock by ~8% ---
    engine.perturb_hw(**{f: getattr(truth_hw, f) * PERTURB
                         for f in PERTURBED_FIELDS})
    rng = np.random.default_rng(0)
    engine.measurement_noise = lambda site: float(
        rng.lognormal(0.0, NOISE_SIGMA))
    flipped = {s: _verdict(engine.hw, flips[s][0]) != flips[s][1]
               for s in CHAOS_SITES}
    if not all(flipped.values()):
        raise AssertionError(
            f"perturbation did not flip the searched verdicts: {flipped}")

    # --- reconverge: measured rows (truth cost + noise) until the drift
    # trigger re-probes the perturbed fields and verdicts return ---
    measured_rows = 0
    converged_at = None
    recal_log = []
    for rnd in range(MAX_ROUNDS):
        for s in CHAOS_SITES:
            dq = drivers[s]
            for _ in range(ROWS_PER_ROUND):
                dec = engine.query(dq)
                truth_cost = _cost_of(truth_hw, dq, dec.choice)
                engine.record_measured(dec, truth_cost, note="chaos")
                measured_rows += 1
        res = engine.maybe_recalibrate(min_rows=RECAL_MIN_ROWS)
        if res["updates"]:
            recal_log.append(res)
        verdicts = {s: engine.query(flips[s][0], record=False).choice
                    for s in CHAOS_SITES}
        ok = all(verdicts[s] == flips[s][1] for s in CHAOS_SITES)
        print(f"chaos_bench,stage=reconverge,round={rnd},"
              f"measured_rows={measured_rows},"
              f"recalibrated={sorted(res['updates'])},"
              f"converged={ok}")
        if ok:
            converged_at = measured_rows
            break
    engine.measurement_noise = None
    if converged_at is None or converged_at > MEASUREMENT_BUDGET:
        raise AssertionError(
            f"chaos recovery failed: verdicts did not reconverge within "
            f"{MEASUREMENT_BUDGET} ledgered measurements "
            f"(got {converged_at}, rows {measured_rows}, "
            f"recalibrations {recal_log})")
    if engine.perturbed_fields:
        raise AssertionError(
            f"recalibration left perturbed fields unhealed: "
            f"{engine.perturbed_fields}")
    healed = {f: getattr(engine.hw, f) / getattr(truth_hw, f)
              for f in PERTURBED_FIELDS}
    print(f"chaos_bench,stage=healed,converged_at_rows={converged_at}," +
          ",".join(f"{f}_vs_truth_x={v:.2f}" for f, v in healed.items())
          + elapsed())

    # --- rollback: plant a harmful factor on a healthy site, then feed
    # accurate rows until a full regret window rolls it back ---
    q_sort = CostQuery.make("sort", (1_000_000,))
    base = engine.query(q_sort, record=False)
    base_pred = base.predicted.total / base.correction
    cs = engine.corrections
    for _ in range(3):            # harmful: measured 4x the prediction
        dec = engine.query(q_sort)
        engine.record_measured(dec, 4.0 * base_pred, note="chaos-harm")
    planted = cs.factor("sort")
    rolled = False
    accurate_rows = 0
    while accurate_rows < 2 * cs.regret_window and not rolled:
        dec = engine.query(q_sort)
        engine.record_measured(dec, base_pred, note="chaos-accurate")
        accurate_rows += 1
        rolled = cs.site("sort").rollbacks >= 1
    if planted < 2.0 or not rolled or abs(cs.factor("sort") - 1.0) > 1e-9:
        raise AssertionError(
            f"rollback drill failed: planted x{planted:.2f}, "
            f"rolled_back={rolled}, factor now x{cs.factor('sort'):.2f}")
    print(f"chaos_bench,stage=rollback,planted_x={planted:.2f},"
          f"accurate_rows_to_rollback={accurate_rows},"
          f"rollbacks={cs.site('sort').rollbacks}{elapsed()}")

    # --- a surviving (in-band, helpful) factor for the restart check ---
    q_scan = CostQuery.make("scan_chunk", (256, 1, 4, 64))
    sdec = engine.query(q_scan, record=False)
    scan_pred = sdec.predicted.total / sdec.correction
    for _ in range(4):
        dec = engine.query(q_scan)
        engine.record_measured(dec, 2.0 * scan_pred, note="chaos-bias")
    survivor = cs.factor("scan_chunk")
    if not 1.5 <= survivor <= 2.5:
        raise AssertionError(
            f"survivor factor drill: expected ~x2, got x{survivor:.2f}")

    # --- serve: token identity with the correction loop live ---
    from repro_torch.benches.serving_bench import sharded_config

    cfg = bench_config(dev, CUT_LAYERS)
    model, params = model_and_params(cfg, dev, model, params)
    common = dict(model=model, params=params, max_len=PROMPT_LEN + MAX_NEW,
                  eos_id=0, slots=SLOTS)
    static = rt.serve(cfg, _trace(cfg), mode="static", **common)
    runs = {
        "dense": rt.serve(cfg, _trace(cfg), mode="continuous", **common),
        "paged": rt.serve(cfg, _trace(cfg), mode="continuous", paged=True,
                          block_size=4, **common),
        "frontend": rt.serve(cfg, _trace(cfg), mode="continuous",
                             frontend=2, stream=True, **common),
    }
    identical = {}
    for label, res in runs.items():
        if not res.report.all_terminal:
            raise AssertionError(f"chaos serve {label}: non-terminal requests")
        identical[label] = all(
            np.array_equal(res.outputs[rid], static.outputs[rid])
            for rid in static.outputs)
    identical["sharded"] = _sharded_identical(dev, cfg, model, params,
                                              sharded_config)
    if not all(identical.values()):
        raise AssertionError(
            f"token identity broke under the correction loop: {identical}")
    fe_respawns = runs["frontend"].report.frontend_respawns
    print("chaos_bench,stage=serve," +
          ",".join(f"{k}_identical={v}" for k, v in sorted(identical.items()))
          + f",frontend_respawns={fe_respawns}{elapsed()}")

    # --- respawn: crash drills against the self-healing front end ---
    drill = _respawn_drill()
    print(f"chaos_bench,stage=respawn,respawns={drill['respawns']},"
          f"transcript_intact={drill['transcript_intact']}{elapsed()}")

    # --- restart: a second Runtime on the same cache dir inherits the
    # healed spec and the surviving correction factors ---
    engine.save_state()
    rt2 = _session(rt_cfg, dev.type)
    for f in PERTURBED_FIELDS:
        a, b = getattr(rt2.engine.hw, f), getattr(engine.hw, f)
        if not np.isclose(a, b, rtol=1e-9):
            raise AssertionError(
                f"restart lost the healed spec: {f} {a} != {b}")
    inherited = rt2.engine.corrections.factor("scan_chunk")
    if not np.isclose(inherited, cs.factor("scan_chunk"), rtol=1e-6):
        raise AssertionError(
            f"restart lost the correction factor: x{inherited:.3f} != "
            f"x{cs.factor('scan_chunk'):.3f}")
    rb2 = rt2.engine.corrections.site("sort")
    if rb2 is None or rb2.rollbacks < 1:
        raise AssertionError("restart lost the rollback count")
    print(f"chaos_bench,stage=restart,spec_inherited=True,"
          f"factor_inherited_x={inherited:.2f},"
          f"rollbacks_inherited={rb2.rollbacks}{elapsed()}")

    chaos = {
        "perturbed_fields": {f: PERTURB for f in PERTURBED_FIELDS},
        "noise_sigma": NOISE_SIGMA,
        "sites": list(CHAOS_SITES),
        "flips": {s: {"truth": flips[s][1]} for s in CHAOS_SITES},
        "converged_at_rows": converged_at,
        "measurement_budget": MEASUREMENT_BUDGET,
        "healed_vs_truth": healed,
        "rollback": {"planted_x": planted,
                     "accurate_rows_to_rollback": accurate_rows},
        "survivor_factor_x": survivor,
        "token_identical": identical,
        "frontend_respawns": drill["respawns"],
        "restart_inherited": True,
    }
    result = load_json(path)  # read-modify-write: the other suites' keys
    result["chaos"] = chaos
    write_json(path, result)
    print(f"chaos_bench,recovered=True,converged_at_rows={converged_at},"
          f"budget={MEASUREMENT_BUDGET},json={path}")
    if check_recovery:
        # every recovery property above is asserted unconditionally; the
        # flag exists for CLI parity with the other CI gates and makes the
        # gate's verdict explicit in the step output
        print("chaos_bench,recovery_check=ok")
    return chaos


def _sharded_identical(dev, cfg, model, params, sharded_config) -> bool:
    """The trace on ``{"data": 1, "model": 8}`` positions of the device
    (shard forced) in a fresh Runtime with corrections on, token-identical
    to a static serve of the same model (on the card the sharded row's fp32
    model, as ``serving_bench`` serves it)."""
    rt = Runtime(RuntimeConfig(corrections=True), device=dev.type)
    scfg = sharded_config(cfg, dev)
    if scfg is not cfg:
        model = params = None
    model, params = model_and_params(scfg, dev, model, params)
    common = dict(model=model, params=params, max_len=PROMPT_LEN + MAX_NEW,
                  eos_id=0)
    static = rt.serve(scfg, _trace(scfg), mode="static", **common)
    res = rt.serve(scfg, _trace(scfg), mode="continuous", slots=SLOTS,
                   mesh_shape={"data": 1, "model": SHARD_DEVICES},
                   shard_params="shard", shards_per_device=SHARD_DEVICES,
                   **common)
    if not res.report.all_terminal:
        raise AssertionError("chaos sharded run: non-terminal requests")
    return all(np.array_equal(np.asarray(res.outputs[rid]),
                              np.asarray(static.outputs[rid]))
               for rid in static.outputs)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke sizing (the default; kept for parity "
                         "with the other gates)")
    ap.add_argument("--check-recovery", action="store_true",
                    help="assert the full recovery contract: verdicts "
                         f"reconverge within {MEASUREMENT_BUDGET} ledgered "
                         "rows, harmful corrections roll back, workers "
                         "respawn, healed state survives a Runtime restart")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args()
    run(runtime=Runtime(device=args.device), out=args.out, smoke=args.smoke,
        check_recovery=args.check_recovery)
