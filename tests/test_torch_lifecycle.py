"""The port's serving request lifecycle against the reference's, on the CPU,
at reduced size (tinyllama-1.1b reduced: 2 layers, fp32), on the
reference's parameters carried across by ``params_from_jax``.

Every case runs the same requests through ``repro.serving``'s and
``repro_torch.serving``'s ``ContinuousServeEngine``, the port's engine
priced on the reference's default hardware spec so the two make the same
decisions, and holds them equal request by request: state, reason, tokens
(no tolerance), preemptions, retries, and every timestamped transition
(the virtual clocks advance per call, so equal stamps mean the same
admission order and the same number of clock reads); then the reference
test's own assertions hold on the port.

* all 18 tests of ``tests/test_serving_robust.py``: typed validation, the
  unperturbed path (no thread, no serve_admit query), the bounded queue,
  deadlines queued and decoding, ``deadline_infeasible`` shedding,
  priority preemption, the raise / nan / stall fault classes, exhausted
  retries, a fatal abort, drift reports on the port's ledger and engine,
  and graceful stops;
* the three paged lifecycle tests of ``tests/test_serving_paged.py``:
  preemption releases the victim's pages and re-pins its prefix, deadline
  eviction releases a paged slot, a fatal abort drains the BlockPool;
* two traces (3 requests, 1 slot, a clock advancing 1 s a call): a
  ``deadline_s=0.5`` request ends TIMED_OUT, a ``priority=5`` third
  request is admitted first, at the reference's virtual times;
* the port only: a step abandoned by the watchdog (a thunk that ignores
  cancellation, then writes into the pools it captured) fails what is in
  flight, and the drained pool holds new tensors the late write cannot
  reach; the watchdog's worker thread builds no autograd graph;
* the launcher ``python -m repro_torch.launch.serve --device cpu
  --reduced``, in a subprocess: the robustness flags give the reference
  launcher's report, SIGINT after the first tokens exits 0 with the queue
  rejected, and malformed serve-mesh options (``--mesh``,
  ``--serve-shard``, ``--shards-per-device``) fail at argument parsing
  with the reference launcher's messages.
"""

import os
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.core.costs.ledger import OverheadLedger as JLedger  # noqa: E402
from repro.core.costs.model import CostBreakdown as JBreakdown  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro.serving import ContinuousServeEngine as JContinuous  # noqa: E402
from repro.serving import FatalFault as JFatal  # noqa: E402
from repro.serving import FaultInjector as JInjector  # noqa: E402
from repro.serving import FaultSpec as JSpec  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.costs.ledger import OverheadLedger  # noqa: E402
from repro_torch.core.costs.model import CostBreakdown  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    FatalFault,
    FaultInjector,
    FaultSpec,
    InvalidRequestError,
    Request,
    RequestState,
    StepFailed,
)

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LEN = 7
MAX_NEW = 9
MAX_LEN = PROMPT_LEN + MAX_NEW
BLOCK = 4


@pytest.fixture(scope="module")
def llama():
    jcfg = j_get_config("tinyllama-1.1b").reduced()
    cfg = get_config("tinyllama-1.1b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jmodel, jparams, model, params


def _spec_engine():
    """The port's CostEngine on the reference's default spec, so its
    decisions (horizons, chunks, admit verdicts) are the reference's."""
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _prompts(cfg, b, p=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, p)).astype(np.int32)


def _tick_clock(dt=1e-3):
    """Deterministic advancing clock: every now() call moves time forward,
    so outcomes do not depend on the host's speed."""
    t = [0.0]

    def now():
        t[0] += dt
        return t[0]

    return now


class Pair:
    """One engine configuration in both packages."""

    def __init__(self, llama, *, faults=(), **kw):
        _, jmodel, jparams, model, params = llama
        kw.setdefault("n_slots", 2)
        kw.setdefault("max_len", MAX_LEN)
        kw.setdefault("eos_id", 0)
        self.jcost = JCostEngine(hw=V5E)
        self.cost = _spec_engine()
        self.ref = JContinuous(
            jmodel, jparams, cost_engine=self.jcost,
            injector=(JInjector(tuple(JSpec(**f) for f in faults))
                      if faults else None), **kw)
        self.port = ContinuousServeEngine(
            model, params, cost_engine=self.cost,
            injector=(FaultInjector(tuple(FaultSpec(**f) for f in faults))
                      if faults else None), **kw)

    def set(self, **attrs):
        for eng in (self.ref, self.port):
            for k, v in attrs.items():
                setattr(eng, k, v)

    def run(self, reqs, clock=lambda: (lambda: 0.0), raises=None):
        """Run ``reqs`` (rid, prompt, max_new, Request kwargs) through both
        engines, each with a fresh ``clock()``.  Returns (reference
        requests, reference report, port requests, port report); a report
        is the raised exception when ``raises`` (one exception class, or a
        (reference, port) pair of them) is given."""
        out = []
        if not isinstance(raises, tuple):
            raises = (raises, raises)
        for eng, make, exc in ((self.ref, JRequest, raises[0]),
                               (self.port, Request, raises[1])):
            rs = [make(rid, p, n, **kw) for rid, p, n, kw in reqs]
            if exc is None:
                rep = eng.run(rs, now_fn=clock())
            else:
                with pytest.raises(exc) as info:
                    eng.run(rs, now_fn=clock())
                rep = info.value
            out += [rs, rep]
        return tuple(out)


def _fates(reqs):
    """Everything a request's run decided, for a package-to-package
    comparison: state, reason, tokens, preemptions, retries and every
    timestamped transition."""
    return {r.rid: dict(state=r.state.value, reason=r.reason,
                        tokens=[int(t) for t in r.tokens],
                        preemptions=r.preemptions, retries=r.retries,
                        history=[(s, float(t)) for s, t in r.history])
            for r in reqs}


def _same(jreqs, jrep, reqs, rep):
    assert _fates(reqs) == _fates(jreqs)
    if not isinstance(rep, BaseException):
        for k in ("step_retries", "watchdog_fires", "preemptions",
                  "host_syncs", "prefix_hit_tokens", "prefilled_tokens"):
            assert getattr(rep, k) == getattr(jrep, k), k
        assert rep.state_counts() == jrep.state_counts()


def _tokens(reqs):
    return {r.rid: [int(t) for t in r.tokens] for r in reqs}


def _solo(llama, prompt, max_new, **kw):
    """Tokens of the request served alone on a fresh port engine (the
    reference test's ``_solo_tokens``), checked against the reference's."""
    pair = Pair(llama, n_slots=1, **kw)
    jr, _, r, _ = pair.run([("solo", prompt, max_new, {})])
    assert _tokens(r) == _tokens(jr)
    return _tokens(r)["solo"]


def _clean(llama, prompts, **kw):
    pair = Pair(llama, **kw)
    jr, jrep, r, rep = pair.run([(f"r{i}", prompts[i], MAX_NEW, {})
                                 for i in range(len(prompts))])
    _same(jr, jrep, r, rep)
    return _tokens(r)


# ---------------------------------------------------------------------------
# Fail-fast validation
# ---------------------------------------------------------------------------


def test_invalid_requests_raise_typed_error_naming_rid(llama):
    cfg = llama[0]
    ok = _prompts(cfg, 1)[0]
    bad = [("empty", np.zeros((0,), np.int32), MAX_NEW, {}),
           ("nonew", ok, 0, {}),
           ("toolong", ok, MAX_LEN, {}),
           ("baddl", ok, MAX_NEW, {"deadline_s": -1.0}),
           ("badttft", ok, MAX_NEW, {"ttft_deadline_s": 0.0})]
    pair = Pair(llama)
    for spec in bad:
        _, jerr, _, err = pair.run([spec], raises=ValueError)
        assert isinstance(err, InvalidRequestError)
        assert spec[0] in str(err)
        assert str(err) == str(jerr)
    _, _, _, err = pair.run([("toolong", ok, MAX_LEN, {})],
                            raises=ValueError)
    assert "exceeds max_len" in str(err)
    jr, jrep, r, rep = pair.run([("r0", ok, MAX_NEW, {})])
    _same(jr, jrep, r, rep)
    assert r[0].state == RequestState.COMPLETED


# ---------------------------------------------------------------------------
# Lifecycle on the unperturbed path
# ---------------------------------------------------------------------------


def test_unperturbed_run_records_lifecycle_without_extra_machinery(llama):
    cfg = llama[0]
    prompts = _prompts(cfg, 3)
    pair = Pair(llama)
    started = []
    start = threading.Thread.start

    def counting_start(self, *a, **kw):
        started.append(self)
        return start(self, *a, **kw)

    threading.Thread.start = counting_start
    try:
        t0 = time.perf_counter()
        reqs = [(f"r{i}", prompts[i], MAX_NEW, {}) for i in range(3)]
        rs = [Request(*x[:3]) for x in reqs]
        rep = pair.port.run(rs, now_fn=lambda: 0.0)
        assert time.perf_counter() > t0
    finally:
        threading.Thread.start = start
    assert started == []  # the direct call: no worker thread
    jrs = [JRequest(*x[:3]) for x in reqs]
    jrep = pair.ref.run(jrs, now_fn=lambda: 0.0)
    _same(jrs, jrep, rs, rep)
    assert rep.all_terminal
    assert rep.state_counts() == {"COMPLETED": 3}
    for r in rep.requests:
        seen = [s for s, _ in r.history]
        assert seen[0] == "PREFILLING" and seen[-1] == "COMPLETED"
        assert "DECODING" in seen
    d = rep.as_dict()
    assert d["all_terminal"] and d["states"] == {"COMPLETED": 3}
    assert d["step_retries"] == 0 and d["watchdog_fires"] == 0
    assert d["preemptions"] == 0
    assert [x["state"] for x in d["requests"]] == ["COMPLETED"] * 3
    # no deadlines anywhere => the admit cost site is never even queried
    assert not [e for e in pair.cost.ledger.entries
                if e.site == "serve_admit"]
    assert [e.site for e in pair.cost.ledger.entries] == \
        [e.site for e in pair.jcost.ledger.entries]


# ---------------------------------------------------------------------------
# Backpressure + deadlines
# ---------------------------------------------------------------------------


def test_bounded_queue_sheds_overflow_with_typed_reason(llama):
    prompts = _prompts(llama[0], 4)
    pair = Pair(llama, n_slots=1, queue_limit=1)
    jr, jrep, r, rep = pair.run([(f"r{i}", prompts[i], MAX_NEW, {})
                                 for i in range(4)])
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    counts = rep.state_counts()
    assert counts["REJECTED"] == 3 and counts["COMPLETED"] == 1
    for q in rep.requests:
        if q.state == RequestState.REJECTED:
            assert q.reason == "queue_full"
            assert not q.tokens


def test_deadline_expires_while_queued(llama):
    prompts = _prompts(llama[0], 2)
    pair = Pair(llama, n_slots=1)
    jr, jrep, r, rep = pair.run(
        [("hog", prompts[0], MAX_NEW, {}),
         ("late", prompts[1], MAX_NEW, {"deadline_s": 1e-3})],
        clock=_tick_clock)
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    late = rep.requests[1]
    assert late.state == RequestState.TIMED_OUT
    assert "queued" in late.reason
    assert rep.requests[0].state == RequestState.COMPLETED


def test_deadline_enforced_at_macro_step_boundary_while_decoding(llama):
    prompts = _prompts(llama[0], 1)
    pair = Pair(llama, n_slots=1, macro_step=1, eos_id=-1)
    jr, jrep, r, rep = pair.run(
        [("r0", prompts[0], MAX_NEW, {"deadline_s": 0.05})],
        clock=lambda: _tick_clock(dt=5e-3))
    _same(jr, jrep, r, rep)
    req = r[0]
    assert rep.all_terminal
    assert req.state == RequestState.TIMED_OUT
    assert "decoding" in req.reason
    assert 0 < len(req.tokens) < MAX_NEW  # evicted mid-stream, slot freed
    assert pair.port.pool.free_count == 1


def test_admission_sheds_infeasible_deadline_as_costed_decision(llama):
    prompts = _prompts(llama[0], 2)
    pair = Pair(llama)
    jr, jrep, r, rep = pair.run(
        [("ok", prompts[0], MAX_NEW, {}),
         ("doomed", prompts[1], MAX_NEW, {"deadline_s": 1e-12})])
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    assert r[0].state == RequestState.COMPLETED
    assert r[1].state == RequestState.REJECTED
    assert r[1].reason == "deadline_infeasible"
    rows = [e for e in pair.cost.ledger.entries if e.site == "serve_admit"]
    jrows = [e for e in pair.jcost.ledger.entries if e.site == "serve_admit"]
    assert rows and any(e.choice == "shed" for e in rows)
    assert all(e.predicted_s >= 0 for e in rows)
    assert [(e.choice, e.query["slack_us"]) for e in rows] == \
        [(e.choice, e.query["slack_us"]) for e in jrows]
    assert [e.predicted_s for e in rows] == pytest.approx(
        [e.predicted_s for e in jrows], rel=1e-9)


# ---------------------------------------------------------------------------
# Priority preemption
# ---------------------------------------------------------------------------


def test_preempted_request_resumes_token_identical(llama):
    prompts = _prompts(llama[0], 2, seed=5)
    pair = Pair(llama, n_slots=1, macro_step=1, eos_id=-1)
    jr, jrep, r, rep = pair.run(
        [("low", prompts[0], MAX_NEW, {"priority": 0}),
         ("high", prompts[1], MAX_NEW, {"arrival_s": 0.01, "priority": 5})],
        clock=_tick_clock)
    _same(jr, jrep, r, rep)
    low, high = r
    assert rep.all_terminal
    assert rep.state_counts() == {"COMPLETED": 2}
    assert low.preemptions >= 1 and rep.preemptions >= 1
    seen = [s for s, _ in low.history]
    assert "PREEMPTED" in seen
    assert seen.index("PREEMPTED") < len(seen) - 1  # re-queued after
    # greedy resume (re-prefill prompt + generated-so-far) is exact
    assert list(low.tokens) == _solo(llama, prompts[0], MAX_NEW, eos_id=-1)
    assert list(high.tokens) == _solo(llama, prompts[1], MAX_NEW, eos_id=-1)
    assert low.admitted_s is not None and low.first_token_s is not None


# ---------------------------------------------------------------------------
# Fault classes
# ---------------------------------------------------------------------------


def test_transient_raise_retries_to_token_identical_finish(llama):
    prompts = _prompts(llama[0], 2)
    clean = _clean(llama, prompts, macro_step=1)
    pair = Pair(llama, macro_step=1,
                faults=[dict(kind="raise", site="macro", after=1)])
    jr, jrep, r, rep = pair.run([(f"r{i}", prompts[i], MAX_NEW, {})
                                 for i in range(2)])
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 2}
    assert rep.step_retries >= 1
    assert any(q.retries >= 1 for q in rep.requests)
    assert _tokens(r) == clean


def test_exhausted_retries_fail_inflight_and_engine_recovers(llama):
    prompts = _prompts(llama[0], 2)
    clean = _clean(llama, prompts, macro_step=1)
    pair = Pair(llama, macro_step=1, max_retries=1,
                faults=[dict(kind="raise", site="macro", after=0,
                             count=100)])
    reqs = [(f"r{i}", prompts[i], MAX_NEW, {}) for i in range(2)]
    jr, jrep, r, rep = pair.run(reqs)
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    for q in rep.requests:
        assert q.state == RequestState.FAILED
        assert "macro step failed" in q.reason
    assert pair.port.pool.free_count == pair.port.pool.n_slots
    pair.set(injector=None)
    jr, jrep, r, rep = pair.run(reqs)
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 2}
    assert _tokens(r) == clean


def test_nan_fault_fails_only_the_poisoned_request(llama):
    prompts = _prompts(llama[0], 2)
    clean = _clean(llama, prompts, macro_step=1)
    pair = Pair(llama, macro_step=1,
                faults=[dict(kind="nan", site="macro", after=0)])
    jr, jrep, r, rep = pair.run([(f"r{i}", prompts[i], MAX_NEW, {})
                                 for i in range(2)])
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    assert rep.state_counts() == {"COMPLETED": 1, "FAILED": 1}
    failed = next(q for q in rep.requests if q.state == RequestState.FAILED)
    assert "corrupt" in failed.reason
    survivor = next(q for q in rep.requests
                    if q.state == RequestState.COMPLETED)
    assert list(survivor.tokens) == clean[survivor.rid]


def test_stalled_step_is_watchdogged_cancelled_and_retried(llama):
    prompts = _prompts(llama[0], 1)
    pair = Pair(llama, macro_step=1)
    jr, jrep, r, rep = pair.run([("r0", prompts[0], MAX_NEW, {})])
    clean = _tokens(r)
    assert clean == _tokens(jr)
    pair.ref.watchdog_s = pair.port.watchdog_s = 0.5
    pair.ref.injector = JInjector((JSpec("stall", site="macro", after=1,
                                         stall_s=30.0),))
    pair.port.injector = FaultInjector((FaultSpec("stall", site="macro",
                                                  after=1, stall_s=30.0),))
    jr, jrep, r, rep = pair.run([("r0", prompts[0], MAX_NEW, {})])
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 1}
    assert rep.watchdog_fires >= 1 and rep.step_retries >= 1
    assert _tokens(r) == clean


def test_fatal_abort_leaves_slots_released_and_state_valid(llama):
    prompts = _prompts(llama[0], 2, seed=11)
    clean = _clean(llama, prompts, macro_step=1)
    pair = Pair(llama, macro_step=1,
                faults=[dict(kind="raise", site="macro", after=0,
                             fatal=True)])
    reqs = [(f"r{i}", prompts[i], MAX_NEW, {}) for i in range(2)]
    jr, _, r, err = pair.run(reqs, raises=(JFatal, FatalFault))
    assert _fates(r) == _fates(jr)
    assert all(q.state.terminal for q in r)
    assert all(q.state == RequestState.FAILED for q in r if q.tokens)
    assert pair.port.pool.free_count == pair.port.pool.n_slots
    pair.set(injector=None)
    jr, jrep, r, rep = pair.run(reqs)
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 2}
    assert _tokens(r) == clean


# ---------------------------------------------------------------------------
# Calibration drift surfacing: the port's ledger and engine
# ---------------------------------------------------------------------------


def _drift_rows(ledger, breakdown, site, n, predicted, measured):
    for _ in range(n):
        e = ledger.record(site, {"op": "t"}, "x", breakdown(predicted))
        e.measured_s = measured


def _bd(cls):
    return lambda total: cls(strategy="x", compute=total, memory=0.0,
                             collective=0.0, fixed=0.0)


def test_drift_report_flags_only_drifting_sites():
    out = []
    for ledger, bd in ((JLedger(), _bd(JBreakdown)),
                       (OverheadLedger(), _bd(CostBreakdown))):
        _drift_rows(ledger, bd, "matmul", 10, 1e-3, 1.1e-3)
        _drift_rows(ledger, bd, "serve", 10, 1e-3, 5e-3)
        out.append((ledger.drift(window=20, threshold=3.0), ledger.report()))
    (jdrift, _), (drift, report) = out
    assert drift == jdrift
    assert not drift["matmul"]["drifting"]
    assert drift["serve"]["drifting"]
    assert drift["serve"]["geomean_ratio"] == pytest.approx(5.0)
    assert "calibration drift" in report and "serve" in report
    assert "matmul: measured/predicted" not in report


def test_drift_window_ages_out_warmup_rows():
    out = []
    for ledger, bd in ((JLedger(), _bd(JBreakdown)),
                       (OverheadLedger(), _bd(CostBreakdown))):
        _drift_rows(ledger, bd, "serve", 5, 1e-3, 0.1)
        _drift_rows(ledger, bd, "serve", 20, 1e-3, 1e-3)
        out.append(ledger.drift(window=20))
    assert out[1] == out[0]
    assert not out[1]["serve"]["drifting"]


def test_cost_engine_drift_report_delegates_to_its_ledger():
    out = []
    for engine, bd in ((JCostEngine(), _bd(JBreakdown)),
                       (CostEngine(), _bd(CostBreakdown))):
        _drift_rows(engine.ledger, bd, "sort", 3, 1e-4, 1e-2)
        out.append(engine.drift_report(window=10, threshold=3.0))
    assert out[1] == out[0]
    assert out[1]["sort"]["drifting"]


# ---------------------------------------------------------------------------
# Graceful shutdown: stop intake, drain in-flight, report still returned
# ---------------------------------------------------------------------------


def test_request_stop_before_run_rejects_everything_typed(llama):
    prompts = _prompts(llama[0], 3)
    pair = Pair(llama)
    for eng in (pair.ref, pair.port):
        eng.request_stop()
    jr, jrep, r, rep = pair.run([(f"r{i}", prompts[i], 3, {})
                                 for i in range(3)])
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    assert rep.state_counts() == {"REJECTED": 3}
    assert all(q.reason == "shutdown: intake stopped" for q in r)
    for eng in (pair.ref, pair.port):
        eng.reset_stop()
    jr, jrep, r, rep = pair.run([(f"s{i}", prompts[i], 3, {})
                                 for i in range(3)])
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 3}


class _TripAfter:
    """Event that 'fires' once the engine has polled it a few times:
    a deterministic mid-run shutdown without wall-clock races."""

    def __init__(self, polls):
        self.left = polls

    def is_set(self):
        self.left -= 1
        return self.left < 0


def test_stop_event_mid_run_drains_active_and_rejects_queued(llama):
    prompts = _prompts(llama[0], 3)
    pair = Pair(llama)
    pair.ref.stop_event = _TripAfter(1)
    pair.port.stop_event = _TripAfter(1)
    jr, jrep, r, rep = pair.run(
        [("r0", prompts[0], MAX_NEW, {}), ("r1", prompts[1], MAX_NEW, {}),
         ("late", prompts[2], 3, {"arrival_s": 1e9})])
    _same(jr, jrep, r, rep)
    assert rep.all_terminal
    by = {q.rid: q for q in rep.requests}
    assert by["late"].state is RequestState.REJECTED
    assert "shutdown" in (by["late"].reason or "")
    assert by["r0"].state is RequestState.COMPLETED
    assert by["r1"].state is RequestState.COMPLETED


def test_runtime_serve_stop_event_returns_report(llama):
    cfg, jmodel, jparams, model, params = llama
    prompts = _prompts(cfg, 2)
    ev = threading.Event()
    ev.set()  # shutdown already requested
    jres = JRuntime().serve(
        j_get_config("tinyllama-1.1b").reduced(),
        [JRequest(f"r{i}", prompts[i], 3) for i in range(2)],
        mode="continuous", model=jmodel, params=jparams, max_len=MAX_LEN,
        eos_id=0, slots=2, stop_event=ev)
    res = Runtime(device="cpu").serve(
        cfg, [Request(f"r{i}", prompts[i], 3) for i in range(2)],
        mode="continuous", model=model, params=params, max_len=MAX_LEN,
        eos_id=0, slots=2, stop_event=ev)
    assert res.report.all_terminal
    assert res.report.state_counts() == {"REJECTED": 2} == \
        jres.report.state_counts()
    assert [q.reason for q in res.report.requests] == \
        [q.reason for q in jres.report.requests]


def test_runtime_serve_checks_robustness_arguments_as_the_reference(llama):
    cfg, jmodel, jparams, model, params = llama
    prompt = _prompts(cfg, 1)[0]
    rt, jrt = Runtime(device="cpu"), JRuntime()
    jcfg = j_get_config("tinyllama-1.1b").reduced()
    for kw in (dict(inject_fault="boom"), dict(deadline_ms=0),
               dict(ttft_deadline_ms=-1.0), dict(queue_limit=0),
               dict(watchdog_ms=0), dict(inject_fault="stall"),
               dict(mode="static", queue_limit=2)):
        with pytest.raises(ValueError) as jerr:
            jrt.serve(jcfg, [JRequest("r0", prompt, 3)], model=jmodel,
                      params=jparams, **kw)
        with pytest.raises(ValueError) as err:
            rt.serve(cfg, [Request("r0", prompt, 3)], model=model,
                     params=params, **kw)
        assert str(err.value) == str(jerr.value)
    # the defaults reach requests without their own, a fault is injected
    # after warmup and retried to the clean tokens
    out = []
    for serve, make, m, p, c in ((jrt.serve, JRequest, jmodel, jparams,
                                  jcfg),
                                 (rt.serve, Request, model, params, cfg)):
        reqs = [make("r0", prompt, MAX_NEW),
                make("r1", prompt, MAX_NEW, deadline_s=30.0)]
        res = serve(c, reqs, model=m, params=p, slots=1, max_len=MAX_LEN,
                    eos_id=-1, macro_step=1, deadline_ms=60000,
                    ttft_deadline_ms=50000, inject_fault="raise",
                    watchdog_ms=5000, queue_limit=4)
        out.append((res.report.as_dict()["step_retries"],
                    [(q.deadline_s, q.ttft_deadline_s) for q in reqs],
                    _tokens(reqs), res.report.state_counts()))
    assert out[1] == out[0]
    assert out[1][0] == 1
    assert out[1][1] == [(60.0, 50.0), (30.0, 50.0)]


# ---------------------------------------------------------------------------
# Paged lifecycle (tests/test_serving_paged.py)
# ---------------------------------------------------------------------------


def test_paged_preemption_releases_blocks_and_resume_repins_prefix(llama):
    prompts = _prompts(llama[0], 2, seed=5)
    pair = Pair(llama, n_slots=1, macro_step=1, eos_id=-1, paged=True,
                block_size=BLOCK, kv_blocks=16, prefix_cache="force")
    jr, jrep, r, rep = pair.run(
        [("low", prompts[0], MAX_NEW, {"priority": 0}),
         ("high", prompts[1], MAX_NEW, {"arrival_s": 0.01, "priority": 5})],
        clock=_tick_clock)
    _same(jr, jrep, r, rep)
    low, high = r
    assert rep.state_counts() == {"COMPLETED": 2}
    assert low.preemptions >= 1
    assert rep.prefix_hit_tokens > 0  # the resume re-pinned low's pages
    assert list(low.tokens) == _solo(llama, prompts[0], MAX_NEW, eos_id=-1)
    assert list(high.tokens) == _solo(llama, prompts[1], MAX_NEW, eos_id=-1)
    assert pair.port.pool.free_count == 1
    pool, jpool = pair.port.pool.blocks, pair.ref.pool.blocks
    assert pool.used_blocks == pool.trie_blocks
    assert (pool.used_blocks, pool.trie_blocks) == \
        (jpool.used_blocks, jpool.trie_blocks)


def test_paged_deadline_eviction_releases_slot(llama):
    prompts = _prompts(llama[0], 1)
    pair = Pair(llama, n_slots=1, macro_step=1, eos_id=-1, paged=True,
                block_size=BLOCK)
    jr, jrep, r, rep = pair.run(
        [("r0", prompts[0], MAX_NEW, {"deadline_s": 0.05})],
        clock=lambda: _tick_clock(dt=5e-3))
    _same(jr, jrep, r, rep)
    assert r[0].state == RequestState.TIMED_OUT
    assert pair.port.pool.free_count == 1
    pool = pair.port.pool.blocks
    assert pool.used_blocks == pool.trie_blocks


def test_paged_fatal_abort_drains_whole_block_pool(llama):
    prompts = _prompts(llama[0], 2, seed=11)
    reqs = [(f"r{i}", prompts[i], MAX_NEW, {}) for i in range(2)]
    clean_pair = Pair(llama, paged=True, block_size=BLOCK)
    jr, jrep, r, rep = clean_pair.run(reqs)
    _same(jr, jrep, r, rep)
    clean = _tokens(r)
    pair = Pair(llama, macro_step=1, paged=True, block_size=BLOCK,
                faults=[dict(kind="raise", site="macro", after=0,
                             fatal=True)])
    jr, _, r, _ = pair.run(reqs, raises=(JFatal, FatalFault))
    assert _fates(r) == _fates(jr)
    assert all(q.state.terminal for q in r)
    assert pair.port.pool.free_count == pair.port.pool.n_slots
    pool = pair.port.pool.blocks
    assert pool.used_blocks == 0 and pool.trie_blocks == 0
    assert pool.free_blocks == pool.n_blocks - 1
    pair.set(injector=None)
    jr, jrep, r, rep = pair.run(reqs)
    _same(jr, jrep, r, rep)
    assert rep.state_counts() == {"COMPLETED": 2}
    assert _tokens(r) == clean


# ---------------------------------------------------------------------------
# Deadline and priority on a 1-slot trace with a 1 s clock
# ---------------------------------------------------------------------------


def _three(cfg, **third):
    prompts = _prompts(cfg, 3, seed=3)
    return [(f"r{i}", prompts[i], MAX_NEW, third if i == 2 else {})
            for i in range(3)]


@pytest.mark.parametrize("third,want", [
    (dict(deadline_s=0.5), "TIMED_OUT"),
    (dict(priority=5), "COMPLETED"),
])
def test_one_slot_deadline_and_priority_traces(llama, third, want):
    pair = Pair(llama, n_slots=1)
    jr, jrep, r, rep = pair.run(_three(llama[0], **third),
                                clock=lambda: _tick_clock(dt=1.0))
    _same(jr, jrep, r, rep)
    assert r[2].state.value == want
    admitted = sorted((q.admitted_s, q.rid) for q in r
                      if q.admitted_s is not None)
    assert admitted == sorted((q.admitted_s, q.rid) for q in jr
                              if q.admitted_s is not None)
    if "priority" in third:
        assert admitted[0][1] == "r2"  # the high priority goes first
    else:
        assert r[2].reason == "deadline expired while queued"
        assert r[2].admitted_s is None and not r[2].tokens


# ---------------------------------------------------------------------------
# The port only: abandonment, and the worker thread's grad mode
# ---------------------------------------------------------------------------


def test_abandoned_step_cannot_reach_the_drained_pool(llama):
    cfg, _, _, model, params = llama
    prompts = _prompts(cfg, 2)
    engine = ContinuousServeEngine(model, params, n_slots=2,
                                   max_len=MAX_LEN, eos_id=-1, macro_step=1,
                                   paged=True, block_size=BLOCK,
                                   cost_engine=_spec_engine())
    reqs = lambda: [Request(f"r{i}", prompts[i], MAX_NEW)  # noqa: E731
                    for i in range(2)]
    clean = _tokens(engine.run(reqs(), now_fn=lambda: 0.0).requests)
    real = engine._macro(1)
    woke, checked = threading.Event(), threading.Event()
    worker = []

    def hung(params_, state, *args):
        # ignores cancellation, outlives the grace join, then writes into
        # the pools it was given, as a late kernel would, and finally runs
        # the real step on them (once the pools have been looked at)
        worker.append(threading.current_thread())
        time.sleep(0.9)
        for leaf in _pools(state):
            leaf.fill_(7.0)
        woke.set()
        checked.wait(10.0)
        return real(params_, state, *args)

    engine._macro_fns[1] = hung
    engine.watchdog_s = 0.2
    before = _pools(engine.pool.state)
    rep = engine.run(reqs(), now_fn=lambda: 0.0)
    assert rep.state_counts() == {"FAILED": 2}
    assert all("macro step failed" in q.reason and "abandon" in q.reason
               for q in rep.requests)
    assert rep.watchdog_fires == 1
    after = _pools(engine.pool.state)
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(after, before))
    assert woke.wait(5.0)
    try:
        assert all(float(b.min()) == float(b.max()) == 7.0 for b in before)
        assert all(not a.any() for a in after)  # the late write missed them
    finally:
        checked.set()
        worker[0].join(10.0)
    assert engine.pool.blocks.used_blocks == 0
    engine._macro_fns[1] = real
    engine.watchdog_s = None
    again = engine.run(reqs(), now_fn=lambda: 0.0)
    assert _tokens(again.requests) == clean


def _pools(state):
    from repro_torch.models.model import is_page_pool
    from repro_torch.tree import leaves_with_paths

    return [leaf for path, leaf in leaves_with_paths(state["layers"])
            if is_page_pool(path)]


def test_watchdog_worker_runs_the_step_as_the_caller(llama):
    """The guarded step runs on a worker thread under the caller's grad
    mode: torch keeps grad mode per thread, and a worker left at its
    default would record an autograd graph on parameters that need one."""
    cfg, _, _, model, params = llama
    prompts = _prompts(cfg, 2)
    leaf = params["unembed"]["w"] if isinstance(params["unembed"], dict) \
        else params["unembed"]
    leaf.requires_grad_(True)
    seen = []
    try:
        engine = ContinuousServeEngine(model, params, n_slots=2,
                                       max_len=MAX_LEN, eos_id=-1,
                                       macro_step=2, watchdog_s=5.0,
                                       cost_engine=_spec_engine())
        real = engine._macro(2)

        def spy(*a):
            em, st = real(*a)
            seen.append((threading.current_thread().name,
                         torch.is_grad_enabled(), em.requires_grad))
            return em, st

        engine._macro_fns[2] = spy
        with torch.no_grad():
            rep = engine.run([Request(f"r{i}", prompts[i], 5)
                              for i in range(2)], now_fn=lambda: 0.0)
    finally:
        leaf.requires_grad_(False)
    assert rep.state_counts() == {"COMPLETED": 2}
    assert seen and all(name != threading.main_thread().name
                        and not grad and not needs
                        for name, grad, needs in seen)


def test_port_fault_module_is_the_reference_policy():
    from repro.serving import faults as jfaults
    from repro_torch.serving import faults

    for name in ("InjectedFault", "FatalFault", "WatchdogTimeout",
                 "StepFailed", "FaultSpec", "FaultInjector", "guarded_call"):
        assert hasattr(faults, name)
    with pytest.raises(ValueError) as err:
        FaultSpec("melt")
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultSpec("melt")
    assert str(err.value) == str(jerr.value)
    calls = []

    def flaky(cancel):
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert faults.guarded_call(flaky, retries=2, backoff_s=0.0) == "ok"
    with pytest.raises(StepFailed, match="after 2 attempts"):
        faults.guarded_call(lambda c: 1 / 0, retries=1, backoff_s=0.0)
    with pytest.raises(FatalFault):
        faults.guarded_call(
            lambda c: (_ for _ in ()).throw(FatalFault("x")), retries=5)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _launch(module, *args, script=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    cmd = ([sys.executable, "-c", script, *args] if script else
           [sys.executable, "-m", module, *args])
    return subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=ROOT)


ROBUST_ARGS = ("--arch", "tinyllama-1.1b", "--reduced", "--requests", "6",
               "--prompt-len", "8", "--max-new", "12", "--slots", "2",
               "--engine", "continuous", "--arrival", "all", "--eos-id",
               "-1", "--deadline-ms", "60000", "--queue-limit", "3",
               "--inject-fault", "raise", "--watchdog-ms", "5000")


def _lifecycle_lines(stdout):
    """The launcher's lifecycle report without its timings: the states
    line and, per request, id, state, tokens and reason."""
    states = [ln.strip() for ln in stdout.splitlines()
              if ln.strip().startswith("states ")]
    rows = [re.sub(r"(arrival|queue|ttft|latency)\s+\S+\s*", "", ln).split()
            for ln in stdout.splitlines()
            if re.match(r"\s+r\d+: ", ln)]
    return states, rows


def test_launcher_robustness_flags_give_the_reference_report():
    ref = _launch("repro.launch.serve", *ROBUST_ARGS)
    port = _launch("repro_torch.launch.serve", *ROBUST_ARGS, "--device",
                   "cpu")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert port.returncode == 0, port.stderr[-2000:]
    states, rows = _lifecycle_lines(port.stdout)
    assert (states, rows) == _lifecycle_lines(ref.stdout)
    assert states == ["states {'COMPLETED': 3, 'REJECTED': 3}, retries 1"]
    assert sum("[queue_full]" in " ".join(r) for r in rows) == 3
    assert "serve ledger:" in port.stdout and "serve_admit" in port.stdout


_SIGINT_SCRIPT = """
import os, signal, sys
from repro_torch.launch import serve
from repro_torch.serving.engine import ContinuousServeEngine

publish = ContinuousServeEngine._publish

def publish_then_interrupt(self, req, tokens, done, t):
    publish(self, req, tokens, done, t)
    if req.rid != "_warmup" and tokens and not getattr(self, "_sent", 0):
        self._sent = 1
        os.kill(os.getpid(), signal.SIGINT)  # after the first tokens

ContinuousServeEngine._publish = publish_then_interrupt
sys.exit(serve.main(sys.argv[1:]))
"""


def test_launcher_sigint_after_first_tokens_drains_and_exits_zero():
    out = _launch(None, "--arch", "tinyllama-1.1b", "--reduced", "--device",
                  "cpu", "--requests", "4", "--prompt-len", "8",
                  "--max-new", "12", "--slots", "1", "--engine",
                  "continuous", "--arrival", "staggered", "--gap-ms",
                  "60000", "--eos-id", "-1", script=_SIGINT_SCRIPT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "interrupted: intake stopped" in out.stdout
    states, rows = _lifecycle_lines(out.stdout)
    assert states == ["states {'COMPLETED': 1, 'REJECTED': 3}"]
    assert rows[0][:2] == ["r0:", "COMPLETED"]
    assert all("[shutdown: intake stopped]" in " ".join(r)
               for r in rows[1:])


@pytest.mark.parametrize("flags,missing", [
    (("--mesh", "data=1;model=2"), "--mesh must look like 'data=1,model=8'"),
    (("--mesh", "model"), "--mesh must look like 'data=1,model=8'"),
    (("--serve-shard", "maybe"), "invalid choice: 'maybe'"),
    (("--shards-per-device", "0"), "--shards-per-device must be >= 1"),
])
def test_launcher_options_of_later_slices_fail_at_parsing(flags, missing,
                                                          capsys):
    """The serve-mesh options (a later slice of the port when this test
    was written, taken since) fail at argument parsing when malformed,
    with the reference launcher's messages, before any model is built."""
    from repro_torch.launch import serve

    with pytest.raises(SystemExit) as stop:
        serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                    "cpu", *flags])
    assert stop.value.code == 2
    err = capsys.readouterr().err
    assert missing in err


def test_lifecycle_modules_import_neither_jax_nor_repro():
    code = ("import sys, repro_torch.serving.faults, "
            "repro_torch.launch.serve, repro_torch.serving.engine; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
