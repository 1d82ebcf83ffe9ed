"""The port's multi-process serving front end against the reference's, on
the CPU, at reduced size (tinyllama-1.1b reduced: 2 layers, fp32), on the
reference's parameters carried across by ``params_from_jax``.

Each case runs the same requests, submissions or bursts through
``repro.serving.frontend`` and ``repro_torch.serving.frontend`` (and the
two ``Runtime.serve``s, the port's priced on the reference's default
hardware spec so the two make the same decisions) and holds the two equal:
tokens and texts exactly, terminal states and reasons, respawn counts, IPC
message counts and bytes, and the ``serve_ipc`` verdicts (choice, worker
count or burst size, predicted seconds within 1e-9); then the reference
test's own assertions hold on the port.  The 14 tests of
``tests/test_serving_frontend.py``:

* TokenStream semantics: mirrored already by
  ``test_torch_paging.py::test_token_stream_bursts_and_terminal``;
* a stream adds no host sync and streams every token: mirrored by
  ``test_torch_paged.py::test_runtime_paged_and_stream``;
* within-group prefix sharing: mirrored by
  ``test_torch_paged.py::test_shared_prefix_engine_matches_reference``
  (2 and 3 slots against 1);
* here: the ``serve_ipc`` site (both ops, the override, a measurement
  attached), the static mode's and bad worker counts' refusals, front-end
  serving through ``Runtime.serve`` with ``frontend=2``, a pinned
  ``FrontendConfig`` and ``"auto"``, dense and paged (pages of 2) against
  the in-process engine, a dead emission worker with ``respawn=0`` (typed
  FAILED, the engine reusable), dead intake workers with ``respawn=0``,
  intake validation, the idle loop on a pinned clock and on the real
  clock, and the three respawn drills (intake, emission mid-stream,
  emission before ``finish``).

The port only: a ``TokenStream`` that raises ``StreamBroken`` fails
everything in flight with the reference's reason, "frontend stream
broken: ..."; no ``torch.Tensor`` and no numpy scalar is ever put on a
queue; a pinned serve gives the calling thread its CPU mask back; the
launcher's ``--workers 2 --pin --stream`` runs with both engines and,
with ``--engine continuous``, prints the reference launcher's lifecycle
report.
"""

import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.serving.engine as j_eng_mod  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.runtime import Runtime as JRuntime  # noqa: E402
from repro.runtime import synthetic_trace as j_synthetic_trace  # noqa: E402
from repro.serving import ContinuousServeEngine as JContinuous  # noqa: E402
from repro.serving import FrontendConfig as JFrontendConfig  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServingFrontend as JServingFrontend  # noqa: E402
from repro.serving import StreamBroken as JStreamBroken  # noqa: E402
from repro.serving import TokenStream as JTokenStream  # noqa: E402
from repro.serving.scheduler import ServeScheduler as JScheduler  # noqa: E402
import repro_torch.serving.engine as t_eng_mod  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime, RuntimeConfig  # noqa: E402
from repro_torch.runtime import synthetic_trace  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    ContinuousServeEngine,
    FrontendConfig,
    Request,
    ServingFrontend,
    StreamBroken,
    TokenStream,
)
from repro_torch.serving.scheduler import ServeScheduler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROMPT_LEN = 7
MAX_NEW = 6
MAX_LEN = PROMPT_LEN + MAX_NEW
ARCH = "tinyllama-1.1b"


@pytest.fixture(scope="module")
def llama():
    jcfg = j_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jmodel, jparams, model, params


def _spec():
    """The reference's default hardware spec, as the port's type."""
    return HardwareSpec.from_dict(V5E.to_dict())


def _runtimes():
    return JRuntime(), Runtime(RuntimeConfig(device="cpu", hardware=_spec()))


def _prompts(cfg, b, p=PROMPT_LEN, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, p)).astype(np.int32)


def _engines(llama, **kw):
    """(reference, port) continuous engines on the same weights and the
    same hardware spec."""
    _, jmodel, jparams, model, params = llama
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("eos_id", 0)
    return (JContinuous(jmodel, jparams, cost_engine=JCostEngine(hw=V5E),
                        **kw),
            ContinuousServeEngine(model, params,
                                  cost_engine=CostEngine(hw=_spec()), **kw))


def _toks(rep):
    return {r.rid: [int(t) for t in r.tokens] for r in rep.requests}


def _fates(rep):
    return {r.rid: (r.state.value, r.reason) for r in rep.requests}


def _ipc_rows(ledger, start=0):
    return [(e.query.get("op"), e.choice, e.predicted_s,
             e.measured_s is not None)
            for e in ledger.entries[start:] if e.site == "serve_ipc"]


def _same_rows(got, want):
    assert [r[:2] + r[3:] for r in got] == [r[:2] + r[3:] for r in want]
    assert [r[2] for r in got] == pytest.approx([r[2] for r in want],
                                                rel=1e-9)


# ---------------------------------------------------------------------------
# serve_ipc: the eleventh decision site
# ---------------------------------------------------------------------------


def test_serve_ipc_decision_sites_ledger_and_override():
    cfg = get_config(ARCH).reduced()
    jrt, rt = _runtimes()
    rows = []
    for sch_cls, r, c in ((JScheduler, jrt, j_get_config(ARCH).reduced()),
                          (ServeScheduler, rt, cfg)):
        sch = sch_cls(c, r.engine, max_len=MAX_LEN)
        w, dec_w = sch.serve_ipc_workers(8, msg_bytes=512,
                                         prompt_len=PROMPT_LEN)
        k, dec_c = sch.serve_ipc_coalesce(4, event_bytes=128)
        assert w in (0, 1, 2, 4) and k >= 1
        w2, dec_w2 = sch.serve_ipc_workers(
            8, msg_bytes=512, prompt_len=PROMPT_LEN, candidates=(2,),
            override="frontend")
        assert w2 == 2 and dec_w2.predicted_s > 0
        sch.record_measured(dec_w, 1.25e-4, note="test attach")
        got = _ipc_rows(r.ledger)
        assert {op for op, *_ in got} == {"workers", "coalesce"}
        assert all(p >= 0 for _, _, p, _ in got)
        measured = [e for e in r.ledger.entries
                    if e.site == "serve_ipc" and e.measured_s is not None]
        assert measured[-1].measured_s == pytest.approx(1.25e-4)
        rows.append((got, (w, k, w2)))
    _same_rows(rows[1][0], rows[0][0])
    assert rows[1][1] == rows[0][1]


def test_static_mode_rejects_frontend_and_bad_worker_counts(llama):
    cfg, jmodel, jparams, model, params = llama
    jrt, rt = _runtimes()
    cases = [dict(mode="static", frontend=2),
             dict(mode="static", stream=True),
             dict(mode="continuous", slots=1, frontend=0),
             dict(mode="continuous", slots=1, frontend="many")]
    for r, mdl, prm, trace_fn in ((jrt, jmodel, jparams, j_synthetic_trace),
                                  (rt, model, params, synthetic_trace)):
        trace = trace_fn(1, prompt_len=PROMPT_LEN, max_new=2,
                         vocab_size=cfg.vocab_size, arrival="all", seed=0)
        for kw in cases:
            with pytest.raises(ValueError):
                r.serve(cfg, trace, model=mdl, params=prm, max_len=MAX_LEN,
                        eos_id=0, **kw)
    for cls in (JFrontendConfig, FrontendConfig):
        for bad in (dict(workers=0), dict(coalesce=0), dict(queue_depth=0),
                    dict(respawn=-1)):
            with pytest.raises(ValueError):
                cls(**bad)


# ---------------------------------------------------------------------------
# Multi-process serving through Runtime.serve, dense and paged
# ---------------------------------------------------------------------------

FRONTENDS = {
    "workers2_dense": lambda C: dict(frontend=2, stream=True),
    "config_paged": lambda C: dict(
        frontend=C(workers=1, coalesce=2), stream=True, paged=True,
        block_size=2),
    "workers2_paged_stream_auto": lambda C: dict(
        frontend=2, paged=True, block_size=2),
    "auto_dense": lambda C: dict(frontend="auto"),
}


@pytest.mark.parametrize("how", list(FRONTENDS))
def test_frontend_serve_matches_reference_and_in_process(llama, how):
    cfg, jmodel, jparams, model, params = llama
    jrt, rt = _runtimes()
    out = []
    for r, mdl, prm, trace_fn, cls in (
            (jrt, jmodel, jparams, j_synthetic_trace, JFrontendConfig),
            (rt, model, params, synthetic_trace, FrontendConfig)):
        common = dict(model=mdl, params=prm, max_len=MAX_LEN, eos_id=0,
                      mode="continuous", slots=2)

        def trace():
            return trace_fn(4, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                            vocab_size=cfg.vocab_size, arrival="all", seed=0)

        base = r.serve(cfg, trace(), **common)
        n0 = len(r.ledger.entries)
        res = r.serve(cfg, trace(), **common, **FRONTENDS[how](cls))
        rep = res.report
        assert rep.state_counts() == {"COMPLETED": 4}
        for rid, want in base.outputs.items():
            np.testing.assert_array_equal(res.outputs[rid], want)
        toks = _toks(rep)
        if rep.frontend_workers:
            # the emission worker's transcript IS the engine's tokens
            assert set(res.texts) == set(base.outputs)
            assert all(res.texts[rid] == " ".join(map(str, t))
                       for rid, t in toks.items())
            assert rep.ipc_messages > 0 and rep.ipc_bytes > 0
            assert rep.streamed_tokens == sum(map(len, toks.values()))
            assert any(m for *_, m in _ipc_rows(r.ledger))
        out.append(dict(
            toks=toks, texts=res.texts, states=rep.state_counts(),
            workers=rep.frontend_workers, respawns=rep.frontend_respawns,
            ipc=(rep.ipc_messages, rep.ipc_bytes),
            stream=(rep.streamed_tokens, rep.stream_events),
            host_syncs=(rep.host_syncs, base.report.host_syncs),
            rows=_ipc_rows(r.ledger, n0)))
    ref, port = out
    _same_rows(port.pop("rows"), ref.pop("rows"))
    assert port == ref
    if how != "auto_dense":
        assert port["workers"] == (1 if how == "config_paged" else 2)
        assert port["texts"] is not None



# ---------------------------------------------------------------------------
# Crash drills: typed failure + drain, never a hung serve
# ---------------------------------------------------------------------------


def test_dead_emission_worker_fails_typed_and_engine_stays_usable(llama):
    cfg = llama[0]
    prompts = _prompts(cfg, 3)
    fates, again = [], []
    for fe_cls, cfg_cls, req_cls, engine in zip(
            (JServingFrontend, ServingFrontend),
            (JFrontendConfig, FrontendConfig), (JRequest, Request),
            _engines(llama, n_slots=2)):
        fe = fe_cls(cfg_cls(workers=1, respawn=0), max_len=MAX_LEN)
        fe.start()
        try:
            engine.stream = fe.stream()
            fe.kill_emission_worker()
            rep = engine.run([req_cls(f"r{i}", prompts[i], MAX_NEW)
                              for i in range(3)], now_fn=lambda: 0.0)
            assert rep.all_terminal
            assert rep.state_counts() == {"FAILED": 3}
            assert all("frontend stream broken" in (r.reason or "")
                       for r in rep.requests)
            fates.append(_fates(rep))
            engine.stream = None
            rep2 = engine.run([req_cls(f"s{i}", prompts[i], MAX_NEW)
                               for i in range(3)], now_fn=lambda: 0.0)
            assert rep2.state_counts() == {"COMPLETED": 3}
            again.append(_toks(rep2))
        finally:
            fe.close()
    assert fates[1] == fates[0]
    assert again[1] == again[0]


def test_dead_intake_workers_yield_typed_failures():
    subs = [{"rid": "a", "prompt": [1, 2], "max_new_tokens": 2},
            {"rid": "b", "prompt": [3], "max_new_tokens": 2}]
    got = []
    for fe_cls, cfg_cls in ((JServingFrontend, JFrontendConfig),
                            (ServingFrontend, FrontendConfig)):
        fe = fe_cls(cfg_cls(workers=1, respawn=0), max_len=MAX_LEN)
        fe.start()
        try:
            fe.kill_intake_workers()
            validated, failures = fe.submit(subs)
            assert validated == {} and set(failures) == {"a", "b"}
            assert all(w.startswith("frontend:") for w in failures.values())
            got.append((failures, fe.respawns))
        finally:
            fe.close()
    assert got[1] == got[0]


def test_intake_workers_validate_and_type_invalid_submissions():
    subs = [{"rid": "ok", "prompt": [1, 2, 3], "max_new_tokens": 2},
            {"rid": "long", "prompt": list(range(1, MAX_LEN + 2)),
             "max_new_tokens": 4},
            {"rid": "bad", "prompt": "not-token-ids", "max_new_tokens": 2}]
    got = []
    for fe_cls, cfg_cls in ((JServingFrontend, JFrontendConfig),
                            (ServingFrontend, FrontendConfig)):
        fe = fe_cls(cfg_cls(workers=2), max_len=MAX_LEN)
        fe.start()
        try:
            assert len(fe.ping_round_trips_s) == 3  # 2 intake + 1 emission
            assert all(t > 0 for t in fe.ping_round_trips_s)
            validated, failures = fe.submit(subs)
            assert set(validated) == {"ok"}
            assert validated["ok"]["prompt_len"] == 3
            assert set(failures) == {"long", "bad"}
            assert fe.ipc_messages > 0 and fe.ipc_bytes > 0
            got.append((validated, failures, fe.ipc_messages, fe.ipc_bytes))
        finally:
            fe.close()
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# The idle loop
# ---------------------------------------------------------------------------


def test_idle_jumps_on_pinned_clock(llama):
    """100 VIRTUAL seconds between arrivals on a pinned clock: the idle
    branch jumps the offset to the next arrival instead of sleeping."""
    prompts = _prompts(llama[0], 2)
    got = []
    for req_cls, engine in zip((JRequest, Request),
                               _engines(llama, n_slots=1)):
        t0 = time.perf_counter()
        rep = engine.run([req_cls("r0", prompts[0], 2, arrival_s=0.0),
                          req_cls("r1", prompts[1], 2, arrival_s=100.0)],
                         now_fn=lambda: 0.0)
        assert rep.state_counts() == {"COMPLETED": 2}
        assert time.perf_counter() - t0 < 30.0
        got.append(_toks(rep))
    assert got[1] == got[0]


def test_idle_sleeps_to_next_arrival_not_fixed_polls(llama, monkeypatch):
    prompts = _prompts(llama[0], 3)
    real_sleep = time.sleep
    got = []
    for mod, req_cls, engine in zip((j_eng_mod, t_eng_mod),
                                    (JRequest, Request),
                                    _engines(llama, n_slots=1)):
        engine.run([req_cls("warm", prompts[2], 2)], now_fn=lambda: 0.0)
        sleeps = []

        def spy(seconds, sleeps=sleeps):
            sleeps.append(seconds)
            real_sleep(seconds)

        gap = 0.3
        with monkeypatch.context() as mp:
            mp.setattr(mod.time, "sleep", spy)
            rep = engine.run([req_cls("r0", prompts[0], 2, arrival_s=0.0),
                              req_cls("r1", prompts[1], 2, arrival_s=gap)])
        assert rep.state_counts() == {"COMPLETED": 2}
        # one computed sleep covers (nearly) the whole idle gap
        assert max(sleeps) >= 0.5 * gap
        assert len(sleeps) <= 6
        got.append(_toks(rep))
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# Self-healing: bounded auto-respawn of crashed workers
# ---------------------------------------------------------------------------


def test_crashed_intake_workers_respawn_and_submissions_validate():
    subs = [{"rid": f"r{i}", "prompt": [1, 2, 3], "max_new_tokens": 2}
            for i in range(4)]
    got = []
    for fe_cls, cfg_cls in ((JServingFrontend, JFrontendConfig),
                            (ServingFrontend, FrontendConfig)):
        fe = fe_cls(cfg_cls(workers=2, respawn=2), max_len=MAX_LEN)
        fe.start()
        try:
            first, failures = fe.submit(subs)
            assert set(first) == {f"r{i}" for i in range(4)} and not failures
            fe.kill_intake_workers()
            second, failures = fe.submit(subs)
            assert set(second) == {f"r{i}" for i in range(4)}
            assert not failures and fe.respawns >= 1
            assert all(p.is_alive() for p in fe._intake_procs)
            # which worker answered depends on the respawn order
            got.append(({k: {**v, "intake_worker": None}
                         for k, v in second.items()}, fe.respawns))
        finally:
            fe.close()
    assert got[1] == got[0]


def test_crashed_emission_worker_respawns_with_replayed_transcript():
    got = []
    for fe_cls, cfg_cls in ((JServingFrontend, JFrontendConfig),
                            (ServingFrontend, FrontendConfig)):
        fe = fe_cls(cfg_cls(workers=1, respawn=2), max_len=MAX_LEN)
        fe.start()
        try:
            stream = fe.stream()
            stream.publish("a", (1, 2), done=False, t=0.0)
            stream.publish("b", (7,), done=False, t=0.0)
            fe.kill_emission_worker()
            stream.publish("a", (3,), done=True, t=0.1)
            stream.publish("b", (8,), done=True, t=0.1)
            transcript = fe.finish()
            assert fe.respawns == 1
            assert transcript["a"]["tokens"] == [1, 2, 3]
            assert transcript["b"]["tokens"] == [7, 8]
            assert transcript["a"]["text"] == "1 2 3"
            got.append((transcript, fe.respawns, fe.ipc_messages))
        finally:
            fe.close()
    assert got[1] == got[0]


def test_emission_respawn_survives_crash_before_finish():
    got = []
    for fe_cls, cfg_cls in ((JServingFrontend, JFrontendConfig),
                            (ServingFrontend, FrontendConfig)):
        fe = fe_cls(cfg_cls(workers=1, respawn=1), max_len=MAX_LEN)
        fe.start()
        try:
            fe.stream().publish("a", (4, 5), done=True, t=0.0)
            fe.kill_emission_worker()  # after the last burst
            transcript = fe.finish()
            assert fe.respawns == 1
            assert transcript["a"]["tokens"] == [4, 5]
            got.append((transcript, fe.respawns))
        finally:
            fe.close()
    assert got[1] == got[0]


# ---------------------------------------------------------------------------
# The port only
# ---------------------------------------------------------------------------


def _breaks_after(base, broken, n):
    class BreaksAfter(base):
        def publish(self, rid, tokens, done, t):
            if self.published_events >= n:
                raise broken("consumer gone")
            super().publish(rid, tokens, done, t)
    return BreaksAfter()


def test_broken_stream_reason_is_the_reference_reason(llama):
    """A TokenStream that raises StreamBroken mid-run: every request in
    flight ends FAILED with the reference's reason text."""
    prompts = _prompts(llama[0], 4)
    fates = []
    for req_cls, base, broken, engine in zip(
            (JRequest, Request), (JTokenStream, TokenStream),
            (JStreamBroken, StreamBroken), _engines(llama, n_slots=2)):
        engine.stream = _breaks_after(base, broken, 3)
        rep = engine.run([req_cls(f"r{i}", prompts[i], MAX_NEW)
                          for i in range(4)], now_fn=lambda: 0.0)
        assert rep.all_terminal
        failed = [r for r in rep.requests if r.state.value == "FAILED"]
        assert failed and all(r.reason.startswith(
            "frontend stream broken: consumer gone") for r in failed)
        fates.append(_fates(rep))
    assert fates[1] == fates[0]


def _plain(obj) -> bool:
    """True when ``obj`` is built only of plain Python values."""
    if obj is None or type(obj) in (bool, int, float, str):
        return True
    if type(obj) in (list, tuple):
        return all(_plain(x) for x in obj)
    if type(obj) is dict:
        return all(_plain(k) and _plain(v) for k, v in obj.items())
    return False


def test_no_tensor_or_numpy_scalar_crosses_a_queue(llama, monkeypatch):
    import multiprocessing.queues as mpq

    cfg, _, _, model, params = llama
    sent = []
    put = mpq.Queue.put

    def recording_put(self, obj, *a, **kw):
        sent.append(obj)
        return put(self, obj, *a, **kw)

    monkeypatch.setattr(mpq.Queue, "put", recording_put)
    rt = Runtime(RuntimeConfig(device="cpu", hardware=_spec()))
    trace = synthetic_trace(4, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                            vocab_size=cfg.vocab_size, arrival="all")
    res = rt.serve(cfg, trace, model=model, params=params, slots=2,
                   eos_id=0, max_len=MAX_LEN, frontend=2)
    assert res.report.frontend_workers == 2 and res.texts
    fe = ServingFrontend(FrontendConfig(workers=1), max_len=MAX_LEN)
    fe.start()
    try:  # a caller's tensors and numpy scalars become ints before the put
        fe.stream().publish("x", torch.tensor([3, 4]), done=False,
                            t=np.float32(0.5))
        fe.stream().publish("x", np.array([5], np.int64), done=np.bool_(1),
                            t=1.0)
        assert fe.finish()["x"]["tokens"] == [3, 4, 5]
    finally:
        fe.close()
    emits = [m for m in sent if isinstance(m, tuple) and m[0] == "emit"]
    assert emits and len(sent) > len(emits)
    assert all(_plain(m) for m in sent), [m for m in sent if not _plain(m)]


def test_pinned_serve_restores_the_callers_cpu_mask(llama):
    cfg, _, _, model, params = llama
    before = os.sched_getaffinity(0)
    rt = Runtime(RuntimeConfig(device="cpu", hardware=_spec()))
    trace = synthetic_trace(2, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
                            vocab_size=cfg.vocab_size, arrival="all")
    res = rt.serve(cfg, trace, model=model, params=params, slots=2,
                   eos_id=0, max_len=MAX_LEN, frontend=1, pin=True)
    assert res.report.state_counts() == {"COMPLETED": 2}
    assert os.sched_getaffinity(0) == before
    notes = [e.note for e in rt.ledger.entries
             if e.site == "serve_ipc" and e.measured_s is not None]
    assert any(re.search(r"workers=1 pinned=\d", n) for n in notes)


def _launch(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


def _report(stdout):
    """The lifecycle report without timings, and the front-end line
    without its bytes: each launcher draws its own random weights, so the
    token ids (and their pickled sizes) differ between the packages."""
    rows = [re.sub(r"(arrival|queue|ttft|latency)\s+\S+\s*", "", ln).split()
            for ln in stdout.splitlines() if re.match(r"\s+r\d+: ", ln)]
    states = [ln.strip() for ln in stdout.splitlines()
              if ln.strip().startswith("states ")]
    front = [re.sub(r" / \d+ B", "", ln.strip().split(", respawns")[0])
             for ln in stdout.splitlines()
             if ln.strip().startswith("frontend: ")]
    return states, rows, front


LAUNCH = ("--arch", "tinyllama-1.1b", "--reduced", "--requests", "4",
          "--prompt-len", "6", "--max-new", "6", "--slots", "2",
          "--arrival", "all", "--workers", "2", "--pin", "--stream")


def test_launcher_workers_pin_stream():
    port = _launch("repro_torch.launch.serve", *LAUNCH, "--device", "cpu")
    assert port.returncode == 0, port.stderr[-2000:]
    assert "[static]" in port.stdout and "frontend: 2 intake" in port.stdout
    ref = _launch("repro.launch.serve", *LAUNCH, "--engine", "continuous")
    cont = _launch("repro_torch.launch.serve", *LAUNCH, "--engine",
                   "continuous", "--device", "cpu")
    assert ref.returncode == 0, ref.stderr[-2000:]
    assert cont.returncode == 0, cont.stderr[-2000:]
    states, rows, front = _report(cont.stdout)
    assert (states, rows, front) == _report(ref.stdout)
    assert states == ["states {'COMPLETED': 4}"] and front
    assert "serve_ipc" in cont.stdout or "ipc_" in cont.stdout
