"""Front-end smoke: the multi-process serving front end must be a pure
host-side wrapper (2 pinned intake/emission workers, streaming on) that
changes nothing the engine generates, on the session's device (reduced
tinyllama-1.1b in fp32 on the CPU; full-width tinyllama-1.1b in bf16 at
CUT_LAYERS layers, random weights from seed 0, on the card).

Three serves over the same full-load trace:

  in-process  the continuous engine as serving_bench runs it: the tokens
  frontend    the same trace through ``frontend=2, pin=True,
              stream=True``: intake validation in spawned workers, token
              bursts detokenized in a pinned emission worker
  paged       the front end again over the paged engine

Hard checks (a gate, not a report): every run terminal and COMPLETED;
both front-end runs token-identical to the in-process run; the emission
transcript detokenizes exactly the engine's tokens; streamed tokens equal
the generated ones, TTFT percentiles finite; and the serve_ipc site
ledgered both ops (workers, coalesce) with predicted and measured rows.
The suite builds its own Runtime on the caller's device, so the serve_ipc
rows are its own.  It writes nothing.

    PYTHONPATH=src python -m repro_torch.benches.frontend_smoke [--device cpu]
"""

from __future__ import annotations

import argparse
import math

import numpy as np

from repro_torch.benches.common import (CUT_LAYERS, bench_config,
                                        model_and_params, session)
from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace

REQUESTS = 6
PROMPT_LEN = 8
MAX_NEW = 8
SLOTS = 3
WORKERS = 2
BLOCK_SIZE = 4


def _trace(cfg):
    return synthetic_trace(
        REQUESTS, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)


def _assert_completed(report, label: str) -> None:
    states = report.state_counts()
    if not report.all_terminal or states.get("COMPLETED", 0) != REQUESTS:
        raise AssertionError(f"{label}: expected {REQUESTS} COMPLETED, "
                             f"got {states}")


def _check_frontend_run(res, base_outputs, label: str) -> None:
    rep = res.report
    _assert_completed(rep, label)
    for rid, ref in base_outputs.items():
        if not np.array_equal(res.outputs[rid], ref):
            raise AssertionError(
                f"{label}: tokens for {rid} diverged from the in-process "
                f"engine — the front end changed generation")
    if rep.frontend_workers != WORKERS:
        raise AssertionError(
            f"{label}: expected {WORKERS} intake workers, report says "
            f"{rep.frontend_workers}")
    if rep.ipc_messages <= 0 or rep.ipc_bytes <= 0:
        raise AssertionError(
            f"{label}: no IPC traffic accounted "
            f"(messages={rep.ipc_messages}, bytes={rep.ipc_bytes})")
    if rep.streamed_tokens != REQUESTS * MAX_NEW:
        raise AssertionError(
            f"{label}: streamed {rep.streamed_tokens} tokens, engine "
            f"generated {REQUESTS * MAX_NEW}")
    if rep.stream_events < REQUESTS:
        raise AssertionError(
            f"{label}: only {rep.stream_events} stream bursts for "
            f"{REQUESTS} requests")
    ttft = rep.ttft_percentiles()
    if not all(math.isfinite(v) and v >= 0 for v in ttft.values()):
        raise AssertionError(f"{label}: non-finite TTFT percentiles {ttft}")
    if res.texts is None or set(res.texts) != set(base_outputs):
        raise AssertionError(
            f"{label}: emission transcript missing requests "
            f"(got {sorted(res.texts or ())})")
    for rid, ref in base_outputs.items():
        want = " ".join(str(int(t)) for t in ref)
        if res.texts[rid] != want:
            raise AssertionError(
                f"{label}: transcript text for {rid} is not the "
                f"detokenized engine output")


def run(csv=True, runtime=None, out=None, model=None, params=None):
    dev = session(runtime).device
    # own session => the serve_ipc rows below are ours (corrections on:
    # the loop must not change a single token for this gate to pass)
    rt = Runtime(RuntimeConfig(corrections=True), device=dev.type)
    cfg = bench_config(dev, CUT_LAYERS)
    model, params = model_and_params(cfg, dev, model, params)
    common = dict(model=model, params=params, max_len=PROMPT_LEN + MAX_NEW,
                  eos_id=0, mode="continuous", slots=SLOTS)

    base = rt.serve(cfg, _trace(cfg), **common)
    _assert_completed(base.report, "in-process reference")
    base_outputs = {f"r{i}": np.asarray(base.outputs[f"r{i}"])
                    for i in range(REQUESTS)}

    fe = rt.serve(cfg, _trace(cfg), frontend=WORKERS, pin=True,
                  stream=True, **common)
    _check_frontend_run(fe, base_outputs, "frontend (dense)")

    fe_paged = rt.serve(cfg, _trace(cfg), frontend=WORKERS, pin=True,
                        stream=True, paged=True, block_size=BLOCK_SIZE,
                        **common)
    _check_frontend_run(fe_paged, base_outputs, "frontend (paged)")

    # --- the eleventh cost site must have ledgered, for BOTH ops, a
    # decision row (predicted) AND an appended measured row ---
    ipc_rows = [e for e in rt.ledger.entries if e.site == "serve_ipc"]
    for op in ("workers", "coalesce"):
        rows = [e for e in ipc_rows if e.query.get("op") == op]
        measured = [e for e in rows if e.measured_s is not None]
        if not rows or not measured:
            raise AssertionError(
                f"serve_ipc op={op!r}: expected decision + measured ledger "
                f"rows, got {len(rows)} rows / {len(measured)} measured")
        if any(e.predicted_s is None or e.predicted_s <= 0 for e in rows):
            raise AssertionError(
                f"serve_ipc op={op!r}: a ledger row has no positive "
                f"predicted cost")

    for label, res in (("dense", fe), ("paged", fe_paged)):
        rep = res.report
        ttft = rep.ttft_percentiles()
        print(f"frontend_smoke,engine={label},workers={rep.frontend_workers},"
              f"ipc_msgs={rep.ipc_messages},ipc_bytes={rep.ipc_bytes},"
              f"streamed={rep.streamed_tokens},bursts={rep.stream_events},"
              f"ttft_p50_ms={ttft['ttft_p50']*1e3:.1f},"
              f"ttft_p99_ms={ttft['ttft_p99']*1e3:.1f}")
    w_rows = [e for e in ipc_rows if e.query.get("op") == "workers"]
    c_rows = [e for e in ipc_rows if e.query.get("op") == "coalesce"]
    print(f"frontend_smoke,site=serve_ipc,rows={len(ipc_rows)},"
          f"workers_measured="
          f"{sum(1 for e in w_rows if e.measured_s is not None)},"
          f"coalesce_measured="
          f"{sum(1 for e in c_rows if e.measured_s is not None)}")
    # drift gate only bites on a spec calibrated against THIS backend;
    # datasheet-spec runs drift by construction and prove nothing
    if rt.engine.calibration is not None:
        rt.engine.assert_drift_resolved()
    print("frontend_smoke,token_identical=True,transcript_identical=True,"
          "drift_check="
          + ("ok" if rt.engine.calibration is not None
             else "skipped_uncalibrated"))
    return {"ipc_rows": len(ipc_rows)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    run(runtime=Runtime(device=ap.parse_args().device))
