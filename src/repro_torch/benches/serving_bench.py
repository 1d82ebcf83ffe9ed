"""Serving benchmark: static-batch against continuous batching, a thin
adapter over ``Runtime.serve``, on the session's device (reduced
tinyllama-1.1b in fp32 on the CPU; full-width tinyllama-1.1b in bf16,
random weights from seed 0, all 22 layers, on the card).

Two traces over the same requests:

  staggered   arrivals every GAP_MS: the latency story
  full-load   everything at t=0: the throughput story (the macro-step
              decode, batched group prefill)

plus a SHARDED full-load row on a ``{"data": 1, "model": 8}`` mesh in
process (eight shards of the card, or eight CPU positions), the shard
verdict forced, token-checked against a static serve of the same model.
On the card that row serves full-width tinyllama in fp32 at CUT_LAYERS
layers: in bf16 the sharded row sums round the residual stream otherwise
than the unsharded products do, and greedy tokens then match only up to
near ties; in fp32 they match;

plus a PAGED full-load row (pages of 4 tokens, so the 8-token prompts
span several), token-checked against the static run and reported as the
paged/dense throughput ratio;

plus a SHARED-PREFIX row: every request opens with the same 6-token
prefix and the radix prefix cache is forced on, so only the first
request prefills the prefix (at most half the prompt tokens prefilled).

Writes ``<out>/serving.json``.  ``check_regression=True`` fails if the
equivalence anchor breaks or a machine-normalized ratio (continuous over
static, paged over dense, the prefix hit rate) falls more than the
reference's fraction below the previous file's in the same directory; with
no previous file it records a baseline and passes.  The suite builds its
own Runtime on the caller's device, so the ledger rows are its own.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch.benches.common import (ARCH, CUT_LAYERS, bench_config,
                                        load_json, model_and_params,
                                        out_dir, session, write_json)
from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace

BENCH_JSON = "serving.json"
REGRESSION_FRACTION = 0.8
PAGED_REGRESSION_FRACTION = 0.5

REQUESTS = 6
PROMPT_LEN = 8
MAX_NEW = 8
SLOTS = 3
GAP_MS = 10.0
SHARD_POSITIONS = 8
BLOCK_SIZE = 4
PREFIX_LEN = 6
PREFIX_SLOTS = SLOTS


def _trace(cfg, *, arrival: str, prefix_share: float = 0.0):
    return synthetic_trace(
        REQUESTS, prompt_len=PROMPT_LEN, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival=arrival, gap_ms=GAP_MS, seed=0,
        prefix_share=prefix_share,
        prefix_len=PREFIX_LEN if prefix_share else 0)


def _engine_dict(res) -> dict:
    d = {"tok_per_s": res.tok_per_s, "p50_s": res.p50_s, "p95_s": res.p95_s}
    if res.report is not None:
        d["host_syncs"] = res.report.host_syncs
        d["device_dispatches"] = res.report.device_dispatches
        d["host_syncs_per_token"] = res.report.host_syncs_per_token
    return d


def _report_dict(report) -> dict:
    pct = report.latency_percentiles()
    return {
        "tok_per_s": report.tok_per_s,
        "p50_s": pct["p50"],
        "p95_s": pct["p95"],
        "host_syncs": report.host_syncs,
        "device_dispatches": report.device_dispatches,
        "host_syncs_per_token": report.host_syncs_per_token,
    }


def _rows(report) -> np.ndarray:
    return np.stack([report.output(f"r{i}", MAX_NEW) for i in range(REQUESTS)])


def sharded_config(cfg, device):
    """The sharded row's model: ``cfg`` on the CPU; on the card fp32 at
    CUT_LAYERS layers (see the module docstring)."""
    if device.type == "cpu":
        return cfg
    return dataclasses.replace(cfg, dtype="float32", n_layers=CUT_LAYERS)


def sharded_row(rt, cfg, *, model=None, params=None) -> dict:
    """The full-load trace on ``{"data": 1, "model": 8}`` positions of
    the session's device with the shard verdict forced, best of three,
    against a static serve of the same model and parameters."""
    from repro_torch.serving.scheduler import ServeScheduler

    card = rt.device.type == "cuda"
    cfg = sharded_config(cfg, rt.device)
    if card:
        model = params = None  # the row's own fp32 model
    model, params = model_and_params(cfg, rt.device, model, params)
    max_len = PROMPT_LEN + MAX_NEW
    common = dict(model=model, params=params, max_len=max_len, eos_id=0)
    static = rt.serve(cfg, _trace(cfg, arrival="all"), mode="static",
                      **common)
    _, auto_dec = ServeScheduler(cfg, rt.engine, max_len=max_len).serve_shard(
        SLOTS, tp=SHARD_POSITIONS, devices=1 if card else None)
    res = rt.serve(cfg, _trace(cfg, arrival="all"), mode="continuous",
                   slots=SLOTS, mesh_shape={"data": 1,
                                            "model": SHARD_POSITIONS},
                   shard_params="shard", shards_per_device=SHARD_POSITIONS,
                   **common)
    rep = res.report
    for _ in range(2):
        r2 = res.engine.run(_trace(cfg, arrival="all"))
        if r2.tok_per_s > rep.tok_per_s:
            rep = r2
    rows = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    want = np.stack([static.outputs[f"r{i}"] for i in range(REQUESTS)])
    return {
        "devices": SHARD_POSITIONS,
        "mesh_shape": rep.mesh_shape,
        "dtype": cfg.dtype,
        "layers": cfg.n_layers,
        "tok_per_s": rep.tok_per_s,
        "host_syncs_per_token": rep.host_syncs_per_token,
        "collective_ops": rep.collective_ops,
        "auto_choice": auto_dec.choice,
        "serve_shard_rows": len(rows),
        "serve_shard_measured": sum(
            1 for e in rows if e.measured_s is not None),
        "token_identical": bool(np.array_equal(_rows(rep), want)),
    }


def run(csv=True, runtime=None, out=None, check_regression: bool = False,
        model=None, params=None):
    """``model``/``params``: the caller's for the main rows (the tests
    pass the reference's parameters); else random from seed 0."""
    caller = session(runtime)
    out = out_dir(out)
    dev = caller.device
    # own session => fresh ledger: the serve rows are this suite's
    rt = Runtime(RuntimeConfig(corrections=True), device=dev.type)
    path = out / BENCH_JSON
    previous = load_json(path)
    cfg = bench_config(dev)
    model, params = model_and_params(cfg, dev, model, params)
    max_len = PROMPT_LEN + MAX_NEW
    common = dict(model=model, params=params, max_len=max_len, eos_id=0)

    # --- staggered trace: the latency story
    static_st = rt.serve(cfg, _trace(cfg, arrival="staggered"),
                         mode="static", **common)
    cont_st = rt.serve(cfg, _trace(cfg, arrival="staggered"),
                       mode="continuous", slots=SLOTS, **common)

    # --- full-load trace: the throughput story and the equivalence anchor
    static_fl = rt.serve(cfg, _trace(cfg, arrival="all"), mode="static",
                         **common)
    cont_fl = rt.serve(cfg, _trace(cfg, arrival="all"), mode="continuous",
                       slots=SLOTS, **common)
    fl_report = cont_fl.report
    for _ in range(2):  # best of three on the warm engine
        rep = cont_fl.engine.run(_trace(cfg, arrival="all"))
        if rep.tok_per_s > fl_report.tok_per_s:
            fl_report = rep
    static_out = np.stack([static_fl.outputs[f"r{i}"]
                           for i in range(REQUESTS)])
    token_identical = bool(np.array_equal(static_out, _rows(fl_report)))

    # --- sharded full-load row
    sharded = sharded_row(rt, cfg, model=model, params=params)

    # --- paged full-load row
    paged_fl = rt.serve(cfg, _trace(cfg, arrival="all"), mode="continuous",
                        slots=SLOTS, paged=True, block_size=BLOCK_SIZE,
                        **common)
    paged_report = paged_fl.report
    for _ in range(4):  # best of five: the ratio divides two small walls
        rep = paged_fl.engine.run(_trace(cfg, arrival="all"))
        if rep.tok_per_s > paged_report.tok_per_s:
            paged_report = rep
    dense_best = fl_report.tok_per_s
    for _ in range(2):
        rep = cont_fl.engine.run(_trace(cfg, arrival="all"))
        dense_best = max(dense_best, rep.tok_per_s)
    paged_identical = bool(np.array_equal(_rows(paged_report), static_out))
    paged_row = _report_dict(paged_report)
    paged_row.update({
        "block_size": BLOCK_SIZE,
        "live_tokens": paged_report.live_tokens,
        "reserved_blocks": paged_report.reserved_blocks,
        "token_identical": paged_identical,
        "paged_over_dense": (paged_report.tok_per_s / dense_best
                             if dense_best > 0 else None),
    })

    # --- shared-prefix row
    static_px = rt.serve(cfg, _trace(cfg, arrival="all", prefix_share=1.0),
                         mode="static", **common)
    prefix_fl = rt.serve(cfg, _trace(cfg, arrival="all", prefix_share=1.0),
                         mode="continuous", slots=PREFIX_SLOTS, paged=True,
                         block_size=BLOCK_SIZE, prefix_cache="force",
                         **common)
    px_report = prefix_fl.report
    px_static_out = np.stack([static_px.outputs[f"r{i}"]
                              for i in range(REQUESTS)])
    px_identical = bool(np.array_equal(_rows(px_report), px_static_out))
    prefix_rows = [e for e in rt.ledger.entries if e.site == "serve_prefix"]
    total_prompt = REQUESTS * PROMPT_LEN
    prefix_row = {
        "prefix_len": PREFIX_LEN,
        "prefix_share": 1.0,
        "slots": PREFIX_SLOTS,
        "tok_per_s": px_report.tok_per_s,
        "prefilled_tokens": px_report.prefilled_tokens,
        "prefix_hit_tokens": px_report.prefix_hit_tokens,
        "prefix_hit_rate": px_report.prefix_hit_rate,
        "cow_count": px_report.cow_count,
        "prefill_reduction": (total_prompt / px_report.prefilled_tokens
                              if px_report.prefilled_tokens > 0 else None),
        "token_identical": px_identical,
        "serve_prefix_rows": len(prefix_rows),
        "serve_prefix_measured": sum(
            1 for e in prefix_rows if e.measured_s is not None),
    }

    serve_rows = [e for e in rt.ledger.entries
                  if e.site in ("serve", "serve_macro")]
    measured = [e for e in serve_rows if e.measured_s is not None]
    result = {
        "arch": ARCH,
        "device": dev.type,
        "config": {"name": cfg.name, "layers": cfg.n_layers,
                   "d_model": cfg.d_model, "dtype": cfg.dtype},
        "trace": {"requests": REQUESTS, "prompt_len": PROMPT_LEN,
                  "max_new": MAX_NEW, "slots": SLOTS, "gap_ms": GAP_MS},
        "static": _engine_dict(static_st),
        "continuous": _engine_dict(cont_st),
        "full_load": {
            "static": _engine_dict(static_fl),
            "continuous": _report_dict(fl_report),
            "continuous_over_static":
                fl_report.tok_per_s / static_fl.tok_per_s
                if static_fl.tok_per_s > 0 else None,
            "sharded": sharded,
            "paged": paged_row,
        },
        "shared_prefix": prefix_row,
        "p50_speedup": (static_st.p50_s / cont_st.p50_s
                        if cont_st.p50_s > 0 else None),
        "token_identical": token_identical,
        "serve_ledger_rows": len(serve_rows),
        "serve_ledger_measured": len(measured),
        "outputs": static_out.tolist(),
    }
    for theirs in ("stress", "chaos"):  # the other suites' keys
        if theirs in previous:
            result[theirs] = previous[theirs]
    write_json(path, result)

    for name, res in (("static", static_st), ("continuous", cont_st)):
        print(f"serving_bench,trace=staggered,engine={name},"
              f"tok_s={res.tok_per_s:.1f},p50_ms={res.p50_s*1e3:.1f},"
              f"p95_ms={res.p95_s*1e3:.1f}")
    print(f"serving_bench,trace=full_load,engine=static,"
          f"tok_s={static_fl.tok_per_s:.1f}")
    print(f"serving_bench,trace=full_load,engine=continuous,"
          f"tok_s={fl_report.tok_per_s:.1f},"
          f"syncs_per_tok={fl_report.host_syncs_per_token:.3f},"
          f"dispatches={fl_report.device_dispatches}")
    print(f"serving_bench,trace=full_load,engine=sharded,"
          f"mesh=model:{SHARD_POSITIONS},dtype={sharded['dtype']},"
          f"layers={sharded['layers']},tok_s={sharded['tok_per_s']:.1f},"
          f"collectives={sharded['collective_ops']},"
          f"auto_choice={sharded['auto_choice']},"
          f"shard_rows={sharded['serve_shard_rows']},"
          f"shard_measured={sharded['serve_shard_measured']},"
          f"token_identical={sharded['token_identical']}")
    print(f"serving_bench,trace=full_load,engine=paged,"
          f"block_size={BLOCK_SIZE},tok_s={paged_report.tok_per_s:.1f},"
          f"paged_over_dense={paged_row['paged_over_dense']:.2f},"
          f"live_tokens={paged_report.live_tokens},"
          f"blocks={paged_report.reserved_blocks},"
          f"token_identical={paged_identical}")
    print(f"serving_bench,trace=shared_prefix,engine=paged,"
          f"prefix_len={PREFIX_LEN},"
          f"hit_tokens={px_report.prefix_hit_tokens},"
          f"hit_rate={px_report.prefix_hit_rate:.2f},"
          f"prefilled={px_report.prefilled_tokens},"
          f"reduction={prefix_row['prefill_reduction']:.2f},"
          f"cow={px_report.cow_count},"
          f"prefix_rows={len(prefix_rows)},"
          f"prefix_measured={prefix_row['serve_prefix_measured']},"
          f"token_identical={px_identical}")
    print(f"serving_bench,token_identical={token_identical},"
          f"serve_rows={len(serve_rows)},measured={len(measured)},"
          f"json={path}")
    if not token_identical:
        raise AssertionError(
            "continuous engine diverged from the static baseline")
    if not sharded["token_identical"]:
        raise AssertionError(
            "sharded continuous engine diverged from the single-device "
            "static baseline")
    if not paged_identical:
        raise AssertionError(
            "paged continuous engine diverged from the dense baseline")
    if not px_identical:
        raise AssertionError(
            "shared-prefix paged run diverged from the static baseline "
            "on the same trace (prefix reuse changed the decode)")
    if prefix_row["prefill_reduction"] is None \
            or prefix_row["prefill_reduction"] < 2.0:
        raise AssertionError(
            f"shared-prefix trace prefilled {px_report.prefilled_tokens} "
            f"of {total_prompt} prompt tokens: reuse below the 2x "
            f"reduction anchor")
    if check_regression:
        _check_regression(previous, result["full_load"],
                          result["shared_prefix"])
        if rt.engine.calibration is not None:
            rt.engine.assert_drift_resolved()
            print("serving_bench,drift_check=ok")
        else:
            print("serving_bench,drift_check=skipped_uncalibrated")
    return result


def _check_regression(previous: dict, full_load: dict,
                      shared_prefix: dict) -> None:
    """Three machine-normalized metrics against the previous file in the
    output directory: continuous over static (full load), paged over
    dense, and the prefix hit rate.  Each is skipped where the previous
    file lacks it; with none, this run is the baseline."""
    if not previous.get("full_load"):
        print("serving_bench,regression_check=baseline_recorded")
        return
    checks = (
        ("continuous_over_static", REGRESSION_FRACTION,
         previous.get("full_load", {}).get("continuous_over_static"),
         full_load.get("continuous_over_static")),
        ("paged_over_dense", PAGED_REGRESSION_FRACTION,
         previous.get("full_load", {}).get("paged", {}).get(
             "paged_over_dense"),
         full_load.get("paged", {}).get("paged_over_dense")),
        ("prefix_hit_rate", REGRESSION_FRACTION,
         previous.get("shared_prefix", {}).get("prefix_hit_rate"),
         shared_prefix.get("prefix_hit_rate")),
    )
    failures = []
    for name, fraction, base, ratio in checks:
        if base is None or ratio is None:
            print(f"serving_bench,regression_check=skipped,metric={name} "
                  f"(no previous value)")
            continue
        floor = fraction * base
        status = "ok" if ratio >= floor else "FAIL"
        print(f"serving_bench,regression_check={status},metric={name},"
              f"value={ratio:.2f},previous={base:.2f},floor={floor:.2f}")
        if ratio < floor:
            failures.append(
                f"{name} regressed: {ratio:.2f} < {floor:.2f} "
                f"({int(fraction * 100)}% of the previous {base:.2f})")
    if failures:
        raise AssertionError("; ".join(failures))


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-regression", action="store_true",
                    help="fail if token equivalence breaks or a gated ratio "
                         "drops >20%% below the previous run's in --out")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args()
    run(runtime=Runtime(device=args.device), out=args.out,
        check_regression=args.check_regression)
