"""Kernel bench and the autotuner's measured search.

Two parts:

  * the measured tune of five (op, shape) entries through the session
    device's ``Autotuner`` and ``kernels/tuning.py``: the matmul's tile at
    (N, K) 128 and 256 in bf16, the sort's tile and group at 16 x 1024,
    and WKV's chunk at 4 heads of 16 (its smallest built head size); flash
    attention has one build per (dtype, hd) and so no family to tune.  A
    second tuner over the same cache answers with no measurement (its
    bench hook raises if called).  On the CPU there is no kernel to time:
    the tuner answers with each family's prior;
  * each kernel against its plain version: both timed and the largest
    difference, on the card; on the CPU the plain version runs and the row
    says there is no kernel.

Writes ``<out>/kernels.json``: one record per (op, shape) with the prior
and tuned configs, their measured times, the speedup and the warm
source.  ``check_regression=True`` fails if a tuned-over-prior speedup
falls more than 20 % below the previous file's in the same directory
(none: a baseline is recorded and the check passes).
"""

from __future__ import annotations

import argparse
import tempfile

import torch

from repro_torch.benches.common import (load_json, out_dir, session,
                                        time_us, write_json)
from repro_torch.core.costs.autotune import Autotuner, fmt_config
from repro_torch.core.costs.calibration import backend_fingerprint
from repro_torch.kernels import ops, ref, tuning

BENCH_JSON = "kernels.json"
REGRESSION_FRACTION = 0.8  # fail below 80% of the previous speedup
FLASH_NO_FAMILY = "one build per (dtype, hd): no family to tune"


def _no_bench(runner, reps):
    raise AssertionError("a warm autotune cache must not measure")


def tune_all(t: Autotuner) -> dict:
    """The five (op, shape) entries on tuner ``t`` (flash: None)."""
    bf16, f32 = torch.bfloat16, torch.float32
    return {
        ("matmul", "128x128x128"):
            tuning.tune_matmul(bf16, bf16, bf16, 128, 128, tuner=t),
        ("matmul", "256x256x256"):
            tuning.tune_matmul(bf16, bf16, bf16, 256, 256, tuner=t),
        ("flash_attention", "8x256x256x64"): None,
        ("sort", "16x1024"): tuning.tune_sort(16, 1024, f32, tuner=t),
        ("wkv", "4x16"): tuning.tune_wkv(4, 16, f32, False, tuner=t),
    }


def _record(op, shape, res, warm_res):
    def us(s):
        return None if s is None else s * 1e6

    if res is None:
        return {"op": op, "shape": shape, "family": None,
                "note": FLASH_NO_FAMILY}
    return {
        "op": op,
        "shape": shape,
        "default_config": res.prior_config,
        "tuned_config": res.config,
        "default_median_us": us(res.prior_measured_s),
        "tuned_median_us": us(res.measured_s),
        "tuned_vs_default_speedup": res.speedup_vs_prior,
        "source": res.source,
        "warm_source": warm_res.source,
    }


def _check_regression(previous: dict, records: list) -> None:
    """Each (op, shape)'s tuned-over-prior speedup must stay within
    REGRESSION_FRACTION of the previous run's in the same directory; both
    ratios are measured back to back in one process, so the check compares
    the tuner, not the machine.  Rows without a previous or a measured
    speedup are skipped."""
    before = {(r.get("op"), r.get("shape")): r.get("tuned_vs_default_speedup")
              for r in previous.get("records", [])}
    if not before:
        print("kernel_tune,regression_check=baseline_recorded")
        return
    failures = []
    for r in records:
        base = before.get((r["op"], r["shape"]))
        now = r.get("tuned_vs_default_speedup")
        if base is None or now is None:
            continue
        floor = REGRESSION_FRACTION * base
        status = "ok" if now >= floor else "FAIL"
        print(f"kernel_tune,regression_check={status},op={r['op']},"
              f"shape={r['shape']},speedup={now:.2f},previous={base:.2f},"
              f"floor={floor:.2f}")
        if now < floor:
            failures.append(f"{r['op']}/{r['shape']}: {now:.2f}x < "
                            f"{floor:.2f}x floor (80% of previous {base:.2f}x)")
    if failures:
        raise AssertionError(
            "tuned-vs-default kernel speedup regressed: " + "; ".join(failures))


def kernel_rows(device: torch.device) -> list:
    """Each kernel against its plain version on the same inputs: (name,
    shape, kernel µs or None on the CPU, plain µs, largest difference or
    None)."""
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen).to(device=device,
                                                    dtype=dtype)

    card = device.type == "cuda"
    rows = []

    def row(name, shape, kernel, plain):
        plain_us = time_us(plain, device)
        if not card:
            rows.append((name, shape, None, plain_us, None))
            return
        got, want = kernel(), plain()
        got = got[0] if isinstance(got, tuple) else got
        want = want[0] if isinstance(want, tuple) else want
        diff = (got.float() - want.float()).abs().max().item()
        rows.append((name, shape, time_us(kernel, device), plain_us, diff))

    for n in (128, 256):
        a, b = rand(n, n, dtype=torch.bfloat16), rand(n, n,
                                                      dtype=torch.bfloat16)
        row("matmul", f"n={n}", lambda: ops.matmul(a, b),
            lambda: ref.matmul_fused_ref(a, b, out_dtype=torch.bfloat16))
    for n in (1024, 4096):
        x = rand(1, n)
        row("sort", f"n={n}", lambda: ops.sort(x),
            lambda: ref.bitonic_sort_ref(x))
    q = rand(2, 256, 4, 64, dtype=torch.bfloat16)
    k = rand(2, 256, 2, 64, dtype=torch.bfloat16)
    v = rand(2, 256, 2, 64, dtype=torch.bfloat16)
    row("flash", "s=256", lambda: ops.flash_attention(q, k, v),
        lambda: ref.flash_attention_fwd_plain(q, k, v))
    r, kk, vv = (rand(2, 256, 4, 32) for _ in range(3))
    logw = -torch.exp(rand(2, 256, 4, 32) - 2.0)
    u = rand(4, 32)
    row("wkv", "2x256x4x32", lambda: ops.wkv(r, kk, vv, logw, u, chunk=64),
        lambda: ref.wkv_fwd_plain(r, kk, vv, logw, u, 64))
    return rows


def run(csv=True, runtime=None, out=None, check_regression: bool = False):
    rt = session(runtime)
    out = out_dir(out)
    dev = rt.device
    card = dev.type == "cuda"
    path = out / BENCH_JSON
    previous = load_json(path)  # before this run overwrites it
    # a fresh cache a run (never the session's): every record is measured
    # in this run; the tunes still ledger to the session
    cache = tempfile.mkdtemp(prefix="kernels-bench-", dir=out)
    tuner = Autotuner(cache_dir=cache, measure=card, ledger=rt.ledger,
                      device=str(dev), hw=rt.hw)
    results = tune_all(tuner)
    # a fresh tuner over the same cache: every answer from the cache, no
    # measurement
    warm = Autotuner(cache_dir=cache, measure=card, bench=_no_bench,
                     device=str(dev), hw=rt.hw)
    warm_results = tune_all(warm)

    records = []
    for (op, shape), res in results.items():
        wres = warm_results[(op, shape)]
        records.append(_record(op, shape, res, wres))
        if not csv:
            continue
        if res is None:
            print(f"kernel_tune,op={op},shape={shape},"
                  f"family=none({FLASH_NO_FAMILY})")
            continue
        sp = res.speedup_vs_prior
        print(f"kernel_tune,op={op},shape={shape},"
              f"default=({fmt_config(res.prior_config)}),"
              f"tuned=({fmt_config(res.config)}),"
              f"tuned_vs_default={'-' if sp is None else f'{sp:.2f}x'},"
              f"source={res.source},warm={wres.source}")
    tuned = [r for r in records if r.get("family", True) is not None]
    warm_ok = all(r["warm_source"] == "cache" for r in tuned)
    if csv:
        print(f"kernel_tune,warm_cache_measurement_free={warm_ok},"
              f"warm_bench_calls={warm.bench_calls}")
    if warm.bench_calls:
        raise AssertionError(
            f"the warm tuner measured {warm.bench_calls} times")

    kernels = []
    for name, shape, k_us, p_us, diff in kernel_rows(dev):
        kernels.append({"kernel": name, "shape": shape, "kernel_us": k_us,
                        "plain_us": p_us, "max_abs_diff": diff})
        if csv:
            if k_us is None:
                print(f"kernel_{name},{shape},kernel=none(cpu),"
                      f"plain={p_us:.0f}us")
            else:
                print(f"kernel_{name},{shape},kernel={k_us:.0f}us,"
                      f"plain={p_us:.0f}us,max_abs_diff={diff:.3g}")

    payload = {
        "schema": 1,
        "device": dev.type,
        "fingerprint": backend_fingerprint(str(dev)),
        "warm_cache_measurement_free": warm_ok,
        "records": records,
        "kernels": kernels,
    }
    write_json(path, payload)
    if csv:
        print(f"kernel_tune,wrote={path}")
    if check_regression:
        _check_regression(previous, records)
    return records


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--check-regression", action="store_true",
                    help="fail if any (op, shape)'s tuned-vs-default speedup "
                         "drops >20%% below the previous run's in --out")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"))
    args = ap.parse_args()
    from repro_torch.runtime import Runtime

    run(runtime=Runtime(device=args.device), out=args.out,
        check_regression=args.check_regression)
