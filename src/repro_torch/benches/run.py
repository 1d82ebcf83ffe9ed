"""Benchmark harness: one module per paper table or figure, and the
framework's extras, on the port.

  matmul_crossover  the paper's Fig. 2: serial products on the matmul
                    kernel against the engine's serial and parallel
                    predictions, and the crossover order
  sort_pivots       the paper's Table 3: serial sorts, and the pivot
                    strategies' imbalance on an 8-position mesh
  wkv_chunk         the WKV chunk sweep against the engine's prediction
  kernels_bench     the autotuner's measured tunes, a warm tuner with no
                    measurement, and each kernel against its plain version
  roofline_table    renders the port's dry-run JSON
  cost_ledger       the datasheet engine against the calibrated one:
                    crossovers, decision flips, measured products and sorts
  serving_bench     static against continuous serving, and the sharded,
                    paged and shared-prefix rows
  stress_bench      overload and the fault drills against the request
                    lifecycle
  chaos_bench       the closed-loop recovery drill of the cost engine

Every suite is ``run(csv=True, runtime=None, out=None)`` over the public
Runtime API and runs on the Runtime's device.  It prints
``name,key=value,...`` CSV lines and writes only under ``out``
(``results/torch/`` by default).  Run:

  PYTHONPATH=src python -m repro_torch.benches.run [--only NAME] [--list]
      [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

# static: --list and --only validation import no suite
SUITE_NAMES = (
    "matmul_crossover",
    "sort_pivots",
    "wkv_chunk",
    "kernels_bench",
    "roofline_table",
    "cost_ledger",
    "serving_bench",
    "stress_bench",
    "chaos_bench",
)


def _suites():
    from repro_torch.benches import (
        chaos_bench,
        cost_ledger,
        kernels_bench,
        matmul_crossover,
        roofline_table,
        serving_bench,
        sort_pivots,
        stress_bench,
        wkv_chunk,
    )

    suites = {
        "matmul_crossover": matmul_crossover.run,
        "sort_pivots": sort_pivots.run,
        "wkv_chunk": wkv_chunk.run,
        "kernels_bench": kernels_bench.run,
        "roofline_table": roofline_table.run,
        "cost_ledger": cost_ledger.run,
        "serving_bench": serving_bench.run,
        "stress_bench": stress_bench.run,
        "chaos_bench": chaos_bench.run,
    }
    assert set(suites) == set(SUITE_NAMES)
    return suites


def run_suites(runtime, only=None, out=None):
    """Run all suites (or just ``only``) against ``runtime``, writing under
    ``out``; returns the names of failed suites.  An unknown ``only``
    raises KeyError: running no suite is an error, never a silent
    success."""
    suites = _suites()
    if only is not None:
        if only not in suites:
            raise KeyError(
                f"unknown suite {only!r}; available: {', '.join(SUITE_NAMES)}")
        suites = {only: suites[only]}
    failed = []
    for name, fn in suites.items():
        print(f"### {name}", flush=True)
        t0 = time.time()
        try:
            fn(runtime=runtime, out=out)
            print(f"### {name} done in {time.time() - t0:.1f}s\n", flush=True)
        except Exception:
            traceback.print_exc()
            failed.append(name)
    _print_drift(runtime)
    return failed


def _print_drift(runtime) -> None:
    """Calibration drift over everything the suites measured: each site's
    geometric-mean measured/predicted ratio from the session's ledger,
    raw drift (outside the site's band) called out beside the live
    correction factor and whether it absorbs the drift (``resolved``)."""
    try:
        drift = runtime.engine.drift_report()
    except Exception:
        traceback.print_exc()
        return
    if not drift:
        return
    print("### calibration drift (measured/predicted, trailing window)")
    for site, row in sorted(drift.items()):
        if row.get("drifting"):
            flag = ("  DRIFTING(resolved)" if row.get("resolved")
                    else "  DRIFTING")
        else:
            flag = ""
        ratio = row.get("geomean_ratio", float("nan"))
        print(f"drift,site={site},geomean_ratio={ratio:.3g},"
              f"raw_ratio={row.get('raw_ratio', float('nan')):.3g},"
              f"correction={row.get('correction', 1.0):.3g},"
              f"rows={row.get('n', 0)}{flag}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help=f"run a single suite; one of: {', '.join(SUITE_NAMES)}")
    ap.add_argument("--list", action="store_true",
                    help="list available suites and exit")
    ap.add_argument("--out", default=None,
                    help="output directory (default results/torch)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the session's device (default: the card)")
    args = ap.parse_args(argv)

    if args.list:
        print("\n".join(SUITE_NAMES))
        return
    if args.only is not None and args.only not in SUITE_NAMES:
        ap.error(f"unknown suite {args.only!r}; "
                 f"available: {', '.join(SUITE_NAMES)}")

    from repro_torch.runtime import Runtime, RuntimeConfig

    runtime = Runtime(RuntimeConfig.from_env(), device=args.device)
    failed = run_suites(runtime, only=args.only, out=args.out)
    if failed:
        print(f"FAILED suites: {failed}")
        sys.exit(1)


if __name__ == "__main__":
    main()
