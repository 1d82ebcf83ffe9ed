"""Predicted against measured: the paper's comparative tables, closed
loop.

Runs real work on the session's device with the CostEngine's timing hooks
armed, for two engines side by side:

  * pred        the session's hardware spec as it stands (the H100 data
                sheet unless the session calibrated), open loop
  * calibrated  constants measured on this card (``CostEngine.calibrated``;
                calibration times the card, so a CPU session has none)

and prints each engine's matmul and sort crossovers, the dispatch
decisions that calibration flips, serial products and sorts measured
against both engines' predictions, how far the autotuner's prior sits
from its measured optimum, and the calibrated (or, on the CPU, the pred)
engine's ledger, written to ``<out>/ledger.json``.
"""

from __future__ import annotations

import tempfile

import torch

from repro_torch.benches.common import (cache_dir, mean_us, out_dir,
                                        session)
from repro_torch.core import CostEngine, distributed_sort
from repro_torch.core.costs.autotune import Autotuner, fmt_config
from repro_torch.kernels import ops
from repro_torch.kernels import tuning as ktuning

ORDERS = (256, 512, 1024, 2048)
SORT_NS = (10_000, 1_000_000)
CHIPS = (8, 64)
FLIP_ORDERS = ORDERS + (4096, 8192, 16384)


def decision_flips(engines: dict) -> list:
    """(chips, order, first engine's choice, second's) wherever two
    engines choose differently for a product at the master."""
    (na, a), (nb, b) = list(engines.items())[:2]
    flips = []
    for c in CHIPS:
        for n in FLIP_ORDERS:
            ca = a.decide_matmul(n, n, n, chips=c, io_at_master=True).choice
            cb = b.decide_matmul(n, n, n, chips=c, io_at_master=True).choice
            if ca != cb:
                flips.append((c, n, ca, cb))
    return flips


def run(csv=True, runtime=None, out=None):
    rt = session(runtime)
    out = out_dir(out)
    dev = rt.device
    card = dev.type == "cuda"
    engines = {"pred": CostEngine(hw=rt.hw)}
    if card:
        engines["calibrated"] = CostEngine.calibrated(
            cache_dir=cache_dir(rt, out), device=str(dev))
    rows = []

    for name, eng in engines.items():
        for c in CHIPS:
            print(f"cost_ledger,engine={name},chips={c},"
                  f"matmul_crossover={eng.matmul_crossover_order(c)},"
                  f"sort_crossover={eng.sort_crossover_n(c)}")
    if len(engines) > 1:
        flips = decision_flips(engines)
        for c, n, a, b in flips:
            print(f"cost_ledger,decision_flip,chips={c},order={n},"
                  f"pred={a},calibrated={b}")
        print(f"cost_ledger,decision_flips={len(flips)}")
    else:
        print("cost_ledger,decision_flips=none(cpu: calibration needs the "
              "card)")

    # measured serial fp32 products against each engine's prediction
    for n in ORDERS:
        a = torch.ones((n, n), dtype=torch.float32, device=dev)
        wall = mean_us(lambda: ops.matmul(a, a), dev) * 1e-6
        preds = {}
        for name, eng in engines.items():
            dec = eng.decide_matmul(n, n, n, chips=1, dtype_bytes=4)
            eng.record_measured(dec, wall, note=f"{name} serial matmul")
            preds[name] = dec.predicted_s
        rows.append({"order": n, "measured_us": wall * 1e6})
        if csv:
            print(f"cost_ledger,matmul_order={n},measured={wall*1e6:.1f}us," +
                  ",".join(f"{'cal_pred' if k == 'calibrated' else k}="
                           f"{v*1e6:.2f}us" for k, v in preds.items()))

    # measured sorts through the dispatch path (serial on one device)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n in SORT_NS:
        x = torch.randn((n,), generator=gen).to(dev)
        for eng in engines.values():
            distributed_sort(x, engine=eng, measure=True, local_sort="kernel")

    # the tuner's prior against its measured optimum (a fresh cache, so
    # it measures; the rows land in the last engine's ledger)
    last = list(engines.values())[-1]
    tuner = Autotuner(cache_dir=tempfile.mkdtemp(prefix="cost-ledger-tune-",
                                                 dir=out),
                      measure=card, ledger=last.ledger, device=str(dev),
                      hw=last.hw)
    tunes = (ktuning.tune_matmul(torch.bfloat16, torch.bfloat16,
                                 torch.bfloat16, 256, 256, tuner=tuner),
             ktuning.tune_sort(16, 1024, torch.float32, tuner=tuner))
    for res in tunes:
        sp = res.speedup_vs_prior
        pm, tm = res.prior_measured_s, res.measured_s
        print(f"cost_ledger,autotune,family={res.family},"
              f"prior=({fmt_config(res.prior_config)}),"
              f"tuned=({fmt_config(res.config)}),"
              f"prior_us={'-' if pm is None else f'{pm * 1e6:.0f}'},"
              f"tuned_us={'-' if tm is None else f'{tm * 1e6:.0f}'},"
              f"tuned_vs_prior={'-' if sp is None else f'{sp:.2f}x'}")

    for name, eng in engines.items():
        s = eng.ledger.summary()
        ratio = s["mean_measured_over_predicted"]
        print(f"cost_ledger,engine={name},measured={s['measured']},"
              f"mean_meas_over_pred="
              f"{'-' if ratio is None else f'{ratio:.3g}'}")
    label = list(engines)[-1]
    print(f"\n--- {label}-engine ledger (predicted vs measured) ---")
    print(last.ledger.table())
    path = out / "ledger.json"
    last.ledger.to_json(str(path))
    print(f"cost_ledger,wrote={path}")
    return rows


if __name__ == "__main__":
    run()
