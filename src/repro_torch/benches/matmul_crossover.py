"""The paper's Fig. 2: serial against parallel matmul over the order.

The paper measures serial and parallel (OpenMP) matmul wall time over the
matrix order and finds parallel pays only above order ~1000.  Here the
serial product is measured through ``adaptive_matmul(use_kernel=True)`` on
the session's device (the matmul kernel on the card, in bf16 up to order
8192; its plain version on the CPU, in fp32 up to 4096), beside the
engine's serial prediction and ``decide_matmul``'s choice at 8, 64 and
256 chips.  The crossover order is the quantitative output, for the
datasheet engine (the H100) and for ``CostEngine.calibrated`` (the card's
own constants; calibration times the card, so a CPU session has none).
"""

from __future__ import annotations

import torch

from repro_torch.benches.common import (cache_dir, mean_us, out_dir,
                                        session)
from repro_torch.core import CostEngine, adaptive_matmul, decide_matmul

ORDERS = (128, 256, 512, 1024, 2048, 4096, 8192, 16384)
CHIPS = (8, 64, 256)
MEASURE_MAX = {"cuda": 8192, "cpu": 4096}


def predictions(engine: CostEngine) -> list:
    """Each order's serial prediction and the chosen strategy and its
    prediction at each chip count (µs): the suite's deterministic rows."""
    om = engine.model
    rows = []
    for n in ORDERS:
        row = {"order": n, "pred_serial_us":
               om.matmul_cost(n, n, n, strategy="serial").total * 1e6}
        for c in CHIPS:
            rep = decide_matmul(n, n, n, chips=c, engine=engine)
            row[f"pred_{c}chips_us"] = rep.chosen.total * 1e6
            row[f"strategy_{c}"] = rep.chosen.strategy
        rows.append(row)
    return rows


def crossovers(engine: CostEngine, calibrated=None) -> dict:
    """chips -> (the datasheet engine's crossover order, the calibrated
    engine's or None)."""
    return {c: (engine.matmul_crossover_order(c),
                calibrated.matmul_crossover_order(c)
                if calibrated is not None else None) for c in CHIPS}


def measure(n: int, device: torch.device, engine=None) -> float:
    """Mean µs of one serial (n, n) product through the matmul kernel
    (its plain version on the CPU)."""
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    a = torch.ones((n, n), dtype=dtype, device=device)
    return mean_us(lambda: adaptive_matmul(a, a, use_kernel=True,
                                           engine=engine), device)


def run(csv=True, runtime=None, out=None):
    rt = session(runtime)
    out = out_dir(out)
    dev = rt.device
    engine = CostEngine()  # the H100 datasheet (open-loop baseline)
    calibrated = CostEngine.calibrated(
        cache_dir=cache_dir(rt, out), device=str(dev)) \
        if dev.type == "cuda" else None
    rows = predictions(engine)
    for row in rows:
        n = row["order"]
        row["measured_us"] = measure(n, dev, rt.engine) \
            if n <= MEASURE_MAX[dev.type] else float("nan")
        if csv:
            print(f"matmul_crossover,order={n},"
                  f"{dev.type}={row['measured_us']:.1f}us,"
                  f"serial={row['pred_serial_us']:.2f}us," +
                  ",".join(f"{c}chips={row[f'pred_{c}chips_us']:.2f}us/"
                           f"{row[f'strategy_{c}']}" for c in CHIPS))
    xo = crossovers(engine, calibrated)
    for c, (order, cal) in xo.items():
        print(f"matmul_crossover,chips={c},crossover_order={order},"
              f"calibrated_order="
              f"{cal if cal is not None else 'none(cpu)'},"
              f"paper_cpu_order=1000")
    return rows


if __name__ == "__main__":
    run()
