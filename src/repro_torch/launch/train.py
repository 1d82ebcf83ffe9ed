"""Training launcher: a thin command-line adapter over
``repro_torch.Runtime.train``.

Runs on the GPU (``cuda``) unless ``--device cpu`` asks for the plain
PyTorch path on the CPU; without a card and without ``--device cpu`` it
raises.  Fault tolerance lives in ``Runtime.train``:

* periodic and SIGTERM-triggered checkpoints (the launcher wires SIGTERM
  to the ``should_stop`` hook);
* ``--resume`` restarts from the latest complete checkpoint, and the
  step-indexed data pipeline replays from the restored step;
* a per-step wall-time watchdog logs stragglers (``--step-timeout``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 4 --batch 2 --seq 2048 --report-overheads
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 4 --batch 2 --seq 32 --device cpu
"""

from __future__ import annotations

import argparse
import signal
import sys

from repro_torch.configs import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime import Runtime, RuntimeConfig
from repro_torch.training import TrainLoopConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke scale (reduced config of the same family)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for parameter init and the synthetic data "
                    "stream (runs are reproducible per seed)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compression", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--step-timeout", type=float, default=0.0,
                    help="log a straggler warning if a step exceeds this "
                    "many seconds")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--report-overheads", action="store_true",
                    help="print the overhead plan up front and the "
                    "CostEngine ledger (predicted-vs-measured) at exit")
    ap.add_argument("--ledger-out", default=None,
                    help="write the CostEngine ledger JSON here at exit")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the GPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    loop = TrainLoopConfig(
        optimizer=AdamWConfig(lr=args.lr),
        warmup_steps=max(args.steps // 20, 1),
        total_steps=args.steps,
        microbatches=args.microbatches,
        compression=args.compression,
    )
    rt = Runtime(RuntimeConfig(device=args.device))

    # preemption safety: checkpoint on SIGTERM, then exit cleanly
    interrupted = {"flag": False}
    signal.signal(signal.SIGTERM,
                  lambda signum, frame: interrupted.update(flag=True))

    on_plan = None
    if args.report_overheads:
        on_plan = lambda plan: print(  # noqa: E731
            f"overhead plan ({rt.hw.name}):\n{plan.summary()}")
    try:
        res = rt.train(
            cfg, loop, steps=args.steps, batch=args.batch, seq=args.seq,
            seed=args.seed, ckpt_dir=args.ckpt_dir,
            ckpt_every=args.ckpt_every, resume=args.resume,
            step_timeout=args.step_timeout, log_every=args.log_every,
            should_stop=lambda: interrupted["flag"], on_plan=on_plan)
    finally:
        if args.report_overheads:
            print("cost ledger:\n" + rt.ledger.table())
        if args.ledger_out:
            rt.ledger.to_json(args.ledger_out)
            print(f"wrote ledger to {args.ledger_out}")
    if res.diverged:
        return 1
    if not res.interrupted:
        print(f"done: {res.steps_run} steps in {res.wall_s:.1f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
