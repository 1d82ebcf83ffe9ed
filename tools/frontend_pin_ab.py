"""Pinned against unpinned: tok/s of the continuous engine serving
through the multi-process front end, in turns, in one process.

    python3 tools/frontend_pin_ab.py                 # the card
    python3 tools/frontend_pin_ab.py --device cpu --reduced --pairs 1

Serves chip_smoke.py's phase 5 trace (tinyllama-1.1b, random weights
from seed 0, 8 requests of 64 prompt + 32 new tokens at t=0, 4 slots, no
EOS) through ``Runtime.serve(frontend=2, stream=True)`` with ``pin`` on
and off, in pairs that alternate which side runs first (on, off, off,
on, ...), after one in-process streamed run that warms the host.  Every
run's tokens must equal the in-process run's.  Prints one line per run,
the card's name and power limit, and a JSON summary as the last line
(per side: every tok/s reading, the median, the quartile spread; the
pairs the pinned side won).
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace

    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    else:
        card = "CPU (not a device measurement)"
    cfg = get_config("tinyllama-1.1b")
    if args.reduced:
        cfg = cfg.reduced()
    rt = Runtime(device=args.device)
    model = build_model(cfg, rt.device)
    params = model.init(0)
    kw = dict(model=model, params=params, slots=4, eos_id=-1)

    def trace():
        return synthetic_trace(8, prompt_len=64, max_new=32,
                               vocab_size=cfg.vocab_size, arrival="all",
                               seed=0)

    base = rt.serve(cfg, trace(), stream=True, **kw)
    print(f"in process: {base.tok_per_s:.3f} tok/s", flush=True)
    want = {r: v.tolist() for r, v in base.outputs.items()}
    runs = {"pinned": [], "unpinned": []}
    order = []
    for i in range(args.pairs):
        pair = (True, False) if i % 2 == 0 else (False, True)
        for pin in pair:
            res = rt.serve(cfg, trace(), frontend=2, stream=True, pin=pin,
                           **kw)
            same = {r: v.tolist() for r, v in res.outputs.items()} == want
            side = "pinned" if pin else "unpinned"
            runs[side].append(res.tok_per_s)
            order.append(side)
            print(f"pair {i} {side}: {res.tok_per_s:.3f} tok/s, tokens "
                  f"equal {same}", flush=True)
            if not same:
                return 1
    summary = {"card": card, "in_process": base.tok_per_s, "order": order,
               "pinned_won": sum(a > b for a, b in zip(runs["pinned"],
                                                       runs["unpinned"]))}
    for side, vals in runs.items():
        q = statistics.quantiles(vals, n=4) if len(vals) > 1 else vals * 3
        summary[side] = {"tok_per_s": vals,
                         "median": statistics.median(vals),
                         "quartile_spread": q[2] - q[0]}
    print(card, flush=True)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
