"""The bf16 flash kernels of two checkouts, forward and backward, at
phi3-mini's, gemma-2b's and recurrentgemma-2b's training shapes, in turns
on one card.

    git archive <commit> | tar -x -C results/base   # results/ is ignored
    python3 tools/flash_ab.py results/base .        # the card

Each run is a process of its own that imports its checkout's
``repro_torch`` and builds its ``flash_attention.cu`` into that checkout's
``build/``; the runs go base, new, new, base (``--pairs`` such pairs).
Each times ``flash_attention_fwd_cuda`` and ``flash_attention_bwd_cuda``
(the backward fed the kernel forward's output and lse) with CUDA events
and a cold L2 (a 512 MiB buffer rewritten before each rep), and
``scaled_dot_product_attention`` and its backward on the same tensors as
a yardstick, and records the path the calls took.  Prints one JSON line
a run, the card's name and power limit, and a summary JSON as the last
line (per side and shape: every forward and backward reading).
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPES = [(2, 2048, 32, 32, 96), (2, 2048, 8, 1, 256), (2, 2048, 10, 1, 256)]


def cuda_ms(torch, fn, flush, reps=10, warm=2) -> float:
    for _ in range(warm):
        fn()
    events = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def run_side(checkout: Path) -> list:
    """One run: every shape's times with ``checkout``'s kernels."""
    import torch
    import torch.nn.functional as F

    sys.path.insert(0, str(checkout / "src"))
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    build.build_all(("flash_attention",))
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, s, hq, hkv, hd in SHAPES:
        q, k, v, do = (torch.randn((b, s, h, hd), generator=gen,
                                   device="cuda").to(torch.bfloat16)
                       for h in (hq, hkv, hkv, hq))
        fa.LAUNCHES.reset()
        o, lse = fa.flash_attention_fwd_cuda(q, k, v)
        path = [p for p, n in fa.LAUNCHES.by_path.items() if n]
        qt, kt, vt = (t.transpose(1, 2).detach().clone().requires_grad_(True)
                      for t in (q, k, v))
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                             enable_gqa=True)
        rows.append(dict(
            shape=[b, s, hq, hkv, hd], path=path,
            fwd_ms=cuda_ms(torch, lambda: fa.flash_attention_fwd_cuda(
                q, k, v), flush),
            bwd_ms=cuda_ms(torch, lambda: fa.flash_attention_bwd_cuda(
                q, k, v, o, lse, do), flush),
            sdpa_fwd_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), flush),
            sdpa_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                out, (qt, kt, vt), do.transpose(1, 2), retain_graph=True),
                flush)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("base", type=Path)
    ap.add_argument("new", type=Path)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--side", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.side:
        print(json.dumps(run_side(args.side.resolve())), flush=True)
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    order = ["base", "new", "new", "base"] * args.pairs
    summary = {"card": card, "order": order, "base": {}, "new": {}}
    for side in order:
        proc = subprocess.run(
            [sys.executable, __file__, str(args.base), str(args.new),
             "--side", str(getattr(args, side))],
            capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps({"side": side, "rows": rows}), flush=True)
        for row in rows:
            key = "x".join(map(str, row["shape"]))
            got = summary[side].setdefault(key, {"path": row["path"]})
            for name in ("fwd_ms", "bwd_ms", "sdpa_fwd_ms", "sdpa_bwd_ms"):
                got.setdefault(name, []).append(row[name])
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
