"""The roofline table: renders each ``dryrun_*.json`` in the output
directory (written by ``python -m repro_torch.launch.dryrun --all --out
<out>/dryrun_pod.json``) as one markdown row per (arch x shape x mesh)
cell: the three terms, the bound, the useful-FLOP fraction and the
roofline fractions."""

from __future__ import annotations

import json
import sys

from repro_torch.benches.common import out_dir

COLS = ("t_compute_s", "t_memory_s", "t_collective_s")


def render(path: str) -> str:
    with open(path) as f:
        recs = json.load(f)
    lines = [
        "| cell | chips | compute s | memory s | collective s | bound | "
        "MODEL/HLO flops | frac (XLA) | frac (flash) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in recs:
        if r["status"] == "skipped":
            lines.append(f"| {r['cell']} | — | — | — | — | skipped | — | — | — |"
                         f" <!-- {r['reason']} -->")
            continue
        if r["status"] != "ok" or "roofline" not in r:
            lines.append(f"| {r['cell']} | — | — | — | — | {r['status']} | — | — | — |")
            continue
        t = r["roofline"]["terms"]
        tf = r["roofline"].get("terms_flash_kernel", t)
        lines.append(
            f"| {r['cell']} | {t['chips']} | {t['t_compute_s']:.3e} | "
            f"{t['t_memory_s']:.3e} | {t['t_collective_s']:.3e} | {t['bound']} | "
            f"{t['useful_flops_fraction']:.3f} | {t['roofline_fraction']:.3f} | "
            f"{tf['roofline_fraction']:.3f} |"
        )
    return "\n".join(lines)


def run(csv=True, runtime=None, out=None):  # renders earlier dry runs
    for p in sorted(out_dir(out).glob("dryrun_*.json")):
        print(f"=== {p} ===")
        print(render(str(p)))
    return []


if __name__ == "__main__":
    if len(sys.argv) > 1:
        print(render(sys.argv[1]))
    else:
        run()
