"""Time the bitonic sort kernel at its own tile and global group against
other pairs, on one NVIDIA GPU.

    python3 tools/sort_tile_sweep.py [LOG_TILE:LOG_GROUP ...]   # default 15:5

Each pair is ``csrc/bitonic_sort.cu`` built by ``kernels/build.py`` with
``SORT_LOG_TILE`` and ``SORT_LOG_GROUP`` defined; the kernel as the port
builds it comes first.  Prints the card's name and power limit, each
build's spills (ptxas -v), then each shape's time (CUDA events, cold L2)
beside ``torch.sort`` and one 2^26 fp32 call by launch kind
(``chip_smoke.sort_stages``).  Exits 1 if an output differs from
``torch.sort`` or a call's launches from ``passes``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
from chip_smoke import (SORT_PTXAS_KINDS, cuda_ms, ptxas_summary,  # noqa: E402
                        sort_stages)
from repro_torch.kernels import bitonic_sort as bs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

SHAPES = [((1, 2048), torch.float32), ((1, 1 << 17), torch.float32),
          ((1, 1 << 20), torch.float32), ((4096, 4096), torch.float32),
          ((1, 1 << 24), torch.int32), ((1, 1 << 26), torch.float32)]


def launcher(log_tile, log_group):
    """sort(x) on the kernel built with this tile and group; its last
    call's launches in ``sort.grids``."""
    own = (log_tile, log_group) == (bs.TILE.bit_length() - 1, bs.LOG_GROUP)
    fn = bs._function(() if own else (f"SORT_LOG_TILE={log_tile}",
                                      f"SORT_LOG_GROUP={log_group}"))
    spill = max(r["spill_bytes"] for r in ptxas_summary(
        build.LOGS.get("bitonic_sort", ""), SORT_PTXAS_KINDS).values()) \
        if "bitonic_sort" in build.LOGS else "not rebuilt"
    print(f"T=2^{log_tile} m={log_group}: spill bytes {spill}", flush=True)
    build.LOGS.pop("bitonic_sort", None)

    def sort(x):
        out, grids = torch.empty_like(x), ctypes.c_int(0)
        err = fn(x.data_ptr(), out.data_ptr(), int(x.dtype == torch.int32),
                 *x.shape, torch.cuda.current_stream().cuda_stream,
                 ctypes.byref(grids))
        if err:
            raise RuntimeError(f"cudaError {err}")
        sort.grids = grids.value
        return out
    return sort


def main() -> int:
    if not torch.cuda.is_available():
        print("sort_tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    pairs = [(bs.TILE.bit_length() - 1, bs.LOG_GROUP)] + [
        tuple(map(int, a.split(":"))) for a in sys.argv[1:] or ["15:5"]]
    sorts = {p: launcher(*p) for p in pairs}
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    ok = True
    for shape, dtype in SHAPES:
        x = (torch.randn(shape, generator=gen, device="cuda") * 1e4).to(dtype)
        want = torch.sort(x, -1).values
        line = (f"{shape} {str(dtype)[6:]}: torch.sort "
                f"{cuda_ms(lambda: torch.sort(x, -1), flush, 5, 1):.4f} ms")
        for (lt, lg), sort in sorts.items():
            good = torch.equal(sort(x), want) and \
                sort.grids == len(bs.passes(shape[1], 1 << lt, lg))
            ok &= good
            line += (f" | T=2^{lt} m={lg}: {'ok' if good else 'WRONG'}, "
                     f"{sort.grids} launches, "
                     f"{cuda_ms(lambda: sort(x), flush, 5, 1):.4f} ms")
        print(line, flush=True)
    for (lt, lg), sort in sorts.items():
        print(f"T=2^{lt} m={lg}:", flush=True)
        sort_stages(gen, sort)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
