"""Distributed sample sort: the paper's quicksort study on a mesh.

Eight shards sort a skewed array under each of the paper's pivot
strategies (plus regular sampling) and report each strategy's bucket
imbalance; then the overhead-managed path picks serial for a small array.
The shards share the devices there are: on one GPU all eight run on it,
each on its own CUDA stream (the counterpart of the reference's eight
forced host devices), which the mesh is told explicitly.

Run:  PYTHONPATH=src python examples/torch_distributed_sort.py       # GPU
      PYTHONPATH=src python examples/torch_distributed_sort.py --device cpu
"""

import argparse
import math

import torch

import repro_torch
from repro_torch.core.sort import PIVOT_STRATEGIES, distributed_sort
from repro_torch.distributed import make_mesh
from repro_torch.distributed.mesh import available_devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: an NVIDIA GPU) or 'cpu'")
    ap.add_argument("--n", type=int, default=20_000, help="array length")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--local-sort", default="kernel",
                    choices=("kernel", "torch"))
    args = ap.parse_args(argv)

    rt = repro_torch.Runtime(device=args.device)
    per_device = args.shards // math.gcd(args.shards,
                                         available_devices(args.device))
    mesh = make_mesh({"data": args.shards}, device=rt.device.type,
                     shards_per_device=per_device)
    print(f"mesh: {mesh.shape} on {len(set(mesh.devices))} "
          f"{rt.device.type} device(s), {per_device} shard(s) a device; "
          f"sort crossover at {args.shards} shards: n >= "
          f"{rt.engine.sort_crossover_n(args.shards)}")

    g = torch.Generator(device=rt.device).manual_seed(0)
    x = torch.exp(torch.randn(args.n, generator=g, device=rt.device))
    ref = torch.sort(x).values

    print(f"{'pivot':>10s} {'correct':>8s} {'imbalance':>10s}   (paper "
          f"Table 3: random pivots worst)")
    for pivot in PIVOT_STRATEGIES:
        out, rep = distributed_sort(x, mesh, pivot=pivot,
                                    force_parallel=True,
                                    engine=rt.engine,
                                    local_sort=args.local_sort)
        ok = torch.equal(out, ref)
        print(f"{pivot:>10s} {str(ok):>8s} {rep.imbalance:>10.2f}")

    # the overhead-managed path: a small array stays serial
    small = torch.arange(100.0, device=rt.device).flip(0)
    _, rep_s = distributed_sort(small, mesh, engine=rt.engine,
                                local_sort=args.local_sort)
    print(f"\nadaptive: n=100 -> {rep_s.strategy} (overhead says serial "
          f"wins)")


if __name__ == "__main__":
    main()
