"""Overhead-managed dispatch: the paper's core idea end to end, on the port.

1. crossover analysis (paper Fig. 2) for matmul and sorting, priced on
   the session's hardware spec (the H100 data sheet unless calibrated),
2. fork-join adaptive matmul on a mesh of eight shards (serial by the
   engine's choice, then each sharded strategy forced) and a matrix chain
   whose products the engine dispatches over the mesh,
3. dependency analysis (work/span) of a block-like function (torch.fx),
4. the overhead-driven sharding plan for every configuration on a 16 x 16
   mesh (analytic: it needs the mesh's shape, not its devices).

The shards share the devices there are: on one GPU all eight run on it,
each on its own CUDA stream, which the mesh is told explicitly.

Run:  PYTHONPATH=src python examples/torch_adaptive_dispatch.py       # GPU
      PYTHONPATH=src python examples/torch_adaptive_dispatch.py --device cpu
"""

import argparse
import math

import torch

import repro_torch
from repro_torch.configs import SHAPES
from repro_torch.core import (
    adaptive_matmul,
    analyze_dependencies,
    decide_matmul,
    matmul_chain,
)
from repro_torch.distributed import make_mesh
from repro_torch.distributed.mesh import available_devices


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default: an NVIDIA GPU) or 'cpu'")
    ap.add_argument("--order", type=int, default=1024,
                    help="order of the forked matmul")
    ap.add_argument("--shards", type=int, default=8)
    args = ap.parse_args(argv)

    # one explicit session; from_env keeps the legacy env-var behaviour
    # (REPRO_CALIBRATE=1 calibrates the engine to this card)
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig.from_env(),
                             device=args.device)
    engine = rt.engine

    print(f"== crossovers on {engine.hw.name} "
          f"(paper: matmul order ~1000 on multicore CPU) ==")
    for chips in (8, 64, 256):
        print(f"  {chips:3d} chips: matmul order >= "
              f"{engine.matmul_crossover_order(chips):6d}, "
              f"sort n >= {engine.sort_crossover_n(chips)}")

    print("\n== adaptive matmul decisions ==")
    for n in (256, 2048, 16384):
        rep = decide_matmul(n, n, n, chips=256, engine=engine)
        print(f"  {n:6d}^3 -> {rep.chosen.strategy:8s} "
              f"predicted speedup {rep.predicted_speedup:5.2f}x "
              f"dominant={rep.chosen.dominant()}")

    per_device = args.shards // math.gcd(args.shards,
                                         available_devices(args.device))
    mesh = make_mesh({"data": args.shards}, device=rt.device.type,
                     shards_per_device=per_device)
    print(f"\n== fork-join on {mesh.shape}, {per_device} shard(s) a "
          f"{rt.device.type} device ==")
    g = torch.Generator(device=rt.device).manual_seed(0)
    o = args.order
    a = torch.randn(o, o, generator=g, device=rt.device)
    b = torch.randn(o, o, generator=g, device=rt.device)
    serial = adaptive_matmul(a, b, use_kernel=True, engine=engine)
    scale = float(serial.abs().max())
    out, rep = adaptive_matmul(a, b, mesh, return_report=True,
                               use_kernel=True, engine=engine)
    print(f"  {o}^3 on {args.shards} shards: the engine says "
          f"{rep.chosen.strategy}")
    for strategy in ("shard_m", "shard_n", "shard_k", "shard_mn"):
        out = adaptive_matmul(a, b, mesh, force_strategy=strategy,
                              use_kernel=True, engine=engine)
        err = float((out - serial).abs().max()) / scale
        print(f"  forced {strategy:8s}: max|C - serial| = {err:.1e} x "
              f"max|C|")
    mats = [torch.randn(s, generator=g, device=rt.device) for s in
            [(o // 4, o // 2), (o // 2, o // 8), (o // 8, o), (o, o // 4)]]
    chain = matmul_chain(mats, mesh, engine=engine, use_kernel=True)
    want = mats[0] @ mats[1] @ mats[2] @ mats[3]
    err = float((chain - want).abs().max() / want.abs().max())
    print(f"  matrix chain on the mesh: {tuple(chain.shape)}, "
          f"max|err| = {err:.1e} x max|C|")

    print("\n== dependency analysis (work/span) ==")
    x = torch.ones((64, 64))
    rep = analyze_dependencies(
        lambda x: torch.softmax(x @ x.T, -1) @ x + torch.tanh(x @ x), x)
    print(f"  attention-like block: {rep.summary()}")

    print("\n== overhead-driven sharding plans (16x16 mesh, train_4k) ==")
    for arch in repro_torch.list_configs():
        plan = rt.plan(repro_torch.get_config(arch), SHAPES["train_4k"],
                       {"data": 16, "model": 16})
        print(f"--- {arch}")
        print(plan.summary())

    print("\n== cost ledger (every decision above; cache stats) ==")
    print(f"  decision cache: {engine.cache_stats()}")
    print(engine.ledger.table(max_rows=12))


if __name__ == "__main__":
    main()
