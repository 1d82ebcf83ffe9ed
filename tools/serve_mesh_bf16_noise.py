"""How far tensor-parallel serving moves bf16 logits, against how far bf16
itself moves them: on the CPU, tinyllama-1.1b's layout at a quarter of its
width (d_model 512, 16 query heads and 4 kv heads of 32, d_ff 1408, vocab
4000), random weights from seed 0, at 2, 8 and 22 layers.  For one
``Model.prefill`` of 4 x 64 tokens it prints, as max|difference| /
max|logit|: the sharded logits (a {"data": 1, "model": 8} CPU mesh, the
serve specs) against the unsharded ones, and each against the same
weights computed in fp32.  The sharded sums add their fp32 partials in
another order than one product does, so the bf16 residual stream rounds
differently; the distance grows with depth as bf16's own does.

    PYTHONPATH=src python tools/serve_mesh_bf16_noise.py   # about a minute
"""

import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.distributed import make_mesh, replicate, take
from repro_torch.distributed.sharding import (ShardingCtx, param_shardings,
                                              place_tree)
from repro_torch.models import build_model
from repro_torch.tree import tree_map


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def main() -> None:
    gen = torch.Generator().manual_seed(0)
    mesh = make_mesh({"data": 1, "model": 8}, device="cpu",
                     shards_per_device=8)
    ctx = ShardingCtx(mesh=mesh, data_axes=())
    for layers in (2, 8, 22):
        cfg = dataclasses.replace(
            get_config("tinyllama-1.1b"), n_layers=layers, d_model=512,
            d_ff=1408, n_heads=16, n_kv_heads=4, head_dim=32,
            vocab_size=4000, dtype="bfloat16")
        model = build_model(cfg, "cpu")
        params = model.init(0)
        placed = place_tree(mesh, params, param_shardings(
            params, mesh, data_axes=(), cfg=cfg))
        toks = torch.randint(1, cfg.vocab_size, (4, 64), generator=gen)
        plain = model.prefill(params, {"tokens": toks}).float()
        sharded = take(mesh, model.prefill(
            placed, [{"tokens": t} for t in replicate(mesh, toks)],
            ctx=ctx), 0).float()
        m32 = build_model(dataclasses.replace(cfg, dtype="float32"), "cpu")
        fp32 = m32.prefill(tree_map(lambda t: t.float(), params),
                           {"tokens": toks}).float()
        print(f"{layers:2d} layers: sharded against unsharded "
              f"{rel(sharded, plain):.3e}, unsharded bf16 against fp32 "
              f"{rel(plain, fp32):.3e}, sharded bf16 against fp32 "
              f"{rel(sharded, fp32):.3e} (x max|logit|)", flush=True)


if __name__ == "__main__":
    main()
