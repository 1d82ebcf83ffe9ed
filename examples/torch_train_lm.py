"""End-to-end training driver: train a ~100M-parameter LM for a few
hundred steps with checkpoints, through the public Runtime API, on the
card by default (``--device cpu`` for the plain PyTorch path).

The default preset (``--preset small``, ~25M parameters) takes minutes on
a CPU; ``--preset 100m`` is the full configuration.  ``--resume`` picks
up from the newest checkpoint in ``--ckpt-dir`` (by default under
``results/torch/``).

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 300
      PYTHONPATH=src python examples/torch_train_lm.py --preset small \\
          --steps 4 --batch 2 --seq 32 --device cpu
"""

import argparse
import dataclasses

import repro_torch

PRESETS = {
    # (layers, d_model, heads, kv, d_ff, vocab)
    "small": (8, 256, 8, 4, 1024, 8192),  # ~25M params
    "100m": (12, 768, 12, 4, 2048, 32000),  # ~100M params
}


def preset_config(preset: str, seq: int):
    nl, d, h, kv, ff, v = PRESETS[preset]
    return dataclasses.replace(
        repro_torch.get_config("tinyllama-1.1b"),
        name=f"train-lm-{preset}", n_layers=nl, d_model=d, n_heads=h,
        n_kv_heads=kv, head_dim=d // h, d_ff=ff, vocab_size=v,
        dtype="float32", max_seq_len=seq,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=PRESETS, default="small")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="results/torch/train_lm")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="the session's device (default: the card)")
    args = ap.parse_args(argv)

    cfg = preset_config(args.preset, args.seq)
    print(f"{cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    rt = repro_torch.Runtime(repro_torch.RuntimeConfig.from_env(),
                             device=args.device)
    loop = repro_torch.TrainLoopConfig(
        optimizer=repro_torch.AdamWConfig(lr=1e-3),
        warmup_steps=args.steps // 10, total_steps=args.steps,
    )
    res = rt.train(cfg, loop, steps=args.steps, batch=args.batch,
                   seq=args.seq, seed=args.seed, ckpt_dir=args.ckpt_dir,
                   ckpt_every=100, resume=args.resume, log_every=25)
    tok = res.steps_run * args.batch * args.seq
    tok_s = tok / res.wall_s if res.wall_s > 0 else 0.0
    print(f"finished {res.steps_run} steps in {res.wall_s:.1f}s "
          f"({tok_s:.0f} tok/s); checkpoint at {args.ckpt_dir}")
    return res


if __name__ == "__main__":
    main()
