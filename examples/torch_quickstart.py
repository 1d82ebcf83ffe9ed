"""Quickstart: the port's public API through one ``import repro_torch``.

Build tinyllama-1.1b at smoke scale, train + checkpoint + resume through
the Runtime, then serve the trained weights both ways (static lockstep
baseline and continuous batching) and check that they agree token for
token; stream the tokens as they are made; serve system-prompt traffic
with paged KV and the radix prefix cache, again against static.  Every
decision the session made lands on one ledger, printed at the end.

Run:  PYTHONPATH=src python examples/torch_quickstart.py            # the GPU
      PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import tempfile

import numpy as np

import repro_torch


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"quickstart check failed: {what}")


def same_tokens(a, b) -> bool:
    return a.outputs.keys() == b.outputs.keys() and all(
        np.array_equal(a.outputs[rid], b.outputs[rid]) for rid in a.outputs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default: an NVIDIA GPU) or 'cpu'")
    args = ap.parse_args(argv)

    print("assigned architectures:", ", ".join(repro_torch.list_configs()))
    rt = repro_torch.Runtime(device=args.device)  # engine + caches + ledger
    print("device:", rt.device)
    cfg = repro_torch.get_config("tinyllama-1.1b").reduced()

    # --- train (the Runtime owns the plan, the loop and checkpoints) ---
    loop = repro_torch.TrainLoopConfig(
        optimizer=repro_torch.AdamWConfig(lr=3e-3), warmup_steps=5,
        total_steps=60)
    with tempfile.TemporaryDirectory() as d:
        res = rt.train(cfg, loop, steps=30, batch=8, seq=32, ckpt_dir=d,
                       ckpt_every=30, log_every=10)
        # --- checkpoint / restore: resuming at the saved step is a no-op
        resumed = rt.train(cfg, loop, steps=30, batch=8, seq=32, ckpt_dir=d,
                           resume=True, log_every=0)
        check(resumed.start_step == 30 and resumed.steps_run == 0,
              "resume at the saved step")
        print("checkpoint roundtrip ok")
    params = res.state["params"]

    # --- serve (static batch; eos_id=-1 keeps the demo un-truncated) ---
    prompts = np.arange(1, 9, dtype=np.int32).reshape(2, 4)

    def trace():
        return [repro_torch.Request(f"r{i}", prompts[i], 8) for i in range(2)]

    static = rt.serve(cfg, trace(), mode="static", params=params, max_len=64,
                      eos_id=-1)
    print("generated:", [static.outputs[f"r{i}"].tolist() for i in range(2)])

    # --- serve (continuous batching: slots, chunked prefill, scheduler) ---
    cont = rt.serve(cfg, trace(), params=params, slots=2, max_len=64,
                    eos_id=-1)
    check(same_tokens(cont, static), "continuous == static")
    print(f"continuous batching matched token-for-token "
          f"({cont.generated_tokens} tokens, {cont.tok_per_s:.0f} tok/s)")

    # --- streaming: tokens surface in bursts at macro-step boundaries (no
    # added device syncs); the first burst comes with the prefill
    streamed = rt.serve(cfg, trace(), params=params, slots=2, max_len=64,
                        eos_id=-1, stream=True)
    for rid in sorted(streamed.stream.rids()):
        bursts = [list(ev.tokens) for ev in streamed.stream.events(rid)
                  if ev.tokens]
        print(f"streamed {rid}: {bursts} "
              f"(first token at {streamed.stream.first_token_s(rid)*1e3:.1f}"
              f" ms)")
        check(streamed.stream.tokens(rid) == streamed.outputs[rid].tolist(),
              f"stream == output for {rid}")

    # --- paged KV + the radix prefix cache on system-prompt traffic: six
    # requests open with one 14-token prefix (3 full pages of 4 and a
    # partial one, copied on write); "force" reuses it, and the
    # serve_prefix cost site still prices and ledgers every admission.
    # Fresh weights from seed 0, whose greedy tokens vary more than the
    # briefly trained model's
    def shared():
        return repro_torch.synthetic_trace(
            6, prompt_len=16, max_new=8, vocab_size=cfg.vocab_size,
            arrival="all", prefix_share=1.0, prefix_len=14, seed=1)

    base = rt.serve(cfg, shared(), mode="static", seed=0, eos_id=-1)
    paged = rt.serve(cfg, shared(), seed=0, slots=2, eos_id=-1, paged=True,
                     block_size=4, prefix_cache="force")
    check(same_tokens(paged, base), "paged + prefix cache == static")
    rep = paged.report
    print(f"paged serving matched static: {rep.prefix_hit_tokens} prompt "
          f"tokens from the prefix cache, {rep.prefilled_tokens} prefilled "
          f"(hit rate {rep.prefix_hit_rate:.2f}), {rep.cow_count} "
          f"copy-on-write pages, {rep.reserved_blocks} pages at peak")

    # --- one session, one ledger: plan + serve decisions, pred-vs-meas ---
    print(rt.ledger.report(max_rows=8))


if __name__ == "__main__":
    main()
