"""Serving launcher: a thin command-line adapter over
``repro_torch.Runtime.serve``.

Builds a request trace (all at once, staggered, or Poisson arrivals) with
``repro_torch.synthetic_trace``, runs it through the chosen engine(s), and
reports per-request lifecycle (state, reason, queue wait, TTFT, latency),
aggregate throughput, the front end's IPC counts, and the serve slice of
the Runtime's overhead ledger (every admission / prefill-chunk /
decode-horizon / admit / prefix / IPC decision, predicted against
measured).  ``--workers`` puts request intake and token emission in
worker processes (the multi-process front end; ``--stream`` then defaults
on), ``--pin`` pins the engine thread and the workers to whole physical
cores.  ``--mesh data=1,model=8`` serves the continuous engine
tensor-parallel over a mesh (``--serve-shard`` forces the serve_shard
verdict; ``--shards-per-device 8`` puts the eight positions on one card).

Runs on the GPU (``cuda``) unless ``--device cpu`` asks for the plain
PyTorch path on the CPU; without a card and without ``--device cpu`` it
raises.  The first SIGINT or SIGTERM stops intake: active slots decode to
the end, queued requests end REJECTED "shutdown: intake stopped", the
report is still printed and the exit code is 0.  A second signal restores
the default handler.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --requests 8 --max-new 16 --slots 4 --deadline-ms 60000 \\
      --inject-fault raise --watchdog-ms 5000
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --reduced --device cpu --requests 8 --prompt-len 8 --max-new 16 \\
      --slots 2 --engine continuous

  # paged KV + shared-prefix traffic: every request opens with the same
  # 6 tokens, prefilled once and reused from the trie
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --reduced --device cpu --requests 8 --prompt-len 8 --max-new 8 \\
      --slots 1 --arrival all --engine continuous --paged --block-size 4 \\
      --prefix-cache force --prefix-share 1.0 --prefix-len 6

  # the multi-process front end: 2 pinned intake workers + the emission
  # worker, tokens streamed
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --reduced --device cpu --workers 2 --pin --stream

  # tensor-parallel serving on eight shards of one card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --engine continuous --mesh data=1,model=8 --serve-shard shard \
      --shards-per-device 8
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys
import threading


def main(argv=None):
    # imported here, not with the module: the front end's spawned workers
    # re-import the main module, and need none of these (nor torch)
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, RuntimeConfig, synthetic_trace

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-slot cache length; default prompt_len + max_new "
                         "(a request must fit its slot end to end)")
    ap.add_argument("--arrival", choices=("all", "staggered", "poisson"),
                    default="staggered")
    ap.add_argument("--gap-ms", type=float, default=20.0,
                    help="staggered: inter-arrival gap")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="poisson: mean arrivals per second")
    ap.add_argument("--engine", choices=("static", "continuous", "both"),
                    default="both")
    ap.add_argument("--prefill-chunk", default="auto",
                    help="'auto' (CostEngine decision) or an explicit chunk")
    ap.add_argument("--macro-step", default="auto",
                    help="decode macro-step horizon K: 'auto' (CostEngine "
                         "decision) or an explicit K (1 = per-token loop)")
    ap.add_argument("--mesh", default=None,
                    help="serve mesh as 'data=1,model=8' (continuous engine "
                         "only); the model axis must divide the arch's "
                         "head/FFN dims and the mesh must fit the devices "
                         "at --shards-per-device positions each")
    ap.add_argument("--serve-shard", choices=("auto", "shard", "replicate"),
                    default="auto",
                    help="shard-vs-replicate over the mesh model axis: "
                         "'auto' asks the CostEngine (the serve_shard "
                         "decision site), the others force a verdict")
    ap.add_argument("--shards-per-device", type=int, default=1,
                    help="mesh positions on each device (8 puts a "
                         "data=1,model=8 mesh on one card, a CUDA stream "
                         "a position)")
    ap.add_argument("--eos-id", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request total-latency budget from arrival; "
                         "infeasible requests shed (REJECTED), over-budget "
                         "ones evicted at macro-step boundaries (TIMED_OUT)")
    ap.add_argument("--queue-limit", type=int, default=None,
                    help="bounded waiting queue: arrivals past the limit "
                         "bounce with a typed REJECTED (backpressure)")
    ap.add_argument("--inject-fault", choices=("raise", "nan", "stall"),
                    default=None,
                    help="failure drill: inject one device-step fault of "
                         "this class ('stall' needs --watchdog-ms)")
    ap.add_argument("--watchdog-ms", type=float, default=None,
                    help="abort any single device step exceeding this "
                         "(bounded retries, then in-flight requests FAIL)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV: store full-attention caches in a shared "
                         "BlockPool of fixed-size pages with per-slot block "
                         "tables (continuous engine only)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV page size in tokens")
    ap.add_argument("--prefix-cache", choices=("auto", "force", "off"),
                    default="auto",
                    help="radix prefix reuse at admission: 'auto' asks the "
                         "CostEngine per prompt (the serve_prefix decision "
                         "site), 'force' pins reuse on, 'off' disables the "
                         "trie")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of trace requests that open with one "
                         "shared random prefix (system-prompt traffic; "
                         "needs --prefix-len)")
    ap.add_argument("--prefix-len", type=int, default=0,
                    help="length of the shared prefix in tokens "
                         "(0 < prefix_len < prompt_len)")
    ap.add_argument("--workers", default=None,
                    help="multi-process front end: 'auto' asks the "
                         "serve_ipc CostQuery (may decide inline), an int "
                         "pins that many intake workers (continuous engine "
                         "only)")
    ap.add_argument("--pin", action="store_true",
                    help="pin the engine thread to a reserved physical "
                         "core and the front-end workers to the remaining "
                         "cores (degrades gracefully without "
                         "sched_setaffinity)")
    ap.add_argument("--stream", action="store_true",
                    help="per-request incremental token streams at "
                         "macro-step boundaries (default on when --workers "
                         "is set); prints TTFT from the stream stamps")
    ap.add_argument("--corrections", action="store_true",
                    help="enable the online correction loop: per-site "
                         "multiplicative factors learned from measured "
                         "ledger rows (equivalent to REPRO_CORRECTIONS=1)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the GPU")
    args = ap.parse_args(argv)

    # fail-fast flag validation (mirrors Runtime.serve, but at the CLI
    # boundary so a bad invocation dies before any model is built)
    robustness = (args.deadline_ms is not None or args.queue_limit is not None
                  or args.inject_fault is not None
                  or args.watchdog_ms is not None)
    if robustness and args.engine != "continuous":
        ap.error("--deadline-ms/--queue-limit/--inject-fault/--watchdog-ms "
                 "need the request lifecycle of --engine continuous")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error(f"--deadline-ms must be > 0, got {args.deadline_ms}")
    if args.queue_limit is not None and args.queue_limit < 1:
        ap.error(f"--queue-limit must be >= 1, got {args.queue_limit}")
    if args.watchdog_ms is not None and args.watchdog_ms <= 0:
        ap.error(f"--watchdog-ms must be > 0, got {args.watchdog_ms}")
    if args.inject_fault == "stall" and args.watchdog_ms is None:
        ap.error("--inject-fault stall without --watchdog-ms would hang "
                 "the trace; pass --watchdog-ms")
    if args.paged and args.engine == "static":
        ap.error("--paged needs the slot pool of --engine continuous")
    if args.paged and args.block_size < 1:
        ap.error(f"--block-size must be >= 1, got {args.block_size}")
    if args.prefix_share:
        if not 0.0 < args.prefix_share <= 1.0:
            ap.error(f"--prefix-share must be in (0, 1], "
                     f"got {args.prefix_share}")
        if not 0 < args.prefix_len < args.prompt_len:
            ap.error(f"--prefix-len must be in (0, prompt_len="
                     f"{args.prompt_len}), got {args.prefix_len}")
    frontend = None
    if args.workers is not None:
        # the reference refuses --workers unless --engine continuous; the
        # port runs it with --engine both too (the static baseline stays
        # in-process), as it does --pin and --stream
        if args.engine == "static":
            ap.error("--workers needs the continuous engine (the front end "
                     "feeds its request lifecycle)")
        if args.workers == "auto":
            frontend = "auto"
        else:
            try:
                frontend = int(args.workers)
            except ValueError:
                ap.error(f"--workers must be 'auto' or an int, "
                         f"got {args.workers!r}")
            if frontend < 1:
                ap.error(f"--workers must be >= 1, got {frontend}")
    if (args.pin or args.stream) and args.engine == "static":
        ap.error("--pin/--stream need --engine continuous")

    mesh_shape = None
    if args.mesh is not None:
        try:
            mesh_shape = {k.strip(): int(v) for k, v in
                          (part.split("=") for part in args.mesh.split(","))}
        except ValueError:
            ap.error(f"--mesh must look like 'data=1,model=8', "
                     f"got {args.mesh!r}")
    if args.shards_per_device < 1:
        ap.error(f"--shards-per-device must be >= 1, "
                 f"got {args.shards_per_device}")

    if args.max_len is None:
        args.max_len = args.prompt_len + args.max_new
    need = args.prompt_len + args.max_new
    if need > args.max_len:
        ap.error(f"--max-len {args.max_len} cannot hold prompt_len "
                 f"{args.prompt_len} + max_new {args.max_new} = {need}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rt_cfg = RuntimeConfig.from_env(device=args.device)
    if args.corrections:
        rt_cfg = dataclasses.replace(rt_cfg, corrections=True)
    rt = Runtime(rt_cfg)
    # one model + params shared by both engines (same weights, fair compare)
    model = build_model(cfg, rt.device)
    params = model.init(0)

    def trace():
        return synthetic_trace(
            args.requests, prompt_len=args.prompt_len, max_new=args.max_new,
            vocab_size=cfg.vocab_size, arrival=args.arrival,
            gap_ms=args.gap_ms, rate=args.rate, seed=args.seed,
            prefix_share=args.prefix_share, prefix_len=args.prefix_len)

    prefix_cache = {"auto": "auto", "force": "force",
                    "off": False}[args.prefix_cache]
    modes = {"static": ("static",), "continuous": ("continuous",),
             "both": ("static", "continuous")}[args.engine]

    # graceful shutdown: the first SIGINT/SIGTERM sets the stop event — the
    # continuous engine stops intake (queued/waiting requests become typed
    # REJECTED), drains in-flight requests to terminal states, and the run
    # still falls through to the report below.  A second signal restores
    # the previous handler's behaviour (hard exit for SIGINT).
    stop_event = threading.Event()
    prev_handlers = {}

    def _on_signal(signum, frame):
        stop_event.set()
        if signum in prev_handlers:
            signal.signal(signum, prev_handlers[signum])

    for signum in (signal.SIGINT, signal.SIGTERM):
        try:
            prev_handlers[signum] = signal.signal(signum, _on_signal)
        except ValueError:
            pass  # not the main thread: degrade to no graceful stop

    results = []
    try:
        for mode in modes:
            if stop_event.is_set():
                break  # stopped during an earlier engine's run
            results.append(rt.serve(
                cfg, trace(), mode=mode, model=model, params=params,
                slots=args.slots, max_len=args.max_len, eos_id=args.eos_id,
                prefill_chunk=args.prefill_chunk, macro_step=args.macro_step,
                mesh_shape=mesh_shape if mode == "continuous" else None,
                shard_params=args.serve_shard,
                shards_per_device=args.shards_per_device,
                queue_limit=args.queue_limit, deadline_ms=args.deadline_ms,
                inject_fault=args.inject_fault, watchdog_ms=args.watchdog_ms,
                paged=args.paged and mode == "continuous",
                block_size=args.block_size, prefix_cache=prefix_cache,
                frontend=frontend if mode == "continuous" else None,
                pin=args.pin,
                stop_event=stop_event if mode == "continuous" else None,
                stream=(True if args.stream and mode == "continuous"
                        else "auto")))
    finally:
        for signum, handler in prev_handlers.items():
            try:
                signal.signal(signum, handler)
            except ValueError:
                pass

    if stop_event.is_set():
        print("interrupted: intake stopped, in-flight requests drained")

    def ms(v):
        return f"{v*1e3:6.0f}ms" if v is not None else "     --"

    for res in results:
        print(f"[{res.mode}] wall {res.wall_s:.2f}s  "
              f"{res.tok_per_s:.1f} tok/s  "
              f"p50 {res.p50_s*1e3:.0f}ms  p95 {res.p95_s*1e3:.0f}ms")
        if res.report is not None:
            print(f"    host syncs {res.report.host_syncs} "
                  f"({res.report.host_syncs_per_token:.3f}/token), "
                  f"device dispatches {res.report.device_dispatches}")
            if args.paged:
                print(f"    paged KV: peak live tokens "
                      f"{res.report.live_tokens}, reserved blocks "
                      f"{res.report.reserved_blocks}, prefix hits "
                      f"{res.report.prefix_hit_tokens} tokens "
                      f"(rate {res.report.prefix_hit_rate:.2f}), "
                      f"prefilled {res.report.prefilled_tokens}, "
                      f"CoW {res.report.cow_count}")
            if res.report.mesh_shape is not None:
                print(f"    mesh {res.report.mesh_shape} "
                      f"({res.report.device_count} devices), "
                      f"collective ops {res.report.collective_ops}")
            if res.report.frontend_workers:
                print(f"    frontend: {res.report.frontend_workers} intake "
                      f"workers, IPC {res.report.ipc_messages} msgs / "
                      f"{res.report.ipc_bytes} B, streamed "
                      f"{res.report.streamed_tokens} tokens in "
                      f"{res.report.stream_events} bursts, respawns "
                      f"{res.report.frontend_respawns}")
            if res.stream is not None:
                ttft = res.report.ttft_percentiles()
                print(f"    stream TTFT p50 {ms(ttft['ttft_p50'])} "
                      f"p95 {ms(ttft['ttft_p95'])} "
                      f"p99 {ms(ttft['ttft_p99'])}")
            states = res.report.state_counts()
            extras = "".join(
                f", {k} {v}" for k, v in (
                    ("retries", res.report.step_retries),
                    ("watchdog fires", res.report.watchdog_fires),
                    ("preemptions", res.report.preemptions)) if v)
            print(f"    states {states}{extras}")
            for r in res.report.requests:
                why = f"  [{r.reason}]" if r.reason else ""
                print(f"    {r.rid}: {r.state.value:9s} "
                      f"arrival {r.arrival_s*1e3:6.0f}ms  "
                      f"queue {ms(r.queue_wait_s)}  "
                      f"ttft {ms(r.ttft_s)}  "
                      f"latency {ms(r.latency_s)}  "
                      f"tokens {len(r.tokens)}{why}")

    serve_rows = [e for e in rt.ledger.entries
                  if e.site in ("serve", "serve_macro", "serve_shard",
                                "serve_admit", "serve_prefix", "serve_ipc")]
    measured = [e for e in serve_rows if e.measured_s is not None]
    print(f"serve ledger: {len(serve_rows)} decisions, "
          f"{len(measured)} with measured wall time")
    # the tail: the head is the warmup's rows, whose times include the
    # first kernel loads
    for e in serve_rows[-12:]:
        op = e.query.get("op", {"serve_macro": "macro_horizon",
                                "serve_shard": "serve_shard",
                                "serve_admit": "serve_admit",
                                "serve_prefix": "serve_prefix",
                                "serve_ipc": "serve_ipc",
                                }.get(e.site, "?"))
        meas = f"{e.measured_s:.3e}s" if e.measured_s is not None else "-"
        print(f"    {op:14s} {e.choice:14s} "
              f"pred {e.predicted_s:.3e}s meas {meas} {e.note}")
    corr = rt.engine.corrections
    if corr is not None and corr.sites():
        facts = ", ".join(f"{s} x{corr.factor(s):.2f}"
                          for s in sorted(corr.sites()))
        print(f"corrections: {facts}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
