"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one report line each (any failure exits non-zero):
  1. card + build: the card's name and power limit, torch/CUDA versions,
     and the build of every kernel from csrc/ (seconds);
  2. each kernel against its plain PyTorch version at the shapes the main
     path gives it (tinyllama-1.1b serving, bf16), timed with CUDA events
     with a cold L2 beside the plain version, one PyTorch library call and
     the card's bound;
  3. the paper's matmul domain: adaptive_matmul(use_kernel=True) at orders
     1024, 4096 and 8192, with the CostEngine's decision;
  4. serving: Runtime(device="cuda").serve of full-width tinyllama-1.1b
     (random weights, seed 0), static and continuous, token identity, the
     kernel's launch count, tok/s, host syncs per token, ledger rows; one
     decode step's matmul calls, captured and replayed through the kernel
     and through the plain version (held against each other, timed with
     torch.profiler), and one calibration of the hardware spec;
  5. card against CPU in fp32: one batched prefill + 4 decode steps.
The line before the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  The full record goes to
chiprun_out/chip_smoke.json.  Exits non-zero, printing no result, where
torch.cuda.is_available() is false or the repository is missing.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BF16_PEAK = 989e12   # H100 SXM data sheet, dense bf16 tensor cores
F32_PEAK = 67e12     # H100 SXM data sheet, fp32 outside the tensor cores
HBM_BW = 3.35e12     # H100 SXM data sheet, bytes/s
BF16_TOL = 8e-3      # x max|plain|: about one bf16 rounding
F32_TOL = 1e-5       # x max|plain|
PROMPT, MAX_NEW, SLOTS, REQUESTS = 64, 32, 4, 8


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, flush, reps: int = 10, warm: int = 2) -> float:
    """Mean ms of ``fn()`` by CUDA events with a cold L2: ``flush``, larger
    than the card's 50 MB L2, is rewritten before every rep, outside the
    timed window, so every input comes from device memory, as the bound
    assumes."""
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


def bound_terms(a, b, out_dtype) -> tuple:
    """(ops ms, bytes ms) for epilogue(a @ b): the FLOPs at the card's peak
    for the inputs' type, and each input read once plus the output written
    once at the memory rate.  The bound is the larger of the two."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    z = a.numel() // (m * k)
    flops = 2.0 * z * m * n * k
    peak = BF16_PEAK if (a.dtype == b.dtype == torch.bfloat16) else F32_PEAK
    nbytes = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + z * m * n * torch.empty((), dtype=out_dtype).element_size())
    return flops / peak * 1e3, nbytes / HBM_BW * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this check needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.configs import get_config
    from repro_torch.core.costs.calibration import calibrate
    from repro_torch.core.dispatch import adaptive_matmul
    from repro_torch.hw import H100
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.matmul import LAUNCHES
    from repro_torch.models import build_model
    from repro_torch.runtime import Runtime, synthetic_trace
    from repro_torch.serving.scheduler import ServeScheduler
    from repro_torch.core.costs.engine import CostEngine

    record: dict = {}
    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)

    # ------------------------------------------------------------------ 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    log("card", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    log("build", f"{', '.join(build.SOURCES)} built in {build_s:.2f} s "
        f"into {build.BUILD_DIR}")
    record.update(card=card, torch=torch.__version__, cuda=torch.version.cuda,
                  build_s=build_s)

    # ------------------------------------------------------------------ 2
    cfg = get_config("tinyllama-1.1b")
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    hq, hkv, g = cfg.n_heads, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    max_len = PROMPT + MAX_NEW
    chunk, _ = ServeScheduler(cfg, CostEngine(), max_len=max_len).prefill_chunk(
        PROMPT, active_decodes=0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    w = {n: rand(kk, nn, scale=kk ** -0.5) for n, (kk, nn) in {
        "wq": (d, hq * hd), "wk": (d, hkv * hd), "wo": (hq * hd, d),
        "w_gate": (d, f), "w_out": (f, d)}.items()}
    table = rand(cfg.vocab_size, d, scale=0.02)
    cache_k = rand(SLOTS, max_len, hkv, hd)
    cache_v = rand(SLOTS, max_len, hkv, hd)
    # (name, a, b, activation, out_dtype)
    cases = []
    for phase_rows, s_new in (("decode", 1), ("prefill", chunk)):
        m = SLOTS * s_new
        x = rand(m, d)
        x32 = rand(m, d, dtype=torch.float32)
        cases += [
            (f"{phase_rows} rmsnorm x*x.1", x32 * x32,
             torch.ones(d, 1, device=dev), None, torch.float32),
            (f"{phase_rows} wq/wo", x, w["wq"], None, torch.bfloat16),
            (f"{phase_rows} wk/wv", x, w["wk"], None, torch.bfloat16),
            (f"{phase_rows} w_gate silu", x, w["w_gate"], "silu",
             torch.bfloat16),
            (f"{phase_rows} w_in", x, w["w_gate"], None, torch.bfloat16),
            (f"{phase_rows} w_out", rand(m, f), w["w_out"], None,
             torch.bfloat16),
            (f"{phase_rows} attn q.k", rand(SLOTS, hkv, s_new * g, hd,
                                            dtype=torch.float32),
             cache_k.permute(0, 2, 3, 1), None, torch.float32),
            (f"{phase_rows} attn p.v", torch.softmax(rand(
                SLOTS, hkv, s_new * g, max_len, dtype=torch.float32), -1),
             cache_v.permute(0, 2, 1, 3), None, torch.float32),
            (f"{phase_rows} unembed", x, table.t(), None, torch.float32),
        ]
    extra = [("fp32 ragged 37x129x65", rand(37, 65, dtype=torch.float32),
              rand(65, 129, dtype=torch.float32), None, torch.float32)]
    for act in ("relu", "gelu", "silu", "tanh"):
        extra.append((f"bias+{act} 37x129x65", rand(37, 65), rand(65, 129),
                      act, torch.bfloat16))
    rows, worst = [], 0.0
    bias = rand(129, dtype=torch.float32)
    for name, a, b, act, out_dt in cases + extra:
        bb = bias if name.startswith("bias") else None
        kw = dict(bias=bb, activation=act, out_dtype=out_dt)
        err, tol = kernel_error(ops, ref, a, b, kw)
        if not err <= tol:
            log("kernel", f"FAIL {name}: max abs err {err:.3e} > {tol:.3e}")
            return 1
        worst = max(worst, err)
        k_ms = cuda_ms(lambda: ops.matmul(a, b, **kw), flush)
        p_ms = cuda_ms(lambda: ref.matmul_fused_ref(a, b, **kw), flush)
        # one library call computing the same function exists only for a
        # plain product whose output type is its inputs' type
        same_fn = (act is None and bb is None and a.dtype == b.dtype == out_dt)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush) if same_fn else None
        t_ops, t_bytes = bound_terms(a, b, out_dt)
        rows.append(dict(name=name, shape=f"{tuple(a.shape)}@{tuple(b.shape)}",
                         max_abs_err=err, tol=tol, ms=k_ms, plain_ms=p_ms,
                         library_ms=l_ms, bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes"))
        log("kernel", f"{name:24s} {rows[-1]['shape']:42s} err {err:.2e} "
            f"(tol {tol:.2e})  kernel {k_ms:.4f} ms  plain {p_ms:.4f} ms  "
            f"library {'-' if l_ms is None else f'{l_ms:.4f}'} ms  "
            f"bound {rows[-1]['bound_ms']:.4f} ms ({rows[-1]['bound_by']}); "
            f"cold L2")
    record["kernel_rows"] = rows

    # ------------------------------------------------------------------ 3
    engine = CostEngine()
    paper = []
    for order in (1024, 4096, 8192):
        a = rand(order, order, scale=order ** -0.5)
        b = rand(order, order)
        out, rep = adaptive_matmul(a, b, engine=engine, use_kernel=True,
                                   return_report=True)
        want = ref.matmul_ref(a, b)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs().max().item()
        tol = BF16_TOL * want.float().abs().max().item()
        if not err <= tol:
            log("paper", f"FAIL order {order}: err {err:.3e} > {tol:.3e}")
            return 1
        row = engine.ledger.entries[-1]
        reps = 3 if order == 8192 else 10
        k_ms = cuda_ms(lambda: adaptive_matmul(a, b, engine=engine,
                                               use_kernel=True), flush, reps, 1)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), flush, reps, 1)
        paper.append(dict(order=order, choice=rep.decision.choice,
                          predicted_s=rep.decision.predicted_s, err=err,
                          kernel_ms=k_ms, torch_matmul_ms=l_ms,
                          kernel_tflops=2 * order**3 / k_ms / 1e9))
        log("paper", f"order {order}: decision {rep.decision.choice} "
            f"(predicted {rep.decision.predicted_s:.3e} s; ledger "
            f"{row.site}/{row.choice} {row.query['shape']}), err {err:.2e} "
            f"(tol {tol:.2e}), kernel {k_ms:.3f} ms "
            f"({paper[-1]['kernel_tflops']:.1f} TFLOP/s), torch.matmul "
            f"{l_ms:.3f} ms")
    record["paper"] = paper

    # ------------------------------------------------------------------ 4
    rt = Runtime(device="cuda")
    model = build_model(cfg, rt.device)
    params = model.init(0)
    trace = lambda: synthetic_trace(  # noqa: E731
        REQUESTS, prompt_len=PROMPT, max_new=MAX_NEW,
        vocab_size=cfg.vocab_size, arrival="all", seed=0)
    LAUNCHES.reset()
    static = rt.serve(cfg, trace(), mode="static", model=model, params=params,
                      slots=SLOTS, eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=SLOTS, eos_id=-1)
    torch.cuda.synchronize()
    launches = LAUNCHES.count
    same = all((static.outputs[r] == cont.outputs[r]).all()
               for r in static.outputs)
    ntok = sum(len(v) for v in cont.outputs.values())
    log("serve", f"tinyllama-1.1b full width bf16, {REQUESTS} requests x "
        f"{PROMPT}+{MAX_NEW} tokens, {SLOTS} slots: static "
        f"{static.tok_per_s:.1f} tok/s, continuous {cont.tok_per_s:.1f} tok/s, "
        f"host_syncs_per_token {cont.report.host_syncs_per_token:.4f} "
        f"({cont.report.host_syncs} syncs, {cont.report.device_dispatches} "
        f"dispatches, {ntok} tokens)")
    log("serve", f"static == continuous tokens: {same}; matmul kernel "
        f"launches during serving: {launches}")
    if not same or launches <= 0:
        return 1
    for site in ("serve", "serve_macro"):
        rows_site = [e for e in rt.ledger.entries if e.site == site]
        meas = [e for e in rows_site if e.measured_s is not None]
        log("ledger", f"{site}: {len(rows_site)} rows, {len(meas)} measured")
        for e in meas[-3:]:
            log("ledger", f"  {site} {e.choice} {e.note}: predicted "
                f"{e.predicted_s:.3e} s, measured {e.measured_s:.3e} s")
    state = model.init_decode_state(SLOTS, max_len, per_slot=True)
    feed = {"tokens": torch.ones((SLOTS, 1), dtype=torch.int64, device=dev)}
    LAUNCHES.reset()
    calls = step_matmuls(model, params, state, feed, ops)
    per_step = LAUNCHES.count
    log("serve", f"matmul kernel launches per decode step: {per_step}")
    prof = profile_decode_step(model, params, state, feed)
    step = replay_step(calls, ops, ref, flush)
    if step is None:
        return 1
    worst = max(worst, step["max_abs_err"])
    if prof["matmul_ms"] > 0 and step["plain_device_ms"] > 0:
        step.update(ms=prof["matmul_ms"], plain_ms=step["plain_device_ms"],
                    timed_by="torch.profiler device time")
    else:
        step.update(ms=step["kernel_window_ms"],
                    plain_ms=step["plain_window_ms"],
                    timed_by="CUDA-event window of the replay (the profiler "
                    "saw no kernels)")
    log("step", f"one decode step's {len(calls)} matmuls ({SLOTS} slots, "
        f"{cfg.n_layers} layers): kernel {step['ms']:.3f} ms in the real "
        f"step, plain {step['plain_ms']:.3f} ms replayed, by "
        f"{step['timed_by']}; replay windows (cold L2) kernel "
        f"{step['kernel_window_ms']:.3f} ms, plain "
        f"{step['plain_window_ms']:.3f} ms; bound {step['bound_ms']:.3f} ms "
        f"({step['bound_by']}); all within tolerance of the plain version, "
        f"largest error {step['worst_call']}")
    record["decode_step_profile"] = prof
    record["decode_step"] = step
    cal = calibrate(H100, cache_dir=ROOT / "build" / "calibration",
                    force=True, device="cuda")
    fields = {k: v for k, v in cal.measurements.items() if v is not None}
    log("calibrate", " ".join(f"{k}={v:.4g}" for k, v in fields.items()))
    record["serve"] = dict(
        static_tok_per_s=static.tok_per_s, continuous_tok_per_s=cont.tok_per_s,
        host_syncs=cont.report.host_syncs,
        device_dispatches=cont.report.device_dispatches,
        host_syncs_per_token=cont.report.host_syncs_per_token,
        generated_tokens=ntok, launches=launches,
        launches_per_decode_step=per_step, tokens_identical=same)
    record["calibration"] = cal.measurements

    # ------------------------------------------------------------------ 5
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p_gpu = _tree_map(params, lambda t: t.float())
    p_cpu = _tree_map(p_gpu, lambda t: t.cpu())
    prompts = torch.as_tensor(
        synthetic_trace(2, prompt_len=16, max_new=1, vocab_size=cfg.vocab_size,
                        arrival="all", seed=1)[0].prompt, dtype=torch.int64)
    prompts = torch.stack([prompts, prompts.flip(0)])
    logits = {}
    for where, p_dev in (("cuda", p_gpu), ("cpu", p_cpu)):
        m32 = build_model(cfg32, where)
        st = m32.init_decode_state(2, 32, per_slot=True)
        out, st = m32.decode_step(p_dev, st, {"tokens": prompts.to(where)})
        steps = [out[:, -1]]
        for _ in range(4):
            tok = steps[-1].argmax(-1)[:, None]
            out, st = m32.decode_step(p_dev, st, {"tokens": tok})
            steps.append(out[:, -1])
        logits[where] = [s.float().cpu() for s in steps]
    worst_rel = 0.0
    for i, (lg, lc) in enumerate(zip(logits["cuda"], logits["cpu"])):
        tol = 2e-3 * lc.abs().max().item()
        err = (lg - lc).abs().max().item()
        worst_rel = max(worst_rel, err / lc.abs().max().item())
        if not err <= tol:
            log("card-vs-cpu", f"FAIL step {i}: logits err {err:.3e} > "
                f"{tol:.3e}")
            return 1
        tg, tc = lg.argmax(-1), lc.argmax(-1)
        if not torch.equal(tg, tc):
            top2 = lc.topk(2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]).min().item()
            log("card-vs-cpu", f"step {i}: tokens differ at a top-2 gap of "
                f"{gap:.3e} (tolerance {tol:.3e})")
            if gap >= tol:
                return 1
            break
    log("card-vs-cpu", f"fp32 prefill 2x16 + 4 decode steps: logits agree, "
        f"max err {worst_rel:.2e} x max|logit| (limit 2e-3); greedy tokens "
        f"equal")
    record["card_vs_cpu_rel_err"] = worst_rel

    # ---------------------------------------------------------------- out
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    kernels = [{
        "name": "matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/matmul.cu",
        "replaces": "src/repro/kernels/matmul.py:103",
        "launches": launches, "max_abs_err": worst,
        # one decode step's matmul calls: the kernel in the real step, the
        # plain version on the same operands, the bound of the same work
        "ms": step["ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        # no single library call computes a step's fused-epilogue and
        # fp32-output products; chiprun_out/chip_smoke.json has
        # torch.matmul beside every plain bf16 product of phase 2
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def kernel_error(ops, ref, a, b, kw) -> tuple:
    """(max abs error, tolerance) of the kernel against its plain version
    on the same operands."""
    got = ops.matmul(a, b, **kw)
    want = ref.matmul_fused_ref(a, b, **kw)
    err = (got.float() - want.float()).abs().max().item()
    top = want.float().abs().max().item()
    return err, (BF16_TOL if want.dtype == torch.bfloat16 else F32_TOL) * top


def device_ms_by_kernel(run) -> tuple:
    """({kernel name: device ms}, device events) of what ``run()``
    launches, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    by_name, n_kernels = {}, 0
    for ev in prof.events():  # device-side events only: each kernel once
        if ev.device_type == DeviceType.CUDA:
            n_kernels += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) + \
                ev.device_time_total / 1e3
    return by_name, n_kernels


def step_matmuls(model, params, state, feed, ops) -> list:
    """Run one decode step and return every ``ops.matmul`` call it made as
    (a, b, keyword arguments); the list keeps the operands alive."""
    calls, launch = [], ops.matmul

    def recording(a, b, **kw):
        calls.append((a, b, kw))
        return launch(a, b, **kw)

    ops.matmul = recording
    try:
        model.decode_step(params, state, feed)
    finally:
        ops.matmul = launch
    return calls


def replay_step(calls, ops, ref, flush):
    """Hold one decode step's matmul calls (the model's own weights for
    every layer, in the step's order) against the plain version, time both
    replays, and add up the bound of the same work.  None if a call
    disagrees."""
    worst, worst_call = 0.0, None
    for a, b, kw in calls:
        err, tol = kernel_error(ops, ref, a, b, kw)
        call = f"{tuple(a.shape)} @ {tuple(b.shape)} {kw}"
        if not err <= tol:
            log("step", f"FAIL {call}: max abs err {err:.3e} > {tol:.3e}")
            return None
        if err >= worst:
            worst, worst_call = err, f"{call}: {err:.3e} (tol {tol:.3e})"

    def run_kernel():
        for a, b, kw in calls:
            ops.matmul(a, b, **kw)

    def run_plain():
        for a, b, kw in calls:
            ref.matmul_fused_ref(a, b, **kw)

    terms = [bound_terms(a, b, kw.get("out_dtype") or a.dtype)
             for a, b, _ in calls]
    t_ops, t_bytes = sum(t[0] for t in terms), sum(t[1] for t in terms)
    run_plain()  # warm the allocator before the profiled replay
    plain_by_name, _ = device_ms_by_kernel(run_plain)
    kernel_by_name, _ = device_ms_by_kernel(run_kernel)
    return dict(max_abs_err=worst, worst_call=worst_call, calls=len(calls),
                plain_device_ms=sum(plain_by_name.values()),
                kernel_replay_device_ms=sum(kernel_by_name.values()),
                kernel_window_ms=cuda_ms(run_kernel, flush, reps=3, warm=1),
                plain_window_ms=cuda_ms(run_plain, flush, reps=3, warm=1),
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def profile_decode_step(model, params, state, feed) -> dict:
    """Where one decode step's time goes: its wall time (host clock around
    synchronized steps, profiler off) against the device time of the
    kernels it launches (torch.profiler), split into the matmul kernel and
    everything else."""
    model.decode_step(params, state, feed)
    torch.cuda.synchronize()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        model.decode_step(params, state, feed)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    by_name, n_kernels = device_ms_by_kernel(
        lambda: model.decode_step(params, state, feed))
    device_ms = sum(by_name.values())
    matmul_ms = sum(v for k, v in by_name.items() if "matmul_kernel" in k)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if device_ms == 0:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms; device time not measured (the profiler saw no kernels)")
    else:
        log("profile", f"one decode step ({SLOTS} slots): wall {wall_ms:.3f} "
            f"ms, device busy {device_ms:.3f} ms "
            f"({100 * device_ms / wall_ms:.1f}% of wall), matmul kernel "
            f"{matmul_ms:.3f} ms, other kernels {device_ms - matmul_ms:.3f} ms; "
            f"{n_kernels} device events under {len(by_name)} kernel names")
    for name, ms in top:
        log("profile", f"  {ms:8.3f} ms  {name[:90]}")
    return dict(wall_ms=wall_ms, device_ms=device_ms, matmul_ms=matmul_ms,
                device_events=n_kernels, top=top)


def _tree_map(tree, fn):
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, list):
        return [_tree_map(v, fn) for v in tree]
    return {k: _tree_map(v, fn) for k, v in tree.items()}


if __name__ == "__main__":
    sys.exit(main())
