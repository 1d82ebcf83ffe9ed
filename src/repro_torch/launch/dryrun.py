"""Multi-pod dry run: every (architecture x input shape) cell on the
production meshes, without the devices.

For every cell and both production meshes (one pod of 16 x 16 = 256
positions, two pods of 2 x 16 x 16 = 512):

  1. run the real step (the train step, prefill or the decode serve step)
     on meta tensors, one position per mesh position
     (``make_production_mesh``): nothing is allocated and nothing
     launches, so it runs on any host, with no card;
  2. record what a position holds (``memory_analysis``: the arguments,
     the outputs, the temporaries at the peak; the fits-in-HBM evidence)
     and the run's FLOPs and bytes (``scanned_cost_analysis``), counted at
     the dispatch level by ``roofline.DispatchCounter`` and the kernels'
     call log (``kernels/calls.py``);
  3. compose the three roofline terms from flat per-layer probes, one per
     block kind plus the embedding and loss head, as the reference does:
     ``count x probe`` for each kind (seamless's encoder counted as
     ``attn`` probes), plus the head.

This is the reference's ``src/repro/launch/dryrun.py`` with its names and
the structure of its records.  Where the reference lowers and compiles
with ``ShapeDtypeStruct`` inputs and reads XLA's analyses, the port runs
its own step functions on the meta device and counts at the dispatch
level; there is no HLO, ``terms_flash_kernel`` equals ``terms`` (the
port's cache-free attention already runs the flash kernel), and
``code_bytes`` is 0.  The decode cells' replicate-or-FSDP rule reads the
session engine's HBM (the H100's 80 GB).

Usage:
  python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
  python -m repro_torch.launch.dryrun --all --no-probe
  python -m repro_torch.launch.dryrun --all --both-meshes --out dryrun.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.configs.base import ModelConfig, ShapeSpec, shape_applicable
from repro_torch.core.planner import plan_model
from repro_torch.data.pipeline import make_batch_specs
from repro_torch.distributed.mesh import COLLECTIVE_KINDS, Mesh
from repro_torch.distributed.sharding import (ShardingCtx, batch_sharding,
                                              param_shardings, place_shapes,
                                              serve_state_sharding,
                                              state_sharding)
from repro_torch.kernels.calls import CallLog
from repro_torch.launch.mesh import data_axes_of, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models import transformer as tfm
from repro_torch.models.common import dtype_of
from repro_torch.models.model import xent_mesh
from repro_torch.roofline import (DispatchCounter, RooflineTerms,
                                  model_flops_for)
from repro_torch.training.step import (TrainLoopConfig, make_serve_step,
                                       make_train_step, train_state_shapes)
from repro_torch.tree import leaves_with_paths, tree_map, tree_map_with_path


# ---------------------------------------------------------------------------
# One traced run on meta tensors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Trace:
    """What one run on meta tensors did: its result, the kernel calls
    (``calls``), the dispatch counter (traffic, live bytes by device), the
    collectives the mesh ran (calls, and result bytes by kind summed over
    the positions) and the run's wall."""

    out: Any
    calls: CallLog
    counter: DispatchCounter
    collectives: int
    collective_bytes: Dict[str, int]
    wall_s: float

    @property
    def flops(self) -> float:
        return self.calls.totals()[0] + self.counter.product_flops

    @property
    def bytes(self) -> float:
        return self.calls.totals()[1] + self.counter.traffic

    @property
    def bytes_min(self) -> float:
        return self.calls.totals()[1] + self.counter.traffic_min

    def memory(self, outputs: Sequence, positions: Sequence) -> dict:
        """The device with the largest peak: its arguments, its outputs
        (new storages among ``outputs``, one tree a position), its
        temporaries at the peak (the rest of it) and the peak, in
        bytes."""
        c = self.counter
        new = c.new_bytes(outputs, positions)
        dev = max(c.peak, key=c.peak.get) if c.peak else None
        arg, out = c.arguments.get(dev, 0), new.get(dev, 0)
        peak = c.peak.get(dev, 0)
        return {"argument_bytes": float(arg), "output_bytes": float(out),
                "temp_bytes": float(max(peak - arg - out, 0)),
                "code_bytes": 0.0, "peak_bytes": float(peak)}


def trace(run: Callable[[], Any], args: Sequence, positions: Sequence, *,
          mesh: Optional[Mesh] = None, grad: bool = False,
          device_of: Optional[Callable] = None) -> Trace:
    """``run()`` under a ``DispatchCounter`` and a ``CallLog``, in
    inference mode unless ``grad`` (a forward-only step: no autograd
    bookkeeping on any op): ``args`` (one tree a position, alive before
    the run) are its arguments.  ``device_of`` maps positions to devices (each
    its own by default)."""
    counter = DispatchCounter(device_of=device_of)
    counter.add_arguments(args, positions)
    before = dict(mesh.collective_bytes) if mesh is not None else {}
    n0 = mesh.collectives if mesh is not None else 0
    t0 = time.perf_counter()
    grads = contextlib.nullcontext() if grad else torch.inference_mode()
    # the run makes millions of small objects, freed by their reference
    # counts; the cycle collector's passes over them only cost time
    collect = gc.isenabled()
    gc.disable()
    try:
        with CallLog() as log, grads, counter:
            out = run()
    finally:
        if collect:
            gc.enable()
    wall = time.perf_counter() - t0
    cols = {k: mesh.collective_bytes[k] - before[k] for k in COLLECTIVE_KINDS
            } if mesh is not None else dict.fromkeys(COLLECTIVE_KINDS, 0)
    return Trace(out, log, counter,
                 (mesh.collectives - n0) if mesh is not None else 0, cols,
                 wall)


def _per_position(tree, n: int) -> list:
    """A step's result (lists with one entry a position, in tuples) as one
    tree a position."""
    if isinstance(tree, (list, tuple)) and len(tree) == n and \
            not isinstance(tree, tuple):
        return list(tree)
    if isinstance(tree, tuple):
        parts = [_per_position(t, n) for t in tree]
        return [tuple(p[i] for p in parts) for i in range(n)]
    return [tree] * n


# ---------------------------------------------------------------------------
# Flat per-layer probes
# ---------------------------------------------------------------------------


def _shapes(fn) -> Any:
    """The tree ``fn()`` builds, every leaf a meta tensor (drawn under
    ``FakeTensorMode``: no memory, no draws)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        fake = fn()
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), fake)


def _batch_rows(ctx, b: int) -> int:
    """A position's rows of a global batch of ``b`` over the data axes
    (all of them where the axes do not divide it, as ``batch_sharding``)."""
    return b // ctx.dp if ctx.data_axes and b % ctx.dp == 0 else b


def _positions(cfg: ModelConfig, b: int, s: int,
               device: str = "meta") -> torch.Tensor:
    if cfg.pos_type == "mrope":
        return torch.zeros((b, s, 3), dtype=torch.int32, device=device)
    return torch.zeros((b, s), dtype=torch.int64, device=device)


def _probe_record(tr: Trace, chips: int) -> dict:
    """A probe's per-device cost and collectives (the mesh's totals over
    its positions, divided by them), as the reference's probes read them
    off one device's program."""
    return {"cost": {"flops": tr.flops / chips, "bytes": tr.bytes / chips,
                     "bytes_min": tr.bytes_min / chips},
            "collectives": {k: v / chips for k, v in
                            tr.collective_bytes.items() if v}}


def decode_state_specs(cfg: ModelConfig, state, mesh: Mesh,
                       data_axes) -> Any:
    """A decode cell's state placement: the reference's ``state_sharding``
    (the batch over the data axes, a dense ``attn`` cache's length over
    the model axis); the encoder-decoder's caches as
    ``serve_state_sharding`` places them (kv heads over the model axis
    where they divide), the form its layers read."""
    if cfg.is_encdec:
        return serve_state_sharding(state, mesh, data_axes=data_axes,
                                    cfg=cfg)
    return state_sharding(state, mesh, data_axes=data_axes, scanned=False,
                          cfg=cfg)


def probe_layer(cfg: ModelConfig, kind: str, mesh: Mesh, ctx, b: int,
                s: int, *, train: bool, decode: bool = False) -> dict:
    """ONE layer on every position, flat: forward and backward (the
    gradient of the sum of its output and its auxiliary loss, by its
    parameters and its input) if ``train``; one token against a state of
    ``s`` positions if ``decode``; else the forward."""
    tr = trace_layer(cfg, kind, mesh, ctx, b, s, train=train, decode=decode)
    return _probe_record(tr, mesh.size)


def trace_layer(cfg: ModelConfig, kind: str, mesh: Mesh, ctx, b: int,
                s: int, *, train: bool, decode: bool = False,
                device: str = "meta") -> Trace:
    """``probe_layer``'s run, traced: on meta tensors, or on zeros on
    ``device`` (the CPU, for the checks that a meta run counts what real
    tensors give)."""
    n = mesh.size
    dtype = dtype_of(cfg.dtype)
    lp = _shapes(lambda: tfm.layer_init(torch.Generator().manual_seed(0),
                                        cfg, kind, dtype))
    p_axes = () if ctx.infer_replicate_params else ctx.data_axes
    specs = param_shardings(lp, mesh, data_axes=p_axes, cfg=cfg)
    lps = place_shapes(mesh, lp, specs, device)
    rows = _batch_rows(ctx, b)
    s_in = 1 if decode else s
    xs = [torch.zeros((rows, s_in, cfg.d_model), dtype=dtype, device=device)
          for _ in range(n)]
    pos = [_positions(cfg, rows, s_in, device) for _ in range(n)]
    none = [None] * n
    if decode:
        # a decode state's layer, placed as the step's state places it
        # (keyed by the index of a layer of this kind, which the specs read)
        j = str(cfg.block_pattern.index(kind))
        st = {"layers": {j: _shapes(lambda: tfm.layer_init_state(
            cfg, kind, b, s, dtype, "cpu"))}}
        sts = [t["layers"][j] for t in place_shapes(
            mesh, st, decode_state_specs(cfg, st, mesh, ctx.data_axes),
            device)]
        ctx = dataclasses.replace(ctx, kv_len=s)
        cps = [torch.full((), s // 2, dtype=torch.int64, device=device)
               for _ in range(n)]

        def run():
            return tfm.layer_apply_tp(ctx, lps, cfg, kind, xs, pos,
                                      states=sts, cache_pos=cps,
                                      block_tables=none,
                                      rnn_chunk=ctx.rnn_chunk)

        args = [(lps[i], xs[i], sts[i]) for i in range(n)]
        tr = trace(run, args, range(n), mesh=mesh)
    elif train:
        def run():
            live = [tree_map(lambda t: t.requires_grad_(True), p)
                    for p in lps]
            xin = [x.requires_grad_(True) for x in xs]
            ys, auxs = tfm.layer_train_tp(ctx, live, specs, cfg, kind, xin,
                                          pos, rnn_chunk=ctx.rnn_chunk)
            scalars = ctx.map(lambda y, a: y.float().sum() + a, ys, auxs)
            paths = [p for p, _ in leaves_with_paths(live[0])]
            m = len(paths)
            got = torch.autograd.grad(
                scalars, [t for p in live for _, t in leaves_with_paths(p)]
                + xin, grad_outputs=ctx.map(torch.ones_like, scalars),
                allow_unused=True)

            def grad_of(i, path, t):
                g = got[i * m + paths.index(path)]
                return torch.zeros_like(t) if g is None else g

            trees = [tree_map_with_path(
                lambda path, t, i=i: grad_of(i, path, t), live[i])
                for i in range(n)]
            # a replicated piece's gradient summed over its holders, as
            # the train step sums it
            return ctx.replica_sum(trees, specs), got[n * m:]

        args = [(lps[i], xs[i]) for i in range(n)]
        tr = trace(run, args, range(n), mesh=mesh, grad=True)
    else:
        def run():
            return tfm.layer_train_tp(ctx, lps, specs, cfg, kind, xs, pos,
                                      rnn_chunk=ctx.rnn_chunk)

        args = [(lps[i], xs[i]) for i in range(n)]
        tr = trace(run, args, range(n), mesh=mesh)
    return tr


def probe_head(cfg: ModelConfig, mesh: Mesh, ctx, b: int, s: int, *,
               train: bool, decode: bool = False) -> dict:
    """The embedding lookup and the final unembedding: the cross-entropy
    (and z loss) forward and backward by both tables if ``train``, else
    the logits of the last position."""
    n = mesh.size
    model = build_model(cfg, "meta")
    dtype = dtype_of(cfg.dtype)
    v, d = cfg.vocab_size, cfg.d_model
    tables = {"embed": torch.empty((v, d), dtype=dtype, device="meta"),
              "unembed": torch.empty((v, d), dtype=dtype, device="meta")}
    p_axes = () if ctx.infer_replicate_params else ctx.data_axes
    specs = param_shardings(tables, mesh, data_axes=p_axes, cfg=cfg)
    placed = place_shapes(mesh, tables, specs)
    rows = _batch_rows(ctx, b)
    s_eff = 1 if decode else s
    toks = [{"tokens": torch.empty((rows, s_eff), dtype=torch.int32,
                                   device="meta")} for _ in range(n)]
    args = [(placed[i], toks[i]) for i in range(n)]
    gctx = dataclasses.replace(ctx, data_axes=p_axes)

    if train:
        def run():
            live = [tree_map(lambda t: t.requires_grad_(True), p)
                    for p in placed]
            full = gctx.gather_tree(live, specs)
            xs = model._tokens_tp(ctx, full, toks)
            tgt = [t["tokens"] for t in toks]
            masks = ctx.map(lambda t: torch.ones(t.shape, dtype=torch.float32,
                                                 device=t.device), tgt)
            # the CE and z sums of every position, over the global batch
            sums = ctx.data_psum(xent_mesh(
                ctx, [f["unembed"] for f in full], xs, tgt, masks, v))
            scalars = ctx.map(lambda sm: (sm[0] + 1e-4 * sm[1])
                              / torch.clamp(sm[2], min=1.0), sums)
            leaves = [t for p in live for _, t in leaves_with_paths(p)]
            return torch.autograd.grad(
                scalars, leaves, grad_outputs=ctx.map(torch.ones_like,
                                                      scalars),
                allow_unused=True)

        tr = trace(run, args, range(n), mesh=mesh, grad=True)
    else:
        def run():
            full = gctx.gather_tree(placed, specs)
            last = [{"tokens": t["tokens"][:, -1:]} for t in toks]
            xs = model._tokens_tp(ctx, full, last)
            return model._logits_tp(ctx, [f["unembed"] for f in full], xs)

        tr = trace(run, args, range(n), mesh=mesh)
    return _probe_record(tr, n)


def composed_roofline(cfg: ModelConfig, shape: ShapeSpec, mesh: Mesh, ctx,
                      label: str, hw=None) -> Dict[str, Any]:
    """sum(kind_count x per-layer probe) + head probe -> RooflineTerms.
    ``hw``: the HardwareSpec to evaluate against (a session engine's);
    the H100's by default."""
    b = shape.global_batch
    s = shape.seq_len
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    counts: Dict[str, int] = {}
    for i in range(cfg.n_layers):
        k = cfg.block_kind(i)
        counts[k] = counts.get(k, 0) + 1

    flops = bytes_ = bytes_min = 0.0
    coll: Dict[str, float] = {}
    per_layer: Dict[str, Any] = {}

    def add(p, cnt):
        nonlocal flops, bytes_, bytes_min
        flops += cnt * p["cost"]["flops"]
        bytes_ += cnt * p["cost"]["bytes"]
        bytes_min += cnt * p["cost"]["bytes_min"]
        for k2, v2 in p["collectives"].items():
            coll[k2] = coll.get(k2, 0.0) + cnt * v2

    for kind, cnt in counts.items():
        p = probe_layer(cfg, kind, mesh, ctx, b, s, train=train,
                        decode=decode)
        per_layer[kind] = {**p, "count": cnt}
        add(p, cnt)
    # enc-dec: the encoder's layers counted as `attn` probes (same dims), as
    # the reference counts them
    if cfg.is_encdec:
        p = probe_layer(cfg, "attn", mesh, ctx, b, s, train=train,
                        decode=decode)
        per_layer["encoder"] = {**p, "count": cfg.encoder_layers}
        add(p, cfg.encoder_layers)

    add(probe_head(cfg, mesh, ctx, b, s, train=train, decode=decode), 1)

    # the probes' costs are a device's; the terms divide the whole
    # program's work by the chips
    chips = mesh.size
    from repro_torch.hw import H100

    terms = RooflineTerms(
        flops=flops * chips,
        hbm_bytes=bytes_ * chips,
        hbm_bytes_min=bytes_min * chips,
        collective_bytes=sum(coll.values()) * chips,
        chips=chips,
        model_flops=model_flops_for(cfg, shape),
        hw=hw or H100,
        label=label,
    )
    # the port's cache-free attention already runs the flash kernel
    flash_terms = dataclasses.replace(terms, label=label + "+flashkernel")
    return {"terms": terms.as_dict(),
            "terms_flash_kernel": flash_terms.as_dict(),
            "collectives": coll, "per_layer": {
                k: {"count": v["count"], "flops": v["cost"]["flops"],
                    "collectives": v["collectives"]}
                for k, v in per_layer.items()}}


# ---------------------------------------------------------------------------
# The cell: the real step on the production mesh
# ---------------------------------------------------------------------------


def decode_replicates(cfg: ModelConfig, tp: int, hw) -> bool:
    """The decode cells' crossover (the reference's §Perf iteration 5):
    with no optimizer state the params replicate over the data axes,
    sharded over the model axis alone, when that fits in 60% of a
    device's HBM; else they stay FSDP-sharded."""
    return cfg.param_count() * 2 / tp < 0.6 * hw.hbm_bytes


def dryrun_cell(arch: str, shape_name: str, *, multi_pod: bool,
                probe: bool = True, verbose: bool = True,
                runtime=None) -> Dict[str, Any]:
    """Run one cell's step on the production mesh's meta positions (see
    the module docstring); ``runtime`` lends its engine (plan, decisions,
    ledger, the hardware spec), a ``Runtime(device="cpu")`` by default:
    the dry run touches no device."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    label = f"{arch}/{shape_name}/{'multipod' if multi_pod else 'pod'}"
    if not ok:
        return {"cell": label, "status": "skipped", "reason": why}

    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    n = mesh.size
    data_axes = data_axes_of(mesh)
    if runtime is None:
        from repro_torch.runtime import Runtime

        runtime = Runtime(device="cpu")
    engine = runtime.engine
    ledger_mark = len(engine.ledger.entries)
    plan = plan_model(cfg, shape, dict(mesh.shape), engine=engine)
    ctx = ShardingCtx(mesh=mesh, data_axes=data_axes,
                      rnn_chunk=plan.rnn_chunk, attn_chunk=plan.attn_chunk,
                      cost_engine=engine)
    model = build_model(cfg, "meta")
    batch_specs = make_batch_specs(cfg, shape, dtype_of(cfg.dtype))
    batches = place_shapes(mesh, batch_specs,
                         batch_sharding(batch_specs, mesh, data_axes))
    overrides = dict(plan.overrides) or None

    if shape.kind == "train":
        loop = TrainLoopConfig()
        ctx = dataclasses.replace(ctx, overrides=overrides)
        state = train_state_shapes(model, loop)
        states = place_shapes(mesh, state, param_shardings(
            state, mesh, data_axes=data_axes, overrides=overrides, cfg=cfg))
        # the state is updated in place, as Runtime.train's step does
        step = make_train_step(model, loop, ctx=ctx, donate=True)
        tr = trace(lambda: step(states, batches),
                   [(states[i], batches[i]) for i in range(n)], range(n),
                   mesh=mesh, grad=True)
    elif shape.kind == "prefill":
        ctx = dataclasses.replace(ctx, overrides=overrides)
        params = model.param_shapes()
        placed = place_shapes(mesh, params, model.mesh_specs(ctx))
        tr = trace(lambda: model.prefill(placed, batches, ctx),
                   [(placed[i], batches[i]) for i in range(n)], range(n),
                   mesh=mesh)
    else:  # decode
        tp = mesh.shape.get("model", 1)
        if not decode_replicates(cfg, tp, engine.hw):
            raise NotImplementedError(
                f"{label}: the params at model {tp} need FSDP over the data "
                f"axes, and the port's decode step takes them replicated "
                f"there")
        ctx = dataclasses.replace(ctx, infer_replicate_params=True)
        params = model.param_shapes()
        placed = place_shapes(mesh, params, param_shardings(
            params, mesh, data_axes=(), cfg=cfg))
        ctx = dataclasses.replace(ctx, kv_len=shape.seq_len)
        state = model.init_decode_state(shape.global_batch, shape.seq_len)
        states = place_shapes(mesh, state, decode_state_specs(
            cfg, state, mesh, data_axes))
        serve = make_serve_step(model, ctx)
        tr = trace(lambda: serve(placed, states, batches),
                   [(placed[i], states[i], batches[i]) for i in range(n)],
                   range(n), mesh=mesh)

    mem = tr.memory(_per_position(tr.out, n), range(n))
    scanned_cost = {"flops": tr.flops / n, "bytes": tr.bytes / n}
    record: Dict[str, Any] = {
        "cell": label,
        "status": "ok",
        "mesh": dict(mesh.shape),
        "chips": n,
        "memory_analysis": mem,
        "scanned_cost_analysis": scanned_cost,
        "plan_hbm_per_chip_gb": plan.hbm_per_chip / 1e9,
        "plan_fits_hbm": plan.fits_hbm,
        "plan_decisions": [dataclasses.asdict(d) for d in plan.decisions],
        "plan_overrides": {k: str(v) for k, v in plan.overrides.items()},
        "compile_s": time.time() - t0,
        "kernel_calls": {" ".join(k): v
                         for k, v in sorted(tr.calls.counts().items())},
        "collective_bytes": tr.collective_bytes,
    }
    del tr
    if verbose:
        print(f"[{label}] traced on {n} meta positions in "
              f"{record['compile_s']:.1f}s")
        print(f"  memory_analysis: {mem}")
        print(f"  cost_analysis(scanned): {scanned_cost}")

    if probe:
        t1 = time.time()
        roof = composed_roofline(cfg, shape, mesh, ctx, label, hw=engine.hw)
        record["roofline"] = roof
        record["probe_s"] = time.time() - t1
        if verbose:
            t = roof["terms"]
            print(f"  roofline: compute={t['t_compute_s']:.3e}s "
                  f"memory={t['t_memory_s']:.3e}s "
                  f"collective={t['t_collective_s']:.3e}s "
                  f"bound={t['bound']} frac={t['roofline_fraction']:.3f}")
    # every CostEngine decision this cell triggered (plan + trace-time sites)
    record["cost_ledger"] = [
        e.as_dict() for e in engine.ledger.entries[ledger_mark:]]
    return record


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probe", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    archs = list_configs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    from repro_torch.runtime import Runtime, RuntimeConfig

    # one session for the whole sweep: every cell's plan and decisions
    # share one engine (and its decision cache) and one ledger; it only
    # lends the engine, so it is a CPU session (the dry run touches no
    # device)
    rt = Runtime(RuntimeConfig.from_env(), device="cpu")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    jsonl = open(args.out + "l", "a") if args.out else None  # incremental
    results = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    rec = dryrun_cell(arch, shape, multi_pod=mp,
                                      probe=not args.no_probe, runtime=rt)
                except Exception as e:  # a failing cell is a bug: surface it
                    rec = {"cell": f"{arch}/{shape}/"
                                   f"{'multipod' if mp else 'pod'}",
                           "status": "FAILED",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    print(f"[{rec['cell']}] FAILED: {rec['error']}")
                results.append(rec)
                if jsonl:
                    jsonl.write(json.dumps(rec, default=str) + "\n")
                    jsonl.flush()

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_fail} FAILED ===")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
        print(f"wrote {args.out}")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
