"""Calibration layer: microbenchmark the running card into a HardwareSpec.

The analytic model (costs/model.py) is only as good as its constants, and
data-sheet peaks are not what the port's kernels reach.  ``calibrate()``
measures, on the CUDA device it is given:

  * kernel launch latency      — back-to-back launches of a trivial kernel,
                                 timed with CUDA events
  * effective memory bandwidth — a read + write sweep over 256 MiB (five
                                 times the 50 MB L2), CUDA events
  * matmul throughput          — FLOP/s of the port's own matmul kernel at
                                 a square order, per dtype, CUDA events
  * host-sync latency          — ``.item()`` of a ready tensor after
                                 ``torch.cuda.synchronize()``, host clock
  * prefix-lookup hop, IPC     — host code: a radix-trie hop and a
    round trip + bandwidth       ping-pong through a spawned echo child
  * collective base latency    — only with at least 2 GPUs: a tiny
    and interconnect bandwidth   cross-device reduction, and a large one
                                 inverted through the ring model

and returns a ``HardwareSpec`` with those fields replaced.  Results persist
to a JSON cache keyed by a fingerprint of the card, its count and the torch
and CUDA versions.  The cache lives under the repository's ``build/``
directory, never beside the reference package's.

A measurement needs the card: asked for any other device, calibration
raises instead of timing the CPU.  A probe that does not apply (the
collectives on one GPU) returns None and the field keeps its base value.
torch is imported where a probe runs, not with the module: the CostEngine
imports this module, and so does a spawned front-end worker that
validates requests through the serving scheduler.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from pathlib import Path
from typing import Optional

from repro_torch.hw import H100, HardwareSpec

_SCHEMA_VERSION = 1


def _require_cuda(device) -> "torch.device":
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"calibration times the GPU and needs a CUDA "
                           f"device, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("calibration needs an NVIDIA GPU, but "
                           "torch.cuda.is_available() is False")
    return dev


def backend_fingerprint(device="cuda") -> str:
    """Stable id of the running card: what the calibration cache keys on."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        parts = ("cuda", torch.cuda.get_device_name(dev),
                 str(torch.cuda.device_count()), torch.__version__,
                 str(torch.version.cuda))
    else:
        parts = (dev.type, dev.type, "1", torch.__version__, "none")
    raw = "|".join(parts)
    return f"{parts[0]}-{hashlib.sha256(raw.encode()).hexdigest()[:12]}"


def default_cache_dir() -> Path:
    """``build/calibration`` at the repository root (``.gitignore`` lists
    ``build/``).  Reads nothing from the environment."""
    return Path(__file__).resolve().parents[4] / "build" / "calibration"


# ---------------------------------------------------------------------------
# Microbenchmarks
# ---------------------------------------------------------------------------


def _timeit(fn, reps: int) -> float:
    """Host wall seconds per call, after one warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def _time_events(fn, reps: int, device: "torch.device") -> float:
    """Device seconds per call from CUDA events around ``reps`` calls,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / 1e3 / reps


def _measure_launch_latency(device, reps: int = 200) -> float:
    """Seconds per launch of a trivial kernel, back to back — the measured
    analogue of the paper's thread-creation overhead."""
    import torch

    x = torch.zeros((8,), dtype=torch.float32, device=device)
    return _time_events(lambda: x.add_(1.0), reps, device)


def _measure_memory_bw(device, nbytes: int = 1 << 28, reps: int = 10) -> float:
    """Effective bytes/s of a read + write sweep over ``nbytes``."""
    import torch

    x = torch.ones((nbytes // 4,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    dt = _time_events(lambda: torch.mul(x, 2.0, out=y), reps, device)
    return 2.0 * nbytes / max(dt, 1e-12)


def _measure_matmul_flops(device, order: int = 1024, reps: int = 10,
                          dtype: str = "float32") -> float:
    """Achieved FLOP/s of the port's matmul kernel at an order^3 product
    in ``dtype`` (a torch dtype's name)."""
    import torch

    from repro_torch.kernels import ops

    a = torch.ones((order, order), dtype=getattr(torch, dtype),
                   device=device)
    dt = _time_events(lambda: ops.matmul(a, a), reps, device)
    return 2.0 * order**3 / max(dt, 1e-12)


def _measure_host_sync(device, reps: int = 50) -> float:
    """Wall seconds of one device->host round trip on a tiny READY tensor —
    the per-macro-step tax the serve horizon amortizes over K tokens."""
    import torch

    y = torch.zeros((8,), dtype=torch.float32, device=device) + 1.0
    torch.cuda.synchronize(device)
    return _timeit(lambda: y[0].item(), reps)


def _measure_prefix_lookup(reps: int = 20000, block_size: int = 16) -> float:
    """Host wall time of ONE radix-trie hop — building a block's token
    tuple and probing a children dict with it.  Pure host Python."""
    tokens = list(range(block_size * 64))
    children = {tuple(tokens[i * block_size:(i + 1) * block_size]): i
                for i in range(64)}
    t0 = time.perf_counter()
    for r in range(reps):
        i = (r % 64) * block_size
        children.get(tuple(tokens[i:i + block_size]))
    return (time.perf_counter() - t0) / reps


def _ipc_echo_child(conn) -> None:
    """Echo server for the IPC probes (module-level: spawn-importable)."""
    while True:
        msg = conn.recv()
        if msg is None:
            return
        conn.send(msg)


def _measure_ipc(small_reps: int = 200, large_reps: int = 5,
                 large_bytes: int = 1 << 20) -> tuple:
    """(round_trip_s, bytes_per_s) of parent<->child pipe messaging — the
    two constants behind the serve_ipc cost site.  One spawned echo child
    (spawn, not fork: the parent holds CUDA state) serves both probes."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_ipc_echo_child, args=(child,), daemon=True)
    proc.start()
    try:
        def round_trip(payload):
            parent.send(payload)
            return parent.recv()

        round_trip(b"x")  # readiness barrier
        rt = _timeit(lambda: round_trip(b"x"), small_reps)
        blob = b"\0" * large_bytes
        dt = _timeit(lambda: round_trip(blob), large_reps)
        return rt, 2.0 * large_bytes / max(dt - rt, 1e-9)
    finally:
        parent.send(None)
        proc.join(timeout=5.0)
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=5.0)
        parent.close()
        child.close()


def _cross_device_sum(nbytes: int):
    import torch

    n = torch.cuda.device_count()
    xs = [torch.ones((max(nbytes // 4, 1),), dtype=torch.float32,
                     device=f"cuda:{i}") for i in range(n)]

    def run():
        torch.cuda.comm.reduce_add(xs, destination=0)
        for i in range(n):
            torch.cuda.synchronize(i)
    return run


def _measure_collective_base(reps: int = 20) -> Optional[float]:
    """Wall seconds of a tiny reduction across every GPU; None with fewer
    than 2 GPUs."""
    import torch

    if torch.cuda.device_count() < 2:
        return None
    return _timeit(_cross_device_sum(4 * torch.cuda.device_count()), reps)


def _measure_interconnect_bw(nbytes: int = 1 << 26, reps: int = 5,
                             links: int = H100.ici_links) -> Optional[float]:
    """Per-link interconnect bytes/s from a large reduction across every
    GPU, inverted through the ring all-reduce model ``collective_time``
    charges (2·(c-1)/c · bytes over ici_links/2 links).  None with fewer
    than 2 GPUs."""
    import torch

    c = torch.cuda.device_count()
    if c < 2:
        return None
    dt = _timeit(_cross_device_sum(nbytes), reps)
    base = _measure_collective_base() or 0.0
    eff_bw = 2.0 * (c - 1) / c * nbytes / max(dt - base, 1e-9)
    return eff_bw * 2.0 / max(links, 1)


# ---------------------------------------------------------------------------
# calibrate + persistence
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    spec: HardwareSpec
    fingerprint: str
    from_cache: bool
    measurements: dict  # raw probe values (doc/debug)
    # persisted per-site correction state (corrections.py) riding in the
    # same fingerprint-keyed cache entry, and the path it lives at
    corrections: dict = dataclasses.field(default_factory=dict)
    path: Optional[Path] = None
    device: str = "cuda"


# Per-field probe dispatch: which microbenchmark calibrates each
# HardwareSpec field, so drift at one CostQuery site re-runs only the
# probes for the fields that site depends on (hw.SITE_FIELDS).  Every probe
# takes (base_spec, matmul_order, device).  The two IPC fields share one
# echo child (``IPC_FIELDS``, measured together by ``run_probe_fields``).
IPC_FIELDS = ("ipc_round_trip_s", "ipc_bytes_per_s")
PROBES = {
    "kernel_launch_s": lambda base, order, dev: _measure_launch_latency(dev),
    "host_sync_s": lambda base, order, dev: _measure_host_sync(dev),
    "prefix_lookup_s": lambda base, order, dev: _measure_prefix_lookup(),
    "hbm_bw": lambda base, order, dev: _measure_memory_bw(dev),
    "peak_flops_f32": lambda base, order, dev: _measure_matmul_flops(
        dev, order, dtype="float32"),
    "peak_flops_bf16": lambda base, order, dev: _measure_matmul_flops(
        dev, order, dtype="bfloat16"),
    "collective_base_s": lambda base, order, dev: _measure_collective_base(),
    "ici_bw_per_link": lambda base, order, dev: _measure_interconnect_bw(
        links=base.ici_links),
}


def run_probe_fields(fields, base: HardwareSpec = H100, *,
                     matmul_order: int = 1024, device="cuda") -> dict:
    """Run the probes for ``fields`` on ``device``.  A field with no probe
    is skipped; a probe that does not apply reports None so the caller
    keeps the current value for that field."""
    import torch

    dev = _require_cuda(device)
    probes = {}
    for name in fields:
        if name in PROBES:
            with torch.cuda.device(dev):
                probes[name] = PROBES[name](base, matmul_order, dev)
    wanted_ipc = [name for name in IPC_FIELDS if name in fields]
    if wanted_ipc:
        probes.update((name, value) for name, value
                      in zip(IPC_FIELDS, _measure_ipc()) if name in wanted_ipc)
    return probes


def calibrate(base: HardwareSpec = H100, *, cache_dir: Optional[Path] = None,
              force: bool = False, matmul_order: int = 1024,
              device="cuda") -> CalibrationResult:
    """Return a HardwareSpec calibrated on the card ``device``.

    Reads the JSON cache first (keyed by ``backend_fingerprint()``); runs the
    microbenchmarks only on a miss or ``force=True``.
    """
    dev = _require_cuda(device)
    fp = backend_fingerprint(dev)
    cache_dir = Path(cache_dir) if cache_dir is not None else default_cache_dir()
    cache_path = cache_dir / f"{fp}.json"

    if not force:
        cached = load_calibration(cache_path, fingerprint=fp)
        if cached is not None:
            return CalibrationResult(cached["spec"], fp, True,
                                     cached.get("measurements", {}),
                                     corrections=cached.get("corrections", {}),
                                     path=cache_path, device=str(dev))

    probes = run_probe_fields(tuple(PROBES) + IPC_FIELDS, base,
                              matmul_order=matmul_order, device=dev)
    updates = {k: v for k, v in probes.items() if v is not None}
    spec = dataclasses.replace(base, name=f"calibrated-{fp}", **updates)
    save_calibration(cache_path, spec, fingerprint=fp, measurements=probes)
    # a forced re-calibration drops any persisted corrections on purpose:
    # they corrected the OLD spec, and a fresh spec must not inherit them
    return CalibrationResult(spec, fp, False, probes, path=cache_path,
                             device=str(dev))


def save_calibration(path: Path, spec: HardwareSpec, *, fingerprint: str,
                     measurements: Optional[dict] = None,
                     corrections: Optional[dict] = None) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = {
        "schema": _SCHEMA_VERSION,
        "fingerprint": fingerprint,
        "spec": spec.to_dict(),
        "measurements": measurements or {},
        "corrections": corrections or {},
    }
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps(payload, indent=1))
    tmp.replace(path)


def load_calibration(path: Path, *, fingerprint: Optional[str] = None
                     ) -> Optional[dict]:
    """Load {spec, measurements, corrections} from ``path``; None on miss or
    mismatch."""
    try:
        payload = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return None
    if payload.get("schema") != _SCHEMA_VERSION:
        return None
    if fingerprint is not None and payload.get("fingerprint") != fingerprint:
        return None
    # a cache written before a HardwareSpec field existed would silently
    # pin that field to its data-sheet default forever — re-calibrate instead
    missing = {f.name for f in dataclasses.fields(HardwareSpec)} - set(
        payload.get("spec", {}))
    if missing:
        return None
    return {"spec": HardwareSpec.from_dict(payload["spec"]),
            "measurements": payload.get("measurements", {}),
            "corrections": payload.get("corrections", {})}
