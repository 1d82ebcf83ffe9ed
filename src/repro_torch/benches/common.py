"""What the suites share: the output directory, the session, the JSON
record files and the timers."""

from __future__ import annotations

import json
import statistics
import time
from pathlib import Path
from typing import Callable, Optional, Union

import torch

DEFAULT_OUT = Path("results") / "torch"


def out_dir(out: Optional[Union[str, Path]] = None) -> Path:
    """The suite's output directory (made if missing): ``out``, else
    ``results/torch/`` under the working directory."""
    path = Path(out) if out is not None else DEFAULT_OUT
    path.mkdir(parents=True, exist_ok=True)
    return path


def session(runtime=None):
    """The Runtime a suite runs on: the caller's, else the process
    default (the card)."""
    if runtime is not None:
        return runtime
    from repro_torch.runtime import default_runtime

    return default_runtime()


def cache_dir(runtime, out: Path) -> Path:
    """Where a suite keeps calibration and tuner caches: the session's
    ``cache_dir`` where it has one, else ``<out>/cache``."""
    return Path(runtime.config.cache_dir) if runtime.config.cache_dir \
        else out / "cache"


def load_json(path: Path) -> dict:
    try:
        return json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}


def write_json(path: Path, payload) -> None:
    Path(path).write_text(json.dumps(payload, indent=1, default=str))


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_us(fn: Callable, device: torch.device, reps: int = 3) -> float:
    """Median wall microseconds of ``fn()`` after one warm call, the device
    synchronised around each."""
    fn()
    sync(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e6


def mean_us(fn: Callable, device: torch.device, reps: int = 3) -> float:
    """Mean wall microseconds of ``reps`` calls of ``fn()`` after one warm
    call, the device synchronised before and after (the reference's
    timing of its serial matmuls and sorts)."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps * 1e6


ARCH = "tinyllama-1.1b"
CUT_LAYERS = 4  # the card's depth for the stress and chaos suites


def bench_config(device: torch.device, layers: Optional[int] = None):
    """The serving suites' model: reduced tinyllama-1.1b in fp32 on the
    CPU; on the card full-width tinyllama-1.1b in bf16, at ``layers``
    layers where given (else all 22)."""
    import dataclasses

    from repro_torch.configs import get_config

    if device.type == "cpu":
        return get_config(ARCH).reduced()
    cfg = get_config(ARCH)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def model_and_params(cfg, device: torch.device, model=None, params=None):
    """The suite's model and parameters (random, seed 0) unless the caller
    passes its own."""
    from repro_torch.models import build_model

    if model is None:
        model = build_model(cfg, device)
    if params is None:
        params = model.init(0)
    return model, params
