"""The scan-chunk fork-join sweep: the paper's overhead trade applied to
the RWKV6 recurrence.

Small chunks mean many serial steps (launch overhead dominates, the
paper's thread-creation analogue); big chunks a large (L, L, N) pairwise
intra-chunk tensor (the memory term dominates).  Each chunk's
``wkv_chunked`` is timed on the session's device (the WKV kernel on the
card, which is built for chunks 16, 32 and 64; its plain version on the
CPU, at every chunk) beside the engine's prediction and its argmin,
``best_scan_chunk``.
"""

from __future__ import annotations

import torch

from repro_torch.benches.common import out_dir, session, time_us
from repro_torch.kernels.wkv import CHUNKS as KERNEL_CHUNKS
from repro_torch.models.rwkv import wkv_chunked

CHUNKS = (16, 32, 64, 128, 256)
B, S, H, N = 2, 1024, 4, 32


def inputs(device, seed: int = 0):
    """r, k, v, logw (B, S, H, N) fp32 and u (H, N) zeros, as the
    reference's suite draws them (logw = -exp(N(0, 1) - 2))."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v, w = (torch.randn((B, S, H, N), generator=gen)
                  for _ in range(4))
    logw = -torch.exp(w - 2.0)
    u = torch.zeros((H, N))
    return [t.to(device) for t in (r, k, v, logw, u)]


def chunk_out(r, k, v, logw, u, chunk: int) -> torch.Tensor:
    """``wkv_chunked`` from a zero state at ``chunk``: the output."""
    state = torch.zeros((B, H, N, N), device=r.device)
    return wkv_chunked(r, k, v, logw, u, state, chunk=chunk)[0]


def predictions(om) -> tuple:
    """({chunk: predicted µs}, model_choice) on an analytic model."""
    pred = {c: om.scan_chunk_cost(S, c, batch=B, heads=H, head_dim=N) * 1e6
            for c in CHUNKS}
    best = om.best_scan_chunk(S, batch=B, heads=H, head_dim=N,
                              candidates=CHUNKS)
    return pred, best


def runs_on(device: torch.device, chunk: int) -> bool:
    """The card runs the kernel, built for ``KERNEL_CHUNKS`` alone."""
    return device.type == "cpu" or chunk in KERNEL_CHUNKS


def run(csv=True, runtime=None, out=None):
    rt = session(runtime)
    out_dir(out)
    dev = rt.device
    r, k, v, logw, u = inputs(dev)
    pred, best = predictions(rt.engine.model)
    rows = []
    for c in CHUNKS:
        us = time_us(lambda: chunk_out(r, k, v, logw, u, c), dev) \
            if runs_on(dev, c) else None
        rows.append({"chunk": c, "measured_us": us, "pred_us": pred[c]})
        if csv:
            got = f"{us:.0f}us" if us is not None else "no_kernel_build"
            print(f"wkv_chunk,chunk={c},{dev.type}={got},"
                  f"pred={pred[c]:.2f}us")
    print(f"wkv_chunk,model_choice={best}")
    return rows


if __name__ == "__main__":
    run()
