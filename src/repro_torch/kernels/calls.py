"""What the port's kernels are asked to do, call by call.

Each kernel wrapper counts its launches where it launches (the
``LAUNCHES`` of its module).  Beside those counters, while a ``CallLog``
is open, every kernel call appends one ``Call``: the kernel, the path its
``choose_path`` picks, the mode (what else tells two calls of one kernel
apart), the call's FLOPs and HBM bytes, and the mesh position whose work
it is.  A CUDA tensor records its call where the wrapper launches the
kernel.  A meta tensor (the dry run, ``launch/dryrun.py``) runs the same
checks and makes the same allocations as the card path, then records the
call where the card path would launch, and launches nothing.  So the dry
run's list of a step and a card run's list of the same step compare.

One function a kernel gives a call's FLOPs and bytes (``matmul_cost``,
``flash_cost``, ``wkv_cost``, ``sort_cost``): the work the call does on
these inputs, each input read once and each output written once.  The dry
run's roofline and ``chip_smoke.py``'s bounds read them.  Attention is
counted dense over S x S_kv, causal or not, as the reference's XLA
attention computes it (forward QK^T and PV, backward dV, dP, dQ and dK).

The mesh position is this thread's (``at_position``; ``Mesh.on`` enters
it for a position's work).  A kernel's autograd Function keeps the
position of its forward and re-enters it in its backward, which autograd
runs outside any ``Mesh.on``.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import List, Optional, Tuple

import torch

_LOCAL = threading.local()
_LOGS: List["CallLog"] = []


def position() -> Optional[int]:
    """The mesh position whose work this thread runs (None: outside any)."""
    return getattr(_LOCAL, "position", None)


class at_position:
    """Context in which this thread runs position ``i``'s work."""

    __slots__ = ("i", "prev")

    def __init__(self, i: Optional[int]):
        self.i = i

    def __enter__(self):
        self.prev = getattr(_LOCAL, "position", None)
        _LOCAL.position = self.i
        return self

    def __exit__(self, *exc):
        _LOCAL.position = self.prev
        return False


@dataclasses.dataclass(frozen=True)
class Call:
    kernel: str  # matmul | flash_attention | wkv | bitonic_sort
    path: str
    mode: str
    flops: float
    bytes: float
    position: Optional[int]

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.kernel, self.path, self.mode)


class CallLog:
    """The kernel calls made while it is open (``with CallLog() as log``),
    from every thread."""

    def __init__(self):
        self.calls: List[Call] = []
        self._lock = threading.Lock()

    def __enter__(self):
        _LOGS.append(self)
        return self

    def __exit__(self, *exc):
        _LOGS.remove(self)
        return False

    def append(self, call: Call) -> None:
        with self._lock:
            self.calls.append(call)

    def counts(self, by_position: bool = False) -> dict:
        """{(kernel, path, mode): calls}, or with ``by_position``
        {position: {(kernel, path, mode): calls}}."""
        out: dict = {}
        for c in self.calls:
            d = out.setdefault(c.position, {}) if by_position else out
            d[c.key] = d.get(c.key, 0) + 1
        return out

    def totals(self) -> Tuple[float, float]:
        """(FLOPs, bytes) of every call."""
        return (sum(c.flops for c in self.calls),
                sum(c.bytes for c in self.calls))


def record(kernel: str, path: str, mode: str, cost: Tuple[float, float]):
    """One call into every open log (a no-op when none is open)."""
    if not _LOGS:
        return
    call = Call(kernel, path, mode, float(cost[0]), float(cost[1]),
                position())
    for log in list(_LOGS):
        log.append(call)


# open card models: dry-run counters (``roofline.DispatchCounter``) that a
# run on real CPU tensors is checked under
_MODELS: list = []


def plain_call(plain, card, *args):
    """A kernel call on CPU tensors: ``plain(*args)``, the kernel's plain
    version.  Under an open card model (a dry-run counter checking a run
    on real CPU tensors against a meta run), the model counts what the
    card would hold instead of what the plain version allocates: the card
    path's checks and allocations run on meta stand-ins of the arguments
    (``card(*stand_ins)``, recorded in the call logs as the meta path
    records it)."""
    if not _MODELS:
        return plain(*args)
    return _MODELS[-1].plain_call(plain, card, args)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_SIZES: dict = {}


def _size(dtype: torch.dtype) -> int:
    size = _SIZES.get(dtype)
    if size is None:
        size = _SIZES[dtype] = torch.empty((), dtype=dtype).element_size()
    return size


# ---------------------------------------------------------------------------
# One function a kernel: a call's (FLOPs, bytes)
# ---------------------------------------------------------------------------


def matmul_cost(a: torch.Tensor, b: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None,
                bias: Optional[torch.Tensor] = None) -> Tuple[float, float]:
    """epilogue(a @ b + bias), 2-D or 4-D: 2·Z·M·N·K FLOPs; a, b (and the
    bias) read once, the (Z, M, N) output written once in ``out_dtype``."""
    m, k = a.shape[-2:]
    n = b.shape[-1]
    z = a.numel() // max(m * k, 1) if m * k else 0
    flops = 2.0 * z * m * n * k
    nbytes = _nbytes(a) + _nbytes(b) + z * m * n * _size(out_dtype or a.dtype)
    if bias is not None:
        nbytes += _nbytes(bias)
    return flops, float(nbytes)


def flash_cost(q: torch.Tensor, k: torch.Tensor,
               direction: str) -> Tuple[float, float]:
    """Attention of q (B, S, Hq, hd) against k, v (B, Skv, Hkv, hd), dense
    over S x Skv: the forward's 4·B·Hq·S·Skv·hd (QK^T, PV) reading q, k, v
    and writing o and the fp32 log-sum-exp; the backward's
    8·B·Hq·S·Skv·hd (dV, dP, dQ, dK) reading q, k, v, o, do and the
    log-sum-exp and writing dq, dk, dv."""
    b, s, hq, hd = q.shape
    flops = 4.0 * b * hq * s * k.shape[1] * hd
    nq, nkv, lse = _nbytes(q), _nbytes(k), 4 * b * hq * s
    if direction == "forward":
        return flops, float(2 * nq + 2 * nkv + lse)
    return 2.0 * flops, float(3 * nq + 2 * nkv + lse + nq + 2 * nkv)


def wkv_cost(r: torch.Tensor, direction: str) -> Tuple[float, float]:
    """Chunked WKV6 on r, k, v, logw (B, S, H, N), u (H, N): the state
    update and the readout, 4·B·S·H·N² FLOPs forward and twice that
    backward.  Forward: r, k, v (r's dtype), logw and u (fp32) read, out
    (B, S, H, N) and the state (B, H, N, N) written in fp32.  Backward: the
    same inputs and dout (fp32) read, dr, dk, dv (r's dtype), dlogw (fp32)
    and du written."""
    b, s, h, n = r.shape
    flops = 4.0 * b * s * h * n * n
    x = _nbytes(r)
    f32 = 4 * b * s * h * n
    if direction == "forward":
        return flops, float(3 * x + f32 + 4 * h * n + f32 + 4 * b * h * n * n)
    return 2.0 * flops, float(3 * x + f32 + 4 * h * n + f32
                              + 3 * x + f32 + 4 * h * n)


def sort_cost(x: torch.Tensor) -> Tuple[float, float]:
    """A bitonic sort of each row of ``x`` (rows, n), n a power of 2: its
    n/2 · log2(n) · (log2(n) + 1) / 2 compare-exchanges a row; the input
    read once and the output written once."""
    rows, n = x.shape
    lg = int(math.log2(n)) if n > 1 else 0
    return rows * n / 2.0 * lg * (lg + 1) / 2.0, float(2 * _nbytes(x))
