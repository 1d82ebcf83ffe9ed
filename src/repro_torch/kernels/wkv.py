"""Python side of the Hopper WKV kernels (``csrc/wkv.cu``), forward and
backward.

The kernels replace ``src/repro/kernels/wkv.py::wkv_pallas``: the chunked
RWKV6 WKV from a zero state, on r, k, v (B, S, H, N) in bf16 or fp32 and
logw (B, S, H, N) fp32 read through their strides, u (H, N) fp32; out (B,
S, H, N) and the final state (B, H, N, N) in fp32.  The TPU kernel has no
backward; the port trains through this one, so the gradient is a kernel
too.  Their plain PyTorch versions are ``kernels/ref.py::wkv_fwd_plain``
and ``wkv_bwd_plain`` with ``subchunk=SUBCHUNK`` (the pairwise decay
factored by sub-chunk, as the kernels take it); the source note in
``wkv.cu`` says what bounds them on an H100.

``wkv_fwd_cuda`` and ``wkv_bwd_cuda`` are the only places the kernels are
launched.  Each checks what the kernels take and raises on anything else,
allocates its outputs and scratch with ``torch.empty``, launches on the
current stream, raises if a launch reports an error, and counts the call
in any open ``calls.CallLog`` (meta tensors, the dry run, take the same
checks and allocations and are recorded there, launching nothing) and in
``LAUNCHES``.  CUDA launches per call (``LAUNCHES.cuda`` counts them by
kernel):

* forward, 2: ``wkv_state`` (the state pass: one CTA per (b, h, 16 value
  columns), sequential over the chunks, writing every chunk's start state)
  then ``wkv_fwd_out`` (one CTA per (b, h, chunk));
* backward, 2: ``wkv_state`` in reverse (the gradient of every chunk's end
  state) then ``wkv_bwd_chunk`` (one CTA per (b, h, chunk)); du's shares
  are summed by one ``torch.sum`` in a fixed order.

``WkvFn`` is the autograd Function around them; on CPU tensors it runs the
plain versions in their place, so its plumbing is tested without a card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, calls
from repro_torch.kernels.ref import wkv_bwd_plain, wkv_fwd_plain

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_SIZES = (16, 32, 64)  # N the kernels are instantiated for
CHUNKS = (16, 32, 64)  # chunk lengths L likewise
SUBCHUNK = 16  # rows of a sub-chunk (wkv.cu kSub)
# CUDA kernels launched by each call, in order
FORWARD_KERNELS = ("wkv_state", "wkv_fwd_out")
BACKWARD_KERNELS = ("wkv_state", "wkv_bwd_chunk")
INFO_KERNELS = ("wkv_state forward", "wkv_fwd_out", "wkv_state backward",
                "wkv_bwd_chunk")
_MAX_GRID = 2**31 - 1


class LaunchCounter:
    """Forward and backward wrapper calls, and CUDA launches by kernel,
    since the last ``reset``."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.forward = 0
        self.backward = 0
        self.cuda = {}

    def add(self, kernels) -> None:
        """One launch of each kernel named in ``kernels``."""
        for name in kernels:
            self.cuda[name] = self.cuda.get(name, 0) + 1


LAUNCHES = LaunchCounter()


def _library():
    lib = build.load("wkv")
    if lib.repro_wkv_fwd.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address
        p, i = ctypes.c_void_p, ctypes.c_int
        s = ctypes.POINTER(ctypes.c_longlong)
        ints = ctypes.POINTER(ctypes.c_int)
        lib.repro_wkv_fwd.argtypes = [p, s, p, s, p, s, p, s, p, p, p, p,
                                      i, i, i, i, i, i, p]
        lib.repro_wkv_bwd.argtypes = [p, s, p, s, p, s, p, s, p, p, s, p, p,
                                      p, p, p, p, p, p, i, i, i, i, i, i, p]
        lib.repro_wkv_design.argtypes = [ints]
        lib.repro_wkv_info.argtypes = [i, i, i, ints]
        lib.repro_wkv_fwd.restype = lib.repro_wkv_bwd.restype = i
        lib.repro_wkv_info.restype = i
        lib.repro_wkv_design.restype = None
    return lib


def _functions():
    lib = _library()
    return lib.repro_wkv_fwd, lib.repro_wkv_bwd


def design() -> dict:
    """The compiled design's constants (``wkv.cu``): sub-chunk rows, value
    columns and threads of a state-pass CTA, threads of a per-chunk CTA."""
    out = (ctypes.c_int * 4)()
    _library().repro_wkv_design(out)
    return dict(subchunk=out[0], state_cols=out[1], state_threads=out[2],
                chunk_threads=out[3])


def kernel_info(dtype: torch.dtype, chunk: int, n: int) -> dict:
    """For one instantiation, each kernel's threads, dynamic shared memory,
    registers and local (spill) bytes a thread, and resident CTAs an SM,
    as the CUDA runtime reports them on the current card."""
    out = (ctypes.c_int * 20)()
    err = _library().repro_wkv_info(_DTYPE_CODE[dtype], chunk, n, out)
    if err != 0:
        raise RuntimeError(f"wkv kernel info failed: cudaError {err}")
    keys = ("threads", "smem_bytes", "registers", "local_bytes",
            "ctas_per_sm")
    return {name: dict(zip(keys, out[5 * i:5 * i + 5]))
            for i, name in enumerate(INFO_KERNELS)}


def smem_bytes(dtype: torch.dtype, chunk: int, n: int) -> dict:
    """Dynamic shared memory of each kernel of one instantiation, by
    ``INFO_KERNELS`` name, as ``wkv.cu`` sizes it: the state pass's two
    stages of x, logw and 16 columns of y (y fp32 in the backward) plus
    cw_L; the per-chunk kernels' padded D x (D + 1) fp32 tiles, D =
    max(chunk, n) (6 forward, 11 backward), and their vectors."""
    xb = torch.empty((), dtype=dtype).element_size()
    d = max(chunk, n)
    tile, nb = d * (d + 1), chunk // SUBCHUNK
    kf_rows = SUBCHUNK * nb * (nb - 1) // 2

    def state(yb):
        return 2 * (chunk * n * xb + chunk * n * 4 + chunk * 16 * yb) + n * 4

    return {"wkv_state forward": state(xb),
            "wkv_fwd_out": 4 * (6 * tile + n + nb * n),
            "wkv_state backward": state(4),
            "wkv_bwd_chunk": 4 * (11 * tile + kf_rows * (d + 1) + n + nb * n
                                  + n + 2 * 16 * n)}


def _strides(t: torch.Tensor):
    return (ctypes.c_longlong * 4)(*t.stride())


def check_shapes(r, k, v, logw, u) -> None:
    """Raise unless r, k, v, logw are (B, S, H, N) of one shape and u is
    (H, N)."""
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"wkv takes r, k, v, logw (B, S, H, N) of one shape, "
                         f"got {tuple(r.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(logw.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"wkv takes u (H, N) = {tuple(r.shape[2:])}, got "
                         f"{tuple(u.shape)}")


def _check_cuda(r, k, v, logw, u, chunk: int) -> None:
    dev = r.device
    for t in (r, k, v, logw, u):
        if not (t.is_cuda or t.is_meta) or t.device != dev:
            raise ValueError(f"wkv kernel needs CUDA tensors on one device, "
                             f"got {t.device}")
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in _DTYPE_CODE:
        raise TypeError(f"wkv kernel takes r, k, v in float32 or bfloat16 "
                        f"of one dtype, got {r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"wkv kernel takes logw and u in float32, got "
                        f"{logw.dtype}, {u.dtype}")
    n = r.shape[3]
    if n not in HEAD_SIZES or chunk not in CHUNKS:
        raise ValueError(f"wkv kernel takes head size N in {HEAD_SIZES} and "
                         f"chunk in {CHUNKS}, got N={n}, chunk={chunk}")
    if r.shape[0] * r.shape[2] * _n_chunks(r.shape[1], chunk) > _MAX_GRID:
        raise ValueError(f"wkv kernel grid too large: {tuple(r.shape)}")


def path_of(r: torch.Tensor) -> str:
    """The instantiation a call runs, by r's dtype (a call log's path)."""
    return str(r.dtype).replace("torch.", "")


def _n_chunks(s: int, chunk: int) -> int:
    return -(-s // chunk)


def wkv_fwd_cuda(r, k, v, logw, u, chunk: int = 64,
                 keep_states: bool = False):
    """Launch the forward: (out (B, S, H, N), final state (B, H, N, N),
    the state at each chunk's start (B, H, nc, N, N) if ``keep_states``
    else None), all fp32.  The state pass writes the chunk-start states in
    either case (into scratch when they are not kept)."""
    check_shapes(r, k, v, logw, u)
    _check_cuda(r, k, v, logw, u, chunk)
    b, s, h, n = r.shape
    dev = r.device
    out = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    state = torch.empty((b, h, n, n), dtype=torch.float32, device=dev)
    starts = torch.empty((b, h, _n_chunks(s, chunk), n, n),
                         dtype=torch.float32, device=dev)
    kept = starts if keep_states else None
    if b * h == 0:
        return out, state, kept
    if s == 0:
        return out, state.zero_(), kept
    u = u.contiguous()
    if r.is_meta:  # the dry run: the card path's allocations, no launch
        calls.record("wkv", path_of(r), "forward",
                     calls.wkv_cost(r, "forward"))
        return out, state, kept
    fwd, _ = _functions()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fwd(r.data_ptr(), _strides(r), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), logw.data_ptr(),
                  _strides(logw), u.data_ptr(), out.data_ptr(),
                  state.data_ptr(), starts.data_ptr(),
                  _DTYPE_CODE[r.dtype], b, s, h, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"wkv forward launch failed: cudaError {err} for "
                           f"{tuple(r.shape)} {r.dtype} chunk {chunk}")
    calls.record("wkv", path_of(r), "forward", calls.wkv_cost(r, "forward"))
    LAUNCHES.forward += 1
    LAUNCHES.add(FORWARD_KERNELS)
    return out, state, kept


def wkv_bwd_cuda(r, k, v, logw, u, chunk_states, dout,
                 dstate: Optional[torch.Tensor] = None, chunk: int = 64):
    """Launch the backward: (dr, dk, dv) in r's dtype, dlogw and du in
    fp32, from the forward's chunk-start states, ``dout`` (B, S, H, N) and
    ``dstate`` (B, H, N, N) (None: zero)."""
    check_shapes(r, k, v, logw, u)
    _check_cuda(r, k, v, logw, u, chunk)
    b, s, h, n = r.shape
    dev = r.device
    nc = _n_chunks(s, chunk)
    if chunk_states.shape != (b, h, nc, n, n) or \
            chunk_states.dtype != torch.float32 or \
            not chunk_states.is_contiguous() or chunk_states.device != dev:
        raise ValueError(f"wkv backward: chunk states must be contiguous "
                         f"fp32 (B, H, nc, N, N), got "
                         f"{tuple(chunk_states.shape)} {chunk_states.dtype}")
    if dout.shape != r.shape or dout.device != dev:
        raise ValueError(f"wkv backward: dout {tuple(dout.shape)} must match "
                         f"r {tuple(r.shape)} on {dev}")
    dout = dout.float()
    if dstate is not None:
        if dstate.shape != (b, h, n, n) or dstate.device != dev:
            raise ValueError(f"wkv backward: dstate must be (B, H, N, N) on "
                             f"{dev}, got {tuple(dstate.shape)}")
        dstate = dstate.float().contiguous()
    dr, dk, dv = (torch.empty((b, s, h, n), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dw = torch.empty((b, s, h, n), dtype=torch.float32, device=dev)
    du_part = torch.empty((b, h, nc, n), dtype=torch.float32, device=dev)
    if b * h == 0 or s == 0:
        return dr, dk, dv, dw, torch.zeros((h, n), dtype=torch.float32,
                                           device=dev)
    ends = torch.empty((b, h, nc, n, n), dtype=torch.float32, device=dev)
    u = u.contiguous()
    if r.is_meta:  # the dry run: the card path's allocations, no launch
        calls.record("wkv", path_of(r), "backward",
                     calls.wkv_cost(r, "backward"))
        return dr, dk, dv, dw, du_part.sum((0, 2))
    _, bwd = _functions()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = bwd(r.data_ptr(), _strides(r), k.data_ptr(), _strides(k),
                  v.data_ptr(), _strides(v), logw.data_ptr(),
                  _strides(logw), u.data_ptr(), dout.data_ptr(),
                  _strides(dout), chunk_states.data_ptr(),
                  None if dstate is None else dstate.data_ptr(),
                  ends.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(),
                  _DTYPE_CODE[r.dtype], b, s, h, n, chunk, stream)
    if err != 0:
        raise RuntimeError(f"wkv backward launch failed: cudaError {err} "
                           f"for {tuple(r.shape)} {r.dtype} chunk {chunk}")
    calls.record("wkv", path_of(r), "backward",
                 calls.wkv_cost(r, "backward"))
    LAUNCHES.backward += 1
    LAUNCHES.add(BACKWARD_KERNELS)
    # du is shared over the batch and the chunks: the kernel writes each
    # (b, h, chunk)'s share, summed here in a fixed order
    return dr, dk, dv, dw, du_part.sum((0, 2))


class WkvFn(torch.autograd.Function):
    """Chunked WKV6 from a zero state with the WKV kernels as forward and
    backward; CPU tensors take the plain versions in the kernels' place.
    Returns (out, final state); both carry gradients."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, chunk: int = 64):
        if r.device.type == "cpu":
            out, state, starts = calls.plain_call(
                wkv_fwd_plain, lambda *t: wkv_fwd_cuda(*t, keep_states=True),
                r, k, v, logw, u, chunk)
        else:
            out, state, starts = wkv_fwd_cuda(r, k, v, logw, u, chunk,
                                              keep_states=True)
        ctx.save_for_backward(r, k, v, logw, u, starts)
        ctx.chunk = chunk
        ctx.position = calls.position()
        return out, state

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, logw, u, starts = ctx.saved_tensors
        with calls.at_position(ctx.position):
            if r.device.type == "cpu":
                dr, dk, dv, dw, du = calls.plain_call(
                    wkv_bwd_plain, wkv_bwd_cuda, r, k, v, logw, u, starts,
                    dout, dstate, ctx.chunk)
            else:
                dr, dk, dv, dw, du = wkv_bwd_cuda(r, k, v, logw, u, starts,
                                                  dout, dstate, ctx.chunk)
        return (dr, dk, dv, dw.to(logw.dtype), du.to(u.dtype), None)
