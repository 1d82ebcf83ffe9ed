"""Python side of the Hopper bitonic sort kernel (``csrc/bitonic_sort.cu``).

The kernel replaces ``src/repro/kernels/bitonic_sort.py::
bitonic_sort_pallas``: the same bitonic network on every row of a (rows, n)
array, n a power of 2.  Its plain PyTorch version, step by step, is
``kernels/ref.py::bitonic_sort_ref``.  The source note in
``bitonic_sort.cu`` says what bounds it on an H100 and how its passes
split the network between registers, shared and device memory;
``passes`` states that schedule in Python.

``bitonic_sort_cuda`` is the only place the kernel is launched.  It checks
what the kernel takes and raises on anything else, allocates the output
with ``torch.empty``, launches on the current stream, raises if a launch
reports an error, and counts the call in ``LAUNCHES`` (``count``: calls;
``grids``: the CUDA kernel launches they made, 31 for a 2^26 row).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, calls

_DTYPE_CODE = {torch.float32: 0, torch.int32: 1}
LOG_TILE = 14  # log2 of the elements a block pass holds (kLogTile)
TILE = 1 << LOG_TILE  # elements a block pass holds in shared memory (kTile)
LOG_E = 5  # log2 of the elements a block-pass thread holds (kLogE)
LOG_GROUP = 6  # stages a global pass runs at most (kLogGroup)
SMEM_LIMIT = 232_448  # bytes of shared memory a block may have on sm_90


class LaunchCounter:
    """Kernel calls (``count``) and their CUDA launches (``grids``) since
    the last ``reset``."""

    def __init__(self):
        self.count = 0
        self.grids = 0

    def reset(self) -> None:
        self.count = 0
        self.grids = 0


LAUNCHES = LaunchCounter()


def passes(n: int, tile: int = TILE, group: int = LOG_GROUP) -> list:
    """The kernel's launches for rows of length ``n``, in order, each as
    (kind, stages): ``"block"`` runs its (k, j) stages on tiles of ``tile``
    elements in shared memory and registers, ``"global"`` runs up to
    ``group`` consecutive stages j >= ``tile`` of one k over device memory.
    The first pass takes every k <= min(n, tile); for each k > tile, the
    stages j >= tile in groups from the top (the last one shorter), then a
    block pass finishes j < tile.  The stages, concatenated, are the
    network's."""
    def stages(k, j_top, j_low):
        out = []
        while j_top >= j_low:
            out.append((k, j_top))
            j_top //= 2
        return out

    first, k = [], 2
    while k <= min(n, tile):
        first += stages(k, k // 2, 1)
        k *= 2
    out = [("block", first)]
    while k <= n:
        wide = stages(k, k // 2, tile)
        out += [("global", wide[i:i + group])
                for i in range(0, len(wide), group)]
        out.append(("block", stages(k, tile // 2, 1)))
        k *= 2
    return out


def grid_launches(n: int, tile: int = TILE, group: int = LOG_GROUP) -> int:
    """CUDA launches the kernel makes for rows of length ``n``: one a pass
    (31 for n = 2^26 at the port's own tile and group)."""
    return len(passes(n, tile, group))


def config_ok(log_tile: int, log_group: int) -> bool:
    """Whether ``bitonic_sort.cu`` builds with this tile and group: its
    static_asserts (a block pass of 32 to 1024 threads, a global pass of
    2 to 64 elements a thread) and the padded tile within a block's shared
    memory."""
    return (LOG_E + 5 <= log_tile <= LOG_E + 10 and 1 <= log_group <= 6
            and smem_bytes(log_tile, 4) <= SMEM_LIMIT)


def smem_bytes(log_tile: int, dtype_bytes: int) -> int:
    """Dynamic shared memory of a block pass on a full tile of
    ``2^log_tile`` elements: one padding word after every 32."""
    tile = 1 << log_tile
    return (tile + (tile >> 5)) * dtype_bytes


def defines(log_tile: int = LOG_TILE, log_group: int = LOG_GROUP) -> tuple:
    """The macros that build ``bitonic_sort.cu`` with this tile and group:
    none for the port's own (so its library is the one every path loads)."""
    if (log_tile, log_group) == (LOG_TILE, LOG_GROUP):
        return ()
    if not config_ok(log_tile, log_group):
        raise ValueError(f"the sort kernel takes no tile 2^{log_tile} with "
                         f"group {log_group}")
    return (f"SORT_LOG_TILE={log_tile}", f"SORT_LOG_GROUP={log_group}")


def kernel_info(log_tile: int = LOG_TILE, log_group: int = LOG_GROUP) -> dict:
    """The build with this tile and group as the CUDA runtime has it on the
    current card: its tile and group, the fp32 block pass's dynamic shared
    memory, threads, registers a thread and resident blocks an SM."""
    fn = build.load("bitonic_sort", defines(log_tile, log_group)) \
        .repro_bitonic_sort_info
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    err = fn(out)
    if err != 0:
        raise RuntimeError(f"sort kernel info failed: cudaError {err}")
    return dict(zip(("log_tile", "log_group", "smem_bytes", "threads",
                     "registers", "ctas_per_sm"), out))


def _function(defines=()):
    """The C entry point; ``defines`` build it with another tile or group
    (``SORT_LOG_TILE=15``: ``defines()``), which the autotuner and
    ``tools/sort_tile_sweep.py`` ask for."""
    fn = build.load("bitonic_sort", defines).repro_bitonic_sort
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: ctypes would otherwise
        # pass a Python int as a 32-bit int and cut the address
        p, ll = ctypes.c_void_p, ctypes.c_longlong
        fn.argtypes = [p, p, ctypes.c_int, ll, ll, p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return fn


def bitonic_sort_cuda(x: torch.Tensor, log_tile: int = LOG_TILE,
                      log_group: int = LOG_GROUP) -> torch.Tensor:
    """Sort each row of the contiguous CUDA tensor ``x`` (rows, n) ascending,
    n a power of 2 (at least 2), float32 or int32; returns a new tensor.
    ``log_tile`` and ``log_group`` pick the build (``defines``); the port's
    own by default."""
    if not (x.is_cuda or x.is_meta):
        raise ValueError(f"bitonic_sort_cuda needs a CUDA tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bitonic sort kernel takes float32 or int32, got "
                        f"{x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"bitonic sort kernel takes (rows, n), got "
                         f"{tuple(x.shape)}")
    rows, n = x.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of 2, at least 2")
    if not x.is_contiguous():
        raise ValueError("bitonic sort kernel takes a contiguous tensor")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    path = str(x.dtype).replace("torch.", "")
    if x.is_meta:  # the dry run: the card path's allocation, no launch
        calls.record("bitonic_sort", path, "rows", calls.sort_cost(x))
        return out
    fn = _function(defines(log_tile, log_group))
    grids = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype], rows, n,
                 stream, ctypes.byref(grids))
    if err != 0:
        raise RuntimeError(f"bitonic sort kernel launch failed: cudaError "
                           f"{err} for {tuple(x.shape)} {x.dtype}")
    calls.record("bitonic_sort", path, "rows", calls.sort_cost(x))
    LAUNCHES.count += 1
    LAUNCHES.grids += grids.value
    return out
