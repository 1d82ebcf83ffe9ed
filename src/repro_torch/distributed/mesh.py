"""The port's device mesh and every collective it runs.

The counterpart of ``jax.sharding.Mesh`` and of what the reference calls
inside ``shard_map`` (``all_gather``, ``all_to_all``, ``psum``,
``ppermute``, ``axis_index``), in PyTorch's single-process idiom: one
controller holds a list with one tensor per mesh position and launches
each position's work under that position's device and CUDA stream.

* A :class:`Mesh` has named axes and one device per position, in
  row-major order over the axes.  Several positions may share a device:
  the counterpart of the reference's forced host devices
  (``--xla_force_host_platform_device_count``), and how eight shards run
  on one GPU, each on its own stream, forking and joining across the
  card's SMs.  It never happens silently: :func:`make_mesh` puts more
  than one position on a device only when asked to
  (``shards_per_device``), or when given the device list.
* Placement (:func:`place`, :func:`shard`, :func:`replicate`) and the way
  back (:func:`unshard`, :func:`take`) are the ``in_specs`` and
  ``out_specs`` of ``shard_map``.
* A collective takes and returns lists of per-position tensors.  Between
  positions it copies within a device or between peers; a tensor made on
  one position's stream and read on another's is fenced here, with a CUDA
  event for the order and ``Tensor.record_stream`` so that the caching
  allocator does not hand its memory out again before the reader is done.
  No call site fences anything itself.

Every collective of the port lives in this module, so that a multi-process
run can put ``torch.distributed`` behind the same calls.  Each is
differentiable through autograd: the copies and sums above are autograd's
own ops, and ``all_gather_cat`` (the FSDP gather of a training step) has a
backward of its own, a reduce-scatter that adds the group's gradients in
a fixed order.  ``join`` hands the positions' results to the caller's
stream.  On the CPU every position is the one CPU device and there are no
streams; the same code runs in program order.

``Mesh.distinct_devices`` counts the devices a group of positions spans:
what the cost engine prices positions sharing a GPU at (their compute,
memory and collectives are that device's).  A CPU position counts as a
device of its own, standing for one of the reference's forced host
devices, and so does a meta position.

A mesh on the ``meta`` device (``make_mesh(..., device="meta")``, of any
size) is the dry run's: its positions hold tensors with shapes and no
memory, have no stream, and run the real step functions, allocating and
launching nothing (``launch/dryrun.py``).

Every collective counts its calls (``Mesh.collectives``) and its result
bytes by kind, summed over the positions (``Mesh.collective_bytes``, the
reference's HLO names: ``all_gather`` is an all-gather, ``psum`` an
all-reduce, ``all_gather_cat``'s backward a reduce-scatter,
``all_to_all`` an all-to-all, ``ppermute`` a collective-permute), on real
devices as on meta ones, so what the dry run predicts can be held
against a run.  ``Mesh.on(i)`` also enters position ``i`` for the kernels'
call logs (``kernels/calls.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import (Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch

from repro_torch.kernels.calls import at_position

Stream = Optional["torch.cuda.Stream"]
# the collective kinds ``Mesh.collective_bytes`` counts, by the reference's
# HLO names
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# one mesh axis, or several taken together (row-major in the given order)
Axes = Union[str, Tuple[str, ...]]


def _names(axis: Axes) -> Tuple[str, ...]:
    return (axis,) if isinstance(axis, str) else tuple(axis)


class Mesh:
    """Named axes over positions, each position on a device and (on a GPU)
    with its own CUDA stream.

    ``shape`` maps axis names to sizes, in order (``{"data": 8}``,
    ``{"data": 2, "model": 4}``); ``devices`` lists one device per
    position, row-major over the axes (the last axis varies fastest)."""

    def __init__(self, shape: Mapping[str, int],
                 devices: Sequence[torch.device]):
        self.axis_names: Tuple[str, ...] = tuple(shape)
        self.axis_sizes: Tuple[int, ...] = tuple(int(v)
                                                 for v in shape.values())
        if not self.axis_names or min(self.axis_sizes) < 1:
            raise ValueError(f"mesh axes need sizes >= 1, got {dict(shape)}")
        self.size = math.prod(self.axis_sizes)
        self.devices: Tuple[torch.device, ...] = tuple(
            _norm(d) for d in devices)
        if len(self.devices) != self.size:
            raise ValueError(f"a mesh of shape {self.shape} has {self.size} "
                             f"positions; got {len(self.devices)} devices")
        self.streams: Tuple[Stream, ...] = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None
            for d in self.devices)
        # collective calls made on this mesh (each all_gather, all_to_all,
        # psum, ppermute or all_gather_cat counts one, whatever the number
        # of positions)
        self.collectives = 0
        # bytes all_gather_cat's forward brought to positions from others
        # (an FSDP weight gather's traffic)
        self.gathered_bytes = 0
        # result bytes of the collectives by kind, summed over positions
        self.collective_bytes = dict.fromkeys(COLLECTIVE_KINDS, 0)

    def count(self, kind: str, results) -> None:
        """Add the bytes of ``results`` (one tensor a position) to
        ``collective_bytes[kind]``."""
        self.collective_bytes[kind] += sum(
            t.numel() * t.element_size() for t in results if t is not None)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices]})")

    def coords(self, i: int) -> Tuple[int, ...]:
        """Position ``i``'s index along each axis."""
        out = []
        for size in reversed(self.axis_sizes):
            out.append(i % size)
            i //= size
        return tuple(reversed(out))

    def axis_index(self, axis: str, i: int) -> int:
        """Position ``i``'s index along ``axis`` (``lax.axis_index``)."""
        return self.coords(i)[self._axis(axis)]

    def groups(self, axis: Axes) -> List[List[int]]:
        """The positions that a collective over ``axis`` joins: one list a
        setting of the other axes, each in ``axis`` order.  ``axis`` may be
        a tuple of axes (the reference's compound ``("pod", "data")``): a
        group then runs over all of them, row-major in the tuple's order."""
        names = _names(axis)
        idx = [self._axis(a) for a in names]
        out: Dict[Tuple[int, ...], List[Tuple[Tuple[int, ...], int]]] = {}
        for i in range(self.size):
            c = self.coords(i)
            rest = tuple(v for k, v in enumerate(c) if k not in idx)
            out.setdefault(rest, []).append((tuple(c[k] for k in idx), i))
        return [[i for _, i in sorted(g)] for g in out.values()]

    def distinct_devices(self, axis: Optional[Axes] = None) -> int:
        """The number of distinct devices a group over ``axis`` spans (the
        whole mesh for None): what its positions' compute and memory share,
        as the cost engine prices them.  It is the group's size unless
        positions share a GPU (``shards_per_device``).  A CPU position
        counts as a device of its own: the CPU mesh stands for the
        reference's forced host devices, which the reference prices as
        separate chips; so does a meta position, the dry run's stand-in
        for a chip of a production mesh."""
        def device(i):
            d = self.devices[i]
            return d if d.type == "cuda" else i

        groups = [range(self.size)] if axis is None else self.groups(axis)
        return max(len({device(i) for i in g}) for g in groups)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh {self.shape} has no axis {axis!r}")
        return self.axis_names.index(axis)

    def on(self, i: int):
        """Context in which work runs as position ``i``'s: its device, and
        its stream on a GPU; the kernels' call logs read the position."""
        stream = self.streams[i]
        if stream is None:
            return at_position(i)
        stack = contextlib.ExitStack()
        stack.enter_context(at_position(i))
        stack.enter_context(torch.cuda.device(self.devices[i]))
        stack.enter_context(torch.cuda.stream(stream))
        return stack

    def map(self, fn: Callable, *per_position: Sequence) -> list:
        """``fn(*args of position i)`` on every position, each launched as
        that position's work (``mesh.on(i)``); ``per_position`` are lists
        with one entry a position."""
        for args in per_position:
            if len(args) != self.size:
                raise ValueError(f"{len(args)} arguments for {self.size} "
                                 f"positions")
        out = []
        for i in range(self.size):
            with self.on(i):
                out.append(fn(*(args[i] for args in per_position)))
        return out


def available_devices(device: str) -> Optional[int]:
    """How many devices of ``device``'s type this process can use (None:
    as many as asked, the meta device's positions)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return torch.cuda.device_count()
    if kind == "cpu":
        return 1
    if kind == "meta":
        return None
    raise ValueError(f"device must be 'cuda', 'cpu' or 'meta', got "
                     f"{device!r}")


def make_mesh(shape: Mapping[str, int], *, device: str = "cuda",
              shards_per_device: int = 1) -> Mesh:
    """A mesh of ``shape`` over devices of type ``device`` (the GPUs by
    default), ``shards_per_device`` positions on each, so the mesh takes
    ``prod(shape) / shards_per_device`` devices.  More devices than exist
    raises: positions share a device only when the caller says so.

    ``make_mesh({"data": 8}, shards_per_device=8)`` puts eight shards on
    GPU 0; ``make_mesh({"data": 8}, device="cpu", shards_per_device=8)``
    is the CPU mesh the tests use.  ``device="meta"`` gives the dry run's
    mesh of any size, every position on the meta device."""
    size = math.prod(int(v) for v in shape.values())
    if shards_per_device < 1 or size % shards_per_device:
        raise ValueError(f"shards_per_device={shards_per_device} must "
                         f"divide the mesh's {size} positions")
    need = size // shards_per_device
    have = available_devices(device)
    kind = torch.device(device).type
    if have is not None and need > have:
        raise ValueError(
            f"mesh {dict(shape)} needs {need} {kind} device(s) at "
            f"{shards_per_device} position(s) a device, and this process "
            f"has {have}; several positions share a device only when asked "
            f"(make_mesh(..., shards_per_device=n))")
    if kind == "cuda":
        devices = [torch.device("cuda", i // shards_per_device)
                   for i in range(size)]
    else:
        devices = [torch.device(kind)] * size
    return Mesh(shape, devices)


# ---------------------------------------------------------------------------
# Moving a tensor between positions (the fences live here)
# ---------------------------------------------------------------------------


def _norm(device) -> torch.device:
    """``device`` with its index (``cuda`` is the current GPU)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _stream_of(device: torch.device) -> Stream:
    """The caller's current stream on ``device`` (None on the CPU)."""
    return torch.cuda.current_stream(device) if device.type == "cuda" \
        else None


def _move(t: torch.Tensor, src: Stream, device: torch.device,
          dst: Stream) -> torch.Tensor:
    """``t``, made in stream ``src``'s order (None: the host's), as a
    tensor on ``device`` that work in stream ``dst``'s order may read."""
    if t.device == device:
        if src is not None and dst is not None and src != dst:
            dst.wait_event(src.record_event())
            t.record_stream(dst)
        return t
    if t.device.type == "cpu":  # host to card: a copy in dst's order
        with torch.cuda.device(device), torch.cuda.stream(dst):
            return t.to(device)
    if device.type == "cpu":  # card to host: blocks until src's work is done
        with torch.cuda.stream(src):
            return t.to(device)
    # card to card: PyTorch copies on the source device's current stream
    # and makes the destination's current stream wait for the copy
    with torch.cuda.stream(src), torch.cuda.device(device), \
            torch.cuda.stream(dst):
        return t.to(device, non_blocking=True)


def place(mesh: Mesh, i: int, t: torch.Tensor) -> torch.Tensor:
    """``t``, made in the caller's order, as position ``i``'s tensor."""
    return _move(t, _stream_of(t.device), mesh.devices[i], mesh.streams[i])


def replicate(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every position (``PartitionSpec()``): the same tensor where
    a position is on ``x``'s device, a copy elsewhere."""
    return [place(mesh, i, x) for i in range(mesh.size)]


def shard(mesh: Mesh, axis: str, x: torch.Tensor,
          dim: int) -> List[torch.Tensor]:
    """``x`` split along ``dim`` into ``mesh.shape[axis]`` equal pieces,
    piece r on every position whose index along ``axis`` is r, replicated
    over the other axes (``PartitionSpec`` with ``axis`` at ``dim``).  A
    piece is contiguous; it is a view of ``x`` where it can be."""
    n = mesh.shape[axis]
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"into {n} pieces")
    pieces = x.chunk(n, dim)
    out = []
    for i in range(mesh.size):
        piece = place(mesh, i, pieces[mesh.axis_index(axis, i)])
        with mesh.on(i):
            out.append(piece.contiguous())
    return out


def join(mesh: Mesh, trees: Sequence) -> list:
    """Hand each position's results (one tree a position) over to the
    caller: on each device the caller's stream waits for the position's
    stream, and each tensor is marked as used on the caller's stream, so
    the caller may read and free them.  Returns ``trees``."""
    from repro_torch.tree import leaves

    for i, tree in enumerate(trees):
        src = mesh.streams[i]
        if src is None:
            continue
        dst = _stream_of(mesh.devices[i])
        if src == dst:
            continue
        dst.wait_stream(src)
        for leaf in leaves(tree):
            if torch.is_tensor(leaf) and leaf.is_cuda:
                leaf.record_stream(dst)
    return list(trees)


def take(mesh: Mesh, xs: Sequence[torch.Tensor], i: int = 0,
         device=None) -> torch.Tensor:
    """Position ``i``'s tensor, for the caller's use on ``device`` (its
    own device by default)."""
    device = xs[i].device if device is None else _norm(device)
    return _move(xs[i], mesh.streams[i], device, _stream_of(device))


def unshard(mesh: Mesh, axis: str, xs: Sequence[torch.Tensor], dim: int,
            device=None) -> torch.Tensor:
    """The pieces that the positions along ``axis`` hold (those with index
    0 along every other axis), joined along ``dim`` on ``device`` (the
    first piece's by default) for the caller: the inverse of
    :func:`shard`."""
    group = mesh.groups(axis)[0]
    device = xs[group[0]].device if device is None else _norm(device)
    return torch.cat([take(mesh, xs, i, device) for i in group], dim)


# ---------------------------------------------------------------------------
# Collectives: lists of per-position tensors in, lists out
# ---------------------------------------------------------------------------


def axis_index(mesh: Mesh, axis: str) -> List[int]:
    """Each position's index along ``axis`` (``lax.axis_index``)."""
    return [mesh.axis_index(axis, i) for i in range(mesh.size)]


def _gather(mesh: Mesh, srcs: Sequence[int], xs, j: int) -> list:
    """Positions ``srcs``' tensors, fenced for position ``j`` to read."""
    return [_move(xs[i], mesh.streams[i], mesh.devices[j], mesh.streams[j])
            for i in srcs]


def all_gather(mesh: Mesh, axis: Axes,
               xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every position gets its group's tensors stacked on a new leading
    dimension in ``axis`` order (``lax.all_gather``, not tiled)."""
    mesh.collectives += 1
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for j in group:
            parts = _gather(mesh, group, xs, j)
            with mesh.on(j):
                out[j] = torch.stack(parts)
    mesh.count("all-gather", out)
    return out


def all_to_all(mesh: Mesh, axis: Axes,
               xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Each position splits its tensor along dimension 0 into one block a
    position of its group and sends block r to the group's r-th; each
    joins what it receives along dimension 0 in sender order
    (``lax.all_to_all(split_axis=0, concat_axis=0, tiled=True)``)."""
    mesh.collectives += 1
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        for i in group:
            if xs[i].shape[0] % n:
                raise ValueError(f"dim 0 of {tuple(xs[i].shape)} does not "
                                 f"split into {n} blocks")
        for r, j in enumerate(group):
            blocks = [xs[i].chunk(n, 0)[r] for i in group]
            parts = [_move(b, mesh.streams[i], mesh.devices[j],
                           mesh.streams[j]) for i, b in zip(group, blocks)]
            with mesh.on(j):
                out[j] = torch.cat(parts, 0)
    mesh.count("all-to-all", out)
    return out


def psum(mesh: Mesh, axis: Axes,
         xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Every position gets the sum of its group's tensors (``lax.psum``),
    added in ``axis`` order in the tensors' dtype, so every position holds
    the same bits.  The sum is made once a device; the group's other
    positions on that device get a copy of it."""
    mesh.collectives += 1
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        made: Dict[torch.device, int] = {}
        for j in group:
            first = made.get(mesh.devices[j])
            if first is None:
                parts = _gather(mesh, group, xs, j)
                with mesh.on(j):
                    acc = parts[0].clone()
                    for p in parts[1:]:
                        acc += p
                made[mesh.devices[j]] = j
            else:
                src = _gather(mesh, [first], out, j)[0]
                with mesh.on(j):
                    acc = src.clone()
            out[j] = acc
    mesh.count("all-reduce", out)
    return out


def ppermute(mesh: Mesh, axis: Axes, xs: Sequence[torch.Tensor],
             perm: Sequence[Tuple[int, int]]) -> List[torch.Tensor]:
    """Within each group, the tensor of the position at index ``src`` along
    ``axis`` goes to the one at ``dst`` for every ``(src, dst)`` in
    ``perm``; a position that receives nothing gets zeros
    (``lax.ppermute``)."""
    mesh.collectives += 1
    dsts = [d for _, d in perm]
    if len(set(dsts)) != len(dsts) or len({s for s, _ in perm}) != len(perm):
        raise ValueError(f"ppermute needs a permutation, got {list(perm)}")
    sender = {d: s for s, d in perm}
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for r, j in enumerate(group):
            if r in sender:
                src = xs[group[sender[r]]]
                moved = _gather(mesh, [group[sender[r]]], xs, j)[0]
                if moved is src:  # same device: a copy of its own
                    with mesh.on(j):
                        moved = src.clone()
                out[j] = moved
            else:
                with mesh.on(j):
                    out[j] = torch.zeros_like(xs[j], device=mesh.devices[j])
    mesh.count("collective-permute", out)
    return out


# ---------------------------------------------------------------------------
# Collectives with a backward of their own (training)
# ---------------------------------------------------------------------------


def _gather_cat(mesh: Mesh, axis: Axes, xs, dim: int) -> list:
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        for j in group:
            parts = _gather(mesh, group, xs, j)
            with mesh.on(j):
                out[j] = torch.cat(parts, dim)
            mesh.gathered_bytes += sum(
                xs[i].numel() * xs[i].element_size() for i in group if i != j)
    mesh.count("all-gather", out)
    return out


def _reduce_scatter(mesh: Mesh, axis: Axes, xs, dim: int, srcs) -> list:
    """Block r along ``dim`` of the group's sum to the group's r-th
    position (``lax.psum_scatter``, tiled): the blocks added in fp32 in
    group order and rounded once to the tensors' dtype.  ``srcs``: the
    stream each input was made on."""
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for group in mesh.groups(axis):
        n = len(group)
        for r, j in enumerate(group):
            parts = [_move(xs[i].chunk(n, dim)[r], srcs[i], mesh.devices[j],
                           mesh.streams[j]) for i in group]
            with mesh.on(j):
                acc = parts[0].to(torch.float32, copy=True)
                for p in parts[1:]:
                    acc += p.float()
                out[j] = acc.to(xs[j].dtype)
    mesh.count("reduce-scatter", out)
    return out


class _GatherCat(torch.autograd.Function):
    """``all_gather_cat``'s forward and its reduce-scatter backward: one
    autograd node for every position, so each shard's gradient is its
    block of the group's gradients added in a fixed order."""

    @staticmethod
    def forward(ctx, mesh, axis, dim, *xs):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return tuple(_gather_cat(mesh, axis, xs, dim))

    @staticmethod
    def backward(ctx, *gs):
        mesh = ctx.mesh
        # the engine hands the gradients over in the caller's stream order,
        # and takes the results back in it
        srcs = [_stream_of(g.device) for g in gs]
        out = _reduce_scatter(mesh, ctx.axis, gs, ctx.dim, srcs)
        return (None, None, None) + tuple(
            _move(o, mesh.streams[j], o.device, _stream_of(o.device))
            for j, o in enumerate(out))


def all_gather_cat(mesh: Mesh, axis: Axes, xs: Sequence[torch.Tensor],
                   dim: int) -> List[torch.Tensor]:
    """Every position gets its group's tensors joined along ``dim`` in
    ``axis`` order (``lax.all_gather(tiled=True)``), differentiably: the
    gradient of a position's tensor is its block of the sum of the group's
    gradients, added in fp32 in group order and rounded once."""
    mesh.collectives += 1
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        return list(_GatherCat.apply(mesh, axis, dim, *xs))
    return _gather_cat(mesh, axis, xs, dim)


