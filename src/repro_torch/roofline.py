"""Roofline terms, and the counter the dry run reads them from.

Three terms a (arch x shape x mesh) cell, all in seconds:

    compute    = FLOPs / (chips x peak FLOP/s)
    memory     = HBM bytes / (chips x HBM rate)
    collective = collective bytes / (chips x link rate)

``RooflineTerms`` and ``model_flops_for`` are the reference's
(``src/repro/roofline.py``), with ``hw`` defaulting to the port's H100.

The reference reads its counts off XLA: ``cost_analysis`` for FLOPs and
bytes, the compiled HLO text for collective bytes and for the
fusion-aware lower bound of the traffic.  The port produces no HLO, so
``DispatchCounter`` counts at the dispatch level instead, over a run of
the real step on meta tensors (``launch/dryrun.py``), where every aten op
passes through it and every kernel call is recorded in a
``kernels.calls.CallLog``:

* FLOPs: the kernels' calls (``calls.matmul_cost`` and the rest;
  attention dense over S x S_kv) and any aten product outside them;
* ``hbm_bytes``, the upper bound: every non-view op's operands and
  results, and every kernel call's bytes;
* ``hbm_bytes_min``, by the traffic rules of the reference's
  ``fused_memory_bytes``: a kernel call or product its operands and
  result, a gather or index op twice its result, a scatter three times
  its updates (the smallest operand), a sort its operands and results;
  elementwise chains count nothing, as if fused;
* collective bytes by kind: the mesh's own counts (``Mesh.collective_bytes``);
* the live-bytes peak of each device: every new storage an op makes is
  held by a weak reference, added to its device's live bytes when made and
  taken off when freed.  A storage belongs to the mesh position whose work
  made it (``kernels.calls.position``), else to the position of the op's
  largest input that has one; ``device_of`` maps positions to devices.

On meta tensors the counter also caches each op's output shapes, strides
and dtypes by its inputs' (and makes the outputs with ``empty_strided``):
the positions of a mesh run the same ops on the same shapes, and PyTorch's
meta kernels for elementwise ops are Python.  Views, in-place ops and ops
with data-dependent shapes always run their meta kernels.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Hashable, Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.hw import H100, HardwareSpec
from repro_torch.kernels import calls
from repro_torch.kernels.calls import _LOCAL as _POSITION


@dataclasses.dataclass
class RooflineTerms:
    flops: float
    hbm_bytes: float  # upper bound (every op's operands and results)
    collective_bytes: float
    chips: int
    model_flops: float = 0.0  # 6*N*D analytic
    hbm_bytes_min: float = 0.0  # lower bound (perfect-fusion traffic)
    hw: HardwareSpec = H100
    label: str = ""

    @property
    def t_compute(self) -> float:
        return self.flops / (self.chips * self.hw.peak_flops_bf16)

    @property
    def t_memory_upper(self) -> float:
        return self.hbm_bytes / (self.chips * self.hw.hbm_bw)

    @property
    def t_memory(self) -> float:
        """Memory term used for the bound call: the perfect-fusion traffic
        when available, else the unfused upper bound."""
        b = self.hbm_bytes_min or self.hbm_bytes
        return b / (self.chips * self.hw.hbm_bw)

    @property
    def t_collective(self) -> float:
        # per-chip collective bytes ride all links of a chip
        bw = self.hw.ici_bw_per_link * self.hw.ici_links / 2
        return self.collective_bytes / (self.chips * bw)

    @property
    def bound(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs: how much of the compute is
        useful."""
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU upper bound for this program: useful FLOPs over
        the time the dominant term forces."""
        if self.step_time == 0:
            return 0.0
        return self.model_flops / (self.step_time * self.chips
                                   * self.hw.peak_flops_bf16)

    def as_dict(self) -> dict:
        return {
            "label": self.label,
            "hw": self.hw.name,
            "chips": self.chips,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "hbm_bytes_min": self.hbm_bytes_min,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_memory_upper_s": self.t_memory_upper,
            "t_collective_s": self.t_collective,
            "bound": self.bound,
            "step_time_s": self.step_time,
            "useful_flops_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens.
    Decode steps process global_batch tokens; train/prefill seq*batch.
    Train includes backward (x3 of the forward 2*N*D): the 6 factor.
    Prefill/decode are forward-only: 2*N*D."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: 1 token per sequence


# ---------------------------------------------------------------------------
# The dispatch-level counter
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# twice the result: reads |result| elements of the source, writes them
GATHER_OPS = frozenset({
    _aten.index_select.default, _aten.gather.default,
    _aten.embedding.default, _aten.index.Tensor, _aten.take.default})
# three times the updates: reads the destination rows and the updates,
# writes the rows
SCATTER_OPS = frozenset({
    _aten.scatter.src, _aten.scatter.value, _aten.scatter_.src,
    _aten.scatter_.value, _aten.scatter_add.default,
    _aten.scatter_add_.default, _aten.index_put.default,
    _aten.index_put_.default, _aten._index_put_impl_.default,
    _aten.index_add.default, _aten.index_add_.default,
    _aten.index_copy.default, _aten.index_copy_.default,
    _aten.embedding_dense_backward.default, _aten.slice_scatter.default,
    _aten.select_scatter.default, _aten.slice_backward.default,
    _aten.select_backward.default})
SORT_OPS = frozenset({_aten.sort.default, _aten.sort.stable,
                      _aten.topk.default})
# products outside the kernels (none on the port's card path)
PRODUCT_OPS = frozenset({_aten.mm.default, _aten.bmm.default,
                         _aten.addmm.default, _aten.baddbmm.default})
# factory ops that touch no memory
_NO_TRAFFIC = frozenset({_aten.empty.memory_format, _aten.empty_strided.default,
                         _aten.empty_like.default})
_CACHE_TAGS = (torch.Tag.dynamic_output_shape,
               torch.Tag.data_dependent_output,
               torch.Tag.nondeterministic_seeded)


# how an op counts: a view (nothing), plain traffic, or one of the rules
_VIEW, _PLAIN_OP, _GATHER, _SCATTER, _SORT, _PRODUCT, _FACTORY = range(7)


def _op_class(func) -> int:
    if func.is_view:
        return _VIEW
    if func in GATHER_OPS:
        return _GATHER
    if func in SCATTER_OPS:
        return _SCATTER
    if func in SORT_OPS:
        return _SORT
    if func in PRODUCT_OPS:
        return _PRODUCT
    if func in _NO_TRAFFIC:
        return _FACTORY
    return _PLAIN_OP


def _cache_kind(func) -> Optional[str]:
    """How a meta op's result can be cached: ``"new"`` (fresh outputs,
    made again from their shapes, strides and dtypes), ``"self"`` (an
    in-place op that writes its first argument and returns it, its
    metadata unchanged: a repeat passes the same checks) or None (views,
    in-place views, ``out=`` forms, data-dependent shapes)."""
    schema = func._schema
    if not schema.returns or func.is_view or any(
            tag in func.tags for tag in _CACHE_TAGS):
        return None
    rets = [r.alias_info for r in schema.returns]
    if all(a is None for a in rets):
        return "new"
    first = schema.arguments[0].alias_info if schema.arguments else None
    if (len(rets) == 1 and rets[0] is not None and rets[0].is_write
            and first is not None and first.is_write
            and rets[0].before_set == first.before_set
            and torch.Tag.inplace_view not in func.tags
            and not schema.name.startswith(("aten::resize", "aten::set_",
                                            "aten::as_strided"))
            and not any(a.kwarg_only and a.alias_info is not None
                        for a in schema.arguments)):
        return "self"
    return None


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)
_Tensor = torch.Tensor


_PLAIN_TYPES = frozenset(_PLAIN)


def _scan(xs, ts: list, meta: list) -> tuple:
    """A hashable key of an op's arguments ``xs`` (a tensor's shape,
    strides and dtype; a plain value itself; None where unhashable),
    collecting their tensors into ``ts``; ``meta[0]`` turns False at a
    non-meta tensor or an unhashable value."""
    out = []
    for y in xs:
        ty = type(y)
        if ty in _PLAIN_TYPES:
            out.append(y)
        elif ty is _Tensor or isinstance(y, _Tensor):
            ts.append(y)
            if not y.is_meta:
                meta[0] = False
            out.append((y.shape, y.stride(), y.dtype))
        elif ty is list or ty is tuple:
            out.append(_scan(y, ts, meta))
        elif isinstance(y, _PLAIN):
            out.append(y)
        else:
            meta[0] = False
            out.append(None)
    return tuple(out)


def _outputs(out) -> list:
    if isinstance(out, _Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, _Tensor)]
    return []


def _describe(out):
    if isinstance(out, _Tensor):
        if not out.is_meta or out.storage_offset():
            raise _NoCache
        return (tuple(out.shape), out.stride(), out.dtype)
    if isinstance(out, (list, tuple)):
        return (type(out), tuple(_describe(o) for o in out))
    raise _NoCache


class _NoCache(Exception):
    pass


def _build(spec):
    if type(spec[0]) is type:
        return spec[0](_build(s) for s in spec[1])
    return torch.empty_strided(spec[0], spec[1], dtype=spec[2],
                               device="meta")


def _tensors(tree) -> list:
    """The tensors in a tree of lists, tuples and dicts."""
    out = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, _Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return out


class _Ref(weakref.ref):
    """A weak reference to a storage that knows the storage's key."""

    __slots__ = ("key",)


class DispatchCounter(TorchDispatchMode):
    """Counts a run's traffic and live bytes at the dispatch level (see the
    module docstring).  ``device_of(position)`` names the device a mesh
    position's storage lives on (the position itself by default: each its
    own device).  Meta ops' outputs are made from their cached metadata.

    ``add_arguments`` registers the tensors alive before the run (a
    position's state and batch); ``arguments``, ``peak`` and ``live`` are
    bytes by device."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # nothing here is compiled: without the wrapper that keeps dynamo
        # out of __torch_dispatch__, an op's dispatch costs a third less
        return False

    def __init__(self, device_of: Optional[Callable[[Optional[int]],
                                                    Hashable]] = None):
        super().__init__()
        self.device_of = device_of or (lambda p: p)
        self.traffic = 0.0
        self.traffic_min = 0.0
        self.product_flops = 0.0
        self.ops = 0
        self.live: Dict[Hashable, int] = {}
        self.peak: Dict[Hashable, int] = {}
        self.arguments: Dict[Hashable, int] = {}
        self._arg_keys: set = set()
        # storage key -> (bytes, device, position, its weak reference)
        self._held: Dict[int, tuple] = {}
        self._cache: dict = {}
        self._info: Dict[Any, tuple] = {}
        self._dev: Dict[Any, Hashable] = {}
        self._paused = 0

    def __enter__(self):
        calls._MODELS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        calls._MODELS.remove(self)
        return super().__exit__(*exc)

    def plain_call(self, plain, card, args):
        """A kernel's plain version on CPU tensors, counted as the card:
        the plain version's own ops uncounted, the card path's checks and
        allocations run on meta stand-ins (recorded in the call logs), its
        outputs dropped, then the plain outputs registered in their
        place (``kernels.calls.plain_call``)."""
        self._paused += 1
        try:
            out = plain(*args)
            stand = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                         device="meta")
                     if isinstance(a, _Tensor) else a for a in args]
        finally:
            self._paused -= 1
        card(*stand)
        self._own([a for a in args if isinstance(a, _Tensor)],
                  _tensors(out))
        return out

    # --- storages and their devices -------------------------------------

    def _freed(self, ref) -> None:
        entry = self._held.pop(ref.key, None)
        if entry is not None:
            self.live[entry[1]] -= entry[0]

    def _register(self, st, position) -> None:
        key = st._cdata
        n = st.nbytes()
        dev = self._dev.get(position)
        if dev is None:
            dev = self._dev[position] = self.device_of(position)
        ref = _Ref(st, self._freed)
        ref.key = key
        self._held[key] = (n, dev, position, ref)
        live = self.live.get(dev, 0) + n
        self.live[dev] = live
        if live > self.peak.get(dev, 0):
            self.peak[dev] = live

    def add_arguments(self, trees: Iterable, positions: Iterable) -> None:
        """The tensors of each tree as its position's, alive from the
        start (each storage once)."""
        for tree, pos in zip(trees, positions):
            for t in _tensors(tree):
                st = t.untyped_storage()
                key = st._cdata
                if key in self._held:
                    continue
                self._register(st, pos)
                self._arg_keys.add(key)
                dev = self._dev[pos]
                self.arguments[dev] = self.arguments.get(dev, 0) + \
                    self._held[key][0]

    def new_bytes(self, trees: Iterable, positions: Iterable) -> Dict:
        """Bytes by device of the storages in ``trees`` (one a position)
        that are not arguments (a step's outputs), each storage once."""
        seen, out = set(), {}
        for tree, pos in zip(trees, positions):
            for t in _tensors(tree):
                st = t.untyped_storage()
                key = st._cdata
                if key in seen or key in self._arg_keys:
                    continue
                seen.add(key)
                dev = self.device_of(pos)
                out[dev] = out.get(dev, 0) + st.nbytes()
        return out

    # --- the dispatch -----------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._paused:
            return func(*args, **kwargs) if kwargs else func(*args)
        info = self._info.get(func)
        if info is None:
            info = self._info[func] = (_op_class(func), _cache_kind(func))
        cls, kind = info
        self.ops += 1
        if cls == _VIEW:
            return func(*args, **kwargs) if kwargs else func(*args)
        ts: list = []
        meta = [True]
        key = (func, _scan(args, ts, meta), (tuple(kwargs), _scan(
            tuple(kwargs.values()), ts, meta)) if kwargs else None)
        cache = self._cache if kind and meta[0] else None
        hit = cache.get(key) if cache is not None else None
        if hit is not None:
            # a repeat: the outputs made again, the counts added again
            spec, traffic, traffic_min, flops = hit
            self.traffic += traffic
            self.traffic_min += traffic_min
            self.product_flops += flops
            if kind == "self":
                return args[0]
            out = _build(spec)
            # fresh storages by construction: registered without a lookup
            pos = getattr(_POSITION, "position", None)
            if pos is None:
                pos = self._inherit(ts)
            if type(out) is _Tensor:
                self._register(out.untyped_storage(), pos)
            else:
                for t in out:
                    self._register(t.untyped_storage(), pos)
            return out
        out = func(*args, **kwargs) if kwargs else func(*args)
        outs = _outputs(out)
        traffic = traffic_min = flops = 0.0
        if cls != _FACTORY:
            n_in = sum([t.nbytes for t in ts])
            n_out = sum([t.nbytes for t in outs])
            traffic = n_in + n_out
            if cls == _GATHER:
                traffic_min = 2 * n_out
            elif cls == _SCATTER:
                traffic_min = 3 * min((t.nbytes for t in ts if t.nbytes > 0),
                                      default=n_out)
            elif cls in (_SORT, _PRODUCT):
                traffic_min = n_in + n_out
            if cls == _PRODUCT:
                flops = 2.0 * args[-2].numel() * args[-1].shape[-1]
        self.traffic += traffic
        self.traffic_min += traffic_min
        self.product_flops += flops
        if cache is not None:
            try:
                cache[key] = (True if kind == "self" else _describe(out),
                              traffic, traffic_min, flops)
            except _NoCache:
                pass
        if kind != "self":
            self._own(ts, outs)
        return out

    def _inherit(self, ins: list):
        """The position of the largest of ``ins`` whose storage has one:
        outside a position's work (autograd's backward ops) an op's
        result belongs where its largest operand lives, a saved
        activation, say, not a gradient that a sum over positions
        handed to all of them."""
        held = self._held
        best, size = None, -1
        for x in ins:
            entry = held.get(x.untyped_storage()._cdata)
            if entry is not None and entry[2] is not None and \
                    entry[0] > size:
                best, size = entry[2], entry[0]
        return best

    def _own(self, ins: list, outs: list) -> None:
        """Register the new storages among an op's outputs under the
        position whose work made them, else the largest input's."""
        pos = getattr(_POSITION, "position", None)
        held = self._held
        for t in outs:
            st = t.untyped_storage()
            if st._cdata in held:
                continue
            if pos is None:
                pos = self._inherit(ins)
            self._register(st, pos)
