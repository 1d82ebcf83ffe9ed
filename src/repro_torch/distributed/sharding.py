"""Sharding rules: per-dimension specs for parameters, decode states and
batches, and the placement of whole trees on a mesh.

Mesh axes:
  ``pod``   — inter-pod axis, present only on multi-pod meshes
  ``data``  — data parallelism; params and optimizer state FSDP-shard here
  ``model`` — tensor and expert parallelism

The rules live in ONE place (``param_shardings``), keyed by tree paths,
as in the reference.  A spec is a tuple with one entry per dimension: an
axis name, a tuple of axis names (one dimension over several axes), or
None (replicated), where the reference builds ``PartitionSpec``s.

The rules read both layouts of a tree: the reference's (stacked layers
under ``layers/``, ``groups/<p>/``, attention projections (D, H, hd) and
experts (E, D, F)) and the port's (a list of layers, ``layers/<i>/...``,
never stacked; attention projections fused to (D, H*hd) and (H*hd, D) by
``convert.py``; experts side by side, (D, E*F) and (E*F, D)).  Where a
port leaf has the reference's shape its spec is the reference's.  A fused
leaf needs the config (``cfg=``): its model-axis split is tested on the
head count or the expert count, so a dimension is only ever cut at head
(or expert) boundaries.

``place_tree`` turns a whole tree into one tree a position, through the
mesh's ``shard`` and ``replicate``: how the serving engine puts the
params and the decode state on a serve mesh, how a train state goes on a
training mesh, and how ``checkpoint.restore_resharded`` places a restored
tree; ``unplace_tree`` joins the blocks back into whole leaves.
``ShardingCtx`` is the execution context of model code on a mesh: the
mesh, the axes, and the collectives that code runs, each a call of
``distributed/mesh.py`` and each differentiable through autograd: over
the model axis ``row_sum`` and ``gather``; over the data axes
``fsdp_gather`` (the FSDP all-gather of a weight just before its use,
whose backward is the reduce-scatter) and ``data_psum`` (loss sums).
``replica_sum`` then adds up the gradients of a piece that several
positions hold, in a fixed order, so every replica updates to the same
bits.  The reference's ``constrain*`` methods (GSPMD sharding
constraints) have no counterpart: the port places every tensor
explicitly, and the residual stream stays replicated over the model axis
(no ``seq_shard``, a memory layout that leaves outputs unchanged).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.mesh import (Mesh, all_gather, all_gather_cat,
                                          place, psum, replicate, shard, take)
from repro_torch.tree import leaves_with_paths, tree_map, tree_map_with_path

Spec = Tuple[Any, ...]


@dataclasses.dataclass(frozen=True)
class ShardingCtx:
    """Execution context threaded through model code: the mesh, its axis
    names and the knobs of the reference's context (the planner tunes the
    chunk sizes and the MoE capacity).  ``data_axes=()`` is the pure
    tensor-parallel context of a serve mesh."""

    mesh: Mesh
    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    use_ep: bool = True
    attn_chunk: int = 1024
    rnn_chunk: int = 64
    moe_capacity_factor: float = 1.25
    unroll_scans: bool = False
    # inference: params replicated over the data axes (no FSDP gathers)
    infer_replicate_params: bool = False
    # the CostEngine whose plan produced this context (None: the default
    # Runtime's)
    cost_engine: Optional[Any] = None
    seq_shard: bool = True
    # the planner's spec overrides (path regex -> spec), which the params
    # are placed by and the model's specs read (``mesh_specs``)
    overrides: Optional[Dict[str, Spec]] = None
    # the whole length of a dense ``attn`` decode cache: a position whose
    # cache holds fewer rows holds its block of that length along the
    # model axis, and attends sequence-parallel (``transformer``)
    kv_len: Optional[int] = None

    @property
    def dp(self) -> int:
        n = 1
        for a in self.data_axes:
            n *= self.mesh.shape[a]
        return n

    @property
    def tp(self) -> int:
        return self.mesh.shape.get(self.model_axis, 1)

    @property
    def dp_spec(self):
        if not self.data_axes:  # pure-TP context (serve meshes): no data axis
            return None
        return tuple(self.data_axes) if len(self.data_axes) > 1 \
            else self.data_axes[0]

    # --- tensor-parallel execution: lists with one entry a position ---

    def rank(self, i: int) -> int:
        """Position ``i``'s index along the model axis."""
        return self.mesh.axis_index(self.model_axis, i)

    def map(self, fn: Callable, *per_position: Sequence) -> list:
        """``fn`` on every position, as that position's work; a function
        returning a tuple gives a tuple of lists."""
        out = self.mesh.map(fn, *per_position)
        if out and isinstance(out[0], tuple):
            return tuple(list(col) for col in zip(*out))
        return out

    def row_sum(self, partials: Sequence[torch.Tensor],
                dtype: torch.dtype) -> List[torch.Tensor]:
        """The sum over the model axis of row-parallel fp32 partials, added
        in fp32 in the axis order and rounded once to ``dtype``."""
        return self.map(lambda t: t.to(dtype),
                        psum(self.mesh, self.model_axis, partials))

    def gather(self, xs: Sequence[torch.Tensor],
               dim: int = -1) -> List[torch.Tensor]:
        """Column shards joined along ``dim`` in the model axis's order, on
        every position."""
        def join(stacked):
            return torch.cat(stacked.unbind(0), dim=dim)

        return self.map(join, all_gather(self.mesh, self.model_axis, xs))

    # --- training: FSDP over the data axes ---

    def fsdp_gather(self, xs: Sequence[torch.Tensor],
                    dim: int) -> List[torch.Tensor]:
        """A weight's FSDP blocks joined along ``dim`` over the data axes,
        on every position, just before its use; the backward is the
        reduce-scatter (each block's gradient the sum of the group's, in
        group order, in fp32)."""
        if self.dp <= 1:
            return list(xs)
        return all_gather_cat(self.mesh, self.data_axes, xs, dim)

    def data_psum(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The sum over the data axes (a loss's sums over the global
        batch), added in the axes' order; every position of a group holds
        the same bits."""
        if self.dp <= 1:
            return list(xs)
        return psum(self.mesh, self.data_axes, xs)

    def model_max(self, xs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """The elementwise maximum over the model axis, outside autograd
        (the stabiliser of a vocab-parallel log-sum-exp)."""
        xs = [x.detach() for x in xs]
        if self.tp <= 1:
            return xs
        return self.map(lambda st: st.amax(0),
                        all_gather(self.mesh, self.model_axis, xs))

    def gather_tree(self, trees: Sequence[Any],
                    specs: Any) -> List[Any]:
        """Every leaf of ``trees`` (one tree a position) whose spec splits a
        dimension over the data axes, FSDP-gathered along it
        (``fsdp_gather``); the other leaves as they are."""
        dp_spec = self.dp_spec

        def one(xs, spec):
            dim = next((k for k, a in enumerate(spec)
                        if a is not None and a == dp_spec), None)
            return xs if dim is None else self.fsdp_gather(xs, dim)

        return _per_leaf(one, trees, specs)

    def replica_sum(self, trees: Sequence[Any], specs: Any) -> List[Any]:
        """Each leaf's per-position values summed over the positions that
        hold the same block of it (the mesh axes its spec does not name),
        in fp32 and in the mesh's order, rounded once to the leaf's dtype:
        the gradient of a replicated piece, the same bits on every
        replica."""
        def one(xs, spec):
            axes = replica_axes(spec, self.mesh)
            if not axes:
                return xs
            dtype = xs[0].dtype
            return self.map(lambda t: t.to(dtype),
                            psum(self.mesh, axes,
                                 self.map(lambda t: t.float(), xs)))

        return _per_leaf(one, trees, specs)


def _per_leaf(fn: Callable, trees: Sequence[Any], specs: Any) -> List[Any]:
    """``fn(the leaf's per-position values, its spec) -> new values`` at
    every leaf of ``trees`` (one tree a position, ``specs`` in their
    structure), leaf by leaf in tree order."""
    order: List[Tuple[str, Spec]] = []
    tree_map_with_path(lambda path, _, spec: order.append((path, spec)),
                       trees[0], specs)
    flat = [dict(leaves_with_paths(t)) for t in trees]
    out: List[Dict[str, Any]] = [dict() for _ in trees]
    for path, spec in order:
        for o, x in zip(out, fn([f[path] for f in flat], spec)):
            o[path] = x
    return [tree_map_with_path(lambda path, _, o=o: o[path], t)
            for t, o in zip(trees, out)]


# ---------------------------------------------------------------------------
# Param sharding rules (path pattern -> spec)
# ---------------------------------------------------------------------------


def _axis_size(axis, mesh_shape: Dict[str, int]) -> int:
    size = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size *= mesh_shape.get(a, 1)
    return size


def _spec_for(path: str, arr, *, fsdp, model: str,
              mesh_shape: Dict[str, int], scanned: bool, cfg=None) -> Spec:
    """The spec of one parameter: the reference's ``_spec_for`` rules, in
    its order, and the port's fused attention and expert leaves.

    ``fsdp`` is the (possibly compound) data-axis group; ``model`` the TP
    axis.  ``scanned`` params carry a leading layer axis (never sharded).
    """
    full = tuple(arr.shape)
    shape = full[1:] if scanned else full
    ndim = len(shape)

    def wrap(*dims):
        return ((None,) + dims) if scanned else tuple(dims)

    def fits(dim_idx: int, axis, unit: int = 1) -> bool:
        """``axis`` divides dimension ``dim_idx`` counted in ``unit``-wide
        pieces (heads, experts)."""
        if axis is None:  # replicated group: always placeable (as None)
            return True
        return (shape[dim_idx] // unit) % _axis_size(axis, mesh_shape) == 0 \
            and shape[dim_idx] % unit == 0

    hd = cfg.resolved_head_dim if cfg is not None and cfg.n_heads else None
    # --- embeddings: vocab on model, d on fsdp
    if re.search(r"(embed|unembed)", path):
        if fits(0, model) and fits(1, fsdp):
            return wrap(model, fsdp)
        return wrap(None, None)
    # --- attention projections
    if re.search(r"attn/w[qkv]$", path) or re.search(r"cross/w[qkv]$", path):
        if ndim == 2:
            # the port's (D, H*hd): heads on model, split at head
            # boundaries only, as the reference splits its (D, H, hd)
            if hd is None:
                raise ValueError(f"{path}: a fused (D, H*hd) attention leaf "
                                 f"needs cfg= to read its head count")
            if fits(1, model, hd) and fits(0, fsdp):
                return wrap(fsdp, model)
            if fits(0, fsdp):
                return wrap(fsdp, None)
            return wrap(None, None)
        # the reference's (D, H, hd): heads on model, D on fsdp
        if fits(1, model) and fits(0, fsdp):
            return wrap(fsdp, model, None)
        if fits(0, fsdp):
            return wrap(fsdp, None, None)
        return wrap(*([None] * ndim))
    if re.search(r"(attn|cross)/wo$", path):
        # (H*hd, D) in both packages
        if fits(0, model) and fits(1, fsdp):
            return wrap(model, fsdp)
        return wrap(None, None)
    # --- MoE experts
    if re.search(r"ffn/(w_in|w_gate|w_out)$", path) and ndim == 3:
        # the reference's (E, D, F) / (E, F, D): experts on model
        if fits(0, model):
            return wrap(model, fsdp if fits(1, fsdp) else None, None)
        return wrap(None, None, None)
    if (re.search(r"ffn/(w_in|w_gate|w_out)$", path) and ndim == 2
            and cfg is not None and cfg.is_moe):
        # the port's side by side: (D, E*F) in, (E*F, D) out, experts on
        # model at expert boundaries.  FSDP splits D of w_in/w_gate as
        # the reference does; the reference's FSDP dim of w_out is F,
        # which lies inside each expert's rows here, so FSDP splits
        # w_out's D (dimension 1) instead: a difference of layout, not of
        # output (the gathered leaf is the same)
        f = cfg.d_ff
        if path.endswith("w_out"):
            return wrap(model if fits(0, model, f) else None,
                        fsdp if fits(1, fsdp) else None)
        return wrap(fsdp if fits(0, fsdp) else None,
                    model if fits(1, model, f) else None)
    if re.search(r"ffn/router$", path):
        return wrap(None, None)
    # --- dense FFN: (D, F) in / (F, D) out
    if re.search(r"ffn/(w_in|w_gate)$", path):
        if fits(1, model) and fits(0, fsdp):
            return wrap(fsdp, model)
        return wrap(None, None)
    if re.search(r"ffn/w_out$", path):
        if fits(0, model) and fits(1, fsdp):
            return wrap(model, fsdp)
        return wrap(None, None)
    # --- RWKV square projections (D, D): shard the output dim on model.
    # This rule also takes channel/w_v (F, D), so the channel/w_v rule
    # below is reached only where this one's pattern misses, as in the
    # reference: channel/w_v comes out replicated
    if re.search(r"(time|channel)/w_[rkvgo]$", path) and ndim == 2:
        if fits(1, model) and fits(0, fsdp):
            return wrap(fsdp, model) if path.endswith(("w_k",)) \
                else wrap(fsdp, None)
        return wrap(None, None)
    if re.search(r"channel/w_v$", path) and ndim == 2:
        if fits(0, model):
            return wrap(model, None)
        return wrap(None, None)
    # --- RG-LRU projections
    if re.search(r"rglru/(w_x|w_gate)$", path):
        if fits(0, fsdp):
            return wrap(fsdp, None)
        return wrap(None, None)
    if re.search(r"rglru/w_out$", path):
        if fits(1, fsdp):
            return wrap(None, fsdp)
        return wrap(None, None)
    # --- vectors / norms / small: replicate
    return wrap(*([None] * ndim))


def _fit_override(spec: Sequence, arr, mesh_shape: Dict[str, int],
                  scanned: bool) -> Spec:
    """A planner override spec fitted to one parameter: specs address the
    logical (unscanned) shape, stacked leaves get a leading None, and a
    dimension the assigned axes do not divide falls back to replicated."""
    dims = tuple(spec)
    if scanned:
        dims = (None,) + dims
    shape = tuple(arr.shape)
    dims = dims[:len(shape)] + (None,) * (len(shape) - len(dims))
    return tuple(None if ax is None or shape[i] % _axis_size(
        ax, mesh_shape) else ax for i, ax in enumerate(dims))


def _scanned(path: str) -> bool:
    """Whether the leaf at ``path`` carries a leading stacked-layer axis:
    under ``layers/`` or ``groups/<p>/`` but not keyed per layer
    (``layer_<i>``, ``rest_<j>``, or the port's list index
    ``layers/<i>/``)."""
    if "layer_" in path or "rest_" in path:
        return False
    m = re.search(r"(^|/)(layers|groups/\d+)/", path)
    if m is None:
        return False
    return re.match(r"\d+/", path[m.end():]) is None


def param_shardings(params_shape: Any, mesh: Mesh, *,
                    data_axes: Sequence[str] = ("data",),
                    model_axis: str = "model",
                    scanned_prefix: str = "layers",
                    overrides: Optional[Dict[str, Sequence]] = None,
                    cfg=None) -> Any:
    """A tree of specs matching ``params_shape`` (any tree whose leaves
    have ``.shape``).  ``overrides``: path regex -> spec, applied first
    (the planner's hook), addressing the logical (unscanned) shape.
    ``data_axes=()`` replicates params over the data axes (inference: no
    FSDP, no per-step weight gathers).  ``cfg`` reads the port's fused
    attention and expert leaves."""
    if data_axes:
        fsdp = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    else:
        fsdp = None
    mesh_shape = dict(mesh.shape)

    def rule(path, arr):
        scanned = _scanned(path)
        if overrides:
            for pat, spec in overrides.items():
                if re.search(pat, path):
                    return _fit_override(spec, arr, mesh_shape, scanned)
        return _spec_for(path, arr, fsdp=fsdp, model=model_axis,
                         mesh_shape=mesh_shape, scanned=scanned, cfg=cfg)

    return tree_map_with_path(rule, params_shape)


def _dp_size(mesh: Mesh, data_axes) -> int:
    n = 1
    for a in data_axes:
        n *= mesh.shape[a]
    return n


def batch_sharding(batch_shape: Any, mesh: Mesh,
                   data_axes=("data",)) -> Any:
    """Inputs: the leading (batch) dim over the data axes (when divisible)."""
    dp_spec = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    dp = _dp_size(mesh, data_axes)

    def rule(arr):
        shape = tuple(arr.shape)
        lead = dp_spec if shape and shape[0] % dp == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    return tree_map(rule, batch_shape)


def _keys(path: str) -> List[str]:
    return path.split("/") if path else []


def _state_lead(keys: List[str]) -> int:
    """Leading stacked-layer axes of a decode-state leaf: 1 under a
    period-scan group or a reference stack, 0 for per-layer keys
    (``rest_``, ``layer_``, ``dec_``, ``cross_``, the port's list index)
    and the position."""
    if "groups" in keys:
        return 1
    if any(k.startswith(("rest_", "layer_", "dec_", "cross_")) or k == "pos"
           or k.isdigit() for k in keys):
        return 0
    return 1


def _length_splits(cfg, keys: List[str]) -> bool:
    """Whether a ``k``/``v`` leaf may split along the cache length: always
    without ``cfg`` (the reference's rule); with it, only a decoder-only
    model's ``attn`` caches.  A ``local`` ring buffer and the
    encoder-decoder's caches keep the port's whole-length form, which its
    layers read (the sequence-parallel decode attention,
    ``transformer._attn_seq_tp``, runs on dense ``attn`` caches)."""
    if cfg is None:
        return True
    if cfg.is_encdec:
        return False
    idx = [int(k) for k in keys if k.isdigit()]
    return not idx or cfg.block_kind(idx[0]) == "attn"


def serve_state_sharding(state_shape: Any, mesh: Mesh, *,
                         model_axis: str = "model",
                         data_axes: Sequence[str] = (), cfg=None) -> Any:
    """Pooled decode-state placement for tensor-parallel serving.

    The slot (batch) axis is split over ``data_axes`` where they divide it
    (none when serving, where it is never sharded).  KV caches ((L?, B, S,
    H, hd) leaves keyed ``k``/``v``) shard their kv-head dim over the
    model axis when it divides; heads that do not divide fall back to the
    cache-length dim, then to replication (the reference's rule).  With
    ``cfg`` the length split applies only where ``_length_splits`` allows
    it.  Paged pools ((L?, n_blocks, block_size, H, hd), ``pk``/``pv``)
    shard kv heads when they divide, never the block axis.  Positions and
    recurrent and conv states replicate."""
    tp = mesh.shape.get(model_axis, 1)
    dp = _dp_size(mesh, data_axes)
    dp_spec = (tuple(data_axes) if len(data_axes) > 1 else data_axes[0]) \
        if data_axes else None

    def rule(path, arr):
        keys = _keys(path)
        shape = tuple(arr.shape)
        lead = min(_state_lead(keys), max(len(shape) - 1, 0))
        dims = [None] * len(shape)
        if dp > 1 and len(shape) > lead and shape[lead] % dp == 0 \
                and not (keys and keys[-1] in ("pk", "pv")):
            dims[lead] = dp_spec
        if tp > 1 and keys and keys[-1] in ("k", "v") \
                and len(shape) == lead + 4:
            s, h = shape[lead + 1], shape[lead + 2]
            if h % tp == 0:
                dims[lead + 2] = model_axis
            elif s % tp == 0 and s >= 2 * tp and _length_splits(cfg, keys):
                dims[lead + 1] = model_axis
        if tp > 1 and keys and keys[-1] in ("pk", "pv") \
                and len(shape) == lead + 4:
            if shape[lead + 2] % tp == 0:
                dims[lead + 2] = model_axis
        return tuple(dims)

    return tree_map_with_path(rule, state_shape)


def validate_serve_mesh(cfg, mesh_shape: Dict[str, int],
                        model_axis: str = "model") -> None:
    """Fail fast, with a fix, when a requested serve mesh cannot
    tensor-shard ``cfg``: the model axis must divide the dims the serve
    param rules split (FFN width, the attention projection output H*hd,
    d_model, and the vocab of the sharded unembedding)."""
    tp = int(mesh_shape.get(model_axis, 1))
    if tp <= 1:
        return
    hd = cfg.resolved_head_dim
    problems = []
    if cfg.d_ff % tp:
        problems.append(f"d_ff={cfg.d_ff}")
    if (cfg.n_heads * hd) % tp:
        problems.append(f"n_heads*head_dim={cfg.n_heads * hd}")
    if cfg.d_model % tp:
        problems.append(f"d_model={cfg.d_model}")
    if cfg.vocab_size % tp:
        problems.append(f"vocab_size={cfg.vocab_size}")
    if problems:
        raise ValueError(
            f"mesh model axis {model_axis}={tp} does not divide "
            f"{', '.join(problems)} for arch {cfg.name!r}; pick a model-axis "
            f"size that divides the head/FFN dims (or 1 to replicate)")


def state_sharding(state_shape: Any, mesh: Mesh, data_axes=("data",),
                   model_axis: str = "model", scanned: bool = True,
                   cfg=None) -> Any:
    """Decode caches and states (L?, B, ...): the batch dim over the data
    axes; KV-cache sequence dims (``k``/``v`` leaves, 4-D after the
    optional layer axis) also over the model axis, whatever the kv heads
    (with ``cfg``, where ``_length_splits`` allows it)."""
    dp_spec = tuple(data_axes) if len(data_axes) > 1 else data_axes[0]
    dp = _dp_size(mesh, data_axes)
    tp = mesh.shape.get(model_axis, 1)

    def rule(path, arr):
        keys = _keys(path)
        shape = tuple(arr.shape)
        lead = 1 if scanned else 0
        if "groups" in keys:  # period-scan states: stacked
            lead = 1
        elif any(k.startswith(("rest_", "layer_", "dec_", "cross_"))
                 or k.isdigit() for k in keys):
            lead = 0
        dims = [None] * len(shape)
        if len(shape) > lead and shape[lead] % dp == 0:
            dims[lead] = dp_spec
        if keys and keys[-1] in ("k", "v") and len(shape) == lead + 4:
            s = shape[lead + 1]
            if s % tp == 0 and s >= 2 * tp and _length_splits(cfg, keys):
                dims[lead + 1] = model_axis
        return tuple(dims)

    return tree_map_with_path(rule, state_shape)


# ---------------------------------------------------------------------------
# Placement of whole trees
# ---------------------------------------------------------------------------


class _PerPosition:
    """One leaf's tensors, one a position (a leaf to ``tree_map``)."""

    def __init__(self, xs: list):
        self.xs = xs


def _piece(mesh: Mesh, i: int, x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Position ``i``'s block of ``x`` under ``spec`` (any number of split
    dims, each over one axis or several, row-major over them)."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        names = axes if isinstance(axes, tuple) else (axes,)
        n, idx = 1, 0
        for a in names:
            size = mesh.shape[a]
            n, idx = n * size, idx * size + mesh.axis_index(a, i)
        x = x.narrow(dim, idx * (x.shape[dim] // n), x.shape[dim] // n)
    return x


def _named_axes(spec: Spec) -> List[str]:
    names: List[str] = []
    for axes in spec:
        if axes is not None:
            names += list(axes) if isinstance(axes, tuple) else [axes]
    return names


def replica_axes(spec: Spec, mesh: Mesh) -> Tuple[str, ...]:
    """The mesh axes over which ``spec`` replicates a leaf: the positions
    that differ only along them hold the same block."""
    used = set(_named_axes(spec))
    return tuple(a for a in mesh.axis_names if a not in used)


def blocks(spec: Spec, mesh: Mesh) -> int:
    """The number of distinct blocks ``spec`` splits a leaf into: the
    product of the sizes of the axes it names."""
    return _axis_size(tuple(_named_axes(spec)), mesh.shape)


def is_representative(spec: Spec, mesh: Mesh, i: int) -> bool:
    """Whether position ``i`` is the first of the positions holding its
    block of a leaf under ``spec`` (index 0 along every replica axis): one
    position a distinct block, to count each piece once."""
    return all(mesh.axis_index(a, i) == 0 for a in replica_axes(spec, mesh))


def _place_leaf(mesh: Mesh, x, spec: Spec, copy: bool) -> _PerPosition:
    if not torch.is_tensor(x):
        return _PerPosition([x] * mesh.size)
    spec = tuple(spec)[:x.dim()] + (None,) * (x.dim() - len(tuple(spec)))
    split = [(d, a) for d, a in enumerate(spec) if a is not None]
    for d, a in split:
        n = _axis_size(a, mesh.shape)
        if x.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split "
                             f"into {n} pieces (spec {spec})")
    if not split:
        xs = replicate(mesh, x)
        if copy:  # storage of its own on every position
            xs = mesh.map(lambda t: t.clone(), xs)
        return _PerPosition(xs)
    if len(split) == 1 and isinstance(split[0][1], str) and not copy:
        return _PerPosition(shard(mesh, split[0][1], x, split[0][0]))
    out = []
    for i in range(mesh.size):
        piece = place(mesh, i, _piece(mesh, i, x, spec))
        with mesh.on(i):
            out.append(piece.clone(memory_format=torch.contiguous_format)
                       if copy else piece.contiguous())
    return _PerPosition(out)


def place_tree(mesh: Mesh, tree: Any, specs: Any, *,
               copy: bool = False) -> List[Any]:
    """``tree`` on the mesh by ``specs`` (a tree of specs in its
    structure): one tree a position, each leaf that position's block of
    the whole leaf (``mesh.shard`` for a split over one axis,
    ``mesh.replicate`` for none).  A replicated leaf is the same tensor on
    every position of its device, and a block may be a view of the whole
    leaf, unless ``copy``, which gives each position storage of its own
    (state that is written in place: a decode pool, or a train state that
    a step updates under ``donate``)."""
    placed = tree_map(lambda x, spec: _place_leaf(mesh, x, spec, copy),
                      tree, specs)
    return [tree_map(lambda leaf, i=i: leaf.xs[i], placed)
            for i in range(mesh.size)]


def place_shapes(mesh: Mesh, tree: Any, specs: Any,
                 device: str = "meta") -> List[Any]:
    """The shapes of ``place_tree(mesh, tree, specs, copy=True)``, in
    tensors made afresh on ``device`` (the meta device by default; zeros
    elsewhere): each position's tree holds its block of every leaf, with
    storage of its own, and nothing is sliced or copied (the dry run's
    train state and batch on a production mesh)."""
    make = torch.empty if torch.device(device).type == "meta" \
        else torch.zeros

    def block_of(x, spec):
        if not torch.is_tensor(x):
            return lambda: x
        spec = tuple(spec)[:x.dim()] + (None,) * (x.dim() - len(tuple(spec)))
        shape = list(x.shape)
        for d, a in enumerate(spec):
            if a is not None:
                n = _axis_size(a, mesh.shape)
                if shape[d] % n:
                    raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                     f"split into {n} pieces (spec {spec})")
                shape[d] //= n
        return lambda: make(shape, dtype=x.dtype, device=device)

    makers = tree_map(block_of, tree, specs)

    def build(node):  # the tree's structure, a new leaf at each maker
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return node()

    return [build(makers) for _ in range(mesh.size)]


def unplace_tree(mesh: Mesh, trees: Sequence[Any], specs: Any,
                 device=None) -> Any:
    """The inverse of ``place_tree``: each leaf whole again on ``device``
    (position 0's by default), its blocks taken from the positions that
    hold them and joined along every split dimension."""
    flat = [dict(leaves_with_paths(t)) for t in trees]

    def whole(path, _, spec):
        xs = [f[path] for f in flat]
        if not torch.is_tensor(xs[0]):
            return xs[0]
        spec = tuple(spec)[:xs[0].dim()] + (None,) * (
            xs[0].dim() - len(tuple(spec)))
        dev = xs[0].device if device is None else torch.device(device)
        shape = [n * _axis_size(a, mesh.shape) if a is not None else n
                 for n, a in zip(xs[0].shape, spec)]
        out = torch.empty(shape, dtype=xs[0].dtype, device=dev)
        for i in range(mesh.size):
            if not is_representative(spec, mesh, i):
                continue
            _piece(mesh, i, out, spec).copy_(take(mesh, xs, i, dev))
        return out

    return tree_map_with_path(whole, trees[0], specs)


__all__ = ["ShardingCtx", "Spec", "batch_sharding", "blocks",
           "is_representative",
           "param_shardings", "place_shapes", "place_tree", "replica_axes",
           "serve_state_sharding", "state_sharding", "unplace_tree",
           "validate_serve_mesh"]
