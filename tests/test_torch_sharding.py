"""The port's sharding rules (``repro_torch.distributed.sharding``)
against the reference's, and the placement of whole trees on a mesh.

* ``param_shardings`` (serve, ``data_axes=()``, and FSDP, every non-model
  axis), ``serve_state_sharding`` (dense and paged states),
  ``state_sharding`` and ``batch_sharding`` for all ten configurations
  (reduced shapes) at meshes {data 1, model 8}, {data 2, model 4} and
  {pod 2, data 2, model 2}.  The reference's specs come from one
  subprocess with 8 forced host devices on ``AxisType.Auto`` axes
  (``torch_mesh_reference.run_reference``).  Two checks a case: the port's
  rules on the reference's own trees (shapes taken from ``eval_shape``)
  give the reference's specs exactly; on the port's trees every leaf's
  spec is the reference's for the same leaf, where the port's fused
  layouts map as ``convert.py`` reshapes them (attention (D, H, hd) ->
  (D, H*hd): the head split moves onto the fused dim, so it falls at head
  boundaries only; experts (E, D, F) -> (D, E*F) and (E, F, D) -> (E*F, D),
  experts over the model axis; the FSDP split of w_out's F, inside each
  expert's rows, moves to its D);
* ``validate_serve_mesh`` raises the reference's message (or none) for
  every configuration at model axes 3 and 8;
* ``place_tree``: each position's block is the slice of the whole leaf
  its spec names (one axis, two axes, a compound axis, replicated), and
  ``copy=True`` gives replicated leaves storage of their own;
* ``checkpoint.restore_resharded`` restores onto a CPU mesh, each
  position's shard the slice of the whole leaf.
"""

import json
import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore_resharded, save  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    ShardingCtx,
    batch_sharding,
    param_shardings,
    place_tree,
    serve_state_sharding,
    state_sharding,
    validate_serve_mesh,
)
from repro_torch.models import build_model  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402

from torch_mesh_reference import needs_reference, run_reference  # noqa: E402

MESHES = {"d1m8": {"data": 1, "model": 8}, "d2m4": {"data": 2, "model": 4},
          "p2d2m2": {"pod": 2, "data": 2, "model": 2}}
SLOTS, MAX_LEN, PAGING = 2, 16, (9, 4)

_REFERENCE = """
import re
from repro.configs import get_config, list_configs
from repro.distributed import sharding as S
from repro.models import build_model

MESHES = %s
SLOTS, MAX_LEN, PAGING = %d, %d, %s


def path_str(path):
    return S._path_str(path)


def flat(specs, shapes):
    out = {}
    sp = jax.tree_util.tree_flatten_with_path(specs)[0]
    sh = jax.tree_util.tree_flatten_with_path(shapes)[0]
    for (p, s), (_, x) in zip(sp, sh):
        spec = [list(a) if isinstance(a, tuple) else a for a in s.spec]
        spec += [None] * (len(x.shape) - len(spec))
        out[path_str(p)] = [spec, list(x.shape)]
    return out


res = {}
for arch in list_configs():
    cfg = get_config(arch).reduced()
    model = build_model(cfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0)))
    state = jax.eval_shape(lambda: model.init_decode_state(
        SLOTS, MAX_LEN, per_slot=True))
    states = {"dense": state}
    if not cfg.is_encdec:
        states["paged"] = jax.eval_shape(lambda: model.init_decode_state(
            SLOTS, MAX_LEN, per_slot=True, paging=PAGING))
    batch = {"tokens": jax.ShapeDtypeStruct((4, MAX_LEN), jnp.int32)}
    for key, shape in MESHES.items():
        mesh = auto_mesh(tuple(shape.values()), tuple(shape))
        data = tuple(a for a in shape if a != "model")
        case = {
            "params_serve": flat(S.param_shardings(params, mesh,
                                                   data_axes=()), params),
            "params_fsdp": flat(S.param_shardings(params, mesh,
                                                  data_axes=data), params),
            "state": flat(S.state_sharding(state, mesh, data_axes=data),
                          state),
            "batch": flat(S.batch_sharding(batch, mesh, data_axes=data),
                          batch),
        }
        for name, st in states.items():
            case["serve_state_" + name] = flat(
                S.serve_state_sharding(st, mesh), st)
        res[f"{arch}|{key}"] = case
OUT["specs"] = np.array(json.dumps(res))
""" % (json.dumps(MESHES), SLOTS, MAX_LEN, PAGING)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharding") / "specs.npz"
    return json.loads(str(run_reference(_REFERENCE, out)["specs"]))


class _Shape:
    """A leaf holding only a shape, as ``jax.eval_shape`` gives."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def _nest(flat_leaves: dict) -> dict:
    """The reference's flat ``path -> [spec, shape]`` as a nested dict of
    shape holders (the reference's own tree, keyed by its paths)."""
    root: dict = {}
    for path, (_, shape) in flat_leaves.items():
        node = root
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _Shape(shape)
    return root


def _norm(spec):
    return tuple(tuple(a) if isinstance(a, list) else a for a in spec)


def _leaf_specs(specs) -> dict:
    """``path -> spec`` of a spec tree (the specs are tuples, which the
    tree helpers would walk into: collect them one level up)."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, tuple):
            out[prefix] = node
            return
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(specs, "")
    return out


def _ref_lead(path: str, ndim: int, kind: str) -> int:
    """The reference's stacked-layer axes of one of its leaves."""
    keys = path.split("/")
    if kind.startswith("params"):
        return int("layer_" not in path and "rest_" not in path and
                   re.search(r"(^|/)(layers|groups/\d+)/", path) is not None)
    if kind.startswith("serve_state"):
        lead = 1 if ("groups" in keys or not any(
            k.startswith(("rest_", "layer_", "dec_", "cross_")) or k == "pos"
            for k in keys)) else 0
        return min(lead, max(ndim - 1, 0))
    if kind == "state":
        if keys[-1] == "pos":  # (B,) in both packages
            return 0
        if "groups" in keys:
            return 1
        if any(k.startswith(("rest_", "layer_", "dec_", "cross_"))
               for k in keys):
            return 0
        return 1
    return 0


def _port_view(path: str, shape, spec, lead: int, cfg):
    """One reference leaf as the port lays it out: (kind key, shape,
    spec) with the stacked axis dropped and the fused layouts mapped."""
    shape, spec = tuple(shape[lead:]), tuple(spec[lead:])
    keys = path.split("/")
    suffix = "/".join(keys[-2:])
    if len(shape) == 3 and keys[-1] in ("wq", "wk", "wv") and \
            keys[-2] in ("attn", "cross"):
        assert spec[2] is None
        return suffix, (shape[0], shape[1] * shape[2]), spec[:2]
    if len(shape) == 3 and keys[-2] == "ffn":
        e, a, b = shape
        if keys[-1] == "w_out":  # (E, F, D) -> (E*F, D), experts on model
            # and the FSDP split moved from F (inside each expert's rows
            # here) to D, the port's deliberate difference of layout
            return suffix, (e * a, b), (spec[0], spec[1])
        return suffix, (a, e * b), (spec[1], spec[0])  # (E, D, F)
    return suffix, shape, spec


def _port_key(path: str, shape, kind: str):
    keys = path.split("/")
    if kind.startswith(("serve_state", "state")):
        return keys[-1], tuple(shape)
    return "/".join(keys[-2:]), tuple(shape)


def _port_tree(cfg, kind: str):
    model = build_model(cfg, "cpu")
    if kind.startswith("params"):
        return model.init(0)
    if kind == "batch":
        return {"tokens": torch.zeros((4, MAX_LEN), dtype=torch.int64)}
    paging = PAGING if kind.endswith("paged") else None
    return model.init_decode_state(SLOTS, MAX_LEN, per_slot=True,
                                   paging=paging)


def _port_specs(tree, mesh, kind: str, cfg):
    data = tuple(a for a in mesh.shape if a != "model")
    if kind == "params_serve":
        return param_shardings(tree, mesh, data_axes=(), cfg=cfg)
    if kind == "params_fsdp":
        return param_shardings(tree, mesh, data_axes=data, cfg=cfg)
    if kind == "state":
        return state_sharding(tree, mesh, data_axes=data)
    if kind == "batch":
        return batch_sharding(tree, mesh, data_axes=data)
    return serve_state_sharding(tree, mesh)


KINDS = ("params_serve", "params_fsdp", "serve_state_dense",
         "serve_state_paged", "state", "batch")


@needs_reference
@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", list_configs())
def test_specs_match_reference(reference, arch, mesh_key):
    cfg = get_config(arch).reduced()
    mesh = make_mesh(MESHES[mesh_key], device="cpu", shards_per_device=8)
    case = reference[f"{arch}|{mesh_key}"]
    checked = 0
    for kind in KINDS:
        if kind not in case:  # no paged layout for encoder-decoder
            assert kind == "serve_state_paged" and cfg.is_encdec
            continue
        ref = case[kind]
        # 1. the port's rules on the reference's own tree: its specs
        want = {p: _norm(s) for p, (s, _) in ref.items()}
        got = _leaf_specs(_port_specs(_nest(ref), mesh, kind, cfg))
        assert got == want, kind
        # 2. the port's tree: each leaf's spec is its reference leaf's
        by_key: dict = {}
        for path, (spec, shape) in ref.items():
            lead = _ref_lead(path, len(shape), kind)
            suffix, pshape, pspec = _port_view(path, shape, _norm(spec),
                                               lead, cfg)
            if kind.startswith(("serve_state", "state")):
                suffix = path.split("/")[-1]
            by_key.setdefault((suffix, pshape), set()).add(pspec)
        tree = _port_tree(cfg, kind)
        specs = _leaf_specs(_port_specs(tree, mesh, kind, cfg))
        for path, leaf in leaves_with_paths(tree):
            key = _port_key(path, leaf.shape, kind)
            assert key in by_key, (kind, path, tuple(leaf.shape))
            want = by_key[key]
            assert len(want) == 1, (kind, path, want)
            assert specs[path] == next(iter(want)), (kind, path)
            checked += 1
    assert checked > 0


def test_fused_attention_splits_at_head_boundaries():
    """tinyllama's 4 kv heads at model 8 stay whole (replicated), never
    half-heads; its 32 query heads split 4 a position; mistral-nemo's 8 kv
    heads split one a position; recurrentgemma's 10 query heads stay
    whole while its wo (H*hd = 2560 rows) splits as the reference's
    does."""
    mesh = make_mesh({"data": 1, "model": 8}, device="cpu",
                     shards_per_device=8)

    def spec(arch, leaf):
        cfg = get_config(arch)
        hd = cfg.resolved_head_dim
        shapes = {"wq": (cfg.d_model, cfg.n_heads * hd),
                  "wk": (cfg.d_model, cfg.n_kv_heads * hd),
                  "wo": (cfg.n_heads * hd, cfg.d_model)}
        tree = {"layers": [{"attn": {leaf: _Shape(shapes[leaf])}}]}
        return _leaf_specs(param_shardings(tree, mesh, data_axes=(),
                                           cfg=cfg))[f"layers/0/attn/{leaf}"]

    assert spec("tinyllama-1.1b", "wk") == (None, None)
    assert spec("tinyllama-1.1b", "wq") == (None, "model")
    assert spec("mistral-nemo-12b", "wk") == (None, "model")
    assert spec("recurrentgemma-2b", "wq") == (None, None)
    assert spec("recurrentgemma-2b", "wo") == ("model", None)
    with pytest.raises(ValueError, match="needs cfg="):
        param_shardings({"attn": {"wq": _Shape((64, 64))}}, mesh)


@needs_reference
@pytest.mark.parametrize("tp", [3, 8])
def test_validate_serve_mesh_messages_match_reference(tp):
    from repro.configs import get_config as j_get_config
    from repro.distributed.sharding import validate_serve_mesh as j_validate

    def message(fn, cfg):
        try:
            fn(cfg, {"data": 1, "model": tp})
        except ValueError as e:
            return str(e)
        return None

    for arch in list_configs():
        for reduced in (False, True):
            jcfg, cfg = j_get_config(arch), get_config(arch)
            if reduced:
                jcfg, cfg = jcfg.reduced(), cfg.reduced()
            assert message(validate_serve_mesh, cfg) == \
                message(j_validate, jcfg), (arch, reduced)


def test_place_tree_blocks_are_slices_of_the_whole():
    mesh = make_mesh({"pod": 2, "data": 2, "model": 2}, device="cpu",
                     shards_per_device=8)
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((4, 6), generator=gen),
            "b": [torch.randn((8, 2), generator=gen),
                  torch.randn((3,), generator=gen)],
            "c": torch.randn((4, 4, 2), generator=gen)}
    specs = {"a": ("data", "model"), "b": [(("pod", "data"), None), (None,)],
             "c": (None, "model", None)}
    placed = place_tree(mesh, tree, specs)
    assert len(placed) == mesh.size
    for i, pos in enumerate(placed):
        p, d, m = mesh.coords(i)
        assert torch.equal(pos["a"], tree["a"][d * 2:(d + 1) * 2,
                                               m * 3:(m + 1) * 3])
        r = p * 2 + d  # ("pod", "data") row-major
        assert torch.equal(pos["b"][0], tree["b"][0][r * 2:(r + 1) * 2])
        assert pos["b"][1] is tree["b"][1]  # replicated, same device
        assert torch.equal(pos["c"], tree["c"][:, m * 2:(m + 1) * 2])
    copied = place_tree(mesh, tree, specs, copy=True)
    ptrs = {c["b"][1].data_ptr() for c in copied}
    assert len(ptrs) == mesh.size and tree["b"][1].data_ptr() not in ptrs
    with pytest.raises(ValueError, match="does not split"):
        place_tree(mesh, {"x": torch.zeros(3)}, {"x": ("model",)})


def test_restore_resharded_on_cpu_mesh(tmp_path):
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg, "cpu")
    params = model.init(3)
    save(tmp_path, 5, params)
    mesh = make_mesh({"data": 1, "model": 8}, device="cpu",
                     shards_per_device=8)
    specs = param_shardings(params, mesh, data_axes=(), cfg=cfg)
    like = model.init(4)
    placed = restore_resharded(tmp_path, 5, like, specs, mesh=mesh)
    flat_specs = _leaf_specs(specs)
    split = 0
    for path, whole in leaves_with_paths(params):
        spec = flat_specs[path]
        for i, pos in enumerate(placed):
            leaf = dict(leaves_with_paths(pos))[path]
            want = whole
            for dim, ax in enumerate(spec):
                if ax is not None:
                    n = whole.shape[dim] // 8
                    want = want.narrow(dim, mesh.axis_index("model", i) * n,
                                       n)
                    split += 1
            assert torch.equal(leaf, want), (path, i)
    assert split > 0


def test_sharding_ctx_collectives_on_cpu_mesh():
    mesh = make_mesh({"data": 1, "model": 4}, device="cpu",
                     shards_per_device=4)
    ctx = ShardingCtx(mesh=mesh, data_axes=())
    assert (ctx.tp, ctx.dp, ctx.dp_spec) == (4, 1, None)
    assert ShardingCtx(mesh=mesh).dp_spec == "data"
    parts = [torch.full((2, 3), float(i + 1)) for i in range(4)]
    before = mesh.collectives
    summed = ctx.row_sum(parts, torch.bfloat16)
    assert all(s.dtype == torch.bfloat16 and torch.all(s == 10)
               for s in summed)
    cols = [torch.full((2, 1), float(i)) for i in range(4)]
    joined = ctx.gather(cols, dim=-1)
    assert all(torch.equal(j, torch.tensor([[0., 1, 2, 3]] * 2))
               for j in joined)
    assert mesh.collectives == before + 2
    assert [ctx.rank(i) for i in range(4)] == [0, 1, 2, 3]
