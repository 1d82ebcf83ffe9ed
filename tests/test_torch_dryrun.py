"""The port's dry run (``launch/dryrun.py``) against the reference's
(``src/repro/launch/dryrun.py``), on the CPU.

* ``shape_applicable`` and ``make_batch_specs`` equal the reference's for
  all 40 (arch, shape) pairs, and the skip rule holds (gemma-2b's
  long_500k skipped as full attention, rwkv6-3b's applicable);
* the production meshes have the reference's shapes and axes, every
  position on the meta device, and building them runs no op;
* ``plan_model`` gives the reference's decisions and overrides on both
  production meshes for the 32 applicable cells, at the same hardware
  values (the reference's V5E);
* each kernel's meta result has the shape and dtype of its plain
  version's output, and a meta tensor takes neither a kernel nor a plain
  version;
* a flat layer's product FLOPs (train gradient, prefill, decode), counted
  from the kernels' call log, equal the sum of 2·M·N·K over the
  ``dot_general``s of ``jax.make_jaxpr`` of the reference's same layer
  within 1 %, for the reduced tinyllama, rwkv6, recurrentgemma, moonshot
  and seamless (its encoder layers counted as ``attn``), with two stated
  differences taken out first: the backward of a product with a fused
  activation recomputes the product on the kernel (``MatmulFn``), and
  rwkv's WKV recurrence, which the reference computes in XLA as chunked
  ``dot_general``s and the port in its WKV kernel (``calls.wkv_cost``);
* on a CPU mesh {"data": 2, "model": 2} the collective bytes by kind, the
  kernel calls and the live-bytes peak of every position of a probe on
  meta tensors equal those of the same probe on real CPU tensors,
  exactly (the CPU's kernel calls counted as the card's by
  ``calls.plain_call``);
* the cell runner's record keys are the reference's, through the CLI's
  function and ``Runtime(device="cpu").dryrun``.
"""

import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import (SHAPES, get_config, list_configs,  # noqa: E402
                                 shape_applicable)
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.planner import plan_model  # noqa: E402
from repro_torch.data import make_batch_specs  # noqa: E402
from repro_torch.distributed.mesh import make_mesh  # noqa: E402
from repro_torch.distributed.sharding import ShardingCtx  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.kernels import calls, ops  # noqa: E402
from repro_torch.launch.dryrun import trace_layer  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.common import dtype_of  # noqa: E402
from repro_torch.roofline import DispatchCounter  # noqa: E402

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")

PAIRS = [(a, s) for a in list_configs() for s in SHAPES]
APPLICABLE = [(a, s) for a, s in PAIRS
              if shape_applicable(get_config(a), SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", PAIRS)
def test_skip_rule_and_batch_specs_match_reference(arch, shape):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config
    from repro.configs import shape_applicable as j_shape_applicable
    from repro.data.pipeline import make_batch_specs as j_make_batch_specs
    from repro.models.common import dtype_of as j_dtype_of

    cfg, jcfg = get_config(arch), j_get_config(arch)
    assert shape_applicable(cfg, SHAPES[shape]) == \
        j_shape_applicable(jcfg, J_SHAPES[shape])
    got = make_batch_specs(cfg, SHAPES[shape], dtype_of(cfg.dtype))
    want = j_make_batch_specs(jcfg, J_SHAPES[shape], j_dtype_of(jcfg.dtype))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].is_meta
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype).replace("torch.", "") == str(w.dtype), k


def test_skip_rule_verdicts():
    ok, why = shape_applicable(get_config("gemma-2b"), SHAPES["long_500k"])
    assert not ok and "full-attention" in why
    assert shape_applicable(get_config("rwkv6-3b"), SHAPES["long_500k"]) \
        == (True, "")
    from repro_torch.launch.dryrun import dryrun_cell

    rec = dryrun_cell("gemma-2b", "long_500k", multi_pod=False,
                      verbose=False)
    assert rec == {"cell": "gemma-2b/long_500k/pod", "status": "skipped",
                   "reason": why}


@pytest.mark.parametrize("multi_pod", [False, True])
def test_production_meshes_match_reference(monkeypatch, multi_pod):
    import repro.launch.mesh as j_mesh

    seen = {}
    monkeypatch.setattr(j_mesh.jax, "make_mesh",
                        lambda shape, axes: seen.update(shape=shape,
                                                        axes=axes))
    j_mesh.make_production_mesh(multi_pod=multi_pod)
    with DispatchCounter() as counter:
        mesh = make_production_mesh(multi_pod=multi_pod)
    assert counter.ops == 0  # no tensor made, nothing allocated
    assert mesh.axis_names == tuple(seen["axes"])
    assert mesh.axis_sizes == tuple(seen["shape"])
    assert mesh.size == math.prod(seen["shape"])
    assert {d.type for d in mesh.devices} == {"meta"}
    assert set(mesh.streams) == {None}
    # a meta position counts as a device of its own, as a CPU one does
    assert mesh.distinct_devices() == mesh.size
    assert mesh.distinct_devices("model") == 16


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["pod", "multipod"])
@pytest.mark.parametrize("arch,shape", APPLICABLE)
def test_plan_on_production_meshes_matches_reference(arch, shape,
                                                     multi_pod):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.core.planner import plan_model as j_plan_model
    from repro.hw import V5E

    mesh = dict(make_production_mesh(multi_pod=multi_pod).shape)
    want = j_plan_model(j_get_config(arch), J_SHAPES[shape], mesh,
                        engine=JCostEngine(hw=V5E))
    got = plan_model(get_config(arch), SHAPES[shape], mesh,
                     engine=CostEngine(hw=HardwareSpec.from_dict(
                         V5E.to_dict())))
    assert [(d.site, d.choice, d.reason) for d in got.decisions] == \
        [(d.site, d.choice, d.reason) for d in want.decisions]
    for g, w in zip(got.decisions, want.decisions):
        assert g.tp_cost == pytest.approx(w.tp_cost, rel=1e-9)
        assert g.rep_cost == pytest.approx(w.rep_cost, rel=1e-9)
    assert got.overrides == {k: tuple(v) for k, v in want.overrides.items()}
    assert (got.rnn_chunk, got.attn_chunk, got.fits_hbm) == \
        (want.rnn_chunk, want.attn_chunk, want.fits_hbm)
    assert got.hbm_per_chip == pytest.approx(want.hbm_per_chip, rel=1e-12)


# --- the kernels' meta path ------------------------------------------------


def _pair(*shape, dtype=torch.float32, gen=None):
    cpu = torch.randn(shape, generator=gen).to(dtype)
    return cpu, torch.empty_strided(cpu.shape, cpu.stride(), dtype=dtype,
                                    device="meta")


def _same(got, want):
    got = got if isinstance(got, (list, tuple)) else (got,)
    want = want if isinstance(want, (list, tuple)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_meta
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)


MATMUL_CASES = [
    # (a shape, b shape, a dtype, b dtype, out dtype, activation)
    ((5, 12), (12, 7), torch.bfloat16, torch.bfloat16, None, "silu"),
    ((5, 12), (12, 7), torch.float32, torch.bfloat16, torch.float32, None),
    ((5, 12), (12, 7), torch.float32, torch.float32, None, "gelu"),
    ((2, 3, 5, 12), (2, 3, 12, 7), torch.float32, torch.bfloat16,
     torch.float32, None),
    # K above TC_K_BLOCK with an fp32 result: k_blocked's launches
    ((3, 5000), (5000, 4), torch.bfloat16, torch.bfloat16, torch.float32,
     None),
]


@pytest.mark.parametrize("case", range(len(MATMUL_CASES)))
def test_matmul_meta_result_matches_plain(case):
    sa, sb, da, db, out, act = MATMUL_CASES[case]
    gen = torch.Generator().manual_seed(case)
    a, am = _pair(*sa, dtype=da, gen=gen)
    b, bm = _pair(*sb, dtype=db, gen=gen)
    with calls.CallLog() as log:
        got = ops.matmul(am, bm, activation=act, out_dtype=out)
    _same(got, ops.matmul(a, b, activation=act, out_dtype=out))
    want_calls = -(-sa[-1] // ops.TC_K_BLOCK) if (
        out == torch.float32 and sa[-1] > ops.TC_K_BLOCK) else 1
    assert len(log.calls) == want_calls
    assert {c.kernel for c in log.calls} == {"matmul"}


def test_tall_fma_product_runs_as_row_blocks():
    """An fp32 product taller than the FMA grid takes is launched as row
    blocks (rwkv's group norm at train_4k), on meta as on the card."""
    a = torch.empty((ops.FMA_MAX_ROWS + 5, 64), device="meta")
    ones = torch.empty((64, 1), device="meta")
    with calls.CallLog() as log:
        out = ops.matmul(a, ones)
    assert out.shape == (ops.FMA_MAX_ROWS + 5, 1) and len(log.calls) == 2


@pytest.mark.parametrize("causal", [True, False])
def test_flash_meta_results_match_plain(causal):
    from repro_torch.kernels.flash_attention import FlashAttentionFn

    gen = torch.Generator().manual_seed(1)
    s_kv = 16 if causal else 24
    q, qm = _pair(2, 16, 4, 64, gen=gen)
    k, km = _pair(2, s_kv, 2, 64, gen=gen)
    v, vm = _pair(2, s_kv, 2, 64, gen=gen)
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    metas = [t.requires_grad_(True) for t in (qm, km, vm)]
    with calls.CallLog() as log:
        om = FlashAttentionFn.apply(*metas, causal, None)
        gm = torch.autograd.grad(om.sum(), metas)
    o = FlashAttentionFn.apply(*leaves, causal, None)
    _same(om, o)
    _same(gm, torch.autograd.grad(o.sum(), leaves))
    mode = "causal" if causal else "non-causal"
    assert [c.mode for c in log.calls] == [f"forward {mode}",
                                           f"backward {mode}"]


@pytest.mark.parametrize("grad", [False, True])
def test_wkv_meta_results_match_plain(grad):
    gen = torch.Generator().manual_seed(2)
    r, rm = _pair(1, 32, 2, 16, gen=gen)
    k, km = _pair(1, 32, 2, 16, gen=gen)
    v, vm = _pair(1, 32, 2, 16, gen=gen)
    w, wm = _pair(1, 32, 2, 16, gen=gen)
    w, wm = -w.abs(), -wm.abs()
    u, um = _pair(2, 16, gen=gen)
    if not grad:
        with calls.CallLog() as log:
            got = ops.wkv(rm, km, vm, wm, um, chunk=16)
        _same(got, ops.wkv(r, k, v, w, u, chunk=16))
        assert [c.mode for c in log.calls] == ["forward"]
        return
    cpu = [t.requires_grad_(True) for t in (r, k, v, w, u)]
    meta = [t.requires_grad_(True) for t in (rm, km, vm, wm, um)]
    with calls.CallLog() as log:
        om, sm = ops.wkv(*meta, chunk=16)
        gm = torch.autograd.grad(om.sum() + sm.sum(), meta)
    o, s = ops.wkv(*cpu, chunk=16)
    _same((om, sm), (o, s))
    _same(gm, torch.autograd.grad(o.sum() + s.sum(), cpu))
    assert [c.mode for c in log.calls] == ["forward", "backward"]


@pytest.mark.parametrize("shape", [(100,), (3, 40)])
def test_sort_meta_result_matches_plain(shape):
    x, xm = _pair(*shape, gen=torch.Generator().manual_seed(3))
    with calls.CallLog() as log:
        got = ops.sort(xm)
    _same(got, ops.sort(x))
    assert [c.kernel for c in log.calls] == ["bitonic_sort"]


def test_meta_takes_neither_kernel_nor_plain_version(monkeypatch):
    from repro_torch.kernels import matmul as mm

    def refuse(*a, **k):
        raise AssertionError("launched or ran the plain version")

    monkeypatch.setattr(ops, "matmul_fused_ref", refuse)
    monkeypatch.setattr(mm, "_function", refuse)
    before = mm.LAUNCHES.count
    a = torch.empty((4, 8), dtype=torch.bfloat16, device="meta")
    out = ops.matmul(a, torch.empty((8, 3), dtype=torch.bfloat16,
                                    device="meta"))
    assert out.is_meta and mm.LAUNCHES.count == before


# --- a flat layer's product FLOPs against the reference's jaxpr -----------


def _subjaxprs(eqn):
    for v in eqn.params.values():
        for x in (v if isinstance(v, (list, tuple)) else [v]):
            if hasattr(x, "jaxpr") and hasattr(x.jaxpr, "eqns"):
                yield x.jaxpr
            elif hasattr(x, "eqns"):
                yield x


def _dot_flops(jaxpr, mult=1) -> int:
    """2·M·N·K summed over every dot_general, a scan's body times its
    length."""
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            a = eqn.invars[0].aval
            k = math.prod(a.shape[i] for i in lc)
            total += mult * 2 * math.prod(eqn.outvars[0].aval.shape) * k
        m = eqn.params.get("length", 1) if eqn.primitive.name == "scan" \
            else 1
        for sub in _subjaxprs(eqn):
            total += _dot_flops(sub, mult * m)
    return total


B, S = 2, 32


def _reference_flops(arch, kind, mode):
    """(the reference layer's dot_general FLOPs, those of its WKV
    recurrence alone: the chunked form, or the decode step)."""
    from repro.configs import get_config as j_get_config
    from repro.models import rwkv as j_rwkv
    from repro.models import transformer as jt
    from repro.models.common import dtype_of as j_dtype_of

    cfg = j_get_config(arch).reduced()
    dtype = j_dtype_of(cfg.dtype)
    lp = jax.eval_shape(lambda key: jt.layer_init(key, cfg, kind, dtype),
                        jax.random.PRNGKey(0))
    s_in = 1 if mode == "decode" else S
    x = jax.ShapeDtypeStruct((B, s_in, cfg.d_model), dtype)
    pos = jax.ShapeDtypeStruct(
        (B, s_in, 3) if cfg.pos_type == "mrope" else (B, s_in), jnp.int32)
    h, n = cfg.d_model // cfg.rnn_head_dim, cfg.rnn_head_dim
    rk = jax.ShapeDtypeStruct((B, s_in, h, n), jnp.float32)
    uu = jax.ShapeDtypeStruct((h, n), jnp.float32)
    if mode == "decode":
        st = jax.eval_shape(lambda: jt.layer_init_state(cfg, kind, B, S,
                                                        dtype))
        jp = jax.make_jaxpr(lambda lp, x, p, st: jt.layer_apply(
            lp, cfg, kind, x, p, state=st, cache_pos=jnp.int32(S // 2))[:2])(
            lp, x, pos, st)
        ss = jax.ShapeDtypeStruct((B, h, n, n), jnp.float32)
        wkv = jax.make_jaxpr(j_rwkv.wkv_step)(rk, rk, rk, rk, uu, ss)
    elif mode == "train":
        def f(lp, x, p):
            def scalar(lp, x):
                y, _, aux = jt.layer_apply(lp, cfg, kind, x, p)
                return jnp.sum(y.astype(jnp.float32)) + aux
            return jax.grad(scalar, argnums=(0, 1))(lp, x)

        jp = jax.make_jaxpr(f)(lp, x, pos)

        def g(*a):
            def scalar(*a):
                o, s_ = j_rwkv.wkv_chunked(*a, None, chunk=64)
                return jnp.sum(o) + jnp.sum(s_)
            return jax.grad(scalar, argnums=(0, 1, 2, 3, 4))(*a)

        wkv = jax.make_jaxpr(g)(rk, rk, rk, rk, uu)
    else:
        jp = jax.make_jaxpr(lambda lp, x, p: jt.layer_apply(
            lp, cfg, kind, x, p)[0])(lp, x, pos)
        wkv = jax.make_jaxpr(lambda *a: j_rwkv.wkv_chunked(
            *a, None, chunk=64))(rk, rk, rk, rk, uu)
    return _dot_flops(jp.jaxpr), (_dot_flops(wkv.jaxpr) if kind == "rwkv"
                                  else 0)


def _port_flops(arch, kind, mode):
    """(the port layer's product FLOPs from the call log, the named
    differences: the recomputed activation products, the WKV kernel's
    calls or, at decode, rwkv's state-step products)."""
    cfg = get_config(arch).reduced()
    mesh = make_mesh({"data": 1, "model": 1}, device="meta")
    ctx = ShardingCtx(mesh=mesh, data_axes=("data",),
                      infer_replicate_params=mode == "decode")
    tr = trace_layer(cfg, kind, mesh, ctx, B, S, train=mode == "train",
                     decode=mode == "decode")
    log = tr.calls.calls
    recompute = sum(c.flops for c in log if mode == "train"
                    and c.kernel == "matmul" and len(c.mode.split()) == 3)
    wkv = sum(c.flops for c in log if c.kernel == "wkv" or (
        kind == "rwkv" and mode == "decode" and c.mode.startswith("4-D")))
    return tr.flops, recompute, wkv


FLOP_LAYERS = [("tinyllama-1.1b", "attn"), ("rwkv6-3b", "rwkv"),
               ("recurrentgemma-2b", "rglru"), ("recurrentgemma-2b", "local"),
               ("moonshot-v1-16b-a3b", "attn"),
               ("seamless-m4t-medium", "attn")]


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch,kind", FLOP_LAYERS)
def test_layer_product_flops_match_reference_jaxpr(arch, kind, mode):
    want, want_wkv = _reference_flops(arch, kind, mode)
    got, recompute, got_wkv = _port_flops(arch, kind, mode)
    assert want > 0 and got > 0
    assert got - recompute - got_wkv == pytest.approx(want - want_wkv,
                                                      rel=0.01)


# --- meta against real CPU tensors on a CPU mesh --------------------------


CPU_PROBES = [("tinyllama-1.1b", "attn", "decode"),
              ("moonshot-v1-16b-a3b", "attn", "decode"),
              ("rwkv6-3b", "rwkv", "prefill"),
              ("rwkv6-3b", "rwkv", "train"),
              ("recurrentgemma-2b", "rglru", "train")]


@pytest.mark.parametrize("arch,kind,mode", CPU_PROBES)
def test_meta_probe_counts_what_cpu_tensors_give(arch, kind, mode):
    cfg = get_config(arch).reduced()
    shape = {"data": 2, "model": 2}
    got = {}
    for device in ("meta", "cpu"):
        mesh = make_mesh(shape, device=device,
                         shards_per_device=1 if device == "meta" else 4)
        ctx = ShardingCtx(mesh=mesh, data_axes=("data",),
                          infer_replicate_params=mode == "decode")
        tr = trace_layer(cfg, kind, mesh, ctx, 4, 16, train=mode == "train",
                         decode=mode == "decode", device=device)
        got[device] = (tr.collective_bytes, tr.collectives,
                       tr.calls.counts(by_position=True),
                       dict(tr.counter.arguments), dict(tr.counter.peak))
    meta, cpu = got["meta"], got["cpu"]
    assert sum(meta[0].values()) > 0 and meta[1] > 0
    assert meta[0] == cpu[0] and meta[1] == cpu[1]
    assert meta[2] == cpu[2]
    assert meta[3] == cpu[3]
    assert meta[4] == cpu[4] and set(range(4)) <= set(meta[4])


# --- the cell runner -------------------------------------------------------

RECORD_KEYS = {"cell", "status", "mesh", "chips", "memory_analysis",
               "scanned_cost_analysis", "plan_hbm_per_chip_gb",
               "plan_fits_hbm", "plan_decisions", "plan_overrides",
               "compile_s", "roofline", "probe_s", "cost_ledger"}


def test_runtime_dryrun_record_has_the_reference_keys(monkeypatch):
    """``Runtime(device="cpu").dryrun`` of a cell whose config is cut to
    one layer (the record's structure, not its size, is checked here)."""
    import dataclasses

    import repro_torch
    import repro_torch.launch.dryrun as dr

    full = dr.get_config
    monkeypatch.setattr(dr, "get_config", lambda a: dataclasses.replace(
        full(a), n_layers=1))
    rt = repro_torch.Runtime(device="cpu")
    rec = rt.dryrun("tinyllama-1.1b", "decode_32k", verbose=False)
    assert RECORD_KEYS <= set(rec) and rec["status"] == "ok"
    assert set(rec["memory_analysis"]) >= {"argument_bytes", "output_bytes",
                                           "temp_bytes", "code_bytes"}
    assert rec["memory_analysis"]["code_bytes"] == 0.0
    roof = rec["roofline"]
    assert set(roof) == {"terms", "terms_flash_kernel", "collectives",
                         "per_layer"}
    assert roof["terms"]["hw"] == "h100-sxm" and roof["terms"]["chips"] == 256
    assert {k: v for k, v in roof["terms_flash_kernel"].items()
            if k != "label"} == {k: v for k, v in roof["terms"].items()
                                 if k != "label"}
    assert set(roof["per_layer"]) == {"attn"}
    assert rec["cost_ledger"] and rec["chips"] == 256
