"""Tensor-parallel serving on a mesh against the reference, on the CPU
mesh ``make_mesh({"data": 1, "model": 8}, device="cpu",
shards_per_device=8)`` (through ``Runtime.serve(shards_per_device=8)``).

* the reference's main-process tests of ``tests/test_serving_sharded.py``
  side by side: the ``serve_shard`` decision (a tiny model replicates, a
  70B-class one shards, an override restricts the candidates and both
  rows land on the ledger, a model axis of 1 replicates) with the
  reference's choices, values and alternatives on its hardware spec;
  ``validate_serve_mesh`` naming the offending dims; ``Runtime.serve``'s
  mesh errors in the reference's order (axes, divisibility before the
  device count, static mode, ``shard_params``, too few devices); and
  ``ServeReport``'s mesh fields off a mesh;
* token identity, reduced and fp32, 6 requests over 2 slots (slot
  turnover), forced ``shard_params="shard"``: tinyllama dense and paged
  (block size 4, ``prefix_cache="force"``, a prefix hit), rwkv6-3b,
  recurrentgemma-2b and the other non-mixture families (mistral-nemo,
  phi3-mini, gemma, qwen2-vl) at model 8, and tinyllama at model 4,
  where its kv heads split one a position (dense and paged pools).  The
  oracle is the reference's single-device static serve of the same trace
  and parameters (``params_from_jax``), in-process; each run reports the
  mesh, 8 (or 4) devices and collective calls, and ledgers ``serve_shard``
  predicted and measured;
* the ``auto`` verdict on a reduced model replicates: the single-device
  path, no collective, the mesh still reported and the decision ledgered;
* a mixture of experts on a shard verdict raises the port's ValueError
  (the reference's ``moe_ep`` fails with an IndexError there); an
  encoder-decoder serves there (its tokens against the reference's in
  ``tests/test_torch_encdec_mesh.py``);
* the launcher ``--mesh data=1,model=8 --shards-per-device 8 --reduced
  --device cpu``: the reference launcher's mesh line and serve_shard rows;
* on a card (``cuda``): the token-identity cases against the port's own
  unsharded continuous serve on the card, eight positions on GPU 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    from repro.configs import get_config as j_get_config
    from repro.core.costs.engine import CostEngine as JCostEngine
    from repro.distributed.sharding import validate_serve_mesh as j_validate
    from repro.hw import V5E
    from repro.models import build_model as j_build_model
    from repro.serving import ServeEngine as JStatic
    from repro.serving.scheduler import ServeScheduler as JScheduler
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.distributed.sharding import validate_serve_mesh  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving.engine import ServeReport  # noqa: E402
from repro_torch.serving.scheduler import ServeScheduler  # noqa: E402

N_REQ, SLOTS, P_LEN, NEW = 6, 2, 8, 8
MAX_LEN = P_LEN + NEW
MESH8 = {"data": 1, "model": 8}


def _spec_engine():
    """The port's engine on the reference's default hardware spec."""
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _trace(cfg, paged=False):
    kw = dict(prefix_share=1.0, prefix_len=6) if paged else {}
    return synthetic_trace(N_REQ, prompt_len=P_LEN, max_new=NEW,
                           vocab_size=cfg.vocab_size, arrival="all", seed=0,
                           **kw)


def _rows(report, n=N_REQ):
    return np.stack([report.output(f"r{i}", NEW) for i in range(n)])


# ---------------------------------------------------------------------------
# The serve_shard decision, validation and Runtime.serve's errors
# ---------------------------------------------------------------------------


def _decision(dec):
    return dec.choice, dec.value, len(dec.alternatives)


@needs_reference
@pytest.mark.parametrize("case", ["tiny", "large", "tp1"])
def test_serve_shard_decisions_match_reference(case):
    kw = {"tiny": dict(batch=4, tp=8, flops_per_token=2e6, weight_bytes=1e6,
                       kv_bytes_per_slot=1e4, n_layers=2, d_model=64),
          "large": dict(batch=8, tp=8, flops_per_token=2 * 70e9,
                        weight_bytes=2 * 70e9, kv_bytes_per_slot=4e8,
                        n_layers=80, d_model=8192),
          "tp1": dict(batch=2, tp=1, flops_per_token=1e6,
                      weight_bytes=1e6)}[case]
    batch = kw.pop("batch")
    jdec = JCostEngine(hw=V5E).decide_serve_shard(batch, **kw)
    dec = _spec_engine().decide_serve_shard(batch, **kw)
    assert _decision(dec) == _decision(jdec)
    assert _decision(dec) == {"tiny": ("replicate", 1, 2),
                              "large": ("shard_model", 8, 2),
                              "tp1": ("replicate", 1, 1)}[case]
    if case == "large":
        assert dec.predicted.total < dec.baseline.total


@needs_reference
def test_serve_shard_override_restricts_candidates():
    cfg = get_config("tinyllama-1.1b").reduced()
    eng, jeng = _spec_engine(), JCostEngine(hw=V5E)
    sched = ServeScheduler(cfg, eng, max_len=16)
    jsched = JScheduler(j_get_config("tinyllama-1.1b").reduced(), jeng,
                        max_len=16)
    for override, want in (("shard", (8, "shard_model")),
                           ("replicate", (1, "replicate")), (None, None)):
        tp, dec = sched.serve_shard(4, tp=8, override=override)
        jtp, jdec = jsched.serve_shard(4, tp=8, override=override)
        assert (tp, _decision(dec)) == (jtp, _decision(jdec))
        if want is not None:
            assert (tp, dec.choice) == want
            assert len(dec.alternatives) == 1  # the restriction is ledgered
    rows = [e for e in eng.ledger.entries if e.site == "serve_shard"]
    assert len(rows) == 3


@needs_reference
def test_validate_serve_mesh_names_offending_dims():
    cfg = get_config("tinyllama-1.1b").reduced()  # d_ff=128, d_model=64
    with pytest.raises(ValueError, match="d_ff") as err:
        validate_serve_mesh(cfg, {"data": 1, "model": 3})
    with pytest.raises(ValueError) as jerr:
        j_validate(j_get_config("tinyllama-1.1b").reduced(),
                   {"data": 1, "model": 3})
    assert str(err.value) == str(jerr.value)
    validate_serve_mesh(cfg, MESH8)
    validate_serve_mesh(cfg, {"data": 4, "model": 1})


def test_runtime_serve_mesh_errors():
    """The reference's checks in its order: axes, the arch's divisibility
    before any device count, static mode, shard_params, too few devices
    (naming shards_per_device, the port's way to put positions on a
    device)."""
    cfg = get_config("tinyllama-1.1b").reduced()
    rt = Runtime(device="cpu")
    trace = synthetic_trace(1, prompt_len=4, max_new=2,
                            vocab_size=cfg.vocab_size, seed=0)
    with pytest.raises(ValueError, match="does not divide"):
        rt.serve(cfg, trace, mesh_shape={"model": 3})
    with pytest.raises(ValueError, match="axes must be"):
        rt.serve(cfg, trace, mesh_shape={"tensor": 2})
    with pytest.raises(ValueError, match="axes must be"):  # axes first
        rt.serve(cfg, trace, mesh_shape={"tensor": 2, "model": 3})
    with pytest.raises(ValueError, match="does not divide"):  # then arch
        rt.serve(cfg, trace, mode="static", mesh_shape={"model": 3})
    with pytest.raises(ValueError, match="static"):
        rt.serve(cfg, trace, mode="static", mesh_shape={"model": 2})
    with pytest.raises(ValueError, match="shard_params"):
        rt.serve(cfg, trace, mesh_shape={"model": 2}, shard_params="maybe")
    with pytest.raises(ValueError, match="devices.*shards_per_device"):
        rt.serve(cfg, trace, mesh_shape={"model": 2})
    with pytest.raises(ValueError, match="shard_params"):
        rt.serve(cfg, trace, mesh_shape={"model": 1}, shard_params="maybe")


def test_serve_report_mesh_fields_default_off_mesh():
    d = ServeReport(requests=[], wall_s=0.1, pad_id=0).as_dict()
    assert d["mesh_shape"] is None
    assert d["device_count"] == 1
    assert d["collective_ops"] == 0


# ---------------------------------------------------------------------------
# Token identity against the reference's single-device static serve
# ---------------------------------------------------------------------------

_PAIRS = {}


def _pair(arch):
    """The reference's reduced model and parameters and the port's model
    with the same parameters (built once per arch)."""
    if arch not in _PAIRS:
        jcfg = j_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jmodel = j_build_model(jcfg)
        jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
        params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                 "cpu")
        _PAIRS[arch] = (cfg, jmodel, jparams, build_model(cfg, "cpu"), params)
    return _PAIRS[arch]


def _serve_sharded(rt, cfg, model, params, tp, paged, device="cpu"):
    kw = dict(paged=True, block_size=4, prefix_cache="force") if paged \
        else {}
    return rt.serve(cfg, _trace(cfg, paged), mode="continuous", model=model,
                    params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                    mesh_shape={"data": 1, "model": tp},
                    shard_params="shard", shards_per_device=tp, **kw)


CASES = [("tinyllama-1.1b", 8, False), ("tinyllama-1.1b", 8, True),
         ("tinyllama-1.1b", 4, False), ("tinyllama-1.1b", 4, True),
         ("rwkv6-3b", 8, False), ("recurrentgemma-2b", 8, False),
         ("mistral-nemo-12b", 8, False), ("phi3-mini-3.8b", 8, False),
         ("gemma-2b", 8, False), ("qwen2-vl-72b", 8, False)]


@needs_reference
@pytest.mark.parametrize("arch,tp,paged", CASES,
                         ids=[f"{a}-tp{t}{'-paged' if p else ''}"
                              for a, t, p in CASES])
def test_sharded_serve_token_identity(arch, tp, paged):
    cfg, jmodel, jparams, model, params = _pair(arch)
    prompts = np.stack([np.asarray(r.prompt, np.int32)
                        for r in _trace(cfg, paged)])
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=NEW)
    rt = Runtime(device="cpu")
    res = _serve_sharded(rt, cfg, model, params, tp, paged)
    rep = res.report
    np.testing.assert_array_equal(_rows(rep), np.asarray(want))
    assert res.engine.tp == tp
    assert rep.mesh_shape == {"data": 1, "model": tp}
    assert rep.device_count == tp
    assert rep.collective_ops > 0
    assert rep.as_dict()["collective_ops"] == rep.collective_ops
    rows = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    assert rows and all(e.choice == "shard_model" for e in rows)
    assert any(e.measured_s is not None for e in rows)
    assert any(e.measured_s is None for e in rows)
    if paged:
        assert rep.reserved_blocks > 0
        assert rep.prefix_hit_tokens > 0, "the second admission wave hits"
    # every position holds its own blocks: kv heads split where they
    # divide the model axis, whole elsewhere
    pool = res.engine.pool.state
    assert len(pool) == tp
    if arch == "tinyllama-1.1b":
        leaf = pool[0]["layers"][0]["pk" if paged else "k"]
        assert leaf.shape[2] == (1 if tp == 4 else cfg.n_kv_heads)
        assert leaf.data_ptr() != pool[1]["layers"][0][
            "pk" if paged else "k"].data_ptr()


@needs_reference
def test_replicate_verdict_runs_single_device_path():
    cfg, jmodel, jparams, model, params = _pair("tinyllama-1.1b")
    prompts = np.stack([np.asarray(r.prompt, np.int32)
                        for r in _trace(cfg)])
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=NEW)
    rt = Runtime(device="cpu")
    res = rt.serve(cfg, _trace(cfg), mode="continuous", model=model,
                   params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                   mesh_shape=MESH8, shard_params="auto",
                   shards_per_device=8)
    np.testing.assert_array_equal(_rows(res.report), np.asarray(want))
    assert res.engine.tp == 1, "a reduced config replicates on auto"
    assert res.report.collective_ops == 0
    assert res.report.mesh_shape == MESH8
    assert res.engine.params is params  # never placed on the mesh
    rows = [e for e in rt.ledger.entries if e.site == "serve_shard"]
    assert rows and rows[0].choice == "replicate"


def test_mixture_of_experts_and_encdec_refused_on_a_shard_verdict():
    """A mixture of experts is refused on a shard verdict; an
    encoder-decoder, refused there before its mesh slice, now serves
    sharded."""
    rt = Runtime(device="cpu")
    for arch, err, match in (
            ("moonshot-v1-16b-a3b", ValueError, "moe_ep"),
            ("qwen3-moe-235b-a22b", ValueError, "IndexError")):
        cfg = get_config(arch).reduced()
        trace = synthetic_trace(2, prompt_len=4, max_new=2,
                                vocab_size=cfg.vocab_size, seed=0)
        with pytest.raises(err, match=match):
            rt.serve(cfg, trace, mesh_shape=MESH8, shard_params="shard",
                     shards_per_device=8)
    # the replicate verdict serves it on the single-device path
    cfg = get_config("moonshot-v1-16b-a3b").reduced()
    res = rt.serve(cfg, synthetic_trace(2, prompt_len=4, max_new=2,
                                        vocab_size=cfg.vocab_size, seed=0),
                   mesh_shape=MESH8, shard_params="replicate",
                   shards_per_device=8)
    assert res.engine.tp == 1 and res.report.generated_tokens > 0
    cfg = get_config("seamless-m4t-medium").reduced()
    res = rt.serve(cfg, synthetic_trace(2, prompt_len=4, max_new=2,
                                        vocab_size=cfg.vocab_size, seed=0),
                   mesh_shape=MESH8, shard_params="shard",
                   shards_per_device=8)
    assert res.engine.tp == 8 and res.report.collective_ops > 0
    assert res.report.generated_tokens > 0


def test_launcher_serves_on_the_mesh(capsys):
    from repro_torch.launch import serve

    assert serve.main(["--arch", "tinyllama-1.1b", "--reduced", "--device",
                       "cpu", "--requests", "4", "--max-new", "4",
                       "--slots", "2", "--engine", "continuous", "--mesh",
                       "data=1,model=8", "--serve-shard", "shard",
                       "--shards-per-device", "8"]) == 0
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if "mesh {" in x)
    assert "mesh {'data': 1, 'model': 8} (8 devices), collective ops" in line
    assert int(line.rsplit(" ", 1)[1]) > 0
    assert "serve_shard    shard_model" in out
    assert "states {'COMPLETED': 4}" in out


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch,tp,paged", CASES,
                         ids=[f"{a}-tp{t}{'-paged' if p else ''}"
                              for a, t, p in CASES])
def test_sharded_serve_token_identity_on_card(arch, tp, paged):
    """The same traces at reduced size (fp32) on eight (or four) positions
    of GPU 0, against the port's unsharded continuous serve on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_serve_mesh.py`")
    cfg = get_config(arch).reduced()
    rt = Runtime(device="cuda")
    model = build_model(cfg, "cuda")
    params = model.init(0)
    kw = dict(paged=True, block_size=4, prefix_cache="force") if paged \
        else {}
    want = rt.serve(cfg, _trace(cfg, paged), mode="continuous", model=model,
                    params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                    **kw)
    res = rt.serve(cfg, _trace(cfg, paged), mode="continuous", model=model,
                   params=params, slots=SLOTS, max_len=MAX_LEN, eos_id=0,
                   mesh_shape={"data": 1, "model": tp}, shard_params="shard",
                   shards_per_device=tp, **kw)
    np.testing.assert_array_equal(_rows(res.report), _rows(want.report))
    assert res.report.collective_ops > 0 and res.engine.tp == tp
    assert all(d.type == "cuda" for d in res.engine.mesh.devices)
    assert len(set(res.engine.mesh.streams)) == tp
