"""The port's serving stack against the reference's, on the reference's own
parameters (bridged through numpy) and the same prompts, on the CPU.

* the port's continuous engine emits exactly the reference static engine's
  tokens, including an EOS inside a macro-step, ragged budgets and slot
  turnover (the shape of the reference's
  ``test_macro_step_eos_turnover_ragged_budgets_match_static``);
* the port's continuous engine equals the port's static engine;
* with the horizon K and the prefill chunk pinned, the port counts the same
  host syncs and device dispatches as the reference;
* ``Runtime(device="cpu").serve`` drives both modes end to end.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import ContinuousServeEngine as JContinuous  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JStatic  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime, synthetic_trace  # noqa: E402
from repro_torch.serving import ContinuousServeEngine, Request, ServeEngine  # noqa: E402

PROMPT_LEN = 7
MAX_NEW = 9
MAX_LEN = PROMPT_LEN + MAX_NEW


def _build(n_layers=2, key=0):
    jcfg = dataclasses.replace(j_get_config("tinyllama-1.1b").reduced(),
                               n_layers=n_layers)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              n_layers=n_layers)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(key))
    model = build_model(cfg, "cpu")
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return cfg, jmodel, jparams, model, params


@pytest.fixture(scope="module")
def two_layer():
    return _build(2)


def _prompts(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, PROMPT_LEN)).astype(np.int32)


def _pick_eos(jmodel, jparams, prompts, step=3):
    """The token the first row emits at ``step`` (so EOS fires mid-run)."""
    base = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=-1).generate(
        prompts, max_new_tokens=MAX_NEW)
    return int(base[0, step])


def _spec_engine():
    """The port's engine on the reference's default spec, so admission
    decisions are the reference's."""
    return CostEngine(hw=HardwareSpec.from_dict(V5E.to_dict()))


def _run_port(model, params, prompts, budgets, **kw):
    engine = ContinuousServeEngine(model, params, max_len=MAX_LEN,
                                   cost_engine=_spec_engine(), **kw)
    report = engine.run([Request(f"r{i}", prompts[i], budgets[i])
                         for i in range(len(prompts))], now_fn=lambda: 0.0)
    return report


@pytest.mark.parametrize("n_layers", [2, 4], ids=["unrolled", "scan"])
def test_continuous_matches_reference_static(n_layers):
    """Slot queueing and reuse (n_slots < n_requests), both parameter
    layouts, auto horizon and chunk."""
    cfg, jmodel, jparams, model, params = _build(n_layers)
    prompts = _prompts(cfg, 3)
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=0).generate(
        prompts, max_new_tokens=MAX_NEW)
    report = _run_port(model, params, prompts, [MAX_NEW] * 3, n_slots=2,
                       eos_id=0)
    got = np.stack([report.output(f"r{i}", MAX_NEW) for i in range(3)])
    np.testing.assert_array_equal(got, want)


def test_macro_step_eos_turnover_ragged_budgets_match_reference(two_layer):
    cfg, jmodel, jparams, model, params = two_layer
    prompts = _prompts(cfg, 3)
    eos = _pick_eos(jmodel, jparams, prompts)
    want = JStatic(jmodel, jparams, max_len=MAX_LEN, eos_id=eos,
                   pad_id=0).generate(prompts, max_new_tokens=MAX_NEW)
    budgets = [MAX_NEW, 5, 6]  # ragged: slots hit budget mid-macro-step
    report = _run_port(model, params, prompts, budgets, n_slots=2,
                       eos_id=eos, pad_id=0, macro_step=4)
    for i in range(3):
        np.testing.assert_array_equal(report.output(f"r{i}", budgets[i]),
                                      want[i, : budgets[i]])
    assert report.all_terminal


def test_port_continuous_matches_port_static(two_layer):
    cfg, jmodel, jparams, model, params = two_layer
    prompts = _prompts(cfg, 3, seed=5)
    eos = _pick_eos(jmodel, jparams, prompts)
    static = ServeEngine(model, params, max_len=MAX_LEN, eos_id=eos,
                         pad_id=0).generate(prompts, max_new_tokens=MAX_NEW)
    for k in (1, 8):
        report = _run_port(model, params, prompts, [MAX_NEW] * 3, n_slots=2,
                           eos_id=eos, pad_id=0, macro_step=k,
                           prefill_chunk=4)
        got = np.stack([report.output(f"r{i}", MAX_NEW) for i in range(3)])
        np.testing.assert_array_equal(got, static)


@pytest.mark.parametrize("k,chunk", [(1, 1), (4, 4), (8, 7)])
def test_sync_and_dispatch_counts_match_reference(two_layer, k, chunk):
    cfg, jmodel, jparams, model, params = two_layer
    prompts = _prompts(cfg, 3, seed=2)
    budgets = [MAX_NEW, 5, 6]
    jengine = JContinuous(jmodel, jparams, n_slots=2, max_len=MAX_LEN,
                          eos_id=0, cost_engine=JCostEngine(hw=V5E),
                          macro_step=k, prefill_chunk=chunk)
    jreport = jengine.run([JRequest(f"r{i}", prompts[i], budgets[i])
                           for i in range(3)], now_fn=lambda: 0.0)
    report = _run_port(model, params, prompts, budgets, n_slots=2, eos_id=0,
                       macro_step=k, prefill_chunk=chunk)
    assert report.host_syncs == jreport.host_syncs
    assert report.device_dispatches == jreport.device_dispatches
    for i in range(3):
        np.testing.assert_array_equal(report.output(f"r{i}"),
                                      jreport.output(f"r{i}"))


def test_runtime_serve_cpu_both_modes(two_layer):
    """The public entry point, with eos_id=-1 (masked slots are fed the
    pad id -1, which counts from the end of the vocabulary)."""
    cfg, _, _, model, params = two_layer
    rt = Runtime(device="cpu")
    trace = lambda: synthetic_trace(5, prompt_len=6, max_new=5,  # noqa: E731
                                    vocab_size=cfg.vocab_size, arrival="all")
    static = rt.serve(cfg, trace(), mode="static", model=model, params=params,
                      eos_id=-1)
    cont = rt.serve(cfg, trace(), mode="continuous", model=model,
                    params=params, slots=2, eos_id=-1)
    assert static.generated_tokens == cont.generated_tokens == 25
    for rid, out in static.outputs.items():
        np.testing.assert_array_equal(cont.outputs[rid], out)
    sites = {e.site for e in rt.ledger.entries}
    assert {"serve", "serve_macro"} <= sites
    assert cont.report.host_syncs_per_token < 1.0


def test_runtime_serve_initializes_from_seed():
    cfg = get_config("tinyllama-1.1b").reduced()
    rt = Runtime(device="cpu")
    trace = synthetic_trace(2, prompt_len=4, max_new=3,
                            vocab_size=cfg.vocab_size, arrival="all")
    first = rt.serve(cfg, trace, seed=3, warmup=False)
    again = rt.serve(cfg, trace, seed=3, warmup=False)
    for rid in first.outputs:
        np.testing.assert_array_equal(first.outputs[rid], again.outputs[rid])
