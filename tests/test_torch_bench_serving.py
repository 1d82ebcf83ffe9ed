"""The port's serving suites on the CPU (reduced tinyllama-1.1b, fp32),
fed the reference's parameters (``params_from_jax``):

* ``serving_bench``: the static, continuous, sharded (8 CPU positions),
  paged and shared-prefix rows token-identical to each other and the
  static rows to the reference's static serve of the same trace; the
  shared-prefix row prefills at most half the dense run's prompt tokens;
  ``check_regression`` records a baseline with no previous file, passes
  against the run's own file and fails below the previous hit rate;
* ``stress_bench --smoke --check-slo``: every request terminal, the fault
  drills token-identical to the clean run (the suite raises otherwise);
* ``chaos_bench --smoke --check-recovery``: the verdicts reconverge within
  the measurement budget, every serve token-identical.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving import ServeEngine as JStatic  # noqa: E402
from repro_torch.benches import (chaos_bench, serving_bench,  # noqa: E402
                                 stress_bench)
from repro_torch.benches.common import ARCH  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402


@pytest.fixture(scope="module")
def pair():
    jcfg = j_get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    cfg = get_config(ARCH).reduced()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jmodel, jparams, build_model(cfg, "cpu"), params


def test_serving_bench_rows_match_reference_static(pair, tmp_path):
    jmodel, jparams, model, params = pair
    cfg = model.cfg
    rt = Runtime(device="cpu")
    res = serving_bench.run(runtime=rt, out=tmp_path, model=model,
                            params=params)
    prompts = np.stack([np.asarray(r.prompt, np.int32) for r in
                        serving_bench._trace(cfg, arrival="all")])
    want = JStatic(jmodel, jparams, max_len=serving_bench.PROMPT_LEN
                   + serving_bench.MAX_NEW, eos_id=0).generate(
        prompts, max_new_tokens=serving_bench.MAX_NEW)
    np.testing.assert_array_equal(np.asarray(res["outputs"]),
                                  np.asarray(want))
    fl = res["full_load"]
    assert res["token_identical"]
    assert fl["sharded"]["token_identical"]
    assert fl["sharded"]["collective_ops"] > 0
    assert fl["paged"]["token_identical"]
    px = res["shared_prefix"]
    assert px["token_identical"]
    dense_prompt = serving_bench.REQUESTS * serving_bench.PROMPT_LEN
    assert px["prefilled_tokens"] <= dense_prompt // 2
    assert px["prefix_hit_tokens"] > 0
    saved = json.loads((tmp_path / "serving.json").read_text())
    assert saved["outputs"] == res["outputs"]
    # --check-regression: no previous file records a baseline; this run
    # held against itself passes; a halved previous hit rate floors it
    serving_bench._check_regression({}, fl, px)
    serving_bench._check_regression(saved, fl, px)
    worse = dict(saved, shared_prefix=dict(
        px, prefix_hit_rate=2 * px["prefix_hit_rate"]))
    with pytest.raises(AssertionError, match="prefix_hit_rate"):
        serving_bench._check_regression(worse, fl, px)


def test_stress_bench_smoke(pair, tmp_path):
    _, _, model, params = pair
    stress = stress_bench.run(runtime=Runtime(device="cpu"), out=tmp_path,
                              smoke=True, check_slo=True, model=model,
                              params=params)
    assert stress["overload"]["all_terminal"]
    assert sum(stress["overload"]["states"].values()) == \
        stress_bench.OVERLOAD_REQUESTS
    for kind, row in stress["faults"].items():
        assert row["all_terminal"] and row["completed_token_identical"], kind
    assert json.loads((tmp_path / "serving.json").read_text())["stress"]


def test_chaos_bench_smoke(pair, tmp_path):
    _, _, model, params = pair
    chaos = chaos_bench.run(runtime=Runtime(device="cpu"), out=tmp_path,
                            check_recovery=True, model=model, params=params)
    assert chaos["converged_at_rows"] <= chaos_bench.MEASUREMENT_BUDGET
    assert all(chaos["token_identical"].values())
    assert set(chaos["token_identical"]) == {"dense", "paged", "frontend",
                                             "sharded"}
    assert chaos["restart_inherited"]
