"""The port's bench suites' deterministic output against the reference's
own functions (``benchmarks/``, ``src/repro/``), the port's engine given
the reference's V5E constants (``HardwareSpec.from_dict``):

* ``matmul_crossover``: each order's serial prediction, the chosen
  strategy and its prediction at 8, 64 and 256 chips (rtol 1e-9), and the
  crossover orders;
* ``wkv_chunk``: each chunk's prediction and ``model_choice``, and each
  chunk's ``wkv_chunked`` output against the reference's on the suite's
  inputs' first 256 positions (fp32, rtol 1e-5 and 1e-5 x max|output|, for the elements near
  a cancellation);
* ``sort_pivots``: the imbalance of the four deterministic pivots at the
  largest of the paper's sizes against the reference's ``distributed_sort`` on an
  ``AxisType.Auto`` mesh of 8 host devices (``torch_mesh_reference``);
  ``random`` draws from a ``torch.Generator`` and is left out; every sort
  equals ``np.sort``;
* ``cost_ledger``: the decision flips between two fixed specs (V5E, and
  V5E with a tenth of its interconnect bandwidth);
* ``chaos_bench``: ``_find_flip`` and ``_find_driver`` for its three sites
  at V5E against the reference harness's;
* ``roofline_table.render``: the reference's text, on the same JSON.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import CostEngine as JCostEngine  # noqa: E402
from repro.core import decide_matmul as j_decide_matmul  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro_torch.benches import (chaos_bench, cost_ledger,  # noqa: E402
                                 matmul_crossover, roofline_table,
                                 sort_pivots, wkv_chunk)
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import HardwareSpec  # noqa: E402

from torch_mesh_reference import run_reference  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:  # the reference harness, ``benchmarks/``
    sys.path.insert(0, str(REPO))

P_V5E = HardwareSpec.from_dict(V5E.to_dict())
S_TEST = 256  # WKV positions compared, a whole chunk at the largest


def test_matmul_crossover_matches_reference():
    jeng = JCostEngine(hw=V5E)
    rows = matmul_crossover.predictions(CostEngine(hw=P_V5E))
    assert [r["order"] for r in rows] == list(matmul_crossover.ORDERS)
    for row in rows:
        n = row["order"]
        want = jeng.model.matmul_cost(n, n, n, strategy="serial").total * 1e6
        np.testing.assert_allclose(row["pred_serial_us"], want, rtol=1e-9)
        for c in matmul_crossover.CHIPS:
            rep = j_decide_matmul(n, n, n, chips=c, engine=jeng)
            assert row[f"strategy_{c}"] == rep.chosen.strategy, (n, c)
            np.testing.assert_allclose(row[f"pred_{c}chips_us"],
                                       rep.chosen.total * 1e6, rtol=1e-9)
    xo = matmul_crossover.crossovers(CostEngine(hw=P_V5E),
                                     CostEngine(hw=P_V5E))
    for c, (order, cal) in xo.items():
        assert order == cal == jeng.matmul_crossover_order(c)


def test_wkv_chunk_predictions_and_outputs_match_reference():
    from repro.core.costs.model import OverheadModel as JModel
    from repro.models.rwkv import wkv_chunked as j_wkv_chunked

    pred, best = wkv_chunk.predictions(CostEngine(hw=P_V5E).model)
    jom = JModel(hw=V5E)
    B, S, H, N = wkv_chunk.B, wkv_chunk.S, wkv_chunk.H, wkv_chunk.N
    for c in wkv_chunk.CHUNKS:
        np.testing.assert_allclose(
            pred[c], jom.scan_chunk_cost(S, c, batch=B, heads=H,
                                         head_dim=N) * 1e6, rtol=1e-9)
    assert best == jom.best_scan_chunk(S, batch=B, heads=H, head_dim=N,
                                       candidates=wkv_chunk.CHUNKS)
    # the suite's inputs' first S_TEST positions: the recurrence is
    # causal from a zero state, so these are its outputs' first positions
    r, k, v, logw, u = wkv_chunk.inputs("cpu")
    r, k, v, logw = (t[:, :S_TEST] for t in (r, k, v, logw))
    jin = [jnp.asarray(t.numpy()) for t in (r, k, v, logw, u)]
    for c in wkv_chunk.CHUNKS:
        got = wkv_chunk.chunk_out(r, k, v, logw, u, c).numpy()
        want = np.asarray(j_wkv_chunked(*jin, None, chunk=c)[0])
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"chunk {c}")


N_SORT = sort_pivots.PAPER_NS[-1]  # the largest of the paper's Table 3
_SORT_REFERENCE = """
from repro.core.sort import distributed_sort
mesh = auto_mesh((8,), ("data",))
x = np.random.default_rng(%d).standard_normal(%d).astype(np.float32)
res, rep = distributed_sort(jnp.asarray(x), mesh, "data", pivot=%r,
                            force_parallel=True)
assert np.array_equal(np.asarray(res), np.sort(x))
OUT["imbalance"] = np.asarray(rep.imbalance)
"""


@pytest.mark.parametrize("pivot", ["left", "right", "mean", "sampled"])
def test_sort_pivot_imbalance_matches_reference(tmp_path, pivot):
    want = run_reference(_SORT_REFERENCE % (N_SORT, N_SORT, pivot),
                         tmp_path / "sort.npz")["imbalance"]
    x = torch.from_numpy(np.random.default_rng(N_SORT).standard_normal(
        N_SORT).astype(np.float32))
    got = sort_pivots.imbalance({N_SORT: x}, sort_pivots.make_sort_mesh(
        torch.device("cpu")), pivots=(pivot,))
    np.testing.assert_allclose(got[N_SORT][pivot], want, rtol=1e-12)
    # imbalance() holds the sort to torch.sort, which is np.sort here
    assert np.array_equal(torch.sort(x).values.numpy(), np.sort(x.numpy()))


def test_cost_ledger_decision_flips_match_reference():
    import dataclasses

    # V5E, and V5E with a tenth of its interconnect bandwidth
    slow = {"ici_bw_per_link": V5E.ici_bw_per_link / 10}
    got = cost_ledger.decision_flips({
        "v5e": CostEngine(hw=P_V5E),
        "slow": CostEngine(hw=dataclasses.replace(P_V5E, **slow))})
    jengines = (JCostEngine(hw=V5E),
                JCostEngine(hw=dataclasses.replace(V5E, **slow)))
    want = []
    for c in cost_ledger.CHIPS:
        for n in cost_ledger.FLIP_ORDERS:
            a, b = (e.decide_matmul(n, n, n, chips=c,
                                    io_at_master=True).choice
                    for e in jengines)
            if a != b:
                want.append((c, n, a, b))
    assert got == want
    assert got, "the slower interconnect flips at least one decision"


@pytest.mark.parametrize("site", chaos_bench.CHAOS_SITES)
def test_chaos_flip_and_driver_queries_match_reference(site):
    import dataclasses

    from benchmarks import chaos_bench as jchaos
    from repro.hw import SITE_FIELDS as J_SITE_FIELDS

    jpert = dataclasses.replace(V5E, **{
        f: getattr(V5E, f) * jchaos.PERTURB for f in jchaos.PERTURBED_FIELDS})
    ppert = dataclasses.replace(P_V5E, **{
        f: getattr(P_V5E, f) * chaos_bench.PERTURB
        for f in chaos_bench.PERTURBED_FIELDS})
    jq, jwant = jchaos._find_flip(site, V5E, jpert,
                                  tuple(J_SITE_FIELDS[site]))
    from repro_torch.hw import SITE_FIELDS

    q, want = chaos_bench._find_flip(site, P_V5E, ppert,
                                     tuple(SITE_FIELDS[site]))
    assert want == jwant
    assert q.kind == jq.kind and tuple(q.shape) == tuple(jq.shape)
    assert dict(q.params) == dict(jq.params)
    jd = jchaos._find_driver(site, V5E, jpert)
    d = chaos_bench._find_driver(site, P_V5E, ppert)
    assert tuple(d.shape) == tuple(jd.shape)
    assert dict(d.params) == dict(jd.params)


def _dryrun_records() -> list:
    terms = {"chips": 256, "t_compute_s": 1.25e-3, "t_memory_s": 4.5e-4,
             "t_collective_s": 2.0e-5, "bound": "compute",
             "useful_flops_fraction": 0.8123, "roofline_fraction": 0.4567}
    return [
        {"cell": "tinyllama-1.1b/train_4k/pod", "status": "ok",
         "roofline": {"terms": terms,
                      "terms_flash_kernel": dict(terms,
                                                 roofline_fraction=0.5)}},
        {"cell": "gemma-2b/decode_32k/pod", "status": "ok",
         "roofline": {"terms": dict(terms, bound="memory")}},
        {"cell": "rwkv6-3b/decode_32k/pod", "status": "ok"},
        {"cell": "tinyllama-1.1b/long_500k/pod", "status": "skipped",
         "reason": "full attention at 500k"},
        {"cell": "x/y/pod", "status": "FAILED", "error": "boom"},
    ]


def test_roofline_render_matches_reference(tmp_path):
    from benchmarks import roofline_table as jroof

    path = tmp_path / "dryrun_pod.json"
    path.write_text(json.dumps(_dryrun_records()))
    assert roofline_table.render(str(path)) == jroof.render(str(path))
