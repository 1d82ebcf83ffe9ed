"""The port's fork-join matmul over a mesh against the reference's.

The reference (``repro.core.dispatch``) runs once for this file, in a
subprocess with 8 forced host devices on an ``AxisType.Auto`` mesh
(``torch_mesh_reference``; its ``shard_map`` bodies under ``jax.jit``);
the port runs on an 8-position CPU mesh on the same arrays.

* ``adaptive_matmul`` with ``force_strategy`` ``shard_m``, ``shard_n``,
  ``shard_k`` and ``shard_mn`` (one axis: ``shard_m``) on (104, 72) @
  (72, 88) in fp32, sizes no shard count divides (the zero padding), with
  and without ``use_kernel``: within 1e-5 x max|C| of the reference's and
  of the serial product, ``shard_m``, ``shard_n`` and ``shard_mn``
  exactly the serial product's bits (each row or column alone);
* the engine's own choice at chips = 8 (serial for this size) equal to the
  reference's, and the chain's per-product decisions (``io_at_master=
  False``: sharded) and result against the reference's ``matmul_chain``
  on its mesh, within 1e-5 x max|C|, on the H100 data sheet's spec;
* the strategies on the ``model`` axis of a 2 x 4 mesh, ``_pad_to``, an
  unknown strategy refused;
* ``examples/torch_adaptive_dispatch.py`` at CPU size;
* on a CUDA card (marked ``cuda``): eight shards on one GPU, ``shard_m``
  bit for bit the serial kernel product in bf16 and fp32, ``shard_n`` and
  ``shard_k`` within 8e-3 (bf16) and 1e-5 (fp32) x max|C|.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from torch_mesh_reference import needs_reference, run_reference

torch = pytest.importorskip("torch")

from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.dispatch import (  # noqa: E402
    _pad_to,
    adaptive_matmul,
    matmul_chain,
)
from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CHIPS = 8
STRATEGIES = ("shard_m", "shard_n", "shard_k", "shard_mn")
CHAIN = [(64, 96), (96, 32), (32, 128), (128, 48), (48, 40)]

_REFERENCE = """
from repro.compat import shard_map
from repro.core import dispatch
from repro.core.costs.engine import CostEngine
from repro.hw import HardwareSpec

# the same shard_map, compiled once a call instead of run op by op
dispatch.shard_map = lambda *a, **k: jax.jit(shard_map(*a, **k))
mesh = auto_mesh((8,), ("data",))
k1, k2 = jax.random.split(jax.random.PRNGKey(0))
a = jax.random.normal(k1, (104, 72))
b = jax.random.normal(k2, (72, 88))
OUT["a"], OUT["b"] = a, b
for strat in ("shard_m", "shard_n", "shard_k", "shard_mn"):
    OUT[strat] = dispatch.adaptive_matmul(a, b, mesh, "data",
                                          force_strategy=strat)
out, rep = dispatch.adaptive_matmul(a, b, mesh, "data", return_report=True)
OUT["default"], OUT["default_strategy"] = out, np.array(rep.chosen.strategy)
eng = CostEngine(hw=HardwareSpec.from_dict(json.loads(FIELDS)))
key = jax.random.PRNGKey(7)
mats = []
for i, s in enumerate(json.loads(CHAIN)):
    mats.append(jax.random.normal(jax.random.fold_in(key, i), tuple(s)))
    OUT[f"chain/{i}"] = mats[-1]
OUT["chain"] = dispatch.matmul_chain(mats, mesh, "data", engine=eng)
rows = [e for e in eng.ledger.entries if e.site == "matmul"]
OUT["chain/choices"] = np.array([r.choice for r in rows])
OUT["chain/predicted"] = np.array([r.predicted_s for r in rows])
OUT["chain/queries"] = np.array([json.dumps(r.query, sort_keys=True)
                                 for r in rows])
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    body = (f"FIELDS = {json.dumps(json.dumps(H100.to_dict()))}\n"
            f"CHAIN = {json.dumps(json.dumps(CHAIN))}\n" + _REFERENCE)
    return run_reference(body, tmp_path_factory.mktemp("ref") / "mm.npz")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh({"data": CHIPS}, device="cpu", shards_per_device=CHIPS)


def _engine():
    return CostEngine(hw=HardwareSpec.from_dict(H100.to_dict()))


@needs_reference
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_match_reference(reference, mesh, strategy, use_kernel):
    a = torch.from_numpy(reference["a"])
    b = torch.from_numpy(reference["b"])
    serial = adaptive_matmul(a, b, use_kernel=use_kernel)
    got = adaptive_matmul(a, b, mesh, force_strategy=strategy,
                          use_kernel=use_kernel)
    assert got.shape == (104, 88) and got.dtype == torch.float32
    want = reference[strategy]
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), serial.numpy(), rtol=0, atol=tol)
    if strategy != "shard_k":  # each row or column computed alone
        assert torch.equal(got, serial)


@needs_reference
def test_engine_choice_at_eight_chips_matches_reference(reference, mesh):
    a = torch.from_numpy(reference["a"])
    b = torch.from_numpy(reference["b"])
    out, rep = adaptive_matmul(a, b, mesh, return_report=True)
    assert rep.chips == CHIPS
    assert rep.chosen.strategy == str(reference["default_strategy"]) \
        == "serial"
    np.testing.assert_allclose(out.numpy(), reference["default"], rtol=0,
                               atol=1e-5 * np.abs(reference["default"]).max())


@needs_reference
@pytest.mark.parametrize("use_kernel", [False, True])
def test_chain_on_mesh_matches_reference(reference, mesh, use_kernel):
    mats = [torch.from_numpy(reference[f"chain/{i}"])
            for i in range(len(CHAIN))]
    eng = _engine()
    got = matmul_chain(mats, mesh, engine=eng, use_kernel=use_kernel)
    want = reference["chain"]
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    rows = [e for e in eng.ledger.entries if e.site == "matmul"]
    assert [r.choice for r in rows] == list(reference["chain/choices"])
    assert [json.dumps(r.query, sort_keys=True) for r in rows] == \
        list(reference["chain/queries"])
    np.testing.assert_allclose([r.predicted_s for r in rows],
                               reference["chain/predicted"], rtol=1e-9)
    assert {r.choice for r in rows} - {"serial"}, "no product sharded"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategies_on_one_axis_of_a_two_axis_mesh(strategy):
    mesh = make_mesh({"data": 2, "model": 4}, device="cpu",
                     shards_per_device=8)
    g = torch.Generator().manual_seed(3)
    a, b = torch.randn(30, 21, generator=g), torch.randn(21, 13, generator=g)
    got, rep = adaptive_matmul(a, b, mesh, axis="model",
                               force_strategy=strategy, return_report=True)
    assert rep.chips == 4
    want = a @ b
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


def test_pad_to_and_unknown_strategy(mesh):
    x = torch.ones(5, 3)
    padded, r = _pad_to(x, 0, 4)
    assert r == 3 and padded.shape == (8, 3) and padded[5:].eq(0).all()
    same, r = _pad_to(x, 1, 3)
    assert r == 0 and same is x
    with pytest.raises(ValueError, match="strategy"):
        adaptive_matmul(x, torch.ones(3, 2), mesh, force_strategy="shard_x")
    # without a mesh a forced strategy runs serially, as in the reference
    torch.testing.assert_close(
        adaptive_matmul(x, torch.ones(3, 2), force_strategy="shard_k"),
        torch.full((5, 2), 3.0))


def test_example_runs_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location(
        "torch_adaptive_dispatch", REPO / "examples" /
        "torch_adaptive_dispatch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu", "--order", "64"])
    out = capsys.readouterr().out
    assert "forced shard_k" in out and "matrix chain on the mesh" in out
    assert out.count("--- ") == 10  # a plan for every configuration


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_sharded_kernel_products_on_eight_shards_of_one_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_sharded_dispatch.py`")
    mesh = make_mesh({"data": CHIPS}, shards_per_device=CHIPS)
    g = torch.Generator(device="cuda").manual_seed(0)
    tol = 8e-3 if dtype == torch.bfloat16 else 1e-5
    for m, k, n in ((1024, 1024, 1024), (104, 72, 88)):
        a = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        b = torch.randn(k, n, generator=g, device="cuda").to(dtype)
        serial = adaptive_matmul(a, b, use_kernel=True)
        scale = float(serial.abs().max())
        for strategy in ("shard_m", "shard_n", "shard_k"):
            got = adaptive_matmul(a, b, mesh, force_strategy=strategy,
                                  use_kernel=True)
            assert got.is_cuda and got.dtype == dtype
            if strategy == "shard_m":
                assert torch.equal(got, serial)
            err = float((got.float() - serial.float()).abs().max())
            assert err <= tol * scale, (strategy, m, err)
