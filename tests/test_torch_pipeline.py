"""The port's GPipe over a mesh axis against the reference's.

The reference (``repro.distributed.pipeline.gpipe``) runs once for this
file, in a subprocess with 4 forced host devices on an ``AxisType.Auto``
mesh (``torch_mesh_reference``); the port runs on a 4-position CPU mesh on
the same stage parameters and microbatches.

* ``gpipe`` with the reference test's 4 tanh stages (6 microbatches of 3
  x 8) and with 8 microbatches: within 1e-5 (the reference test's limit)
  of the reference's outputs, and bit for bit the port's own sequential
  application of the stages to each microbatch;
* ``gpipe`` on the ``pod`` axis of a 2 x 4 mesh, and with the stage's
  product on the matmul kernel's wrapper (its plain version here);
* ``pipeline_bubble_fraction`` and ``best_microbatch_count`` equal to the
  reference's;
* on a CUDA card (marked ``cuda``): four stages on one GPU, each on its
  own stream, the products on the matmul kernel, bit for bit the
  sequential stages (the kernel's rows do not depend on the batch).
"""

import numpy as np
import pytest

from torch_mesh_reference import needs_reference, run_reference

torch = pytest.importorskip("torch")

from repro_torch.distributed import make_mesh  # noqa: E402
from repro_torch.distributed.pipeline import (  # noqa: E402
    best_microbatch_count,
    gpipe,
    pipeline_bubble_fraction,
)
from repro_torch.kernels import ops  # noqa: E402

S, MB, D = 4, 3, 8

_REFERENCE = """
from repro.distributed.pipeline import gpipe

mesh = auto_mesh((4,), ("pod",))
S, mb, d = 4, 3, 8
key = jax.random.PRNGKey(0)
ws = jax.random.normal(key, (S, d, d)) * 0.3
bs = jax.random.normal(jax.random.fold_in(key, 1), (S, d)) * 0.1
OUT["ws"], OUT["bs"] = ws, bs


def stage(params, h):
    w, b = params
    return jnp.tanh(h @ w + b)


for m in (6, 8):
    x = jax.random.normal(jax.random.fold_in(key, 2 + m), (m, mb, d))
    OUT[f"x{m}"] = x
    OUT[f"out{m}"] = gpipe(stage, (ws, bs), x, mesh, "pod")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return run_reference(_REFERENCE, tmp_path_factory.mktemp("ref") /
                         "pipe.npz", devices=4)


def _stage(params, h):
    w, b = params
    return torch.tanh(h @ w + b)


def _kernel_stage(params, h):
    w, b = params
    return torch.tanh(ops.matmul(h, w) + b)


def _sequential(stage, ws, bs, x):
    out = []
    for mb in x:
        for s in range(ws.shape[0]):
            mb = stage((ws[s], bs[s]), mb)
        out.append(mb)
    return torch.stack(out)


@needs_reference
@pytest.mark.parametrize("m", [6, 8])
def test_gpipe_matches_reference_and_sequential(reference, m):
    ws = torch.from_numpy(reference["ws"])
    bs = torch.from_numpy(reference["bs"])
    x = torch.from_numpy(reference[f"x{m}"])
    mesh = make_mesh({"pod": S}, device="cpu", shards_per_device=S)
    got = gpipe(_stage, (ws, bs), x, mesh, "pod")
    assert got.shape == (m, MB, D)
    np.testing.assert_allclose(got.numpy(), reference[f"out{m}"], atol=1e-5,
                               rtol=1e-5)
    assert torch.equal(got, _sequential(_stage, ws, bs, x))


@pytest.mark.parametrize("stage", [_stage, _kernel_stage],
                         ids=["torch", "kernel"])
def test_gpipe_on_one_axis_of_a_two_axis_mesh(stage):
    g = torch.Generator().manual_seed(1)
    ws = torch.randn(S, D, D, generator=g) * 0.3
    bs = torch.randn(S, D, generator=g) * 0.1
    x = torch.randn(5, MB, D, generator=g)
    mesh = make_mesh({"data": 2, "pod": S}, device="cpu", shards_per_device=8)
    got = gpipe(stage, (ws, bs), x, mesh, "pod")
    assert torch.equal(got, _sequential(stage, ws, bs, x))


@needs_reference
def test_bubble_and_microbatch_count_match_reference():
    from repro.distributed import pipeline as j_pipeline

    for s in (1, 2, 4, 8):
        for m in (1, 4, 8, 29, 64):
            assert pipeline_bubble_fraction(s, m) == \
                j_pipeline.pipeline_bubble_fraction(s, m)
        for budget in (0.05, 0.1, 0.3):
            assert best_microbatch_count(s, 1024, bubble_budget=budget) == \
                j_pipeline.best_microbatch_count(s, 1024,
                                                 bubble_budget=budget)
    assert pipeline_bubble_fraction(4, 4) == pytest.approx(3 / 7)
    m = best_microbatch_count(4, 1024, bubble_budget=0.1)
    assert pipeline_bubble_fraction(4, m) <= 0.1 < \
        pipeline_bubble_fraction(4, m - 1)


@pytest.mark.cuda
def test_gpipe_on_four_stages_of_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_pipeline.py`")
    from repro_torch.kernels.matmul import LAUNCHES

    g = torch.Generator(device="cuda").manual_seed(0)
    d = 1024
    ws = torch.randn(S, d, d, generator=g, device="cuda") * d ** -0.5
    bs = torch.randn(S, d, generator=g, device="cuda") * 0.1
    x = torch.randn(8, 64, d, generator=g, device="cuda")
    mesh = make_mesh({"pod": S}, shards_per_device=S)
    before = LAUNCHES.count
    got = gpipe(_kernel_stage, (ws, bs), x, mesh, "pod")
    assert LAUNCHES.count - before == S * x.shape[0]
    assert got.is_cuda
    assert torch.equal(got, _sequential(_kernel_stage, ws, bs, x))
