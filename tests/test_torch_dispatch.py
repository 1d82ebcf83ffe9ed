"""The paper's adaptive matmul dispatch, port against reference.

``adaptive_matmul(use_kernel=True)`` takes the serial path in both packages
(the reference's Pallas kernel in interpret mode, the port's kernel's plain
version on CPU tensors) and gives the same product (rtol = atol = 1e-5,
fp32); ``decide_matmul`` gives the same strategy and predicted seconds
when both engines are built from the same ``HardwareSpec`` fields.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.core.dispatch import adaptive_matmul as j_adaptive  # noqa: E402
from repro.core.dispatch import decide_matmul as j_decide  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.hw import HardwareSpec as JSpec  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.core.dispatch import adaptive_matmul, decide_matmul  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402


def _engines(spec_fields):
    return (JCostEngine(hw=JSpec.from_dict(spec_fields)),
            CostEngine(hw=HardwareSpec.from_dict(spec_fields)))


@pytest.mark.parametrize("m,k,n", [(64, 48, 80), (37, 130, 9)])
def test_adaptive_matmul_kernel_serial_path_matches(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    jeng, eng = _engines(V5E.to_dict())
    want, jrep = j_adaptive(jnp.asarray(a), jnp.asarray(b), engine=jeng,
                            use_kernel=True, interpret=True,
                            return_report=True)
    got, rep = adaptive_matmul(torch.from_numpy(a), torch.from_numpy(b),
                               engine=eng, use_kernel=True, return_report=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert rep.chosen.strategy == jrep.chosen.strategy == "serial"
    assert rep.chosen.total == pytest.approx(jrep.chosen.total, rel=1e-9)
    assert [e.site for e in eng.ledger.entries] == ["matmul"]


@pytest.mark.parametrize("spec", ["v5e", "h100"])
@pytest.mark.parametrize("order,chips,io", [
    (256, 1, True), (1024, 4, True), (8192, 4, True), (8192, 8, False),
    (300, 16, False)])
def test_decide_matmul_same_strategy_and_seconds(spec, order, chips, io):
    fields = (V5E if spec == "v5e" else H100).to_dict()
    jeng, eng = _engines(fields)
    want = j_decide(order, order, order, chips=chips, engine=jeng,
                    io_at_master=io)
    got = decide_matmul(order, order, order, chips=chips, engine=eng,
                        io_at_master=io)
    assert got.chosen.strategy == want.chosen.strategy
    assert got.chosen.total == pytest.approx(want.chosen.total, rel=1e-9)
    assert got.serial.total == pytest.approx(want.serial.total, rel=1e-9)


def test_sharded_paths_raise_in_the_single_gpu_slice():
    a = torch.ones((4, 4))
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        adaptive_matmul(a, a, mesh=object())
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        adaptive_matmul(a, a, force_strategy="shard_k")
