"""The port's matmul (``repro_torch.kernels.ops.matmul``) against the
reference's Pallas kernel (``repro.kernels.ops.matmul``, interpret mode),
on the same numpy inputs.

On CPU tensors the port runs the kernel's plain PyTorch version; the CUDA
kernel itself is held against that version in test_torch_isolation.py (on
a card) and by chip_smoke.py.  Tolerance: rtol = atol = 1e-5 in fp32 (both
sides accumulate in fp32; only the summation order differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.matmul import LAUNCHES  # noqa: E402

K, N = 200, 129  # neither a multiple of 128: the ragged edges


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "tanh"])
@pytest.mark.parametrize("m", [1, 4, 37])
def test_matmul_matches_reference_kernel(m, activation, bias):
    rng = np.random.default_rng(m * 10 + len(str(activation)) + bias)
    a = rng.standard_normal((m, K)).astype(np.float32)
    b = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    c = rng.standard_normal((N,)).astype(np.float32) if bias else None
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b),
                       bias=None if c is None else jnp.asarray(c),
                       activation=activation, interpret=True)
    launches = LAUNCHES.count
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                     bias=None if c is None else torch.from_numpy(c),
                     activation=activation)
    assert LAUNCHES.count == launches  # CPU tensors never launch the kernel
    assert got.shape == (m, N) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_batched_strided_operands_match_per_matrix_products():
    """4-D operands read through their strides (the cached-attention
    contractions) equal the per-matrix 2-D products."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((3, 2, 5, 16)).astype(np.float32))
    cache = torch.from_numpy(
        rng.standard_normal((3, 11, 2, 16)).astype(np.float32))
    got = ops.matmul(q, cache.permute(0, 2, 3, 1))  # B is a strided view
    assert got.shape == (3, 2, 5, 11)
    for i in range(3):
        for j in range(2):
            want = ops.matmul(q[i, j].contiguous(),
                              cache[i, :, j].t().contiguous())
            np.testing.assert_allclose(got[i, j].numpy(), want.numpy(),
                                       rtol=1e-6, atol=1e-6)


def test_out_dtype_and_unknown_activation():
    a = torch.ones((3, 4), dtype=torch.bfloat16)
    b = torch.ones((4, 5), dtype=torch.bfloat16)
    assert ops.matmul(a, b).dtype == torch.bfloat16
    out = ops.matmul(a, b, out_dtype=torch.float32)
    assert out.dtype == torch.float32 and torch.all(out == 4.0)
    with pytest.raises(ValueError, match="activation"):
        ops.matmul(a, b, activation="softplus")
