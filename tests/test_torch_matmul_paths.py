"""The matmul kernel's three paths (``repro_torch.kernels.matmul``).

On the CPU: the path is a function of the operands' dtypes alone and the
tile of N alone (never of M or the batch), the TMA-eligibility of every
operand form the wrapper is given, ``split_hi_lo``, and the split product
``hi @ b + lo @ b`` against the reference's Pallas kernel (interpret mode)
on the same numpy inputs.

On a card (marked ``cuda``; skipped elsewhere): each path against the
plain version on the operand forms of the main paths (row-major weights,
``table.t()``, ``a.t()``, the 4-D cache permutes, a ragged shape no tensor
map can describe), launching the path ``choose_path`` names; and the
batch-invariance contract bit for bit: row ``i`` of a product of ``M``
rows equals that row multiplied alone, for every path and epilogue, with
transposed and 4-D operands, and for both tile widths.
"""

import numpy as np
import pytest

from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

from repro_torch.kernels import matmul as mm  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
BF16_TOL = 8e-3  # x max|plain|: about one bf16 rounding
F32_TOL = 1e-5   # x max|plain|
SPLIT_TOL = 1e-5  # x max|plain| of an fp32 result of the split product


# ----------------------------------------------------------------- CPU


@settings(max_examples=60, deadline=None)
@given(m=st.integers(1, 300), n=st.integers(1, 9000), k=st.integers(1, 300),
       z=st.integers(1, 6),
       dts=st.sampled_from([(BF16, BF16), (F32, BF16), (BF16, F32),
                            (F32, F32)]),
       b_t=st.sampled_from([False, True]))
def test_path_and_tile_never_depend_on_rows_or_batch(m, n, k, z, dts, b_t):
    """The path comes from the dtypes alone and the tile width from N
    alone: the same for every M and Z, and for any operand strides."""
    a_dt, b_dt = dts

    def plan(rows, batch):
        a = torch.empty((batch, 1, rows, k), dtype=a_dt)
        b = torch.empty((batch, 1, n, k), dtype=b_dt).transpose(-1, -2) \
            if b_t else torch.empty((batch, 1, k, n), dtype=b_dt)
        return mm.choose_path(a.dtype, b.dtype), mm.tile_n(b.shape[-1])

    got = plan(m, z)
    assert plan(1, 1) == plan(4096, 3) == got
    want = {(BF16, BF16): "tensor_core", (F32, F32): "fma"}.get(dts, "split")
    assert got == (want, 128 if n >= 4096 else 64)


def test_unknown_dtypes_are_refused():
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        mm.choose_path(torch.float16, BF16)


def _aligned(t):
    return t.data_ptr() % 16 == 0


def test_tma_eligibility_of_the_wrappers_operand_forms():
    """(mn_major, tma) of what the wrapper is really given."""
    x = torch.empty((4096, 2048), dtype=BF16)            # activations
    w = torch.empty((2048, 5632), dtype=BF16)            # a weight (K, N)
    table = torch.empty((32000, 2048), dtype=BF16)       # embedding table
    assert _aligned(x) and _aligned(w) and _aligned(table)
    assert mm.operand_mode(x, "a") == (False, True)      # K-major A
    assert mm.operand_mode(w, "b") == (True, True)       # N-major B
    assert mm.operand_mode(table.t(), "b") == (False, True)  # unembed
    assert mm.operand_mode(x.t(), "a") == (True, True)   # aᵀ in dB = aᵀ dz
    assert mm.operand_mode(w.t(), "b") == (False, True)  # bᵀ in dA = dz bᵀ
    assert mm.operand_mode(x[:1], "a") == (False, True)  # decode, M = 1
    # the decode-attention contractions: (B, Smax, Hkv, hd) caches
    cache = torch.empty((4, 96, 4, 64), dtype=BF16)
    assert mm.operand_mode(cache.permute(0, 2, 3, 1), "b") == (False, True)
    assert mm.operand_mode(cache.permute(0, 2, 1, 3), "b") == (True, True)
    q = torch.empty((4, 4, 8, 64), dtype=BF16)
    assert mm.operand_mode(q, "a") == (False, True)
    # chip_smoke's ragged 37 x 129 x 65: pitches of 130 and 258 bytes
    a, b = torch.empty((37, 65), dtype=BF16), torch.empty((65, 129),
                                                          dtype=BF16)
    assert mm.operand_mode(a, "a") == (False, False)
    assert mm.operand_mode(b, "b") == (True, False)
    # a view whose base is off 16 bytes, and one with no unit stride
    assert mm.operand_mode(x[:, 1:], "a") == (False, False)
    assert mm.operand_mode(x[:, ::2], "a") == (False, False)
    # a single column sliced from a transposed operand: unaligned base
    assert mm.operand_mode(x.t()[3:4], "a")[1] is False


@settings(max_examples=40, deadline=None)
@given(exp=st.integers(-60, 60), seed=st.integers(0, 10_000))
def test_split_hi_lo_reconstructs_x(exp, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((64, 33)) * 2.0 ** exp)
                         .astype(np.float32))
    hi, lo = mm.split_hi_lo(x)
    assert hi.dtype == lo.dtype == BF16
    assert hi.stride() == lo.stride() == x.stride()
    resid = (x.double() - hi.double() - lo.double()).abs()
    assert bool((resid <= 2.0 ** -16 * x.double().abs()).all())


def test_split_hi_lo_zeros_and_non_finite():
    x = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"),
                      1.0, 3e38, -1e-30], dtype=F32)
    hi, lo = mm.split_hi_lo(x)
    assert hi[0] == 0 and lo[0] == 0 and hi[1] == 0 and lo[1] == 0
    assert hi[2] == float("inf") and lo[2] == 0
    assert hi[3] == -float("inf") and lo[3] == 0
    assert torch.isnan(hi[4]) and lo[4] == 0
    assert bool(torch.isfinite(lo).all())
    s = hi.float() + lo.float()
    assert s[5] == 1.0 and s[2] == float("inf") and torch.isnan(s[4])
    # strides follow x, transposed or not
    xt = torch.randn(5, 7).t()
    assert mm.split_hi_lo(xt)[1].stride() == xt.stride()


@pytest.mark.parametrize("side", ["a", "b"])
@pytest.mark.parametrize("activation", [None, "silu"])
def test_split_product_matches_reference_kernel(side, activation):
    """The split path's arithmetic, hi @ b + lo @ b summed in fp32 (here by
    the plain version on the CPU), against the reference's Pallas kernel in
    interpret mode on the same numpy inputs (the fp32 operand as given, the
    other rounded to bf16 first on both sides).  Limit 1e-5 x max: the
    split's residual is below 2^-17 |x| a term."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    rng = np.random.default_rng(7 + (side == "b") + 2 * (activation is None))
    m, k, n = 37, 200, 129
    x32 = rng.standard_normal((m, k) if side == "a" else (k, n)) \
        .astype(np.float32)
    other = torch.from_numpy(rng.standard_normal(
        (k, n) if side == "a" else (m, k)).astype(np.float32) / np.sqrt(k)) \
        .to(BF16)
    other_np = other.float().numpy()
    a_np, b_np = (x32, other_np) if side == "a" else (other_np, x32)
    want = np.asarray(jops.matmul(jnp.asarray(a_np), jnp.asarray(b_np),
                                  activation=activation, interpret=True))
    hi, lo = mm.split_hi_lo(torch.from_numpy(x32))
    if side == "a":
        z = ref.matmul_ref(hi, other, F32) + ref.matmul_ref(lo, other, F32)
    else:
        z = ref.matmul_ref(other, hi, F32) + ref.matmul_ref(other, lo, F32)
    got = z if activation is None else ref.EPILOGUES[activation](z)
    top = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= SPLIT_TOL * top
    # and the port's entry on the CPU (the plain version) agrees as well
    a_t = torch.from_numpy(a_np) if side == "a" else other
    b_t = other if side == "a" else torch.from_numpy(b_np)
    plain = ops.matmul(a_t, b_t, activation=activation, out_dtype=F32)
    assert np.abs(plain.numpy() - want).max() <= SPLIT_TOL * top


def test_cpu_tensors_launch_nothing():
    before = (mm.LAUNCHES.count, dict(mm.LAUNCHES.by_path))
    ops.matmul(torch.ones((3, 4), dtype=BF16), torch.ones((4, 5)))
    assert (mm.LAUNCHES.count, mm.LAUNCHES.by_path) == before
    assert set(mm.LAUNCHES.by_path) == set(mm.PATHS)


# ---------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_matmul_paths.py`")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rand(gen, *shape, dtype=F32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale) \
        .to(dtype)


def _forms(gen):
    """(name, a, b, kwargs): the operand forms of the main paths, one
    product each, at real widths (tinyllama-1.1b's)."""
    x = _rand(gen, 300, 2048, dtype=BF16)
    w = _rand(gen, 2048, 5632, dtype=BF16, scale=2048 ** -0.5)
    wo = _rand(gen, 2048, 2048, dtype=BF16, scale=2048 ** -0.5)
    table = _rand(gen, 32000, 2048, dtype=BF16, scale=0.02)
    dz = _rand(gen, 300, 5632)
    cache = _rand(gen, 4, 96, 4, 64, dtype=BF16)
    qg = _rand(gen, 4, 4, 8, 64)
    probs = torch.softmax(_rand(gen, 4, 4, 8, 96), -1)
    return [
        ("proj silu", x, w, dict(activation="silu")),
        ("proj wo", x, wo, {}),
        ("unembed table.t()", x[:4], table.t(), dict(out_dtype=F32)),
        ("z recompute fp32 out", x, w, dict(out_dtype=F32)),
        ("dA = dz bᵀ (split A)", dz, w.t(), dict(out_dtype=BF16)),
        ("dB = aᵀ dz (split B)", x.t(), dz, dict(out_dtype=BF16)),
        ("aᵀ bf16 (MN-major A)", x.t(), _rand(gen, 300, 2048, dtype=BF16), {}),
        ("decode q.k (split, 4-D)", qg, cache.permute(0, 2, 3, 1),
         dict(out_dtype=F32)),
        ("decode p.v (split, 4-D)", probs, cache.permute(0, 2, 1, 3),
         dict(out_dtype=F32)),
        ("ragged 37x129x65 bias gelu", _rand(gen, 37, 65, dtype=BF16),
         _rand(gen, 65, 129, dtype=BF16),
         dict(bias=_rand(gen, 129), activation="gelu")),
        ("fp32 rmsnorm sum", _rand(gen, 300, 2048) ** 2,
         torch.ones(2048, 1, device="cuda"), {}),
    ]


@pytest.mark.cuda
def test_each_path_matches_plain_on_card():
    gen = _card()
    for name, a, b, kw in _forms(gen):
        path = mm.choose_path(a.dtype, b.dtype)
        before = mm.LAUNCHES.by_path[path]
        got = ops.matmul(a, b, **kw)
        assert mm.LAUNCHES.by_path[path] == before + 1, name
        want = ref.matmul_fused_ref(a, b, **kw)
        tol = BF16_TOL if want.dtype == BF16 else F32_TOL
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (name, err)


def _invariance_cases(gen, n):
    """(name, a of 4096 rows, b, kwargs): every path and epilogue, with
    transposed operands; a product takes a[:m], a row alone a[i:i + 1]."""
    k = 320
    x = _rand(gen, 4096, k, dtype=BF16)
    xt = _rand(gen, k, 4096, dtype=BF16).t()    # MN-major A
    w = _rand(gen, k, n, dtype=BF16, scale=k ** -0.5)
    x32 = _rand(gen, 4096, k)
    bias = _rand(gen, n)
    cases = [(f"tensor_core {act}", x, w, dict(activation=act))
             for act in (None, "relu", "gelu", "silu", "tanh")]
    cases += [
        ("tensor_core bias+silu", x, w, dict(bias=bias, activation="silu")),
        ("tensor_core aᵀ", xt, w, {}),
        ("tensor_core bᵀ fp32 out", x, w.t().contiguous().t(),
         dict(out_dtype=F32)),
        ("split A", x32, w, dict(out_dtype=BF16, activation="gelu")),
        ("split A fp32 out", x32, w, dict(out_dtype=F32)),
        ("split B (aᵀ dz)", xt, _rand(gen, k, n), dict(out_dtype=BF16)),
        ("fma", x32, _rand(gen, k, n), dict(activation="tanh")),
    ]
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("n", [320, 4096])  # tile_n 64 and 128
def test_rows_are_batch_invariant_on_card(n):
    gen = _card()
    for name, a, b, kw in _invariance_cases(gen, n):
        for m in (1, 3, 4, 8, 16, 17, 64, 255, 4096):
            whole = ops.matmul(a[:m], b, **kw)
            for i in sorted({0, m // 2, m - 1}):
                alone = ops.matmul(a[i:i + 1], b, **kw)
                assert torch.equal(whole[i:i + 1], alone), (name, m, i)
    # 4-D: the decode-attention contractions (split A), one query row alone
    cache = _rand(gen, 4, 96, 4, 64, dtype=BF16)
    for q, bb in ((_rand(gen, 4, 4, 17, 64), cache.permute(0, 2, 3, 1)),
                  (torch.softmax(_rand(gen, 4, 4, 17, 96), -1),
                   cache.permute(0, 2, 1, 3))):
        for m in (1, 4, 17):
            whole = ops.matmul(q[:, :, :m], bb, out_dtype=F32)
            for i in sorted({0, m - 1}):
                alone = ops.matmul(q[:, :, i:i + 1], bb, out_dtype=F32)
                assert torch.equal(whole[:, :, i:i + 1], alone), (m, i)


@pytest.mark.cuda
def test_copied_operands_counted_on_card():
    """``LAUNCHES.copied_operands`` counts the tensor-core operands no
    tensor map loads (a pitch of 2049 bf16 is not a multiple of 16 bytes),
    none for a fresh split operand, and never on the FMA path."""
    gen = _card()
    w = _rand(gen, 2048, 512, dtype=BF16, scale=2048 ** -0.5)
    odd = _rand(gen, 300, 2049, dtype=BF16)[:, :2048]
    cases = [(_rand(gen, 300, 2048, dtype=BF16), w, 0), (odd, w, 1),
             (odd.float(), w, 0), (odd.float(), w.float(), 0)]
    for a, b, copied in cases:
        before = mm.LAUNCHES.copied_operands
        got = ops.matmul(a, b, out_dtype=F32)
        assert mm.LAUNCHES.copied_operands - before == copied, (a.dtype,
                                                                a.stride())
        want = ref.matmul_fused_ref(a, b, out_dtype=F32)
        err = (got - want).abs().max().item()
        assert err <= F32_TOL * want.abs().max().item(), err


@pytest.mark.cuda
def test_both_tile_widths_give_the_same_bits(monkeypatch):
    """Every tile width the kernel can pick gives a row the same bits."""
    gen = _card()
    a = _rand(gen, 300, 512, dtype=BF16)
    a32 = _rand(gen, 300, 512)
    b = _rand(gen, 512, 4096, dtype=BF16, scale=512 ** -0.5)
    outs = {}
    for width in (64, 128):
        monkeypatch.setattr(mm, "tile_n", lambda n, w=width: w)
        outs[width] = (ops.matmul(a, b, activation="silu"),
                       ops.matmul(a32, b, out_dtype=F32))
    for x, y in zip(outs[64], outs[128]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("shape", [((37, 9000), (9000, 65)),
                                   ((2, 3, 5, 4097), (2, 3, 4097, 17))],
                         ids=["2d", "4d"])
def test_k_blocked_fp32_product_equals_one_product(shape, monkeypatch):
    """An fp32 result on a tensor-core path with K above TC_K_BLOCK runs as
    launches over consecutive K blocks, added in k order: with the plain
    version as the launch, one launch a block, the blocks' last one
    ragged, the bias in the first block only, and the sum within 1e-5 x
    max of one product (fp32, another order of the sums)."""
    ash, bsh = shape
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(ash, generator=gen).to(torch.bfloat16)
    b = torch.randn(bsh, generator=gen).to(torch.bfloat16)
    bias = torch.randn((bsh[-1],), generator=gen)
    seen = []

    def launch(x, y, bias=None, activation=None, out_dtype=None):
        seen.append((x.shape[-1], y.shape[-2], bias is not None, activation,
                     out_dtype))
        return ref.matmul_fused_ref(x, y, bias=bias, out_dtype=out_dtype)

    monkeypatch.setattr(ops, "matmul_cuda", launch)
    got = ops.k_blocked(a, b, bias)
    k = ash[-1]
    assert [s[0] for s in seen] == [min(ops.TC_K_BLOCK, k - k0) for k0 in
                                    range(0, k, ops.TC_K_BLOCK)]
    assert [s[2] for s in seen] == [True] + [False] * (len(seen) - 1)
    assert all(s[0] == s[1] and s[3] is None and s[4] == torch.float32
               for s in seen)
    want = ref.matmul_fused_ref(a, b, bias=bias, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    top = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * top


def test_k_blocked_refuses_an_activation(monkeypatch):
    """The K blocks' sum has no fused epilogue: an activation raises
    before any launch."""
    monkeypatch.setattr(ops, "matmul_cuda", lambda *a, **kw: pytest.fail(
        "launched"))
    a = torch.zeros((2, ops.TC_K_BLOCK + 1), dtype=torch.bfloat16)
    b = torch.zeros((ops.TC_K_BLOCK + 1, 3), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="no fused"):
        ops.k_blocked(a, b, activation="gelu")
