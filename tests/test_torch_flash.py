"""The port's flash attention and the matmul's backward against the
reference and against autograd of the plain versions, on seeded numpy
inputs, on the CPU.

* forward: the flash kernel's plain version (``flash_attention_fwd_plain``,
  which is what a CPU tensor runs) against the reference's Pallas kernel
  in interpret mode (``repro.kernels.ops.flash_attention``) and against
  ``flash_attention_ref``, with GQA and S not a multiple of the block;
  tolerance 2e-3 (tests/test_kernels.py's for flash);
* backward: ``FlashAttentionFn`` on the CPU (the kernels' plain versions
  in their place) against torch.autograd through ``dense_attention``,
  atol 1e-5 (fp32, another summation order);
* ``MatmulFn`` with each epilogue and a bias against autograd of
  ``matmul_fused_ref``, atol 1e-5;
* the batched (4-D) ``ops.matmul`` takes a gradient through ``MatmulFn``
  (its backward on the kernel on a card) equal to autograd of
  ``matmul_fused_ref``;
* ``choose_path`` picks the tensor-core kernels for bf16 at hd 64, 96,
  128 and 256 and the FMA kernels otherwise (fp32, bf16 at hd 16 and 32),
  from the dtype and hd alone, and the backward takes every head dim the
  forward takes;
* the tensor-core kernels' two decompositions at the new head dims, on
  the plain versions: hd 96 zero-padded to 128 (and scaled by 96^-0.5)
  and sliced back gives the same forward and backward, and dK/dV taken
  in two hd halves from the full-hd P and dS (hd 256's split between
  warpgroups) equals the whole; both held against the reference's
  ``flash_attention_ref`` and ``jax.grad`` of it (1e-5 absolute between
  the plain versions, 2e-4 against the reference's fp32 on the CPU);
* the ``cuda``-marked tests hold the kernels against their plain versions
  on a card, forward and backward, causal and not, on the path their
  dtype and hd name (fp32 within 2e-3 x max|plain|, bf16 outputs element
  by element within 8e-3 x their row's max|plain| + 1e-5 x max|plain|, the
  rule of chip_smoke.py's phase 7), hold kernel forward then kernel
  backward against plain forward then plain backward (gradients within
  2e-3 x max|plain| in fp32, 2e-2 x in bf16), at every head dim (the FMA
  tensor-core kernels at hd 96 and 256 among them), check that the
  backward's bits repeat, that operands no tensor map describes go
  through the copy loader (its zero columns at hd 96 too), and that the 4-D matmul's gradients match autograd of the plain
  product; they skip elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.matmul import LAUNCHES as MM_LAUNCHES  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402

try:  # the reference; a card machine without jax runs only the cuda tests
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
except ImportError:
    jops = None

needs_reference = pytest.mark.skipif(
    jops is None, reason="needs jax and the reference package")

FLASH_TOL = 2e-3
GRAD_ATOL = 1e-5
# (B, S, Hq, Hkv, hd): GQA groups of 2 and 4, MHA, S below, across and
# not a multiple of the 64-row block, and of the reference's 128; phi3's
# hd 96 and gemma's hd 256 (the FMA backward's 32-row kv tiles there)
SHAPES = [(2, 100, 4, 2, 16), (1, 130, 8, 2, 32), (2, 64, 4, 4, 16),
          (1, 7, 2, 1, 16), (1, 70, 4, 4, 96), (2, 45, 2, 1, 256)]


def _qkv(shape, seed):
    b, s, hq, hkv, hd = shape
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, hd)).astype(np.float32)
                 for h in (hq, hkv, hkv))


def _fold(x, hq):
    """(B, S, H, hd) -> (B*hq, S, hd), kv heads repeated as the reference's
    wrapper does."""
    b, s, h, hd = x.shape
    x = np.repeat(x, hq // h, axis=2)
    return x.transpose(0, 2, 1, 3).reshape(b * hq, s, hd)


@needs_reference
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_forward_matches_reference_kernel(shape):
    q, k, v = _qkv(shape, sum(shape))
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        interpret=True))
    launches = fa.LAUNCHES.forward
    out, lse = ref.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v))
    assert fa.LAUNCHES.forward == launches  # CPU tensors never launch
    assert torch.equal(got, out)
    assert got.shape == q.shape and lse.shape == (shape[0], shape[2],
                                                  shape[1])
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                               rtol=FLASH_TOL)
    hq = shape[2]
    oracle = np.asarray(jref.flash_attention_ref(
        jnp.asarray(_fold(q, hq)), jnp.asarray(_fold(k, hq)),
        jnp.asarray(_fold(v, hq))))
    np.testing.assert_allclose(_fold(got.numpy(), hq), oracle,
                               atol=FLASH_TOL, rtol=FLASH_TOL)
    port_oracle = ref.flash_attention_ref(
        *(torch.from_numpy(_fold(t, hq)) for t in (q, k, v)))
    np.testing.assert_allclose(port_oracle.numpy(), oracle, atol=1e-5,
                               rtol=0)
    # the log-sum-exp is the softmax's normaliser, row by row
    scale = shape[4] ** -0.5
    qf, kf = _fold(q, hq) * scale, _fold(k, hq)
    sc = np.einsum("bqd,bkd->bqk", qf, kf)
    sc = np.where(np.tril(np.ones(sc.shape[1:], bool))[None], sc, -np.inf)
    lse_want = np.log(np.exp(sc - sc.max(-1, keepdims=True)).sum(-1)) + \
        sc.max(-1)
    np.testing.assert_allclose(lse.numpy().reshape(lse_want.shape), lse_want,
                               atol=1e-5, rtol=0)


@needs_reference
def test_flash_non_causal_matches_reference_kernel():
    q, k, v = _qkv((2, 37, 4, 2, 16), 5)
    k, v = k[:, :29], v[:, :29]  # Skv != S is fine without the mask
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False,
        interpret=True))
    got = attn.attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=False, impl="flash")
    np.testing.assert_allclose(got.numpy(), want, atol=FLASH_TOL,
                               rtol=FLASH_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_backward_matches_autograd_of_dense(shape):
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv(shape, 7 + sum(shape)))
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        q.shape).astype(np.float32))
    (attn.attention(q, k, v, impl="flash") * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (attn.dense_attention(q, k, v) * w).sum().backward()
    for name, g, t in zip("qkv", got, (q, k, v)):
        assert g.shape == t.shape
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=GRAD_ATOL,
                                   rtol=0, err_msg=f"d{name}")


def test_flash_bwd_plain_is_the_closed_form():
    """``flash_attention_bwd_plain`` from the forward's lse equals autograd
    through the plain forward itself."""
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv((1, 70, 4, 2, 16), 3))
    o, lse = ref.flash_attention_fwd_plain(q, k, v)
    do = torch.randn(o.shape, generator=torch.Generator().manual_seed(0))
    o.backward(do)
    dq, dk, dv = ref.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), o.detach(), lse.detach(), do)
    for got, t in zip((dq, dk, dv), (q, k, v)):
        np.testing.assert_allclose(got.numpy(), t.grad.numpy(),
                                   atol=GRAD_ATOL, rtol=0)


def test_flash_rejects_what_it_does_not_compute():
    q = torch.zeros((1, 8, 4, 16))
    kv = torch.zeros((1, 6, 2, 16))
    with pytest.raises(ValueError, match="S == Skv"):
        ops.flash_attention(q, kv, kv)  # causal S != Skv
    with pytest.raises(ValueError, match="S == Skv"):
        attn.attention(q, kv, kv, impl="flash")
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="sliding windows"):
        attn.attention(q, q, q, window=4, impl="flash")
    with pytest.raises(ValueError, match="impl"):
        attn.attention(q, q, q, impl="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd_cuda(q, q, q)  # never the plain path
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_bwd_cuda(q, q, q, q, torch.zeros((1, 4, 8)), q)


@pytest.mark.parametrize("hd", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_choose_path_by_dtype_and_head_dim(dtype, hd):
    """bf16 at hd 64, 96, 128 and 256 takes the tensor cores, everything
    else (fp32, bf16 at hd 16 and 32) the FMA kernels; B, S and the heads
    never enter (the function takes neither)."""
    want = "tensor_core" if dtype == torch.bfloat16 and hd in (64, 96, 128,
                                                               256) \
        else "fma"
    assert fa.choose_path(dtype, hd) == want
    assert want in fa.PATHS


def test_choose_path_rejects_what_no_kernel_takes():
    """No kernel takes fp16 or hd 48.  The backward takes every head dim
    the forward takes: at hd 96 and 256 (bf16 on the tensor cores, fp32 on
    the FMA kernels) its wrapper does not refuse the head dim, and stops
    only at what every head dim needs, a CUDA tensor."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.choose_path(torch.float16, 64)
    with pytest.raises(ValueError, match="head dim"):
        fa.choose_path(torch.bfloat16, 48)
    assert fa.BWD_HEAD_DIMS == fa.HEAD_DIMS
    for hd in (96, 256):
        for dtype in (torch.float32, torch.bfloat16):
            want = "tensor_core" if dtype == torch.bfloat16 else "fma"
            assert fa.choose_path(dtype, hd) == want
            q = torch.zeros((1, 4, 2, hd), dtype=dtype)
            lse = torch.zeros((1, 2, 4))
            with pytest.raises(ValueError, match="needs CUDA tensors"):
                fa.flash_attention_bwd_cuda(q, q, q, q, lse, q)


# the plain versions against the reference: 1e-5 between two plain
# computations of one function (fp32, another summation order), 2e-4
# against the reference's fp32 oracle (XLA's CPU sums in another order,
# over up to 256 terms of order 1)
DECOMP_ATOL, DECOMP_REF_TOL = 1e-5, 2e-4
# (B, S, Hq, Hkv, hd, Skv, causal) for the decompositions: causal GQA and
# MQA, and a non-causal one with Skv != S
DECOMP_SHAPES = [(2, 70, 4, 2, 96, 70, True), (1, 37, 4, 4, 96, 45, False),
                 (2, 45, 4, 1, 256, 45, True), (1, 29, 2, 2, 256, 40, False)]


def _decomp_inputs(shape, seed):
    b, s, hq, hkv, hd, skv, _ = shape
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((b, s, hq, hd))
                              .astype(np.float32)) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, hd))
                             .astype(np.float32)) for _ in range(2))
    return q, k, v, do


def _reference_grads(q, k, v, do, causal):
    """The reference's ``flash_attention_ref`` on heads folded as its
    wrapper folds them, and ``jax.grad`` of <o, do> through it: (o, dq, dk,
    dv) back in (B, S, H, hd), dk and dv summed over each kv head's group."""
    import jax

    hq, hkv = q.shape[2], k.shape[2]
    b, hd = q.shape[0], q.shape[3]
    fq, fk, fv, fdo = (jnp.asarray(_fold(t.numpy(), hq))
                       for t in (q, k, v, do))

    def loss(a, bb, c):
        return (jref.flash_attention_ref(a, bb, c, causal=causal)
                * fdo).sum()

    o = jref.flash_attention_ref(fq, fk, fv, causal=causal)
    grads = jax.grad(loss, argnums=(0, 1, 2))(fq, fk, fv)

    def unfold(x, heads):
        x = np.asarray(x).reshape(b, hkv, hq // hkv, -1, hd)
        if heads == hkv:
            x = x.sum(axis=2)
        return x.reshape(b, heads, -1, hd).transpose(0, 2, 1, 3)

    return (unfold(o, hq), unfold(grads[0], hq), unfold(grads[1], hkv),
            unfold(grads[2], hkv))


def _dkv_by_hd_halves(q, k, v, o, lse, do, causal):
    """dK and dV as the hd-256 dK/dV kernel takes them: Pᵀ and dSᵀ from the
    full head dim (every warpgroup computes both), then each warpgroup's
    half of the columns, ``dV[:, half] = Pᵀ dO[:, half]`` and ``dK[:, half]
    = scale dSᵀ Q[:, half]``, the halves side by side and each kv head's
    group summed in head order."""
    b, s, hq, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = hd ** -0.5
    qf, kf, vf = ref._heads_first(q, k, v)
    of, dof = (t.float().permute(0, 2, 1, 3) for t in (o, do))
    sc = (qf * scale) @ kf.transpose(-1, -2)
    if causal:
        sc = torch.where(ref._causal_keep(s, torch.arange(skv)), sc,
                         ref.NEG_INF)
    p = torch.exp(sc - lse[..., None])
    ds = p * (dof @ vf.transpose(-1, -2)
              - (dof * of).sum(dim=-1, keepdim=True))
    half = hd // 2
    dv = torch.cat([p.transpose(-1, -2) @ dof[..., c:c + half]
                    for c in (0, half)], dim=-1)
    dk = torch.cat([scale * (ds.transpose(-1, -2) @ qf[..., c:c + half])
                    for c in (0, half)], dim=-1)
    fold = lambda t: t.reshape(b, hkv, hq // hkv, skv, hd).sum(  # noqa: E731
        dim=2).permute(0, 2, 1, 3)
    return fold(dk), fold(dv)


@needs_reference
@pytest.mark.parametrize("shape", [s for s in DECOMP_SHAPES if s[4] == 96],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_hd96_padded_to_128_is_unchanged(shape):
    """The tensor-core kernels run hd 96 on hd-128 tiles whose last 32
    columns are zeros, at the scale of hd 96: the plain forward and
    backward on operands padded so, sliced back to 96 columns, equal the
    unpadded ones (1e-5), and both hold against the reference's
    ``flash_attention_ref`` and ``jax.grad`` of it (2e-4)."""
    causal = shape[6]
    q, k, v, do = _decomp_inputs(shape, sum(shape[:6]))
    hd = q.shape[3]
    pad = lambda t: torch.nn.functional.pad(t, (0, 128 - hd))  # noqa: E731
    o, lse = ref.flash_attention_fwd_plain(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_plain(pad(q), pad(k), pad(v),
                                               causal, sm_scale=hd ** -0.5)
    assert torch.equal(o_p[..., hd:], torch.zeros_like(o_p[..., hd:]))
    grads = ref.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
    grads_p = ref.flash_attention_bwd_plain(
        pad(q), pad(k), pad(v), o_p, lse_p, pad(do), causal,
        sm_scale=hd ** -0.5)
    for name, got, want in [("o", o_p[..., :hd], o), ("lse", lse_p, lse),
                            *((f"d{n}", gp[..., :hd], g) for n, gp, g in
                              zip("qkv", grads_p, grads))]:
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=DECOMP_ATOL, rtol=0, err_msg=name)
    for name, got, want in zip(("o", "dq", "dk", "dv"),
                               (o_p[..., :hd], *(g[..., :hd]
                                                 for g in grads_p)),
                               _reference_grads(q, k, v, do, causal)):
        np.testing.assert_allclose(got.numpy(), want, atol=DECOMP_REF_TOL,
                                   rtol=DECOMP_REF_TOL, err_msg=name)


@needs_reference
@pytest.mark.parametrize("shape", DECOMP_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_dkv_by_hd_halves_equals_the_whole(shape):
    """dK and dV taken in two hd halves from the full-hd P and dS (the
    hd-256 dK/dV kernel's split between its two warpgroups) equal the
    plain backward's (1e-5) and ``jax.grad`` of the reference's
    ``flash_attention_ref`` (2e-4), at hd 96 and 256."""
    causal = shape[6]
    q, k, v, do = _decomp_inputs(shape, 3 + sum(shape[:6]))
    o, lse = ref.flash_attention_fwd_plain(q, k, v, causal)
    dk, dv = _dkv_by_hd_halves(q, k, v, o, lse, do, causal)
    _, want_dk, want_dv = ref.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                        causal)
    np.testing.assert_allclose(dk.numpy(), want_dk.numpy(),
                               atol=DECOMP_ATOL, rtol=0)
    np.testing.assert_allclose(dv.numpy(), want_dv.numpy(),
                               atol=DECOMP_ATOL, rtol=0)
    _, _, ref_dk, ref_dv = _reference_grads(q, k, v, do, causal)
    np.testing.assert_allclose(dk.numpy(), ref_dk, atol=DECOMP_REF_TOL,
                               rtol=DECOMP_REF_TOL)
    np.testing.assert_allclose(dv.numpy(), ref_dv, atol=DECOMP_REF_TOL,
                               rtol=DECOMP_REF_TOL)


def test_tma_ok_reads_strides_and_alignment():
    """A tensor map takes hd-contiguous operands whose other strides step
    16-byte multiples; a strided hd or an odd pitch goes to the copy
    loader."""
    x = torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16)
    assert fa.tma_ok(x)
    assert fa.tma_ok(torch.zeros((2, 8, 1, 64), dtype=torch.bfloat16)
                     .expand(2, 8, 1, 64))
    assert not fa.tma_ok(torch.zeros((2, 8, 4, 128),
                                     dtype=torch.bfloat16)[..., ::2])
    assert not fa.tma_ok(torch.zeros((2, 8, 4, 65),
                                     dtype=torch.bfloat16)[..., :64])
    assert fa.tma_ok(x.transpose(1, 2))  # heads-major storage, hd last


_PTXAS = """\
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async instructions are serialized due to insufficient register resources for the function '_ZN4_GLOBAL18repro_flash_tc_dkvILi128EEEvNS_7BwdArgsE'
ptxas info    : Compiling entry function '_ZN4_GLOBAL18repro_flash_tc_dkvILi128EEEvNS_7BwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL18repro_flash_tc_dkvILi128EEEvNS_7BwdArgsE
    192 bytes stack frame, 316 bytes spill stores, 224 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 192 bytes cumulative stack size
ptxas info    : Compiling entry function '_ZN4_GLOBAL18repro_flash_tc_fwdILi64EEEvNS_7FwdArgsE' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL18repro_flash_tc_fwdILi64EEEvNS_7FwdArgsE
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 154 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN4_GLOBAL9flash_fwdIfLi64EEEvNS_7Tensor4E' for 'sm_90a'
ptxas info    : Function properties for _ZN4_GLOBAL9flash_fwdIfLi64EEEvNS_7Tensor4E
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
"""


def _chip_smoke():
    """chip_smoke.py as a module, with the torch it imports only when run
    as a script."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.torch = torch
    return smoke


def test_chip_smoke_reads_the_flash_ptxas_report():
    """chip_smoke.py's ptxas reader, on a report of the form nvcc -Xptxas
    -v prints: kernels, registers, spills and C75xx notices by path, the
    tensor-core kernels named apart from the FMA ones."""
    smoke = _chip_smoke()
    got = smoke.ptxas_summary(_PTXAS, smoke.FLASH_PTXAS_KINDS)
    assert got["tensor_core"]["kernels"] == 2
    assert got["tensor_core"]["registers"] == [154, 168]
    assert got["tensor_core"]["spill_bytes"] == 316
    assert got["tensor_core"]["notices"] == ["C7512"]
    assert got["tensor_core"]["serialized_wgmma"] == 0  # C7520 only
    assert got["fma"]["kernels"] == 1 and got["fma"]["notices"] == []
    assert smoke.LIBRARY_ATTENTION.search("void flash_fwd_kernel<Flash_fwd")
    assert smoke.LIBRARY_ATTENTION.search("fmha_cutlassB_f32_aligned_64x64")
    assert not any(smoke.LIBRARY_ATTENTION.search(name)
                   for name in smoke.FLASH_ALL_KERNELS.values())
    assert not smoke.LIBRARY_GEMM.search("repro_flash_tc_dkv")


_PTXAS_FMA = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3412flash_bwd_dqI13__nv_bfloat16Li256ELi32EEEvNS_7Tensor4ES2_S2_S2_S2_PKfPfPT_iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3412flash_bwd_dqI13__nv_bfloat16Li256ELi32EEEvNS_7Tensor4ES2_S2_S2_S2_PKfPfPT_iiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 179 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3412flash_bwd_dqIfLi256ELi32EEEvNS_7Tensor4ES1_S1_S1_S1_PKfPfPT_iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3412flash_bwd_dqIfLi256ELi32EEEvNS_7Tensor4ES1_S1_S1_S1_PKfPfPT_iiiifi
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 175 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3413flash_bwd_dkvIfLi96ELi64EEEvNS_7Tensor4ES1_S1_S1_PKfS3_PT_S5_iiiifi' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3413flash_bwd_dkvIfLi96ELi64EEEvNS_7Tensor4ES1_S1_S1_PKfS3_PT_S5_iiiifi
    8 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__04cf38d3_18_flash_attention_cu_dc5cfe3412flash_bwd_dqIfLi64ELi64EEEvNS_7Tensor4ES1_S1_S1_S1_PKfPfPT_iiiifi' for 'sm_90a'
ptxas info    : Used 100 registers, used 1 barriers
"""


def test_chip_smoke_reads_the_new_backward_ptxas_rows():
    """Phase 1's rows for the fp32 FMA backward at hd 96 and 256, read off
    the mangled names (type, head dim; hd 256 with its 32-row kv tiles); a
    bf16 FMA kernel at hd 256, which no call reaches since bf16 there takes
    the tensor cores, is no row and is named by the pattern phase 1 fails
    on; and the profile's patterns for the FMA kernels, which name no
    library attention kernel."""
    import re

    smoke = _chip_smoke()
    got = smoke.ptxas_summary(_PTXAS_FMA, smoke.FLASH_NEW_BWD_KINDS)
    assert sorted(got) == ["dkv hd 96 fp32", "dq hd 256 fp32"]
    assert got["dq hd 256 fp32"]["registers"] == [175, 175]
    assert got["dq hd 256 fp32"]["spill_bytes"] == 0
    assert got["dkv hd 96 fp32"]["spill_bytes"] == 8
    assert len(smoke.FLASH_NEW_BWD_KINDS) == 4
    dead = [line for line in _PTXAS_FMA.splitlines()
            if re.search(smoke.FLASH_FMA_BF16_DEAD, line)]
    assert len(dead) == 1 and "bfloat16Li256ELi32E" in dead[0]
    name = ("void (anonymous namespace)::flash_bwd_dkv<float, 256, "
            "32>((anonymous namespace)::Tensor4, (anonymous namespace)::"
            "Tensor4)")
    assert [k for k, pat in smoke.FLASH_ALL_KERNELS.items()
            if re.search(pat, name)] == ["flash fma backward dk dv"]
    assert not any(re.search(pat, "void flash_fwd_kernel<Flash_fwd_kernel_"
                             "traits<128, 128, 64, 4, false>>(Flash_fwd_"
                             "params)")
                   for pat in smoke.FLASH_ALL_KERNELS.values())


def test_chip_smoke_states_the_flash_rule_apart():
    """chip_smoke.py's own statement of the routing rule (flash_path), which
    its gates hold the wrapper's counts to, names the path choose_path
    names at every dtype and head dim; its tensor-core kernel count is
    three kernels at each tensor-core head dim and the group sum."""
    smoke = _chip_smoke()
    for dtype in (torch.float32, torch.bfloat16):
        for hd in fa.HEAD_DIMS:
            assert smoke.flash_path(dtype, hd) == fa.choose_path(dtype, hd)
    assert smoke.FLASH_TC_KERNELS == 3 * len(fa.TC_HEAD_DIMS) + 1
    assert fa.TC_INFO_KERNELS == ("forward", "dq", "dkv")


def test_chip_smoke_reads_profiler_events():
    """chip_smoke.py's profile reader (profile_events), which reads the
    profiler's private kineto results: on a CPU run the host events carry
    their names and durations, and no device event is read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    smoke = _chip_smoke()
    a = torch.ones(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        a @ a
    host = smoke.profile_events(prof, DeviceType.CPU)
    assert [ms for name, ms in host if name == "aten::mm"][0] > 0
    assert smoke.profile_events(prof) == []


@pytest.mark.parametrize("depth,peak,layer,fault", [
    (None, 48.17, 0.39, None), (15, 74.37, 3.27, None),
    (14, 71.10, 3.27, "at least 15 layers"), (8, 76.50, 6.85, "over"),
    (None, 77.00, 0.39, "over")], ids=["whole", "deepest", "shallow",
                                         "cut-over", "whole-over"])
def test_chip_smoke_depth_rule(depth, peak, layer, fault):
    """Phase 21's depth rule: a run's peak within TRAIN_PEAK_LIMIT_GB, and
    a cut model's next layer, at least its state, past it; the reason
    states the numbers, and a depth the rule refuses is a failure naming
    what it gives."""
    smoke = _chip_smoke()
    assert smoke.TRAIN_PEAK_LIMIT_GB == 76.0
    reason, failure = smoke.depth_rule("m", depth, 40, peak, layer)
    assert f"peak {peak:.2f} GB, limit 76.0 GB" in reason
    if depth is not None:
        assert f"cut to {depth} of 40 layers" in reason
        assert f"{peak + layer:.2f} GB" in reason
    assert (failure is None) == (fault is None)
    assert fault is None or fault in failure


@pytest.mark.cuda
def test_chip_smoke_reads_device_kernels_on_card():
    """device_ms_by_kernel on a card: the launches of one torch.matmul
    (cuBLAS may split K into a second kernel), each a library GEMM counted
    once with a positive device time."""
    _card()
    smoke = _chip_smoke()
    a = torch.ones(512, 512, device="cuda")
    a @ a
    counts = {}
    by_name, events = smoke.device_ms_by_kernel(lambda: a @ a, counts)
    assert events == sum(counts.values()) >= 1, (events, counts)
    assert set(counts.values()) == {1} and set(counts) == set(by_name)
    assert all(smoke.LIBRARY_GEMM.search(n) and ms > 0
               for n, ms in by_name.items()), by_name


def test_attention_auto_keeps_the_reference_rule_on_cpu():
    """On the CPU ``impl="auto"`` is still dense/chunked (the reference's
    XLA paths), equal to the flash plain version within tolerance."""
    q, k, v = (torch.from_numpy(t) for t in _qkv((2, 11, 4, 2, 8), 4))
    auto = attn.attention(q, k, v, chunk=4)  # 11 > 2*4: chunked
    np.testing.assert_allclose(auto.numpy(),
                               attn.chunked_attention(q, k, v,
                                                      chunk=4).numpy(),
                               atol=0, rtol=0)
    np.testing.assert_allclose(
        auto.numpy(), attn.attention(q, k, v, impl="flash").numpy(),
        atol=1e-5, rtol=0)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("activation", [None, "relu", "gelu", "silu", "tanh"])
def test_matmul_fn_gradients_match_autograd_of_plain(activation, bias):
    rng = np.random.default_rng(len(str(activation)) * 2 + bias)
    a0 = rng.standard_normal((37, 65)).astype(np.float32)
    b0 = (rng.standard_normal((65, 29)) / 8).astype(np.float32)
    c0 = rng.standard_normal((29,)).astype(np.float32) if bias else None
    w = torch.from_numpy(rng.standard_normal((37, 29)).astype(np.float32))

    def run(fn):
        a = torch.from_numpy(a0).requires_grad_(True)
        b = torch.from_numpy(b0).requires_grad_(True)
        c = None if c0 is None else torch.from_numpy(c0).requires_grad_(True)
        out = fn(a, b, bias=c, activation=activation)
        (out * w).sum().backward()
        return out, [t.grad for t in (a, b, c) if t is not None]

    launches = MM_LAUNCHES.count
    out, grads = run(ops.matmul)
    assert out.grad_fn is not None and "MatmulFn" in type(out.grad_fn).__name__
    assert MM_LAUNCHES.count == launches  # CPU tensors never launch
    want_out, want = run(ref.matmul_fused_ref)
    np.testing.assert_allclose(out.detach().numpy(),
                               want_out.detach().numpy(), atol=GRAD_ATOL)
    for g, gw in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), gw.numpy(), atol=GRAD_ATOL,
                                   rtol=0)


def test_matmul_fn_mixed_dtypes_and_rmsnorm_column():
    """The ones-column product of rmsnorm and a bf16 weight with fp32
    logits (the unembedding) keep their gradients' dtypes and values."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    x.requires_grad_(True)
    ones = torch.ones((16, 1))
    ops.matmul(x * x, ones).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), 2 * x.detach().numpy(),
                               atol=1e-6)
    table = torch.from_numpy(rng.standard_normal((11, 16)).astype(
        np.float32)).to(torch.bfloat16).requires_grad_(True)
    h = torch.from_numpy(rng.standard_normal((5, 16)).astype(
        np.float32)).to(torch.bfloat16)
    logits = ops.matmul(h, table.t(), out_dtype=torch.float32)
    assert logits.dtype == torch.float32
    logits.sum().backward()
    assert table.grad.dtype == torch.bfloat16 and table.grad.shape == (11, 16)
    want = h.float().sum(0)[None].expand(11, 16)
    np.testing.assert_allclose(table.grad.float().numpy(), want.numpy(),
                               atol=0.05, rtol=1e-2)


def test_batched_matmul_has_no_backward():
    """The batched (4-D) form now has its backward, in ``MatmulFn`` as the
    2-D one: a gradient through both operands, one a transposed bf16 view,
    equals autograd of the plain product (on the CPU ``MatmulFn``'s
    products are the plain version's, so what this holds is the
    backward's transposes, shapes and dtypes); without a gradient the call
    stays a plain product."""
    rng = np.random.default_rng(4)
    a0 = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    b0 = rng.standard_normal((2, 3, 6, 4)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((2, 3, 5, 6)).astype(
        np.float32))

    def run(fn):
        a = torch.from_numpy(a0).requires_grad_(True)
        b = torch.from_numpy(b0).to(torch.bfloat16).requires_grad_(True)
        out = fn(a, b.transpose(-2, -1), out_dtype=torch.float32)
        (out * w).sum().backward()
        return out, a.grad, b.grad

    out, ga, gb = run(ops.matmul)
    assert "MatmulFn" in type(out.grad_fn).__name__
    want, wa, wb = run(ref.matmul_fused_ref)
    assert ga.dtype == torch.float32 and gb.dtype == torch.bfloat16
    np.testing.assert_allclose(out.detach().numpy(), want.detach().numpy(),
                               atol=GRAD_ATOL, rtol=0)
    np.testing.assert_allclose(ga.numpy(), wa.numpy(), atol=GRAD_ATOL, rtol=0)
    assert torch.equal(gb, wb)
    with torch.no_grad():  # decode attention: no gradient asked
        got = ops.matmul(torch.from_numpy(a0), torch.from_numpy(b0)
                         .transpose(-2, -1))
        assert got.grad_fn is None and got.shape == (2, 3, 5, 6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_flash.py`")


def _held(got, want):
    """(max abs err, its ratio to the limit): bf16 element by element
    within 8e-3 x the largest |plain| of its row (the last axis) + 1e-5 x
    max|plain|, fp32 within 2e-3 x max|plain| (chip_smoke.py phase 7)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item()
    if want.dtype == torch.bfloat16:
        limit = 8e-3 * mag.amax(-1, keepdim=True) + 1e-5 * top
    else:
        limit = torch.full_like(mag, 2e-3 * top)
    return diff.max().item(), (diff / limit).max().item()


def _card_inputs(shape, dtype, causal, seed):
    b, s, hq, hkv, hd = shape
    skv = s if causal else s + 37  # non-causal attention takes Skv != S
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, skv, hkv, hd), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    do = torch.randn((b, s, hq, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 256, 32, 4, 64), (3, 100, 8, 2, 64),
                                   (2, 70, 4, 2, 16), (1, 130, 4, 1, 128),
                                   (3, 100, 8, 1, 64), (2, 300, 16, 2, 128),
                                   (3, 100, 8, 2, 96), (3, 100, 8, 2, 256),
                                   (1, 200, 10, 1, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_kernels_match_plain_on_card(shape, dtype, causal):
    """Forward and backward kernels against their plain versions on the
    same inputs, on the path the dtype and hd name.  Each kernel alone
    (the backward fed the plain forward's output and lse): fp32 within
    2e-3 x max|plain|, bf16 outputs element by element within 8e-3 x their
    row's max|plain| (about one bf16 rounding) + 1e-5 x max|plain|.  The
    chain as training runs it, kernel forward then kernel backward against
    plain forward then plain backward: gradients within 2e-3 (fp32) or
    2e-2 (bf16) x max|plain|, where the bf16 output the backward reads
    brings its own rounding."""
    _card()
    dt = getattr(torch, dtype)
    q, k, v, do = _card_inputs(shape, dt, causal, sum(shape))
    path = fa.choose_path(dt, shape[4])
    before = (fa.LAUNCHES.forward, fa.LAUNCHES.backward,
              fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v, causal)
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v, causal)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o_p, lse_p, do, causal)
    chained = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal)
    assert (fa.LAUNCHES.forward, fa.LAUNCHES.backward,
            fa.LAUNCHES.by_path[path], fa.LAUNCHES.copied_operands) == (
        before[0] + 1, before[1] + 2, before[2] + 3, before[3])
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o_p, lse_p, do, causal)
    torch.cuda.synchronize()
    for name, got, want in [("o", o, o_p), ("lse", lse, lse_p),
                            *zip(("dq", "dk", "dv"), grads, grads_p)]:
        err, ratio = _held(got, want)
        assert ratio <= 1.0, (name, err, ratio)
    tol = 2e-3 if dt == torch.float32 else 2e-2
    for name, got, want in zip(("dq", "dk", "dv"), chained, grads_p):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (
            f"chained {name}", err)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 512, 32, 4, 64), (1, 200, 8, 2, 128),
                                   (2, 300, 8, 8, 96), (1, 300, 8, 1, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_flash_backward_bits_repeat_on_card(shape):
    """The bf16 backward has no atomics and sums each kv head's group in a
    fixed order: two runs on the same inputs give the same bits."""
    _card()
    q, k, v, do = _card_inputs(shape, torch.bfloat16, True, 11)
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    first = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    second = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    o2, lse2 = fa.flash_attention_fwd_cuda(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [64, 96, 256])
def test_flash_copy_loader_on_card(hd):
    """Operands no tensor map describes (hd strided, a pitch of hd + 1) run
    the tensor-core kernels through the producer's copy loader (which
    writes hd 96's zero columns itself), and agree with the plain versions
    by the bf16 rule."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    b, s, hq, hkv = 2, 150, 8, 2
    q = torch.randn((b, s, hq, 2 * hd), generator=gen,
                    device="cuda").to(torch.bfloat16)[..., ::2]
    k = torch.randn((b, s, hkv, hd + 1), generator=gen,
                    device="cuda").to(torch.bfloat16)[..., :hd]
    v = torch.randn((b, s, hkv, hd), generator=gen,
                    device="cuda").to(torch.bfloat16)
    do = torch.randn((b, s, hq, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    assert not fa.tma_ok(q) and not fa.tma_ok(k) and fa.tma_ok(v)
    before = fa.LAUNCHES.copied_operands
    o, lse = fa.flash_attention_fwd_cuda(q, k, v)
    grads = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
    assert fa.LAUNCHES.copied_operands - before == 4  # q, k twice each
    o_p, lse_p = ref.flash_attention_fwd_plain(q, k, v)
    grads_p = ref.flash_attention_bwd_plain(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for name, got, want in [("o", o, o_p), ("lse", lse, lse_p),
                            *zip(("dq", "dk", "dv"), grads, grads_p)]:
        err, ratio = _held(got, want)
        assert ratio <= 1.0, (name, err, ratio)


@pytest.mark.cuda
def test_matmul_fn_gradients_on_card():
    """``MatmulFn`` on the card: every gradient from the kernel, within
    1e-5 x max|plain| of autograd through the plain version in fp32."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    a0 = torch.randn((300, 200), generator=gen, device="cuda")
    b0 = torch.randn((200, 130), generator=gen, device="cuda") / 14
    c0 = torch.randn((130,), generator=gen, device="cuda")
    w = torch.randn((300, 130), generator=gen, device="cuda")
    for act in (None, "silu", "gelu"):
        res = []
        for fn in (ops.matmul, ref.matmul_fused_ref):
            a, b, c = (t.clone().requires_grad_(True) for t in (a0, b0, c0))
            before = MM_LAUNCHES.count
            (fn(a, b, bias=c, activation=act) * w).sum().backward()
            res.append((MM_LAUNCHES.count - before,
                        [t.grad for t in (a, b, c)]))
        (launched, got), (_, want) = res
        assert launched == (4 if act else 3)  # forward, recompute, dA, dB
        for g, gw in zip(got, want):
            err = (g - gw).abs().max().item()
            assert err <= 1e-5 * gw.abs().max().item(), (act, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["scores", "mix"])
def test_batched_matmul_gradients_on_card(form, b_dtype):
    """The 4-D ``ops.matmul`` under autograd on the card, at the windowed
    attention's shapes (recurrentgemma's MQA, hd 256, a 64-row window:
    scores ``qg @ kᵀ`` and the mix ``p @ v``, k and v read through
    permuted views): every gradient from the matmul kernel (forward, dA,
    dB: 3 launches), within 1e-5 x max|plain| of autograd through the
    plain product in fp32 (an fp32 gradient) or one bf16 rounding of
    max|plain| (a bf16 gradient)."""
    _card()
    gen = torch.Generator(device="cuda").manual_seed(3)
    bt, w, hd, g = 4, 64, 256, 10
    kv = torch.randn((bt, 2 * w, 1, hd), generator=gen, device="cuda")
    kv = kv.to(getattr(torch, b_dtype))
    if form == "scores":
        a0 = torch.randn((bt, 1, w * g, hd), generator=gen, device="cuda")
        view = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
    else:
        a0 = torch.softmax(torch.randn((bt, 1, w * g, 2 * w), generator=gen,
                                       device="cuda"), -1)
        view = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
    n = hd if form == "mix" else 2 * w
    wt = torch.randn((bt, 1, w * g, n), generator=gen, device="cuda")
    res = []
    for fn in (ops.matmul, ref.matmul_fused_ref):
        a = a0.clone().requires_grad_(True)
        b = kv.clone().requires_grad_(True)
        before = MM_LAUNCHES.count
        (fn(a, view(b), out_dtype=torch.float32) * wt).sum().backward()
        res.append((MM_LAUNCHES.count - before, a.grad, b.grad))
    (launched, ga, gb), (_, wa, wb) = res
    assert launched == 3
    assert gb.dtype == kv.dtype
    err = (ga - wa).abs().max().item()
    assert err <= 1e-5 * wa.abs().max().item(), ("da", err)
    tol = 1e-5 if b_dtype == "float32" else 8e-3
    err = (gb.float() - wb.float()).abs().max().item()
    assert err <= tol * wb.float().abs().max().item(), ("db", err)
