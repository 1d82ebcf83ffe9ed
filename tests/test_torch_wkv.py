"""The port's WKV against the reference, and its backward against
``jax.vjp`` of the reference's chunked form, on seeded numpy inputs, on the
CPU.

* forward: the WKV kernel's plain version (``wkv_fwd_plain``) and
  ``ops.wkv`` on CPU tensors against the reference's Pallas kernel in
  interpret mode (``repro.kernels.ops.wkv``), its sequential oracle
  (``ref.wkv_ref``) and its XLA chunked form (``wkv_chunked``), at the
  reference's own cases (tests/test_kernels.py): atol = rtol = 1e-4;
  extreme decay (logw = -50) stays finite;
* backward: ``wkv_bwd_plain`` (the backward kernel's plain version) against
  ``jax.vjp`` of the reference's ``wkv_chunked``, for r, k, v, logw and u,
  with and without a gradient on the final state: within 1e-4 x max|grad|.
  The decays there are the model's (logw = -exp(-2 + N(0, 1)), as the time
  mix makes them with its w0 = -2): at unit-scale decays the reference's
  own gradient is NaN, since it masks exp(cwe_t - cw_s) after taking it and
  the masked entries overflow (inf x 0 in its autodiff).  At unit scale the
  backward is held against autograd of the sequential oracle instead; and
  ``torch.autograd.gradcheck`` of ``WkvFn`` in float64;
* ``wkv_step`` and ``wkv_chunked`` of ``models/rwkv.py`` against the
  reference's, 1e-5 (fp32);
* the kernels' arithmetic on the CPU: the forward as its two passes
  (``wkv_states_plain``, then ``wkv_out_plain`` from the chunk-start
  states) and the pairwise decay factored by sub-chunk (``subchunk``)
  against the reference's Pallas kernel (interpret mode) and oracle at its
  cases, 1e-4; the factored backward against ``jax.vjp`` at the model's
  decays and against autograd of the oracle at unit scale, 1e-4 x
  max|grad|; at logw = -50 and at heavy mixed decays (cumulative decays
  near -1000 a chunk) every output finite and every exponent a factor
  takes <= 0 (``wkv_max_exponent``);
* the ``cuda``-marked test holds the kernels against their plain versions
  (with the kernels' sub-chunk factorization) on a card, forward and
  backward, counts the CUDA launches each call makes, and skips elsewhere.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import wkv as wkv_k  # noqa: E402
from repro_torch.models import rwkv as rwkv_lib  # noqa: E402

try:  # the reference; a card machine without jax runs only the cuda tests
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import rwkv as jrwkv
except ImportError:
    jops = None

needs_reference = pytest.mark.skipif(
    jops is None, reason="needs jax and the reference package")

TOL = 1e-4  # tests/test_kernels.py's WKV tolerance, at unit scale
GRAD_TOL = 1e-4  # x max|grad|
# (s, chunk): the reference's cases; S a multiple of L, across and not
CASES = [(32, 8), (64, 16), (40, 16), (128, 64)]


def _inputs(b, s, h, n, seed, decay=None, log_offset=0.0):
    """r, k, v ~ N(0, 1), logw = -exp(log_offset + N(0, 1)) (or the
    constant ``decay``), u ~ N(0, 0.3), float32 numpy."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32)
               for _ in range(3))
    logw = (-np.exp(log_offset + rng.standard_normal((b, s, h, n)))
            if decay is None else np.full((b, s, h, n), decay)
            ).astype(np.float32)
    u = (0.3 * rng.standard_normal((h, n))).astype(np.float32)
    return r, k, v, logw, u


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@needs_reference
@pytest.mark.parametrize("s,chunk", CASES)
def test_wkv_forward_matches_reference_kernel_and_oracle(s, chunk):
    x = _inputs(2, s, 3, 8, seed=s + chunk)
    k_out, k_state = (np.asarray(a) for a in
                      jops.wkv(*_j(*x), chunk=chunk, interpret=True))
    o_out, o_state = (np.asarray(a) for a in jref.wkv_ref(*_j(*x)))
    launches = wkv_k.LAUNCHES.forward
    out, state, starts = ref.wkv_fwd_plain(*_t(*x), chunk)
    got_out, got_state = ops.wkv(*_t(*x), chunk=chunk)
    assert wkv_k.LAUNCHES.forward == launches  # CPU tensors never launch
    assert torch.equal(got_out, out) and torch.equal(got_state, state)
    assert out.dtype == torch.float32 and out.shape == (2, s, 3, 8)
    assert starts.shape == (2, 3, -(-s // chunk), 8, 8)
    assert torch.equal(starts[:, :, 0], torch.zeros_like(starts[:, :, 0]))
    for want_out, want_state in ((k_out, k_state), (o_out, o_state)):
        np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(state.numpy(), want_state, atol=TOL,
                                   rtol=TOL)
    seq_out, seq_state = ref.wkv_ref(*_t(*x))  # the port's own oracle
    np.testing.assert_allclose(seq_out.numpy(), o_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(seq_state.numpy(), o_state, atol=TOL,
                               rtol=TOL)


@needs_reference
def test_wkv_extreme_decay_stays_finite():
    x = _inputs(1, 32, 1, 4, seed=7, decay=-50.0)
    x = x[:4] + (np.zeros_like(x[4]),)
    out, state = ops.wkv(*_t(*x), chunk=8)
    assert torch.isfinite(out).all() and torch.isfinite(state).all()
    want, want_state = jops.wkv(*_j(*x), chunk=8, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               atol=TOL, rtol=TOL)
    do = torch.ones_like(out)
    grads = ref.wkv_bwd_plain(*_t(*x), ref.wkv_fwd_plain(*_t(*x), 8)[2], do,
                              None, 8)
    assert all(torch.isfinite(g).all() for g in grads)


@needs_reference
def test_wkv_plain_matches_xla_chunked():
    """The kernel's plain version against the reference's XLA chunked form
    (same math, another tiling)."""
    x = _inputs(2, 48, 2, 8, seed=3)
    want, want_state = jrwkv.wkv_chunked(*_j(*x), None, chunk=16)
    out, state = ops.wkv(*_t(*x), chunk=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(want_state),
                               atol=TOL, rtol=TOL)


@needs_reference
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("s,chunk", CASES)
def test_wkv_backward_matches_jax_vjp(s, chunk, with_dstate):
    b, h, n = 2, 3, 8
    x = _inputs(b, s, h, n, seed=100 + s + chunk, log_offset=-2.0)
    rng = np.random.default_rng(s)
    dout = rng.standard_normal((b, s, h, n)).astype(np.float32)
    dstate = rng.standard_normal((b, h, n, n)).astype(np.float32) \
        if with_dstate else np.zeros((b, h, n, n), np.float32)

    def f(r, k, v, logw, u):
        return jrwkv.wkv_chunked(r, k, v, logw, u, None, chunk=chunk)

    _, vjp = jax.vjp(f, *_j(*x))
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))
    _, _, starts = ref.wkv_fwd_plain(*_t(*x), chunk)
    got = ref.wkv_bwd_plain(*_t(*x), starts, torch.from_numpy(dout),
                            torch.from_numpy(dstate) if with_dstate else None,
                            chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("s,chunk", [(40, 16), (128, 64)])
def test_wkv_backward_matches_autograd_of_oracle(s, chunk):
    """At unit-scale decays, where the reference's autodiff is NaN: the
    closed form against torch.autograd through the sequential oracle."""
    b, h, n = 1, 2, 8
    x = _t(*_inputs(b, s, h, n, seed=200 + s))
    rng = np.random.default_rng(s)
    dout = torch.from_numpy(
        rng.standard_normal((b, s, h, n)).astype(np.float32))
    dstate = torch.from_numpy(
        rng.standard_normal((b, h, n, n)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in x]
    out, state = ref.wkv_ref(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (state * dstate).sum(),
                               leaves)
    _, _, starts = ref.wkv_fwd_plain(*x, chunk)
    got = ref.wkv_bwd_plain(*x, starts, dout, dstate, chunk)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * w.abs().max().item(),
                                   err_msg=name)


def test_wkv_fn_gradcheck_float64():
    """WkvFn's backward (the plain versions on the CPU) is the gradient of
    its forward, out and final state both, at float64."""
    rng = np.random.default_rng(0)
    b, s, h, n, chunk = 1, 11, 2, 4, 4
    r, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, n)))
               .requires_grad_(True) for _ in range(3))
    logw = torch.from_numpy(-np.exp(rng.standard_normal((b, s, h, n))))
    u = torch.from_numpy(0.3 * rng.standard_normal((h, n)))
    args = (r, k, v, logw.requires_grad_(True), u.requires_grad_(True))
    assert torch.autograd.gradcheck(
        lambda *a: wkv_k.WkvFn.apply(*a, chunk), args)


def test_wkv_fn_grads_equal_plain_backward():
    """ops.wkv with inputs that need gradients goes through WkvFn, whose
    gradients are wkv_bwd_plain's on the CPU, and launches nothing."""
    x = _t(*_inputs(1, 40, 2, 16, seed=11))
    leaves = [t.clone().requires_grad_(True) for t in x]
    before = (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward)
    out, state = ops.wkv(*leaves, chunk=16)
    do = torch.ones_like(out)
    grads = torch.autograd.grad(out, leaves, do)
    assert (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward) == before
    _, _, starts = ref.wkv_fwd_plain(*x, 16)
    want = ref.wkv_bwd_plain(*x, starts, do, None, 16)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_wkv_rejects_what_it_does_not_compute():
    r = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="one shape"):
        ops.wkv(r, r, r, torch.zeros((1, 4, 2, 8)), torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="u"):
        ops.wkv(r, r, r, r, torch.zeros((3, 16)))
    with pytest.raises(TypeError):
        ops.wkv(r, r, r, r, torch.zeros((2, 16)), state=None)  # no carry-in
    with pytest.raises(ValueError, match="CUDA"):  # never the plain path
        wkv_k.wkv_fwd_cuda(r, r, r, r, torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="CUDA"):
        wkv_k.wkv_bwd_cuda(r, r, r, r, torch.zeros((2, 16)),
                           torch.zeros((1, 2, 1, 16, 16)), r)


@needs_reference
def test_wkv_step_and_carried_chunked_match_reference():
    """The decode step and the chunked form from a carried state (model
    code, not the kernel) against the reference's."""
    b, h, n = 2, 3, 8
    x = _inputs(b, 1, h, n, seed=5)
    rng = np.random.default_rng(6)
    state = rng.standard_normal((b, h, n, n)).astype(np.float32)
    want_o, want_s = jrwkv.wkv_step(*_j(*x), jnp.asarray(state))
    got_o, got_s = rwkv_lib.wkv_step(*_t(*x), torch.from_numpy(state))
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-5)
    x = _inputs(b, 37, h, n, seed=8)
    want_o, want_s = jrwkv.wkv_chunked(*_j(*x), jnp.asarray(state), chunk=16)
    got_o, got_s = rwkv_lib.wkv_chunked(*_t(*x), torch.from_numpy(state), 16)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), atol=1e-5,
                               rtol=1e-5)


def _sub(chunk):
    """A sub-chunk that cuts the chunk into at least two: the kernels' 16
    where the chunk allows it."""
    return 16 if chunk > 16 else chunk // 2


@needs_reference
@pytest.mark.parametrize("s,chunk", CASES)
def test_wkv_two_passes_factored_match_reference_kernel_and_oracle(s, chunk):
    """The forward as the kernels split it, the state pass then the output
    pass from the chunk-start states alone, with the pairwise decay
    factored by sub-chunk: equal to wkv_fwd_plain(subchunk=...), and within
    1e-4 of the reference's Pallas kernel and oracle."""
    x = _inputs(2, s, 3, 8, seed=s + chunk)
    sub = _sub(chunk)
    k_out, k_state = (np.asarray(a) for a in
                      jops.wkv(*_j(*x), chunk=chunk, interpret=True))
    o_out, o_state = (np.asarray(a) for a in jref.wkv_ref(*_j(*x)))
    r, k, v, logw, u = _t(*x)
    starts, state = ref.wkv_states_plain(k, v, logw, chunk, sub)
    out = ref.wkv_out_plain(r, k, v, logw, u, starts, chunk, sub)
    f_out, f_state, f_starts = ref.wkv_fwd_plain(r, k, v, logw, u, chunk,
                                                 sub)
    assert torch.equal(out, f_out) and torch.equal(state, f_state)
    assert torch.equal(starts, f_starts)
    assert starts.shape == (2, 3, -(-s // chunk), 8, 8)
    for want_out, want_state in ((k_out, k_state), (o_out, o_state)):
        np.testing.assert_allclose(out.numpy(), want_out, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(state.numpy(), want_state, atol=TOL,
                                   rtol=TOL)
    # the output pass needs nothing but each chunk's start state: fed the
    # oracle's own states at the chunk starts it gives the oracle's output
    oracle_starts = torch.stack(
        [torch.zeros_like(starts[:, :, 0])] +
        [ref.wkv_ref(*(t[:, :c * chunk] for t in (r, k, v, logw)), u)[1]
         for c in range(1, starts.shape[2])], dim=2)
    np.testing.assert_allclose(
        ref.wkv_out_plain(r, k, v, logw, u, oracle_starts, chunk,
                          sub).numpy(), o_out, atol=TOL, rtol=TOL)


@needs_reference
@pytest.mark.parametrize("with_dstate", [False, True])
@pytest.mark.parametrize("s,chunk", CASES)
def test_wkv_factored_backward_matches_jax_vjp(s, chunk, with_dstate):
    """The backward with the pairwise decay factored by sub-chunk (and its
    reverse state pass) against jax.vjp of the reference's chunked form at
    the model's decays, within 1e-4 x max|grad|."""
    b, h, n = 2, 3, 8
    x = _inputs(b, s, h, n, seed=300 + s + chunk, log_offset=-2.0)
    rng = np.random.default_rng(s + 1)
    dout = rng.standard_normal((b, s, h, n)).astype(np.float32)
    dstate = rng.standard_normal((b, h, n, n)).astype(np.float32) \
        if with_dstate else np.zeros((b, h, n, n), np.float32)

    def f(r, k, v, logw, u):
        return jrwkv.wkv_chunked(r, k, v, logw, u, None, chunk=chunk)

    _, vjp = jax.vjp(f, *_j(*x))
    want = vjp((jnp.asarray(dout), jnp.asarray(dstate)))
    sub = _sub(chunk)
    _, _, starts = ref.wkv_fwd_plain(*_t(*x), chunk, sub)
    ds = torch.from_numpy(dstate) if with_dstate else None
    ends = ref.wkv_dstates_plain(_t(x[0])[0], _t(x[3])[0],
                                 torch.from_numpy(dout), ds, chunk, sub)
    assert ends.shape == starts.shape
    assert torch.equal(ends[:, :, -1], torch.from_numpy(dstate))
    got = ref.wkv_bwd_plain(*_t(*x), starts, torch.from_numpy(dout), ds,
                            chunk, sub)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.parametrize("s,chunk", [(40, 16), (128, 64)])
def test_wkv_factored_backward_matches_autograd_of_oracle(s, chunk):
    """At unit-scale decays: the factored closed form against
    torch.autograd through the sequential oracle."""
    b, h, n = 1, 2, 8
    x = _t(*_inputs(b, s, h, n, seed=400 + s))
    rng = np.random.default_rng(s + 2)
    dout = torch.from_numpy(
        rng.standard_normal((b, s, h, n)).astype(np.float32))
    dstate = torch.from_numpy(
        rng.standard_normal((b, h, n, n)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in x]
    out, state = ref.wkv_ref(*leaves)
    want = torch.autograd.grad((out * dout).sum() + (state * dstate).sum(),
                               leaves)
    sub = _sub(chunk)
    _, _, starts = ref.wkv_fwd_plain(*x, chunk, sub)
    got = ref.wkv_bwd_plain(*x, starts, dout, dstate, chunk, sub)
    for name, g, w in zip(("dr", "dk", "dv", "dlogw", "du"), got, want):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=GRAD_TOL * w.abs().max().item(),
                                   err_msg=name)


@needs_reference
@pytest.mark.parametrize("decay", ["-50", "heavy"])
def test_wkv_factored_strong_decay_finite_and_exponents_nonpositive(decay):
    """logw = -50, and heavy mixed decays (logw = -exp(3 + N(0, 1)):
    cumulative decays near -1000 a chunk): every output of the factored
    forward and backward finite, the forward within 1e-4 of the
    reference's oracle, and the largest exponent any factor takes <= 0."""
    b, s, h, n, chunk = 2, 100, 2, 16, 64
    x = _inputs(b, s, h, n, seed=9, decay=-50.0 if decay == "-50" else None,
                log_offset=3.0)
    r, k, v, logw, u = _t(*x)
    cw = torch.cumsum(ref._wkv_chunks(logw, chunk, torch.float32), dim=3)
    assert cw.min().item() < (-50 * 60 if decay == "-50" else -500)
    assert ref.wkv_max_exponent(logw, chunk, 16) <= 0.0
    out, state, starts = ref.wkv_fwd_plain(r, k, v, logw, u, chunk, 16)
    rng = np.random.default_rng(10)
    do = torch.from_numpy(rng.standard_normal((b, s, h, n)).astype(
        np.float32))
    ds = torch.from_numpy(rng.standard_normal((b, h, n, n)).astype(
        np.float32))
    grads = ref.wkv_bwd_plain(r, k, v, logw, u, starts, do, ds, chunk, 16)
    assert all(torch.isfinite(t).all() for t in (out, state, *grads))
    o_out, o_state = (np.asarray(a) for a in jref.wkv_ref(*_j(*x)))
    np.testing.assert_allclose(out.numpy(), o_out, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(state.numpy(), o_state, atol=TOL, rtol=TOL)


def test_wkv_launch_counter_counts_cuda_launches_by_kernel():
    """The counter keeps wrapper calls and CUDA launches by kernel apart;
    CPU tensors launch nothing; reset clears both."""
    x = _t(*_inputs(1, 20, 2, 16, seed=12))
    wkv_k.LAUNCHES.add(wkv_k.FORWARD_KERNELS)
    assert wkv_k.LAUNCHES.cuda["wkv_fwd_out"] >= 1
    wkv_k.LAUNCHES.reset()
    ops.wkv(*x, chunk=16)
    assert (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward,
            wkv_k.LAUNCHES.cuda) == (0, 0, {})
    assert set(wkv_k.FORWARD_KERNELS) | set(wkv_k.BACKWARD_KERNELS) == {
        "wkv_state", "wkv_fwd_out", "wkv_bwd_chunk"}


def _held(got, want):
    """Max of |got - want| over its limit: fp32 outputs within 1e-4 x
    max|want|; bf16 outputs element by element within 8e-3 x the largest
    |want| of the element's row (one bf16 rounding) + 1e-5 x max|want|."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    top = mag.max().item()
    if want.dtype == torch.bfloat16:
        limit = 8e-3 * mag.amax(-1, keepdim=True) + 1e-5 * top
    else:
        limit = torch.full_like(mag, 1e-4 * top)
    return (diff / limit).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 256, 8, 64, 64, "bfloat16"),
                                   (2, 256, 8, 64, 64, "float32"),
                                   (3, 100, 5, 64, 64, "float32"),
                                   (2, 70, 3, 32, 32, "float32"),
                                   (1, 45, 4, 16, 16, "bfloat16"),
                                   (3, 100, 5, 64, 64, "float32", 3.0)],
                         ids=lambda s: "x".join(map(str, s)))
def test_wkv_kernels_match_plain_on_card(shape):
    """Forward (two CUDA launches) and backward (two) against the plain
    versions with the kernels' sub-chunk factorization; the last case at
    heavy mixed decays (logw = -exp(3 + N(0, 1)))."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_wkv.py`")
    b, s, h, n, chunk, dtype_name, *rest = shape
    dt = getattr(torch, dtype_name)
    x = _inputs(b, s, h, n, seed=sum(shape[:5]),
                log_offset=rest[0] if rest else 0.0)
    r, k, v = (torch.from_numpy(a).to("cuda", dt) for a in x[:3])
    logw, u = (torch.from_numpy(a).cuda() for a in x[3:])
    do = torch.randn((b, s, h, n), device="cuda")
    ds = torch.randn((b, h, n, n), device="cuda")
    sub = wkv_k.SUBCHUNK
    before = (wkv_k.LAUNCHES.forward, wkv_k.LAUNCHES.backward)
    cuda_before = dict(wkv_k.LAUNCHES.cuda)
    out, state, starts = wkv_k.wkv_fwd_cuda(r, k, v, logw, u, chunk,
                                            keep_states=True)
    grads = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, starts, do, ds, chunk)
    assert (wkv_k.LAUNCHES.forward - before[0],
            wkv_k.LAUNCHES.backward - before[1]) == (1, 1)
    launched = {kk: vv - cuda_before.get(kk, 0)
                for kk, vv in wkv_k.LAUNCHES.cuda.items()}
    assert launched == {"wkv_state": 2, "wkv_fwd_out": 1,
                        "wkv_bwd_chunk": 1}
    p_out, p_state, p_starts = ref.wkv_fwd_plain(r, k, v, logw, u, chunk,
                                                 sub)
    p_grads = ref.wkv_bwd_plain(r, k, v, logw, u, p_starts, do, ds, chunk,
                                sub)
    torch.cuda.synchronize()
    for name, got, want in [("out", out, p_out), ("state", state, p_state),
                            ("starts", starts, p_starts),
                            *zip(("dr", "dk", "dv", "dlogw", "du"), grads,
                                 p_grads)]:
        assert got.dtype == want.dtype and got.shape == want.shape, name
        assert torch.isfinite(got).all(), name
        assert _held(got, want) <= 1.0, name
    # the autograd Function on the card: kernels both ways
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, logw, u)]
    out2, _ = ops.wkv(*leaves, chunk=chunk)
    grads2 = torch.autograd.grad(out2, leaves, do)
    assert (wkv_k.LAUNCHES.forward - before[0],
            wkv_k.LAUNCHES.backward - before[1]) == (2, 2)
    assert torch.equal(out2, out)
    ref_grads = wkv_k.wkv_bwd_cuda(r, k, v, logw, u, starts, do, None, chunk)
    for got, want in zip(grads2, ref_grads):
        assert torch.equal(got, want)
    # extreme decay: every output finite
    w50 = torch.full_like(logw, -50.0)
    out3, state3, st3 = wkv_k.wkv_fwd_cuda(r, k, v, w50, u, chunk, True)
    g3 = wkv_k.wkv_bwd_cuda(r, k, v, w50, u, st3, do, None, chunk)
    assert all(torch.isfinite(t).all() for t in (out3, state3, *g3))
