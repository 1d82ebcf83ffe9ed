"""The port's RG-LRU block (``models/rglru.py``) against the reference's
(``src/repro/models/rglru.py``), on the CPU, on seeded numpy inputs and the
reference's parameters (d 48, width 40, fp32).

* ``rglru_apply`` without a state (the port's Hillis-Steele scan against
  the reference's ``associative_scan``) and with one (step by step, both):
  outputs and the new state within 1e-5 (fp32, other summation orders);
* the conv state carried across chunks: a sequence fed in chunks of 1, 2
  and 5 with the state carried gives the one-call output and final state
  of both packages (1e-5);
* decays at both ends of the init range (a^c at 0.9 and at 0.999, and
  past them both ways, with the recurrence gate near 1): the decay within
  1e-6, the gated input within 1e-6 plus 8 fp32 ulps over 1 - a^2 (the
  cancellation in sqrt(1 - a^2)), and the block within 1e-5 of the
  reference;
* ``linear_scan`` against a plain step loop at lengths below, at and above
  powers of 2 (1e-5), and the stateless block against the stepped block on
  the same tokens;
* ``rglru_init`` draws the reference's distributions (its decay range, the
  gates' scales, dtypes and shapes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference
    import jax
    import jax.numpy as jnp
    from repro.models import rglru as jrglru
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.models import rglru  # noqa: E402

D, WIDTH = 48, 40
ATOL = 1e-5
GATE_ATOL = 1e-6


def _ref_params(seed=0):
    params = jrglru.rglru_init(jax.random.PRNGKey(seed), D, WIDTH)
    return params, {k: torch.from_numpy(np.array(v)) for k, v in
                    params.items()}


def _x(b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, s, D)).astype(np.float32)


def _state(b, seed):
    rng = np.random.default_rng(seed)
    return {"h": rng.standard_normal((b, WIDTH)).astype(np.float32),
            "conv": rng.standard_normal(
                (b, rglru.CONV_WIDTH - 1, WIDTH)).astype(np.float32)}


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want),
                               atol=atol, rtol=0, err_msg=what)


@needs_reference
@pytest.mark.parametrize("with_state", [False, True],
                         ids=["parallel", "stepped"])
def test_rglru_apply_matches_reference(with_state):
    jp, p = _ref_params()
    s = 3 if with_state else 37
    x = _x(2, s, seed=1)
    if with_state:
        st = _state(2, seed=2)
        jst = {k: jnp.asarray(v) for k, v in st.items()}
        tst = {k: torch.from_numpy(v) for k, v in st.items()}
    else:
        jst = tst = None
    want, want_state = jrglru.rglru_apply(jp, jnp.asarray(x), jst)
    got, got_state = rglru.rglru_apply(p, torch.from_numpy(x), tst)
    _close(got, want, ATOL, "output")
    if with_state:
        assert got_state["h"].dtype == torch.float32
        for k in ("h", "conv"):
            _close(got_state[k], want_state[k], ATOL, k)
    else:
        assert got_state is None and want_state is None


@needs_reference
@pytest.mark.parametrize("chunks", [(1,) * 9, (2, 2, 2, 2, 1), (5, 4)],
                         ids=["1s", "2s", "5+4"])
def test_conv_state_carried_across_chunks(chunks):
    """Nine tokens in chunks, the state carried from one call to the next:
    the concatenated outputs and the final state equal one call over the
    nine, in the port and in the reference (the conv state holds the last
    three inputs, across a chunk of 1 or 2 too)."""
    jp, p = _ref_params(seed=3)
    x = _x(2, sum(chunks), seed=4)
    st0 = _state(2, seed=5)
    whole, whole_state = rglru.rglru_apply(
        p, torch.from_numpy(x), {k: torch.from_numpy(v)
                                 for k, v in st0.items()})
    jwhole, jwhole_state = jrglru.rglru_apply(
        jp, jnp.asarray(x), {k: jnp.asarray(v) for k, v in st0.items()})
    tst = {k: torch.from_numpy(v) for k, v in st0.items()}
    jst = {k: jnp.asarray(v) for k, v in st0.items()}
    outs, jouts, at = [], [], 0
    for c in chunks:
        out, tst = rglru.rglru_apply(p, torch.from_numpy(x[:, at:at + c]),
                                     tst)
        jout, jst = jrglru.rglru_apply(jp, jnp.asarray(x[:, at:at + c]), jst)
        outs.append(out)
        jouts.append(np.asarray(jout))
        at += c
    _close(torch.cat(outs, dim=1), whole.numpy(), ATOL, "chunks vs whole")
    _close(torch.cat(outs, dim=1), np.concatenate(jouts, axis=1), ATOL,
           "chunks vs reference chunks")
    _close(whole, jwhole, ATOL, "whole vs reference")
    for k in ("h", "conv"):
        _close(tst[k], whole_state[k].numpy(), ATOL, k)
        _close(tst[k], jst[k], ATOL, f"reference {k}")
        _close(whole_state[k], jwhole_state[k], ATOL, f"whole {k}")
    # the conv state is the last three inputs of the conv: x @ w_x
    assert tst["conv"].shape == (2, rglru.CONV_WIDTH - 1, WIDTH)
    _close(tst["conv"], x[:, -3:] @ np.asarray(jp["w_x"]), ATOL, "conv")


@needs_reference
@pytest.mark.parametrize("decay", [0.9, 0.999, 0.5, 0.99999],
                         ids=["range-low", "range-high", "strong", "weak"])
def test_gates_at_the_ends_of_the_decay_range(decay):
    """Every channel at one decay a^c = ``decay`` (the init range's ends,
    and past them both ways), with a recurrence-gate bias of 6 so that r
    is near 1 and a reaches a^c: the gates and the block against the
    reference's; log a <= 0 and 1 - a^2 floored at 1e-12 in both."""
    jp, _ = _ref_params(seed=6)
    lam = float(np.log(np.expm1(-np.log(decay) / rglru.C_FACTOR)))
    jp = dict(jp, lam=jnp.full((WIDTH,), lam, jnp.float32),
              b_rec_gate=jnp.full((WIDTH,), 6.0, jnp.float32))
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = _x(2, 20, seed=7)
    u = np.random.default_rng(8).standard_normal((2, 20, WIDTH)).astype(
        np.float32)
    ja, jb = jrglru._gates(jp, jnp.asarray(u))
    a, b = rglru.gates(p, torch.from_numpy(u))
    _close(a, ja, GATE_ATOL, "a")
    # b's factor sqrt(1 - a^2) cancels as a nears 1: an ulp of exp(2 log a)
    # is a relative error of eps / (1 - a^2) in it, and XLA's exp and
    # torch's differ by a few ulps.  Hence 1e-6 + 8 eps |b| / (1 - a^2).
    ja2 = np.asarray(ja, np.float64) ** 2
    limit = GATE_ATOL + 8 * np.finfo(np.float32).eps * np.abs(
        np.asarray(jb)) / np.maximum(1.0 - ja2, 1e-12)
    diff = np.abs(b.numpy() - np.asarray(jb))
    assert (diff <= limit).all(), (diff / limit).max()
    # a = decay^r with r = sigmoid(6 + u w) near 1: a reaches the decay
    assert float(a.max()) <= 1.0
    assert decay * (1 - 1e-6) <= float(a.min()) <= decay ** 0.9
    want, _ = jrglru.rglru_apply(jp, jnp.asarray(x))
    got, _ = rglru.rglru_apply(p, torch.from_numpy(x))
    _close(got, want, ATOL, "block")


@pytest.mark.parametrize("s", [1, 7, 64, 100])
def test_linear_scan_equals_the_step_loop(s):
    rng = np.random.default_rng(s)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (3, s, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, s, 5)).astype(np.float32))
    h = torch.zeros((3, 5))
    want = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(rglru.linear_scan(a, b), torch.stack(want, dim=1).numpy(), ATOL,
           f"S={s}")


def test_parallel_block_equals_stepped_block():
    """The same 13 tokens through the block without a state (the scan) and
    token by token from a zero state (the step loop)."""
    gen = torch.Generator().manual_seed(9)
    p = rglru.rglru_init(gen, D, WIDTH)
    x = torch.randn((2, 13, D), generator=gen)
    whole, _ = rglru.rglru_apply(p, x)
    st = rglru.rglru_init_state(2, WIDTH, torch.float32, "cpu")
    outs = []
    for t in range(13):
        out, st = rglru.rglru_apply(p, x[:, t:t + 1], st)
        outs.append(out)
    _close(torch.cat(outs, dim=1), whole.numpy(), ATOL, "stepped vs scan")


@needs_reference
def test_init_draws_the_reference_distributions():
    """Shapes and dtypes as the reference's (bf16 projections and conv,
    fp32 gates and decay); the decay a^c = exp(-c softplus(lam)) inside
    [0.9, 0.999]; the gates' weights N(0, 0.5^2) and biases 0."""
    jp = jrglru.rglru_init(jax.random.PRNGKey(0), 256, 512, jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    p = rglru.rglru_init(gen, 256, 512, torch.bfloat16)
    assert list(p) == list(jp)
    for k, v in p.items():
        assert tuple(v.shape) == jp[k].shape, k
        assert str(v.dtype)[6:] == str(jp[k].dtype), k
    ac = torch.exp(-rglru.C_FACTOR * torch.nn.functional.softplus(p["lam"]))
    assert 0.9 - 1e-6 <= float(ac.min()) and float(ac.max()) <= 0.999 + 1e-6
    assert float(ac.max() - ac.min()) > 0.09  # spans the range
    for k in ("w_rec_gate", "w_in_gate"):
        assert abs(float(p[k].std()) - 0.5) < 0.06, k
    for k in ("b_rec_gate", "b_in_gate"):
        assert not p[k].any(), k
    assert abs(float(p["conv_w"].float().std()) - 0.1) < 0.01
    assert abs(float(p["w_x"].float().std()) - 256 ** -0.5) < 0.005
