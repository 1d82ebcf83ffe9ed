"""Training the dense and hybrid families against the reference, on the
CPU, at reduced size (``.reduced()``: d 64, 4 query heads, vocab 256,
fp32), from the reference's parameters carried across by
``params_from_jax`` and the same numpy-seeded batches: mistral-nemo-12b
(GQA), phi3-mini-3.8b (MHA), gemma-2b (MQA, tied embeddings scaled by
sqrt(d)) and recurrentgemma-2b (RG-LRU and sliding-window ``local``
layers, window 8).

* the loss and every gradient leaf against ``jax.value_and_grad`` of the
  reference's ``loss``: each leaf within 1e-4 x its max|grad| (fp32, other
  summation orders), the loss within 1e-4; recurrentgemma at 32 positions
  (the banded ``local_attention``, S > 2 x window) and at 12 (the masked
  dense form, window < S <= 2 x window);
* the same at head dims 96 and 256 (phi3's and gemma's), set on both
  packages' reduced configs;
* three ``make_train_step`` steps against the reference's on its own
  batches, as ``tests/test_torch_train.py::test_train_steps_match_reference``
  holds tinyllama: metrics within 1e-4, each leaf's change within 1e-3 x
  max|reference change|;
* the batched (4-D) ``ops.matmul`` under autograd (``MatmulFn``) against
  autograd of ``matmul_fused_ref`` at the windowed forms' shapes, operands
  fp32 x fp32 and fp32 x bf16: fp32 gradients within 1e-5 x max|plain|,
  bf16 ones bit for bit;
* the training launcher on the CPU;
* on a card only (``cuda`` marker): one gradient of every one of the
  seven configurations that train here for the first time (these four,
  moonshot-v1-16b-a3b, qwen3-moe-235b-a22b, qwen2-vl-72b), reduced, card
  against CPU, every flash call on the path its dtype and head dim name.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

try:  # the reference; a card machine without jax runs the rest
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.data import SyntheticLMData as JSyntheticLMData
    from repro.models import build_model as j_build_model
    from repro.optim import adamw as j_adamw
    from repro.training import TrainLoopConfig as JTrainLoopConfig
    from repro.training import init_train_state as j_init_train_state
    from repro.training import make_train_step as j_make_train_step
except ImportError:
    jax = None

needs_reference = pytest.mark.skipif(
    jax is None, reason="needs jax and the reference package")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.training import (  # noqa: E402
    TrainLoopConfig,
    make_grad_fn,
    make_train_step,
)
from repro_torch.tree import leaves_with_paths, tree_map  # noqa: E402

FAMILIES = ["mistral-nemo-12b", "phi3-mini-3.8b", "gemma-2b",
            "recurrentgemma-2b"]
# the seven configurations that train on the card from this slice on
NEW_TRAINERS = FAMILIES + ["moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b",
                           "qwen2-vl-72b"]
ATOL = 1e-4
GRAD_RTOL = 1e-4  # x max|grad| of the leaf
MATMUL_RTOL = 1e-5  # x max|plain|: fp32, the same products on the CPU


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, head_dim=None):
    jcfg, cfg = j_get_config(arch).reduced(), get_config(arch).reduced()
    if head_dim is not None:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    return jcfg, cfg


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)


def _loss_and_grads_match(arch, head_dim=None, seq=16):
    """The port's loss and every gradient against the reference's, from
    the reference's parameters."""
    jcfg, cfg = _configs(arch, head_dim)
    jmodel = j_build_model(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    tokens = _tokens(cfg, 2, seq, seed=seq)
    jloss, jgrads = jax.value_and_grad(lambda p: jmodel.loss(
        p, {"tokens": jnp.asarray(tokens)})[0])(jparams)
    params = params_from_jax(_np(jparams), cfg, "cpu")
    loss, _, grads = make_grad_fn(build_model(cfg, "cpu"))(
        params, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(float(loss), float(jloss), atol=ATOL, rtol=0)
    want = dict(leaves_with_paths(params_from_jax(_np(jgrads), cfg, "cpu")))
    got = leaves_with_paths(grads)
    assert [p for p, _ in got] == list(want)
    for path, g in got:
        w = want[path].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=f"{arch} hd {head_dim} {path}")


@needs_reference
@pytest.mark.parametrize("arch,seq", [(a, 16) for a in FAMILIES[:3]] + [
    ("recurrentgemma-2b", 32), ("recurrentgemma-2b", 12)],
    ids=["mistral-nemo-12b", "phi3-mini-3.8b", "gemma-2b",
         "recurrentgemma-2b-local", "recurrentgemma-2b-dense"])
def test_loss_and_every_gradient_match_reference(arch, seq):
    if arch == "recurrentgemma-2b":  # which windowed form the length takes
        w = get_config(arch).reduced().window_size
        assert (seq > 2 * w) == (seq == 32) and seq > w
    _loss_and_grads_match(arch, seq=seq)


@needs_reference
@pytest.mark.parametrize("head_dim", [96, 256])
@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_at_head_dims_96_and_256_match_reference(arch, head_dim):
    _loss_and_grads_match(arch, head_dim,
                          seq=32 if arch == "recurrentgemma-2b" else 16)


@needs_reference
@pytest.mark.parametrize("arch", FAMILIES)
def test_train_steps_match_reference(arch):
    """Three steps from the same parameters on the reference's batches, at
    a warmup of one step and a peak lr of 1e-2: every metric within 1e-4,
    and each leaf's change over the three steps within 1e-3 x max|reference
    change| of the reference's, a change at least 10x that tolerance."""
    jcfg, cfg = _configs(arch)
    jmodel = j_build_model(jcfg)
    jloop = JTrainLoopConfig(optimizer=j_adamw.AdamWConfig(lr=1e-2),
                             warmup_steps=1)
    jstate = j_init_train_state(jmodel, jax.random.PRNGKey(0), jloop)
    jstep = jax.jit(j_make_train_step(jmodel, jloop))
    params = params_from_jax(_np(jstate["params"]), cfg, "cpu")
    start = tree_map(torch.clone, params)
    state = {"params": params, "opt": adamw.adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    step = make_train_step(build_model(cfg, "cpu"), TrainLoopConfig(
        optimizer=adamw.AdamWConfig(lr=1e-2), warmup_steps=1))
    data = JSyntheticLMData(jcfg, seq_len=32, global_batch=2)
    for i in range(3):
        tokens = np.array(data.batch_at(i)["tokens"])
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens).long()})
        assert set(m) == set(jm)
        for k in m:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL,
                                       rtol=1e-6, err_msg=k)
    assert int(state["step"]) == 3
    want = dict(leaves_with_paths(params_from_jax(_np(jstate["params"]), cfg,
                                                  "cpu")))
    begin = dict(leaves_with_paths(start))
    for path, p in leaves_with_paths(state["params"]):
        moved = (p - begin[path]).numpy()
        want_moved = (want[path] - begin[path]).numpy()
        tol = 1e-3 * np.abs(want_moved).max()
        assert tol >= 1e-3 * 1e-3, f"{path}: the reference barely moved"
        assert np.abs(moved).max() >= 10 * tol, f"{path}: no update"
        np.testing.assert_allclose(moved, want_moved, atol=tol, rtol=0,
                                   err_msg=f"change of {path}")


# (batch x blocks, Hkv, rows, hd, keys): local_attention's blocks (window 8,
# GQA 4 / 2, hd 16, so 2 x window keys) and the masked dense form's one
# block of 12 positions (MQA, hd 256)
WINDOWED = {"local": (6, 2, 8 * 2, 16, 16), "dense": (2, 1, 12 * 4, 256, 12)}


@pytest.mark.parametrize("b_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("product", ["scores", "mix"])
@pytest.mark.parametrize("form", sorted(WINDOWED))
def test_batched_matmul_gradient_matches_autograd_of_plain(form, product,
                                                           b_dtype):
    """The windowed forms' two contractions as ``_scores`` and ``_mix``
    form them (fp32 grouped queries or probabilities against k or v read
    through a permuted view), through ``ops.matmul`` under autograd, which
    takes ``MatmulFn`` for 4-D operands: the output and both gradients
    against autograd through ``matmul_fused_ref``."""
    bt, hkv, rows, hd, keys = WINDOWED[form]
    rng = np.random.default_rng(len(form) + len(product))
    kv0 = rng.standard_normal((bt, keys, hkv, hd)).astype(np.float32)
    if product == "scores":
        a0 = rng.standard_normal((bt, hkv, rows, hd)).astype(np.float32)
        view = lambda t: t.permute(0, 2, 3, 1)  # noqa: E731
        n = keys
    else:
        a0 = rng.random((bt, hkv, rows, keys)).astype(np.float32)
        view = lambda t: t.permute(0, 2, 1, 3)  # noqa: E731
        n = hd
    w = torch.from_numpy(rng.standard_normal((bt, hkv, rows, n)).astype(
        np.float32))

    def run(fn):
        a = torch.from_numpy(a0).requires_grad_(True)
        kv = torch.from_numpy(kv0).to(getattr(torch, b_dtype))
        kv.requires_grad_(True)
        out = fn(a, view(kv), out_dtype=torch.float32)
        (out * w).sum().backward()
        return out, a.grad, kv.grad

    out, ga, gkv = run(ops.matmul)
    assert "MatmulFn" in type(out.grad_fn).__name__
    want, wa, wkv = run(ref.matmul_fused_ref)
    assert gkv.dtype == getattr(torch, b_dtype) and gkv.shape == kv0.shape
    for got, exp in ((out.detach(), want.detach()), (ga, wa)):
        np.testing.assert_allclose(got.numpy(), exp.numpy(), rtol=0,
                                   atol=MATMUL_RTOL * exp.abs().max().item())
    if b_dtype == "bfloat16":  # one rounding of the same fp32 sum
        assert torch.equal(gkv, wkv)
    else:
        np.testing.assert_allclose(gkv.numpy(), wkv.numpy(), rtol=0,
                                   atol=MATMUL_RTOL * wkv.abs().max().item())


def test_windowed_forms_train_through_the_batched_matmul(monkeypatch):
    """On the CPU the windowed forms keep PyTorch's own autograd through
    the plain product (the oracle above); routed through ``ops.matmul``
    instead, as a CUDA tensor is, their gradients are the same."""
    rng = np.random.default_rng(9)
    q0, k0, v0 = (rng.standard_normal((2, 40, h, 16)).astype(np.float32)
                  for h in (4, 2, 2))

    def grads():
        q, k, v = (torch.from_numpy(t).requires_grad_(True)
                   for t in (q0, k0, v0))
        out = attn.attention(q, k, v, window=8) + attn.attention(
            q[:, :12], k[:, :12], v[:, :12], window=8).sum()
        out.square().sum().backward()
        return [t.grad for t in (q, k, v)]

    want = grads()
    seen = []

    def through_ops(a, b):
        seen.append(a.shape)
        return ops.matmul(a, b, out_dtype=torch.float32)

    monkeypatch.setattr(attn, "_product", through_ops)
    got = grads()
    assert len(seen) == 4  # scores and mix, banded and dense
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=0,
                                   atol=MATMUL_RTOL * w_.abs().max().item())


@pytest.mark.parametrize("arch", ["gemma-2b", "recurrentgemma-2b"])
def test_train_launcher_runs_the_new_trainers(arch, capsys):
    from repro_torch.launch import train as launch

    rc = launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "32",
                      "--log-every", "1"])
    text = capsys.readouterr().out
    assert rc == 0 and "done: 2 steps" in text


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("arch", NEW_TRAINERS)
def test_reduced_gradient_on_card_matches_cpu(arch):
    """One gradient of the reduced model on the card and on the CPU from
    the same parameters and batch: every leaf within 2e-3 x its max|grad|
    (chip_smoke.py's card-against-CPU rule), the loss within 1e-4
    relative; every flash call on the FMA path (fp32, hd 16) and, for
    recurrentgemma, the windowed forms' 4-D products on the matmul
    kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda "
                    "tests/test_torch_family_train.py`")
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.matmul import LAUNCHES as MM_LAUNCHES

    cfg = get_config(arch).reduced()
    params = build_model(cfg, "cuda").init(0)
    batch = SyntheticLMData(cfg, seq_len=32, global_batch=2,
                            seed=0).batch_at(0)
    fa.LAUNCHES.reset()
    MM_LAUNCHES.reset()
    shapes = []
    product = attn._product

    def recording(a, b):
        shapes.append(a.shape)
        return product(a, b)

    attn._product = recording
    try:
        loss, _, grads = make_grad_fn(build_model(cfg, "cuda"))(
            params, {k: v.cuda() for k, v in batch.items()})
    finally:
        attn._product = product
    torch.cuda.synchronize()
    attn_layers = sum(cfg.block_kind(i) == "attn"
                      for i in range(cfg.n_layers))
    assert fa.LAUNCHES.by_mode["backward causal fma"] == attn_layers
    assert fa.LAUNCHES.by_path["tensor_core"] == 0
    assert bool(shapes) == bool(cfg.window_size)
    assert MM_LAUNCHES.count > 0
    cpu_loss, _, cpu_grads = make_grad_fn(build_model(cfg, "cpu"))(
        tree_map(lambda t: t.cpu(), params), batch)
    assert abs(float(loss) - float(cpu_loss)) <= 1e-4 * abs(float(cpu_loss))
    for (path, g), (_, c) in zip(leaves_with_paths(grads),
                                 leaves_with_paths(cpu_grads)):
        assert g.is_cuda, path
        err = (g.cpu() - c).abs().max().item()
        assert err <= 2e-3 * c.abs().max().item(), (path, err)
