"""The port's roofline (``repro_torch/roofline.py``) against the
reference's (``src/repro/roofline.py``).

* ``RooflineTerms`` equals the reference's on a grid of inputs, every
  ``as_dict`` value within rel 1e-12, with the port's ``HardwareSpec``
  given the reference's V5E values (and the port's default is the H100);
* ``model_flops_for`` is equal for all 40 (arch, shape) pairs;
* the cases of ``tests/test_roofline.py`` that parse no HLO, ported;
* the dispatch counter's traffic rules (``fused_memory_bytes``'s, at the
  dispatch level) on hand-counted ops, and the kernels' cost functions.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.hw import H100, HardwareSpec  # noqa: E402
from repro_torch.kernels import calls  # noqa: E402
from repro_torch.roofline import (DispatchCounter, RooflineTerms,  # noqa: E402
                                  model_flops_for)

jax_roofline = pytest.importorskip("repro.roofline")


def _v5e_pair():
    from repro.hw import V5E

    return V5E, HardwareSpec.from_dict(V5E.to_dict())


GRID = list(itertools.product(
    (0.0, 1e12, 3.7e15, 2e18),          # flops
    (1.0, 5e9, 8.1e14),                 # hbm_bytes
    (0.0, 2e9, 6e13),                   # collective_bytes
    (1, 256, 512),                      # chips
    (0.0, 4e14),                        # model_flops
    (0.0, 3e9)))                        # hbm_bytes_min


@pytest.mark.parametrize("chunk", range(8))
def test_roofline_terms_match_reference(chunk):
    j_hw, hw = _v5e_pair()
    assert hw.peak_flops_bf16 == j_hw.peak_flops_bf16
    assert hw.hbm_bw == j_hw.hbm_bw and hw.ici_links == j_hw.ici_links
    for args in GRID[chunk::8]:
        f, hb, cb, chips, mf, hbmin = args
        kw = dict(flops=f, hbm_bytes=hb, collective_bytes=cb, chips=chips,
                  model_flops=mf, hbm_bytes_min=hbmin, label="cell")
        want = jax_roofline.RooflineTerms(**kw, hw=j_hw).as_dict()
        got = RooflineTerms(**kw, hw=hw).as_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            if isinstance(w, str):
                assert got[k] == w, (k, args)
            else:
                assert got[k] == pytest.approx(w, rel=1e-12, abs=0), (k, args)


def test_roofline_terms_default_to_the_h100():
    t = RooflineTerms(flops=1e15, hbm_bytes=1e9, collective_bytes=0.0,
                      chips=8)
    assert t.hw is H100 and t.as_dict()["hw"] == "h100-sxm"
    assert t.t_compute == pytest.approx(1e15 / (8 * 989e12))


@pytest.mark.parametrize("arch", list_configs())
@pytest.mark.parametrize("shape", list(SHAPES))
def test_model_flops_for_matches_reference(arch, shape):
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import get_config as j_get_config

    assert model_flops_for(get_config(arch), SHAPES[shape]) == \
        jax_roofline.model_flops_for(j_get_config(arch), J_SHAPES[shape])


# --- tests/test_roofline.py's cases that parse no HLO, on the port --------


def test_roofline_terms_bound_selection():
    t = RooflineTerms(flops=1e15, hbm_bytes=1e9, collective_bytes=1e9,
                      chips=256, model_flops=5e14)
    assert t.bound == "compute"
    assert t.useful_flops_fraction == pytest.approx(0.5)
    t2 = RooflineTerms(flops=1e12, hbm_bytes=1e15, collective_bytes=1e9,
                       chips=256)
    assert t2.bound == "memory"
    t3 = RooflineTerms(flops=1e12, hbm_bytes=1e9, collective_bytes=1e14,
                       chips=256)
    assert t3.bound == "collective"


def test_roofline_fraction_bounded():
    t = RooflineTerms(flops=2e15, hbm_bytes=1.0, collective_bytes=1.0,
                      chips=256, model_flops=1e15)
    # compute-bound: roofline fraction = useful fraction of counted flops
    assert 0 < t.roofline_fraction <= 1.0
    assert t.roofline_fraction == pytest.approx(0.5)


def test_model_flops_train_vs_decode():
    cfg = get_config("tinyllama-1.1b")
    tr = model_flops_for(cfg, SHAPES["train_4k"])
    de = model_flops_for(cfg, SHAPES["decode_32k"])
    # train: 6*N*B*S; decode: 2*N*B
    assert tr == pytest.approx(6 * cfg.param_count() * 4096 * 256, rel=1e-6)
    assert de == pytest.approx(2 * cfg.param_count() * 128, rel=1e-6)


def test_model_flops_moe_uses_active_params():
    cfg = get_config("qwen3-moe-235b-a22b")
    tr = model_flops_for(cfg, SHAPES["train_4k"])
    assert tr == pytest.approx(6 * cfg.active_param_count() * 4096 * 256,
                               rel=1e-6)
    assert cfg.active_param_count() < 0.15 * cfg.param_count()


# --- the dispatch counter and the cost functions --------------------------


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_counter_traffic_rules_by_hand():
    """fused_memory_bytes's rules at the dispatch level: a gather twice its
    result, a scatter three times its updates, a sort its operands and
    results, an elementwise op nothing (fused); the upper bound every
    non-view op's operands and results; a view nothing."""
    x = _meta(64, 32)
    idx = torch.empty((10,), dtype=torch.int64, device="meta")
    with DispatchCounter() as c:
        y = x * 2.0                          # 8192 in + 8192 out
        v = y.view(32, 64)                   # a view: nothing
        g = torch.index_select(x, 0, idx)    # gather: 2 x 1280
        s = torch.zeros_like(x).index_add_(0, idx, g)  # scatter: 3 x 80
        srt, _ = torch.sort(x, dim=-1)       # sort: in + out (+ int64 ids)
    del v, s, srt
    n = 64 * 32 * 4
    assert c.traffic_min == 2 * 1280 + 3 * 80 + (n + n + 64 * 32 * 8)
    # mul, index_select, zeros_like (its operand is read for its shape),
    # index_add_ (the destination in and out), sort (values and ids)
    upper = (n + n) + (n + 80 + 1280) + (n + n) + (n + 80 + 1280 + n) \
        + (n + n + 64 * 32 * 8)
    assert c.traffic == upper
    assert c.product_flops == 0.0


def test_counter_peak_follows_frees():
    """Live bytes rise as storages are made and fall as they are freed; the
    peak is the largest, the arguments counted from the start."""
    x = _meta(1024)  # 4 KiB
    with DispatchCounter() as c:
        c.add_arguments([x], [None])
        a = x + 1.0
        b = a * 2.0
        del a
        d = b + 1.0
        del b, d
    assert c.arguments == {None: 4096}
    assert c.peak == {None: 3 * 4096}
    assert c.live == {None: 4096}


def test_meta_cache_gives_the_meta_kernels_outputs():
    """The cached meta outputs have the shapes, strides and dtypes the meta
    kernels give, for a layout-preserving op and a reduction."""
    x = _meta(4, 6, 8, dtype=torch.bfloat16).permute(2, 0, 1)
    want = [(x * 3).float(), x.sum(-1), torch.cat([x, x], 1)]
    with DispatchCounter() as c:
        for _ in range(2):
            got = [(x * 3).float(), x.sum(-1), torch.cat([x, x], 1)]
            for g, w in zip(got, want):
                assert (g.shape, g.stride(), g.dtype) == \
                    (w.shape, w.stride(), w.dtype)
    assert len(c._cache) >= 4


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_matmul_cost(dt):
    a, b = _meta(3, 5, 7, 11, dtype=dt), _meta(3, 5, 11, 13, dtype=dt)
    flops, nbytes = calls.matmul_cost(a, b, torch.float32)
    assert flops == 2 * 15 * 7 * 13 * 11
    es = torch.empty((), dtype=dt).element_size()
    assert nbytes == es * (a.numel() + b.numel()) + 4 * 15 * 7 * 13


def test_flash_and_sort_costs():
    q, k = _meta(2, 16, 8, 64), _meta(2, 24, 2, 64)
    f, nb = calls.flash_cost(q, k, "forward")
    assert f == 4 * 2 * 8 * 16 * 24 * 64
    assert nb == 4 * (2 * q.numel() + 2 * k.numel()) + 4 * 2 * 8 * 16
    fb, _ = calls.flash_cost(q, k, "backward")
    assert fb == 2 * f
    x = _meta(3, 1024)
    f, nb = calls.sort_cost(x)
    assert f == 3 * 512 * 10 * 11 / 2 and nb == 2 * 4 * 3 * 1024
    assert np.isfinite(calls.wkv_cost(_meta(1, 8, 2, 16), "backward")[1])
