"""The port's CostEngine against the reference's: given the same
``HardwareSpec`` fields, every CostQuery kind gives the same choice and the
same predicted seconds (rtol 1e-9) — the analytic layer is host Python,
transliterated.  Also the port's calibration layer's CPU-side contract."""

import dataclasses
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.costs.engine import CostEngine as JCostEngine  # noqa: E402
from repro.hw import SITE_FIELDS as J_SITE_FIELDS  # noqa: E402
from repro.hw import V5E  # noqa: E402
from repro.hw import HardwareSpec as JSpec  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.costs import calibration  # noqa: E402
from repro_torch.core.costs.engine import CostEngine  # noqa: E402
from repro_torch.hw import H100, SITE_FIELDS, HardwareSpec  # noqa: E402

SERVE = dict(flops_per_token=2_200_000_000, weight_bytes=2_200_000_000)

# (decision method, positional args, keyword args): all eleven query kinds
QUERIES = [
    ("decide_matmul", (512, 512, 512), dict(chips=4, io_at_master=True)),
    ("decide_matmul", (4, 2048, 2048), dict(chips=1, dtype_bytes=2)),
    ("decide_sort", (1 << 20,), dict(chips=8)),
    ("decide_scan_chunk", (4096,), dict(batch=2, heads=8, head_dim=64)),
    ("decide_moe_dispatch", (512, 1024), dict(top_k=2, ep_shards=4)),
    ("decide_layer_shard", (256, 4096, 4096), dict(tp=4)),
    ("decide_serve_prefill_chunk", (64,), dict(active_decodes=0, **SERVE)),
    ("decide_serve_prefill_chunk", (200,), dict(active_decodes=3, **SERVE)),
    ("decide_serve_admission", (2,), dict(waiting=5, free_slots=2,
                                          kv_bytes_per_slot=1 << 20, **SERVE)),
    ("decide_serve_decode_step", (4,), dict(kv_bytes_per_slot=1 << 20,
                                            **SERVE)),
    ("decide_serve_macro", (3,), dict(remaining=(2, 9, 31),
                                      candidates=(1, 2, 4, 8, 16, 32),
                                      **SERVE)),
    ("decide_serve_macro", (4,), dict(remaining=(1, 1, 1, 1),
                                      candidates=(1, 2, 4), **SERVE)),
    ("decide_serve_admit", (2,), dict(n_slots=4, prompt_len=64, new_tokens=32,
                                      slack_us=None, ttft_slack_us=None,
                                      **SERVE)),
    ("decide_serve_admit", (3,), dict(n_slots=4, prompt_len=64, new_tokens=32,
                                      slack_us=200, ttft_slack_us=50, **SERVE)),
    ("decide_serve_shard", (4,), dict(tp=4, n_layers=22, d_model=2048,
                                      **SERVE)),
    ("decide_serve_prefix", (64,), dict(hit_tokens=48, cow_blocks=1, chunk=64,
                                        block_size=16, **SERVE)),
    ("decide_serve_ipc_workers", (8,), dict(msg_bytes=600, validate_us=10)),
    ("decide_serve_ipc_coalesce", (4,), dict(event_bytes=60,
                                             token_interval_us=900)),
]


def test_site_fields_and_spec_fields_match_the_reference():
    assert SITE_FIELDS == J_SITE_FIELDS
    assert [f.name for f in dataclasses.fields(HardwareSpec)] == \
        [f.name for f in dataclasses.fields(JSpec)]


def test_queries_cover_all_eleven_kinds():
    eng = CostEngine()
    for method, args, kwargs in QUERIES:
        getattr(eng, method)(*args, **kwargs)
    assert {e.site for e in eng.ledger.entries} == {
        "matmul", "sort", "scan_chunk", "moe_dispatch", "layer_shard",
        "serve", "serve_macro", "serve_shard", "serve_admit", "serve_prefix",
        "serve_ipc"}


@pytest.mark.parametrize("spec", ["v5e", "h100"])
@pytest.mark.parametrize("method,args,kwargs", QUERIES,
                         ids=[f"{q[0]}-{i}" for i, q in enumerate(QUERIES)])
def test_query_same_choice_and_seconds(spec, method, args, kwargs):
    fields = (V5E if spec == "v5e" else H100).to_dict()
    want = getattr(JCostEngine(hw=JSpec.from_dict(fields)), method)(
        *args, **kwargs)
    got = getattr(CostEngine(hw=HardwareSpec.from_dict(fields)), method)(
        *args, **kwargs)
    assert got.choice == want.choice
    assert got.value == want.value
    assert got.predicted_s == pytest.approx(want.predicted_s, rel=1e-9)
    assert [a.total for a in got.alternatives] == pytest.approx(
        [a.total for a in want.alternatives], rel=1e-9)


def test_default_spec_is_h100_data_sheet():
    assert CostEngine().hw == H100
    assert H100.peak_flops_bf16 == 989e12 and H100.hbm_bw == 3.35e12


def test_calibration_needs_the_card(tmp_path):
    """A measurement path that finds no card raises; it never times the
    CPU under a device metric's name."""
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration.calibrate(H100, cache_dir=tmp_path, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        calibration.run_probe_fields(["hbm_bw"], device="cpu")


def test_calibration_cache_roundtrip_and_location(tmp_path):
    spec = dataclasses.replace(H100, hbm_bw=1.5e12)
    path = tmp_path / "fp.json"
    calibration.save_calibration(path, spec, fingerprint="fp",
                                 measurements={"hbm_bw": 1.5e12})
    loaded = calibration.load_calibration(path, fingerprint="fp")
    assert loaded["spec"] == spec
    assert calibration.load_calibration(path, fingerprint="other") is None
    # the port's own cache, inside the checkout: never ~/.cache/repro
    default = calibration.default_cache_dir()
    assert default == Path(repro_torch.__file__).resolve().parents[2] / \
        "build" / "calibration"
    assert calibration.backend_fingerprint("cpu").startswith("cpu-")
