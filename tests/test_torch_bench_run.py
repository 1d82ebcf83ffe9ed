"""The port's bench harness and training example on the CPU:

* ``SUITE_NAMES`` equals the reference harness's (``benchmarks/run.py``);
* ``run_suites(only="nope")`` raises KeyError; a suite that raises is
  returned as failed, the others still run;
* ``Runtime(device="cpu").bench(only=...)`` runs one suite (the roofline
  table over a dry-run JSON in its output directory);
* a run in a fresh working directory writes nothing outside its output
  directory (``results/torch/`` by default);
* ``kernels_bench``: the warm tuner answers the five entries with the cold
  tuner's configs and no bench call;
* ``python -m repro_torch.benches.run --list`` and ``--only``;
* ``examples/torch_train_lm.py --preset small --steps 4 --batch 2 --seq
  32`` runs and resumes from its checkpoint.
"""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.benches import kernels_bench  # noqa: E402
from repro_torch.benches import run as bench_run  # noqa: E402
from repro_torch.runtime import Runtime  # noqa: E402

REPO = Path(__file__).resolve().parent.parent


def _reference_suite_names():
    spec = importlib.util.spec_from_file_location(
        "reference_bench_run", REPO / "benchmarks" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # imports no suite
    return mod.SUITE_NAMES


def test_suite_names_match_reference():
    assert bench_run.SUITE_NAMES == _reference_suite_names()
    assert set(bench_run._suites()) == set(bench_run.SUITE_NAMES)


def test_unknown_suite_raises_and_failed_suites_are_listed(monkeypatch,
                                                           capsys):
    rt = Runtime(device="cpu")
    with pytest.raises(KeyError, match="nope"):
        bench_run.run_suites(rt, only="nope")
    ran = []

    def boom(runtime=None, out=None):
        raise RuntimeError("boom")

    def fine(runtime=None, out=None):
        ran.append(out)

    monkeypatch.setattr(bench_run, "_suites",
                        lambda: {"boom": boom, "fine": fine})
    assert bench_run.run_suites(rt, out="x") == ["boom"]
    assert ran == ["x"]
    assert "RuntimeError: boom" in capsys.readouterr().err


def _dryrun_json(path: Path) -> None:
    path.write_text(json.dumps([
        {"cell": "tinyllama-1.1b/decode_32k/pod", "status": "ok"},
        {"cell": "rwkv6-3b/long_500k/pod", "status": "skipped",
         "reason": "not applicable"}]))


def test_runtime_bench_runs_one_suite(tmp_path, capsys):
    _dryrun_json(tmp_path / "dryrun_pod.json")
    assert Runtime(device="cpu").bench(only="roofline_table",
                                       out=str(tmp_path)) == []
    out = capsys.readouterr().out
    assert "### roofline_table" in out
    assert "| tinyllama-1.1b/decode_32k/pod | — |" in out
    assert "skipped" in out


def test_a_run_writes_only_under_its_output_directory(tmp_path, monkeypatch,
                                                      capsys):
    monkeypatch.chdir(tmp_path)
    rt = Runtime(device="cpu")
    assert bench_run.run_suites(rt, only="kernels_bench") == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["results"]
    out = tmp_path / "results" / "torch"
    assert (out / "kernels.json").is_file()
    assert not list((tmp_path / "results").glob("*.json"))
    assert bench_run.run_suites(rt, only="roofline_table",
                                out=str(tmp_path / "elsewhere")) == []
    assert sorted(p.name for p in tmp_path.iterdir()) == ["elsewhere",
                                                          "results"]
    text = capsys.readouterr().out
    assert "kernel_matmul,n=128,kernel=none(cpu)" in text


def test_kernels_bench_warm_tuner_measures_nothing(tmp_path):
    from repro_torch.core.costs.autotune import Autotuner

    cold = Autotuner(cache_dir=tmp_path, measure=False, device="cpu")
    warm = Autotuner(cache_dir=tmp_path, measure=True, device="cpu",
                     bench=kernels_bench._no_bench)
    a, b = kernels_bench.tune_all(cold), kernels_bench.tune_all(warm)
    assert set(a) == set(b) and len(a) == 5
    for key, res in a.items():
        if res is None:  # flash: no tuner family
            assert key[0] == "flash_attention" and b[key] is None
            continue
        assert res.config == b[key].config == res.prior_config
    assert warm.bench_calls == 0


def test_bench_cli_lists_and_runs_one_suite(tmp_path, capsys):
    bench_run.main(["--list"])
    assert capsys.readouterr().out.split() == list(bench_run.SUITE_NAMES)
    _dryrun_json(tmp_path / "dryrun_x.json")
    bench_run.main(["--only", "roofline_table", "--out", str(tmp_path),
                    "--device", "cpu"])
    assert "=== " in capsys.readouterr().out
    with pytest.raises(SystemExit):
        bench_run.main(["--only", "nope"])


@pytest.fixture
def one_thread():
    """One intra-op thread: the small preset's many small leaf updates
    spend most of their time waking a contended thread pool otherwise."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_lm_example_runs_and_resumes(tmp_path, capsys, one_thread):
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import torch_train_lm
    finally:
        sys.path.remove(str(REPO / "examples"))
    ckpt = str(tmp_path / "ckpt")
    common = ["--preset", "small", "--batch", "2", "--seq", "32",
              "--device", "cpu", "--ckpt-dir", ckpt]
    first = torch_train_lm.main(common + ["--steps", "4"])
    assert first.steps_run == 4 and not first.diverged
    again = torch_train_lm.main(common + ["--steps", "6", "--resume"])
    assert again.start_step == 4 and again.steps_run == 2
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert "train-lm-small" in out
