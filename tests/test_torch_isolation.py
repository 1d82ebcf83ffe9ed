"""The port stands alone, runs on the card by default, and its kernel
agrees with the kernel's plain version on the card.

* every ``repro_torch`` module imports without pulling in ``jax`` or
  ``repro`` (checked in a fresh interpreter), the rwkv6 family's
  (``models/rwkv.py``, ``kernels/wkv.py``, ``configs/rwkv6_3b.py``)
  among them, and so do the paging and token-stream modules and
  ``examples/torch_quickstart.py``'s imports, and the autotuner's
  (``core/costs/autotune.py``, ``kernels/tuning.py``, ``core/overhead.py``),
  whose ``Autotuner`` the public surface exports as the reference's does,
  and the tensor-parallel serving modules' (``distributed/sharding.py``,
  the engine, the launcher, ``checkpoint.restore_resharded``), and the
  training mesh's (``distributed/mesh.py``'s collectives with a backward,
  ``models/ffn.py``'s expert parallelism, the mesh loss and train step,
  the cost sites that price shared devices), and the bench suites'
  (``repro_torch.benches``, ``Runtime.bench``,
  ``examples/torch_train_lm.py``), which import nothing of the
  reference's ``benchmarks/`` either;
* what a spawned front-end worker imports loads no torch either, and on a
  card (marked ``cuda``) the workers of a front end spawned beside a CUDA
  tensor hold no context on it;
* ``repro_torch.Runtime()`` with no device asks for the GPU and raises
  where there is none, naming the missing card, instead of falling back;
* a tensor that is not on the CPU never takes a kernel's plain version:
  the WKV entry points route a non-CPU tensor to the kernel's wrapper,
  which launches only for CUDA tensors; a meta tensor (the dry run) takes
  the card path's checks and allocations there and is recorded in the
  call log, with no launch and no plain version, and the dry run's
  modules (``launch/dryrun.py``, ``roofline.py``, ``kernels/calls.py``)
  import neither jax nor repro;
* on a CUDA card (marked ``cuda``; skipped elsewhere), the matmul kernel
  matches its plain version at serving shapes: bf16 within 8e-3 x
  max|plain| (about one bf16 rounding), fp32 within 1e-5 x max|plain|,
  on the path its dtypes name, and gives bit-identical rows whatever the
  batch size (every path, epilogue and operand form:
  test_torch_matmul_paths.py).
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for attr in repro_torch.__all__:
    getattr(repro_torch, attr)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.split(" ", 1)
    assert int(count) >= 50
    assert leaked.strip() == "[]"


_IMPORT_RWKV = """
import sys
import repro_torch.configs.rwkv6_3b, repro_torch.kernels.wkv
import repro_torch.models.rwkv
from repro_torch.configs import get_config
print(get_config("rwkv6-3b").n_layers, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_rwkv_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_RWKV], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["32", "[]\n"]


_IMPORT_SERVING = """
import importlib.util, sys
import repro_torch.serving.paging, repro_torch.serving.frontend.stream
spec = importlib.util.spec_from_file_location("torch_quickstart", sys.argv[1])
quickstart = importlib.util.module_from_spec(spec)
spec.loader.exec_module(quickstart)  # its imports; main() does not run
print(callable(quickstart.main), sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_paging_stream_and_quickstart_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    quickstart = SRC.parent / "examples" / "torch_quickstart.py"
    out = subprocess.run([sys.executable, "-c", _IMPORT_SERVING,
                          str(quickstart)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["True", "[]\n"]


_IMPORT_AUTOTUNE = """
import sys
import repro_torch
import repro_torch.core.costs.autotune, repro_torch.kernels.tuning
import repro_torch.core.overhead
from repro_torch.core.costs import Autotuner
assert repro_torch.Autotuner is Autotuner is repro_torch.core.Autotuner
print("Autotuner" in repro_torch.__all__, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_autotuner_modules_import_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_AUTOTUNE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["True", "[]\n"]


_IMPORT_SERVE_MESH = """
import sys
import repro_torch.distributed.sharding, repro_torch.launch.serve
import repro_torch.checkpoint.checkpoint, repro_torch.serving.engine
from repro_torch.distributed.sharding import ShardingCtx, place_tree
from repro_torch.checkpoint import restore_resharded
print(callable(place_tree), sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_serve_mesh_modules_import_neither_jax_nor_repro():
    """The tensor-parallel serving modules: the sharding rules and
    placement, the mesh-aware engine, launcher and checkpoint restore."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_SERVE_MESH], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["True", "[]\n"]


_IMPORT_TRAIN_MESH = """
import sys
import repro_torch.distributed.mesh, repro_torch.distributed.sharding
import repro_torch.models.ffn, repro_torch.models.model
import repro_torch.models.transformer, repro_torch.training.step
import repro_torch.checkpoint.checkpoint, repro_torch.core.planner
import repro_torch.core.costs.model, repro_torch.core.costs.engine
import repro_torch.core.sort, repro_torch.core.dispatch
import repro_torch.serving.scheduler, repro_torch.optim.adamw
from repro_torch.distributed import all_gather_cat, join
from repro_torch.models.ffn import moe_ep, moe_ep_plain
from repro_torch.training import make_train_step
print(callable(moe_ep), sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_train_mesh_modules_import_neither_jax_nor_repro():
    """The training mesh's modules: the collectives with a backward, the
    training context, expert parallelism, the mesh loss and train step,
    the placed checkpoint, and the cost sites that price shared devices."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_TRAIN_MESH],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["True", "[]\n"]


_IMPORT_DRYRUN = """
import sys
import repro_torch.launch.dryrun, repro_torch.roofline
import repro_torch.kernels.calls
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.data import make_batch_specs
mesh = make_production_mesh(multi_pod=True)
print(mesh.size, sorted(
    m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_dryrun_modules_import_neither_jax_nor_repro():
    """The dry run's modules: the CLI and cell runner, the roofline and its
    dispatch counter, the kernels' call log, the production meshes."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_DRYRUN], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["512", "[]\n"]


_IMPORT_BENCHES = """
import runpy, sys
from repro_torch.benches import (chaos_bench, common, cost_ledger,
                                 frontend_smoke, kernels_bench,
                                 matmul_crossover, roofline_table, run,
                                 serving_bench, sort_pivots, stress_bench,
                                 wkv_chunk)
import repro_torch
assert hasattr(repro_torch.Runtime, "bench")
runpy.run_path(sys.argv[1], run_name="example")  # its imports, no main()
print(len(run.SUITE_NAMES), sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "repro", "benchmarks")))
"""


def test_bench_modules_and_train_example_import_neither_jax_nor_repro():
    """The bench suites, the harness behind ``Runtime.bench`` and
    ``examples/torch_train_lm.py``: no jax, no reference package, and
    nothing of the reference's ``benchmarks/``."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    example = SRC.parent / "examples" / "torch_train_lm.py"
    out = subprocess.run([sys.executable, "-c", _IMPORT_BENCHES,
                          str(example)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(" ", 1) == ["9", "[]\n"]


def test_public_surface_has_the_reference_autotuner():
    """The reference's exports that the port has include ``Autotuner``
    (read from the reference's source: this process may not load it)."""
    import ast

    import repro_torch

    tree = ast.parse((SRC / "repro" / "__init__.py").read_text())
    ref_all = next(ast.literal_eval(node.value) for node in tree.body
                   if isinstance(node, ast.Assign)
                   and getattr(node.targets[0], "id", "") == "__all__")
    assert "Autotuner" in ref_all and "Autotuner" in repro_torch.__all__
    assert repro_torch.Autotuner.__module__ == \
        "repro_torch.core.costs.autotune"


_IMPORT_WORKER = """
import sys
import repro_torch.serving.frontend.workers
import repro_torch.serving.scheduler  # what _intake_main imports
import repro_torch.launch.serve  # a launcher's worker re-imports it
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "torch")))
"""


def test_frontend_worker_imports_neither_torch_nor_jax_nor_repro():
    """A spawned front-end worker imports its module, the topology module
    and the scheduler's request validation (and, under the launcher, the
    launcher module): none of that may load torch, jax or the reference."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_WORKER], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _compute_pids():
    """Pids nvidia-smi lists as holding a CUDA context on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [int(x) for x in out.stdout.split()]


@pytest.mark.cuda
def test_frontend_workers_create_no_cuda_context():
    """A front end spawned next to a live CUDA tensor: its workers answer
    (readiness pings, one validated submission, a streamed burst) and none
    of them appears among the processes holding a context on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_isolation.py`")
    from repro_torch.serving.frontend import FrontendConfig, ServingFrontend

    x = torch.ones(1 << 20, device="cuda")
    torch.cuda.synchronize()
    before = _compute_pids()
    fe = ServingFrontend(FrontendConfig(workers=2), max_len=16)
    fe.start()
    try:
        ok, bad = fe.submit([{"rid": "a", "prompt": [1, 2],
                              "max_new_tokens": 2}])
        fe.stream().publish("a", x[:2].long(), done=True, t=0.0)
        children = {p.pid for p in fe._intake_procs} | {fe._emit_proc.pid}
        during = _compute_pids()
        assert fe.finish()["a"]["tokens"] == [1, 1]
    finally:
        fe.close()
    assert set(ok) == {"a"} and not bad
    assert not children & set(during), (children, during)
    assert len(during) == len(before), (before, during)


def test_runtime_without_device_needs_the_card():
    import repro_torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: Runtime() runs on it")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        repro_torch.Runtime()
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        repro_torch.Runtime(repro_torch.RuntimeConfig(device="cuda"))
    assert repro_torch.Runtime(device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.Runtime(repro_torch.RuntimeConfig(calibrate=True),
                            device="cpu")  # measuring needs the card


def test_runtime_hardware_spec():
    import dataclasses

    import repro_torch

    assert repro_torch.Runtime(device="cpu").hw == repro_torch.H100
    spec = dataclasses.replace(repro_torch.H100, hbm_bw=2e12)
    rt = repro_torch.Runtime(repro_torch.RuntimeConfig(hardware=spec,
                                                       device="cpu"))
    assert rt.hw is spec and rt.ledger is rt.engine.ledger


def test_kernel_build_failures_raise(tmp_path, monkeypatch):
    """No nvcc, or an nvcc that fails: the build raises with the reason;
    nothing falls back and no library is left behind."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "DEFAULT_NVCC", tmp_path / "no-nvcc")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    (tmp_path / "bin").mkdir()
    fake = tmp_path / "bin" / "nvcc"
    fake.write_text("#!/bin/sh\necho 'matmul.cu(1): error: no card here'\n"
                    "exit 2\n")
    fake.chmod(0o755)
    with pytest.raises(RuntimeError, match="no card here"):
        build.build_all()
    assert not build.library_path("matmul").exists()


def test_library_path_tracks_the_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every ``csrc/*.cuh``: an
    edited header renames (so rebuilds) every library, an edited source
    only its own."""
    import shutil

    from repro_torch.kernels import build

    before = {n: build.library_path(n) for n in build.SOURCES}
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert (csrc / "hopper.cuh").exists()
    monkeypatch.setattr(build, "CSRC", csrc)
    assert before == {n: build.library_path(n) for n in build.SOURCES}
    header = csrc / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    edited = {n: build.library_path(n) for n in build.SOURCES}
    assert all(edited[n] != before[n] for n in build.SOURCES)
    source = csrc / "flash_attention.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != edited[n]] == [
        "flash_attention"]


def test_cuda_tensor_never_takes_the_plain_path():
    """Without a card a CUDA tensor cannot exist; the wrapper refuses any
    non-CUDA operand rather than running the plain version."""
    from repro_torch.kernels.matmul import matmul_cuda

    a = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(a, torch.ones((3, 4)))


def test_wkv_off_the_cpu_never_takes_the_plain_path(monkeypatch):
    """``ops.wkv`` and ``WkvFn`` choose the plain version only for a tensor
    on the CPU; any other device goes to the kernel's wrapper, which
    launches only for CUDA tensors: a ``meta`` tensor (the dry run) takes
    the card path's checks and allocations, is recorded in the call log,
    and neither launches nor runs the plain version."""
    from repro_torch.kernels import calls, ops
    from repro_torch.kernels import wkv as wkv_k
    from repro_torch.kernels.wkv import LAUNCHES, WkvFn

    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached the plain version")

    monkeypatch.setattr(wkv_k, "wkv_fwd_plain", refuse)
    monkeypatch.setattr(wkv_k, "wkv_bwd_plain", refuse)
    monkeypatch.setattr(ops, "wkv_fwd_plain", refuse)
    monkeypatch.setattr(wkv_k, "_functions", refuse)
    x = torch.empty((1, 8, 2, 16), device="meta")
    u = torch.empty((2, 16), device="meta")
    before = (LAUNCHES.forward, LAUNCHES.backward, dict(LAUNCHES.cuda))
    with calls.CallLog() as log:
        out, state = ops.wkv(x, x, x, x, u)
        xg = x.clone().requires_grad_(True)
        o2, s2 = WkvFn.apply(xg, x, x, x, u, 16)
        (o2.sum() + s2.sum()).backward()
    assert out.is_meta and out.shape == (1, 8, 2, 16)
    assert state.shape == (1, 2, 16, 16) and xg.grad.is_meta
    assert [(c.kernel, c.mode) for c in log.calls] == [
        ("wkv", "forward"), ("wkv", "forward"), ("wkv", "backward")]
    assert (LAUNCHES.forward, LAUNCHES.backward, LAUNCHES.cuda) == before


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 256])
def test_kernel_matches_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_isolation.py`")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.matmul import LAUNCHES, choose_path

    gen = torch.Generator(device="cuda").manual_seed(m)
    a = torch.randn((m, 2048), generator=gen, device="cuda")
    b = torch.randn((2048, 5632), generator=gen, device="cuda") / 2048 ** 0.5
    for dt, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        for act in (None, "silu", "gelu"):
            before = LAUNCHES.count
            on_path = LAUNCHES.by_path[choose_path(dt, dt)]
            got = ops.matmul(a.to(dt), b.to(dt), activation=act)
            assert LAUNCHES.count == before + 1
            assert LAUNCHES.by_path[choose_path(dt, dt)] == on_path + 1
            want = ref.matmul_fused_ref(a.to(dt), b.to(dt), activation=act)
            err = (got.float() - want.float()).abs().max().item()
            assert err <= tol * want.float().abs().max().item(), (dt, act)
    ab = a.to(torch.bfloat16)
    whole = ops.matmul(ab, b.to(torch.bfloat16))
    row = ops.matmul(ab[m // 2:m // 2 + 1].contiguous(), b.to(torch.bfloat16))
    assert torch.equal(whole[m // 2:m // 2 + 1], row)  # batch-invariant
    sq, ones = a * a, torch.ones((2048, 1), device="cuda")  # rmsnorm's sum
    got = ops.matmul(sq, ones)
    want = ref.matmul_fused_ref(sq, ones)
    assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()
    row = ops.matmul(sq[m // 2:m // 2 + 1].contiguous(), ones)
    assert torch.equal(got[m // 2:m // 2 + 1], row)
