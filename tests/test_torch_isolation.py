"""The port stands alone, runs on the card by default, and its kernel
agrees with the kernel's plain version on the card.

* every ``repro_torch`` module imports without pulling in ``jax`` or
  ``repro`` (checked in a fresh interpreter);
* ``repro_torch.Runtime()`` with no device asks for the GPU and raises
  where there is none, naming the missing card, instead of falling back;
* on a CUDA card (marked ``cuda``; skipped elsewhere), the matmul kernel
  matches its plain version at serving shapes: bf16 within 8e-3 x
  max|plain| (about one bf16 rounding), fp32 within 1e-5 x max|plain|,
  and gives bit-identical rows whatever the batch size.
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
    assert int(count) >= 25
    assert leaked.strip() == "[]"


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


def test_cuda_tensor_never_takes_the_plain_path():
    """Without a card a CUDA tensor cannot exist; the wrapper refuses any
    non-CUDA operand rather than running the plain version."""
    from repro_torch.kernels.matmul import matmul_cuda

    a = torch.ones((2, 3))
    with pytest.raises(ValueError, match="CUDA"):
        matmul_cuda(a, torch.ones((3, 4)))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 4, 256])
def test_kernel_matches_plain_on_card(m):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); on a card run `python -m "
                    "pytest --noconftest -m cuda tests/test_torch_isolation.py`")
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.matmul import LAUNCHES

    gen = torch.Generator(device="cuda").manual_seed(m)
    a = torch.randn((m, 2048), generator=gen, device="cuda")
    b = torch.randn((2048, 5632), generator=gen, device="cuda") / 2048 ** 0.5
    for dt, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
        for act in (None, "silu", "gelu"):
            before = LAUNCHES.count
            got = ops.matmul(a.to(dt), b.to(dt), activation=act)
            assert LAUNCHES.count == before + 1
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
