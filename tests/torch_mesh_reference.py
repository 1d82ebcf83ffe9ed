"""Run the reference over a mesh of forced host devices, for the port's
mesh tests (``tests/test_torch_mesh.py``, ``test_torch_sample_sort.py``,
``test_torch_sharded_dispatch.py``, ``test_torch_pipeline.py``).

jax fixes its device count when it first starts, so the reference runs in
a fresh interpreter with ``--xla_force_host_platform_device_count`` set,
on a mesh whose axes are ``AxisType.Auto`` (jax 0.9 makes ``Explicit``
ones by default, under which the reference's ``shard_map`` bodies fail),
and hands its arrays back in an ``.npz``.  A card machine without jax
skips the tests that need it (``needs_reference``)."""

import importlib.util
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent

needs_reference = pytest.mark.skipif(
    importlib.util.find_spec("jax") is None,
    reason="needs jax and the reference package")

_PRELUDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType


def auto_mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape))


OUT = {}
"""

_EPILOGUE = """
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in OUT.items()})
"""


def run_reference(body: str, out: Path, devices: int = 8,
                  timeout: float = 300) -> dict:
    """Run ``body`` (which fills ``OUT``, a dict of arrays) in a fresh
    interpreter with ``devices`` host devices; returns ``OUT``."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO / "src")
    script = _PRELUDE + textwrap.dedent(body) + _EPILOGUE
    proc = subprocess.run([sys.executable, "-c", script, str(out)], env=env,
                          capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, \
        f"STDOUT:\n{proc.stdout}\nSTDERR:\n{proc.stderr}"
    with np.load(out) as data:
        return dict(data)
