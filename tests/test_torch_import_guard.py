"""The port stands alone: importing every ``repro_torch`` module loads no
``jax`` and nothing of the reference package ``repro``, and its entry
points run on the card unless the caller asks for the CPU."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

_SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_GUARD = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m.startswith("jaxlib.") or m == "repro"
             or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_no_jax_and_no_reference():
    env = dict(os.environ, PYTHONPATH=str(_SRC))
    out = subprocess.run([sys.executable, "-c", _GUARD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.strip().split(" ", 1)
    assert int(count) >= 15, out.stdout
    assert bad == "[]", out.stdout


def test_engine_runs_on_the_card_unless_told_otherwise():
    from repro_torch.core import Aulid
    from repro_torch.device import resolve
    from repro_torch.serving import IndexEngine

    keys = np.arange(1, 2000, dtype=np.uint64) * np.uint64(7)
    idx = Aulid()
    idx.bulkload(keys, keys + np.uint64(1))
    if torch.cuda.is_available():
        eng = IndexEngine(idx)
        assert eng.device.type == "cuda"
        assert eng.stats()["read_backend"] == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IndexEngine(idx)
        with pytest.raises(RuntimeError):
            resolve("cuda")
    eng = IndexEngine(idx, device="cpu")
    assert eng.stats()["read_backend"] == "torch"
    assert resolve("cpu") == torch.device("cpu")


def test_cuda_kernels_refuse_without_a_card():
    """A wrapper given a tensor on a device other than cpu or cuda raises;
    it never computes there through the plain version."""
    from repro_torch.kernels.fused_lookup.ops import fused_lookup
    from repro_torch.kernels.overlay_merge.ops import overlay_merge
    q = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        fused_lookup({}, None, q, 3)
    with pytest.raises(ValueError):
        overlay_merge(torch.zeros((3, 4), dtype=torch.int64, device="meta"),
                      q.reshape(1, 4), 4)
