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
    # K1-K6, the LM path of every family (rwkv6, mamba2 and the ten
    # configs), the index mesh and checkpointing included
    assert int(count) >= 56, out.stdout
    assert bad == "[]", out.stdout


_FAMILIES = r"""
import sys
from repro_torch.configs import ARCHS
from repro_torch.models import mamba2, model, rwkv6   # noqa: F401
print(len(ARCHS), sorted({c.family for c in ARCHS.values()}))
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                         "repro")))
"""


def test_every_family_imports_no_jax_and_no_reference():
    """The ssm, hybrid, audio and vlm modules and configs load alone."""
    env = dict(os.environ, PYTHONPATH=str(_SRC))
    out = subprocess.run([sys.executable, "-c", _FAMILIES], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split("\n")[:2] == [
        "10 ['audio', 'dense', 'hybrid', 'moe', 'ssm', 'vlm']", "[]"]


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


def test_sharded_engine_runs_on_the_card_unless_told_otherwise():
    from repro_torch.core import partition_bulkload
    from repro_torch.serving import ShardedIndexEngine

    keys = np.arange(1, 2000, dtype=np.uint64) * np.uint64(7)
    part = partition_bulkload(keys, keys + np.uint64(1), 3)
    if torch.cuda.is_available():
        eng = ShardedIndexEngine(part)
        assert eng.device.type == "cuda"
        assert eng.stats()["read_backend"] == "cuda"
        assert eng.stk["leaf_keys"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedIndexEngine(part)
    eng = ShardedIndexEngine(part, device="cpu")
    assert eng.stats()["read_backend"] == "torch"
    assert eng.stk["leaf_keys"].device.type == "cpu"


def test_cuda_kernels_refuse_without_a_card():
    """A wrapper given a tensor on a device other than cpu or cuda raises;
    it never computes there through the plain version."""
    from repro_torch.kernels.fused_lookup.ops import (fused_lookup,
                                                      fused_lookup_sharded)
    from repro_torch.kernels.inner_probe.ops import probe_level
    from repro_torch.kernels.leaf_search.ops import leaf_search
    from repro_torch.kernels.overlay_merge.ops import (overlay_merge,
                                                       overlay_merge_stacked)
    from repro_torch.kernels.overlay_probe.ops import overlay_probe
    from repro_torch.kernels.paged_attention.ops import paged_attention
    q = torch.zeros(4, dtype=torch.int64, device="meta")
    pack = torch.zeros((3, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        fused_lookup({}, None, q, 3)
    with pytest.raises(ValueError):
        fused_lookup_sharded({}, None, q, 3)
    with pytest.raises(ValueError):
        overlay_merge(pack, q.reshape(1, 4), 4)
    with pytest.raises(ValueError):
        overlay_merge_stacked(pack[None], pack[None], 4)
    with pytest.raises(ValueError):
        overlay_probe({"ov_pack": pack}, q)
    with pytest.raises(ValueError):
        leaf_search(pack, pack, q.to(torch.int32), q)
    with pytest.raises(ValueError):
        probe_level({}, q.to(torch.int32), q)
    qa = torch.zeros((2, 4, 8), device="meta")
    pages = torch.zeros((3, 4, 2, 8), device="meta")
    with pytest.raises(ValueError):
        paged_attention(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                        torch.ones(2, dtype=torch.int32, device="meta"), qa,
                        pages, pages)


def test_serve_engine_runs_on_the_card_unless_told_otherwise():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving import LearnedPageTable, PagePool, Request
    from repro_torch.serving import ServeEngine

    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), n_layers=1,
                              d_model=32, n_heads=2, n_kv_heads=1,
                              head_dim=16, d_ff=64, vocab_size=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if torch.cuda.is_available():
        assert ServeEngine(cfg, model.to("cuda")).device.type == "cuda"
        model = model.cpu()
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, model)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            LearnedPageTable(PagePool(4))
    eng = ServeEngine(cfg, model, slots=2, page_size=4, n_pages=8,
                      device="cpu")
    eng.submit(Request(rid=0, prompt=[1, 2], max_new=2))
    assert [len(r.out) for r in eng.run()] == [2]
    assert eng.kv["k"].device.type == "cpu"
