"""The port's dry-run on the meta device (``repro_torch.launch.dryrun``,
``cost_analysis``) against the reference's analysis layer
(``repro.launch.hlo_analysis``, its spec trees and ``spec_for``).

* ``model_flops`` == the reference's for all ten configs x their shapes.
* ``Roofline``'s dominant term and bound as in the reference's
  ``test_roofline_terms``, and with no collective term.
* ``build_cell`` on the reduced config of each family, every kind of step
  (small shapes), on a (pod=2, data=2, model=2) host mesh of the CPU: the
  per-device argument bytes, by group, equal a recount from the
  reference's spec trees and its ``spec_for``, and the step runs on the
  meta device under the mesh's context.
* One full-size cell (qwen3-4b, decode_32k) on the 16x16 and 2x16x16
  shapes: status ``ok``, its bytes and flops.
"""
import dataclasses
import math

import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax.numpy as jnp

from repro.configs import get_config as ref_config
from repro.launch import hlo_analysis as ref_H
from repro.models import model as ref_M
from repro.optim.adamw import opt_state_specs as ref_opt_specs
from repro.parallel import sharding as ref_sh

from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_config
from repro_torch.configs import shapes_for
from repro_torch.launch import cost_analysis as H
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel.sharding import ShardingContext, set_context

FAMILIES = {c.family: name for name, c in sorted(ARCHS.items())}
KINDS = ("train", "prefill", "decode", "long_decode")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_model_flops_equal_the_references(arch):
    for s in shapes_for(get_config(arch)):
        assert H.model_flops(get_config(arch), SHAPES[s]) == \
            ref_H.model_flops(ref_config(arch), SHAPES[s]), s


def test_roofline_terms():
    r = H.Roofline(compute_s=1.0, memory_s=2.0, collective_s=0.5,
                   flops=1, hbm_bytes=1, coll_bytes=1)
    assert r.dominant == "memory" and r.bound_s == 2.0
    ref = ref_H.Roofline(compute_s=1.0, memory_s=2.0, collective_s=0.5,
                         flops=1, hbm_bytes=1, coll_bytes=1)
    assert r.row() == ref.row()
    r = H.Roofline(compute_s=3.0, memory_s=2.0, collective_s=None,
                   flops=1, hbm_bytes=1, coll_bytes=None)
    assert r.dominant == "compute" and r.bound_s == 3.0
    assert r.row()["collective_s"] is None
    assert H.H100_PEAK_FLOPS_BF16 == 989e12 and H.H100_HBM_BW == 3.35e12


def _ref_group_bytes(arch: str, cfg, shape, mesh) -> dict:
    """Per-device bytes of each argument group, recounted from the
    reference's spec trees and ``spec_for``."""
    import jax
    pspecs = ref_M.param_specs(cfg)
    groups = {"params": pspecs}
    bspecs = ref_M.input_specs(cfg, shape)
    if shape.kind == "train":
        groups["opt"] = ref_opt_specs(pspecs, ref_M.Spec)
    else:
        groups["cache"] = bspecs.pop("cache")
        if shape.kind != "prefill":
            groups["state"] = bspecs.pop("state")
    groups["batch"] = bspecs
    out = {}
    for g, tree in groups.items():
        rules = (ref_sh.PARAM_RULES if g in ("params", "opt")
                 else ref_sh.ACT_RULES)
        total = 0
        for s in jax.tree.leaves(tree,
                                 is_leaf=lambda x: isinstance(x, ref_M.Spec)):
            spec = ref_sh.spec_for(s.shape, s.axes, mesh, rules)
            div = 1
            for part in spec:
                for ax in (part,) if isinstance(part, str) else (part or ()):
                    div *= mesh.shape[ax]
            n = math.prod(s.shape) * jnp.dtype(s.dtype).itemsize
            assert n % div == 0, (g, s)
            total += n // div
        out[g] = total
    return out


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_build_cell_bytes_equal_a_recount(family):
    arch = FAMILIES[family]
    cfg = get_config(arch).reduced()
    rcfg = ref_config(arch).reduced()
    mesh = make_host_mesh(data=2, model=2, pod=2, devices=["cpu"] * 8)
    kinds = KINDS if arch in ("rwkv6-1.6b", "zamba2-1.2b") else KINDS[:3]
    for kind in kinds:
        shape = ShapeConfig(kind, 64, 8, kind)
        cell = dryrun.build_cell(cfg, shape, mesh)
        mem = dryrun.argument_bytes(cell, mesh)
        exp = _ref_group_bytes(arch, rcfg, shape, mesh)
        assert mem["by_group"] == exp, kind
        assert mem["argument_bytes"] == sum(exp.values())
        assert mem["temp_bytes"] is None
        set_context(ShardingContext(mesh))
        try:
            flops, nbytes = dryrun.count_step(cell)
        finally:
            set_context(None)
        assert flops > 0 and nbytes > mem["argument_bytes"], kind


def test_full_size_cell():
    rec = dryrun.run_cell("qwen3-4b", "decode_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    r = rec["roofline"]
    assert r["collective_s"] is None and r["dominant"] == "memory"
    assert r["flops_per_dev"] > 0
    assert rec["model_flops_global"] == ref_H.model_flops(
        ref_config("qwen3-4b"), SHAPES["decode_32k"])
    assert 0 < rec["useful_flops_ratio"] <= 1
    mesh = dataclasses.make_dataclass("M", ["shape", "axis_names"])(
        {"data": 16, "model": 16}, ("data", "model"))
    assert rec["memory"]["by_group"] == _ref_group_bytes(
        "qwen3-4b", ref_config("qwen3-4b"), SHAPES["decode_32k"], mesh)
    multi = dryrun.run_cell("qwen3-4b", "decode_32k", multi_pod=True)
    assert multi["status"] == "ok" and multi["chips"] == 512
    assert "roofline" not in multi
    assert multi["memory"]["argument_bytes"] < \
        rec["memory"]["argument_bytes"]
    assert torch.cuda.is_initialized() is False
