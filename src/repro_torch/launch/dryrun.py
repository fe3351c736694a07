"""Dry-run on the meta device: every (architecture x input shape) cell at
full depth and global shape, on the reference's production mesh shapes —
the counterpart of ``src/repro/launch/dryrun.py``.

The reference lowers and compiles each cell for the 16x16 (256-chip) and
2x16x16 (512-chip) TPU meshes and reads XLA's memory and cost analyses and
the HLO's collectives.  The port runs each cell's step once on
``torch.device("meta")``, where tensors have a shape and a dtype and no
storage, under the ``ShardingContext`` of the mesh (so the MoE dispatch
runs in the mesh's groups), and records:

* ``memory.argument_bytes``: per device, the sum over the step's argument
  leaves of the leaf's bytes divided by the product of the mesh axes in its
  spec (``launch.steps.shardings_for``: ``PARAM_RULES`` for the parameters
  and optimizer state, ``ACT_RULES`` for the batch, cache and state), split
  by group.  It is exact, since ``spec_for`` shards only dims that divide.
  ``temp_bytes`` is ``None``: there is no compiler to ask;
* ``roofline``: the step's flops (``FlopCounterMode``, which counts the
  matmul-class ops: products, convolutions, attention) and the bytes of
  every op's tensor operands and results (views excluded) over the chips,
  against one H100's peaks (``cost_analysis``).  The bytes are unfused, so
  they are an upper bound on what fused kernels would move; there is no
  collective term;
* ``model_flops_global`` and ``useful_flops_ratio`` (model flops over the
  counted flops).

The multi-pod pass resolves the specs and argument bytes only, as the
reference's pass proves the shardings only.  Nothing here touches CUDA or
sets an environment variable: the mesh's positions are all the meta device,
and no memory, HBM traffic or collective of a real cluster is shown.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod both]
Outputs one JSON per cell under experiments/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, SHAPES, get_config, shapes_for
from ..models import model as M
from ..optim import adamw_init, opt_state_specs
from ..parallel.sharding import ShardingContext, set_context
from ..tree import leaves
from . import cost_analysis as H
from .mesh import make_production_mesh
from .steps import (make_decode_step, make_prefill_step, make_train_step,
                    shardings_for)

OUT_DIR = (pathlib.Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")
META = torch.device("meta")
# argument groups sharded by PARAM_RULES; the others by ACT_RULES
PARAM_GROUPS = ("params", "opt")


@dataclasses.dataclass
class Cell:
    """One cell's step, its meta arguments (``step(*args)`` runs it), and
    per argument group (params, opt, batch, cache, state) the ``Spec`` tree
    and the spec tuples the rules give it."""
    step: Callable
    args: tuple
    specs: dict
    shardings: dict


def build_cell(cfg, shape, mesh) -> Cell:
    """train: (params, AdamW state, batch) through ``make_train_step``;
    prefill: (params, batch, cache); decode and long_500k: (params, tokens,
    pos, cache, state).  The parameters are a ``DenseLM`` on the meta
    device, the rest meta tensors of the specs (``spec_tree_to_meta``)."""
    model = M.DenseLM(cfg, META)
    specs = {"params": M.param_spec_tree(cfg)}
    bspecs = M.input_specs(cfg, shape)
    if shape.kind == "train":
        specs["opt"] = opt_state_specs(specs["params"], M.Spec)
        specs["batch"] = bspecs
        step = make_train_step(cfg, device=META)
        args = (model, adamw_init(model), M.spec_tree_to_meta(bspecs))
    elif shape.kind == "prefill":
        specs["cache"] = bspecs.pop("cache")
        specs["batch"] = bspecs
        step = make_prefill_step(cfg, device=META)
        args = (model, M.spec_tree_to_meta(bspecs),
                M.spec_tree_to_meta(specs["cache"]))
    else:   # decode / long_decode
        specs["cache"] = bspecs.pop("cache")
        specs["state"] = bspecs.pop("state")
        specs["batch"] = bspecs
        step = make_decode_step(cfg, device=META)
        batch = M.spec_tree_to_meta(bspecs)
        args = (model, batch["tokens"], batch["pos"],
                M.spec_tree_to_meta(specs["cache"]),
                M.spec_tree_to_meta(specs["state"]))
    shardings = {g: shardings_for(t, mesh, params=g in PARAM_GROUPS)
                 for g, t in specs.items()}
    return Cell(step, args, specs, shardings)


def spec_bytes(spec, sharding: tuple, mesh) -> int:
    """One device's bytes of a leaf: its bytes over the product of the
    mesh axes its spec tuple names (each divides its dim)."""
    n = math.prod(spec.shape) * getattr(torch, spec.dtype).itemsize
    for part in sharding:
        for ax in (part,) if isinstance(part, str) else (part or ()):
            n //= mesh.shape[ax]
    return n


def argument_bytes(cell: Cell, mesh) -> dict:
    """Per-device argument bytes of a cell, in all and by group."""
    by = {g: sum(spec_bytes(s, sh, mesh) for s, sh in
                 zip(leaves(cell.specs[g]), _spec_tuples(cell.shardings[g])))
          for g in cell.specs}
    return {"argument_bytes": sum(by.values()), "by_group": by,
            "temp_bytes": None}


def _spec_tuples(tree) -> list:
    """The spec tuples of a ``shardings_for`` tree, in leaf order (a spec
    tuple is itself a tuple, so ``tree.leaves`` would walk into it)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _spec_tuples(tree[k])]
    return [tree]


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements (a broadcast dim, stride 0,
    counts once)."""
    n = math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0)
    return n * t.element_size()


# ops that move no bytes: aliases and uninitialised allocations
_FREE = {"alias", "detach", "empty", "empty_like", "empty_strided",
         "lift_fresh", "_unsafe_view"}


class OpBytes(TorchDispatchMode):
    """Sums the bytes of every op's tensor operands and results (views and
    :data:`_FREE` ops excluded): unfused traffic, an upper bound on what
    fused kernels move."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not (func.is_view or func.overloadpacket.__name__ in _FREE):
            self.bytes += sum(_nbytes(t) for t in tree_leaves(
                (args, kwargs, out)) if isinstance(t, torch.Tensor))
        return out


def count_step(cell: Cell) -> tuple:
    """(flops, operand and result bytes) of one run of the cell's step."""
    with FlopCounterMode(display=False) as fc, OpBytes() as ob:
        cell.step(*cell.args)
    return float(fc.get_total_flops()), float(ob.bytes)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    set_context(ShardingContext(mesh))
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "chips": mesh.size, "status": "ok"}
    try:
        t0 = time.time()
        cell = build_cell(cfg, shape, mesh)
        rec["memory"] = argument_bytes(cell, mesh)
        rec["build_s"] = round(time.time() - t0, 1)
        if multi_pod:
            return rec
        t1 = time.time()
        flops, nbytes = count_step(cell)
        rec["run_s"] = round(time.time() - t1, 1)
        chips = rec["chips"]
        roof = H.Roofline(
            compute_s=flops / chips / H.H100_PEAK_FLOPS_BF16,
            memory_s=nbytes / chips / H.H100_HBM_BW, collective_s=None,
            flops=flops / chips, hbm_bytes=nbytes / chips, coll_bytes=None)
        rec["roofline"] = roof.row()
        rec["collectives"] = None
        mf = H.model_flops(cfg, shape)
        rec["model_flops_global"] = mf
        rec["useful_flops_ratio"] = (mf / flops) if flops else 0.0
    except Exception as e:   # a failed cell is recorded; the sweep goes on
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    finally:
        set_context(None)
    return rec


_PODS = {"single": [False], "multi": [True], "both": [False, True]}


def cell_list(multi_pod_mode: str):
    for arch, cfg in ARCHS.items():
        for shape_name in shapes_for(cfg):
            for mp in _PODS[multi_pod_mode]:
                yield arch, shape_name, mp


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", default="both", choices=list(_PODS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    outdir = pathlib.Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.arch and args.shape:
        cells = [(args.arch, args.shape, mp) for mp in _PODS[args.multi_pod]]
    elif args.arch:
        cells = [(args.arch, s, mp) for s in shapes_for(get_config(args.arch))
                 for mp in _PODS[args.multi_pod]]
    else:
        cells = list(cell_list(args.multi_pod))

    n_fail = 0
    for arch, shape_name, mp in cells:
        tag = f"{arch}__{shape_name}__{'2x16x16' if mp else '16x16'}"
        path = outdir / f"{tag}.json"
        if path.exists() and not args.force:
            rec = json.loads(path.read_text())
            print(f"[skip] {tag}: {rec.get('status')}")
            continue
        print(f"[run ] {tag} ...", flush=True)
        rec = run_cell(arch, shape_name, mp)
        path.write_text(json.dumps(rec, indent=1))
        if rec["status"] == "ok":
            gb = rec["memory"]["argument_bytes"] / 1e9
            r = rec.get("roofline")
            if r is None:  # multi-pod: shard proof only
                print(f"  ok build={rec['build_s']}s args/dev={gb:.3f} GB"
                      f" (multi-pod shard proof)", flush=True)
            else:
                print(f"  ok build={rec['build_s']}s run={rec['run_s']}s "
                      f"args/dev={gb:.3f} GB dominant={r['dominant']} "
                      f"c/m={r['compute_s']:.2e}/{r['memory_s']:.2e}s "
                      f"useful={rec['useful_flops_ratio']:.2f}", flush=True)
        else:
            n_fail += 1
            print(f"  FAIL: {rec['error']}", flush=True)
    print(f"done; {n_fail} failures")
    print(summary(outdir))
    return 1 if n_fail else 0


def summary(outdir: pathlib.Path) -> str:
    """A markdown table of the records under ``outdir``, one row an arch
    and a column a shape: argument GB a device on 16x16 / on 2x16x16,
    TFLOP a device on 16x16 and the useful-flops ratio; the dominant
    roofline term where it is not memory."""
    recs: dict = {}
    for path in sorted(outdir.glob("*.json")):
        r = json.loads(path.read_text())
        recs.setdefault(r["arch"], {}).setdefault(r["shape"], {})[
            r["mesh"]] = r
    shapes = [s for s in SHAPES if any(s in by for by in recs.values())]
    rows = ["| arch | " + " | ".join(shapes) + " |",
            "|---" * (len(shapes) + 1) + "|"]
    for arch, by_shape in recs.items():
        cells = []
        for shape in shapes:
            by = by_shape.get(shape, {})
            one, multi = by.get("16x16", {}), by.get("2x16x16", {})
            if not by:
                cells.append("-")
            elif one.get("status") != "ok" or multi.get("status") != "ok":
                cells.append("fail")
            else:
                roof = one["roofline"]
                dom = "" if roof["dominant"] == "memory" else \
                    f", {roof['dominant']}"
                cells.append(
                    f"{one['memory']['argument_bytes'] / 1e9:.3f} / "
                    f"{multi['memory']['argument_bytes'] / 1e9:.3f} GB, "
                    f"{roof['flops_per_dev'] / 1e12:.3f} TF, "
                    f"{one['useful_flops_ratio']:.2f}{dom}")
        rows.append(f"| {arch} | " + " | ".join(cells) + " |")
    return "\n".join(rows)


if __name__ == "__main__":
    raise SystemExit(main())
