"""Checkpoint/restart training driver with straggler + elastic handling —
port of ``src/repro/runtime/driver.py``.

Runs a REAL train loop (the port's ``make_train_step``, on ``cuda:0``
unless ``device`` names another) while a SimCluster injects failures
around it, event for event as the reference's driver:

  * periodic atomic checkpoints (params, optimizer, loader cursor);
  * hard-failure recovery: restart from the latest checkpoint, losing at
    most ``ckpt_every`` steps of work;
  * straggler eviction + elastic data-axis shrink with constant global
    batch (loader re-sharded by stride, no sample loss/duplication);
  * deterministic loss trajectory across a crash.

The initial weights come from ``init_params`` with a ``torch.Generator``
on the device seeded ``run.seed`` (not the reference's ``jax.random``
numbers).  Checkpoints hold ``{"params", "opt"}`` in the reference's tree
(layer leaves stacked over L, ``mu`` / ``nu`` mirroring the params, ``step``
an int32 scalar; :func:`checkpoint_tree`), so a checkpoint of either
package resumes in the other.
"""
from __future__ import annotations

import dataclasses
import pathlib
import tempfile
from typing import Callable, Optional

import numpy as np
import torch

from ..checkpoint.ckpt import (latest_step, restore_checkpoint,
                               save_checkpoint)
from ..configs.base import ModelConfig
from ..data.loader import ShardedLoader
from ..data.store import PackedDocStore, synth_corpus
from ..device import resolve
from ..launch.steps import make_train_step
from ..models import model as M
from ..optim import AdamWConfig, adamw_init
from ..tree import leaf_numpy, leaf_tensor
from .ft import SimCluster, StragglerDetector, plan_elastic_remesh


@dataclasses.dataclass
class TrainRunConfig:
    steps: int = 50
    ckpt_every: int = 10
    batch: int = 4
    seq_len: int = 128
    dp_size: int = 4             # simulated data-parallel width
    seed: int = 0
    ckpt_dir: Optional[str] = None
    fail_at: Optional[int] = None       # inject a hard failure at this step
    straggler_at: Optional[int] = None  # inject a straggler at this step


def _numpy(flat) -> dict:
    return {k: leaf_numpy(v) for k, v in dict(flat).items()}


def checkpoint_tree(cfg: ModelConfig, model: M.DenseLM,
                    opt_state: dict) -> dict:
    """``{"params", "opt"}`` as the reference's driver saves it: numpy
    arrays, layer leaves stacked over L, the moments mirroring the params
    and ``step`` an int32 scalar.  bfloat16 parameters are their bits
    (``tree.BF16_BITS``: numpy has no bfloat16), which
    ``save_checkpoint`` writes under the reference's ``"bfloat16"``."""
    return {"params": M.stacked_tree(cfg, _numpy(model.named_parameters())),
            "opt": {"mu": M.stacked_tree(cfg, _numpy(opt_state["mu"])),
                    "nu": M.stacked_tree(cfg, _numpy(opt_state["nu"])),
                    "step": np.asarray(opt_state["step"].cpu().numpy(),
                                       np.int32)}}


def checkpoint_like(cfg: ModelConfig) -> dict:
    """The structure of :func:`checkpoint_tree` with ``Spec`` leaves (what
    ``restore_checkpoint`` reads into)."""
    specs = M.param_spec_tree(cfg)
    return {"params": specs, "opt": {"mu": specs, "nu": specs,
                                     "step": M.Spec((), "int32", ())}}


@torch.no_grad()
def load_checkpoint_tree(cfg: ModelConfig, tree: dict, model: M.DenseLM,
                         opt_state: dict) -> None:
    """Copy a :func:`checkpoint_tree` (numpy, either package's; bfloat16
    leaves as their bits or as ml_dtypes arrays) into the model's
    parameters and ``opt_state``, in place."""
    params = M.flat_arrays(cfg, tree["params"])
    for k, p in model.named_parameters():
        p.copy_(leaf_tensor(params[k]))
    for m in ("mu", "nu"):
        for k, a in M.flat_arrays(cfg, tree["opt"][m]).items():
            opt_state[m][k].copy_(leaf_tensor(a))
    opt_state["step"].fill_(int(tree["opt"]["step"]))


class TrainDriver:
    def __init__(self, cfg: ModelConfig, run: TrainRunConfig,
                 opt: Optional[AdamWConfig] = None, device=None):
        self.cfg = cfg
        self.run = run
        self.device = resolve(device)
        self.opt = opt or AdamWConfig(lr=1e-3, warmup_steps=5,
                                      total_steps=run.steps)
        self.ckpt_dir = run.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
        store = PackedDocStore(block_tokens=256)
        store.build(synth_corpus(256, cfg.vocab_size, seed=run.seed))
        self.store = store
        self.loader = ShardedLoader(store, run.batch, run.seq_len,
                                    dp_rank=0, dp_size=1)
        self.cluster = SimCluster(run.dp_size, seed=run.seed)
        self.detector = StragglerDetector(k=3.0)
        self.step_fn = make_train_step(cfg, self.opt, self.device)
        self.events: list[str] = []
        self.losses: list[float] = []
        self.dp_size = run.dp_size

    # -- state ----------------------------------------------------------
    def _init_state(self):
        gen = torch.Generator(device=self.device).manual_seed(self.run.seed)
        model = M.init_params(self.cfg, gen, self.device)
        return model, adamw_init(model)

    def _save(self, step, model, opt_state):
        save_checkpoint(self.ckpt_dir, step,
                        checkpoint_tree(self.cfg, model, opt_state),
                        extra={"loader": self.loader.snapshot(),
                               "dp_size": self.dp_size})

    def _restore(self, model, opt_state):
        step = latest_step(self.ckpt_dir)
        if step is None:
            return 0, *self._init_state()
        tree, manifest = restore_checkpoint(
            pathlib.Path(self.ckpt_dir) / f"step_{step:08d}",
            checkpoint_like(self.cfg))
        load_checkpoint_tree(self.cfg, tree, model, opt_state)
        self.loader.restore(manifest["extra"]["loader"])
        self.dp_size = int(manifest["extra"]["dp_size"])
        self.events.append(f"restart@{step}")
        return step, model, opt_state

    # -- main loop --------------------------------------------------------
    def train(self, on_step: Optional[Callable] = None) -> dict:
        run = self.run
        model, opt_state = self._init_state()
        step = 0
        crashed_once = False
        while step < run.steps:
            # failure injection (simulated cluster events)
            if run.fail_at is not None and step == run.fail_at and not crashed_once:
                self.cluster.inject_failure(1 % self.cluster.n)
                crashed_once = True
                self.events.append(f"failure@{step}")
                # hard failure -> all workers restart from latest checkpoint
                step, model, opt_state = self._restore(model, opt_state)
                self.cluster.heal(1 % self.cluster.n)
                continue
            if run.straggler_at is not None and step == run.straggler_at:
                self.cluster.inject_straggler(2 % self.cluster.n, 25.0)
                self.events.append(f"straggler@{step}")

            # straggler watch: evict + elastic shrink (constant global batch)
            times = self.cluster.step_times()
            late = self.detector.observe(times)
            if late:
                plan = plan_elastic_remesh(run.batch, self.dp_size, late)
                if plan is not None and plan.changed:
                    self.events.append(
                        f"elastic@{step}:dp{plan.old_dp}->{plan.new_dp}")
                    self.dp_size = plan.new_dp
                    for r in plan.dropped_ranks:
                        self.cluster.heal(r)  # replacement joins the pool
                    self.loader.set_shard(0, 1)  # driver simulates rank 0

            batch = self.loader.next_batch()
            model, opt_state, metrics = self.step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            self.losses.append(loss)
            if on_step:
                on_step(step, loss)
            step += 1
            if step % run.ckpt_every == 0:
                self._save(step, model, opt_state)
        self._save(run.steps, model, opt_state)
        return {"losses": self.losses, "events": self.events,
                "final_loss": self.losses[-1], "ckpt_dir": self.ckpt_dir}
