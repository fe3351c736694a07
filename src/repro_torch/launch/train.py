"""End-to-end training launcher — port of ``src/repro/launch/train.py``
(the same flags and presets, plus ``--device``).

CPU-scale presets run REAL optimization through the same ``train_step``
as any other size, with fault-tolerance events injected on request:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
      --preset tiny --steps 50 --fail-at 20          # on cuda:0
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --preset tiny

It runs on the card unless ``--device`` names another device, and raises
without CUDA.  ``--preset small100m`` is a ~124M-param model of the arch's
family trained on the synthetic corpus.  The weights are random, drawn
from a ``torch.Generator`` seeded 0 on the device (not the reference's
``jax.random`` numbers).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

from ..configs import get_config
from ..optim import AdamWConfig
from ..runtime import TrainDriver, TrainRunConfig


def preset_config(arch: str, preset: str):
    cfg = get_config(arch)
    if preset == "tiny":
        return dataclasses.replace(
            cfg.reduced(), n_layers=2, d_model=128, n_heads=2, n_kv_heads=2,
            head_dim=64, d_ff=256, vocab_size=512, remat=False)
    if preset == "reduced":
        return cfg.reduced()
    if preset == "small100m":
        # ~124M params (GPT-2-small scale) in the arch's own family
        return dataclasses.replace(
            cfg.reduced(), n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
            head_dim=64, d_ff=3072, vocab_size=32_000, remat=False)
    raise ValueError(preset)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "reduced", "small100m"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--straggler-at", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda:0; 'cpu' for the "
                         "plain path)")
    args = ap.parse_args(argv)

    cfg = preset_config(args.arch, args.preset)
    run = TrainRunConfig(steps=args.steps, ckpt_every=args.ckpt_every,
                         batch=args.batch, seq_len=args.seq,
                         ckpt_dir=args.ckpt_dir, fail_at=args.fail_at,
                         straggler_at=args.straggler_at)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 5),
                      total_steps=args.steps)
    drv = TrainDriver(cfg, run, opt, device=args.device)
    t0 = time.time()
    last = [t0]

    def on_step(step, loss):
        now = time.time()
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:7.4f} "
                  f"({now - last[0]:.2f}s)", flush=True)
        last[0] = now

    res = drv.train(on_step=on_step)
    dt = time.time() - t0
    print(json.dumps({
        "arch": args.arch, "preset": args.preset, "steps": args.steps,
        "first_loss": round(res["losses"][0], 4),
        "final_loss": round(res["final_loss"], 4),
        "events": res["events"], "wall_s": round(dt, 1),
        "ckpt_dir": res["ckpt_dir"],
    }, indent=1))


if __name__ == "__main__":
    main()
