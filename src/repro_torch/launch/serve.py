"""Serving launcher: continuous batching over the learned paged-KV cache —
port of ``src/repro/launch/serve.py`` (the same CLI on the same reduced
config, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b --requests 8
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

It runs on the card unless ``--device`` names another device.  The weights
are random, drawn from a ``torch.Generator`` seeded 0 on that device (not
the reference's ``jax.random`` numbers).  The paged step serves the text
stack of the attention families (dense, moe, audio, vlm); the ssm and
hybrid families are refused, with the reference's message.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..configs import get_config
from ..device import resolve
from ..models.model import init_params
from ..serving import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda:0)")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(
        get_config(args.arch).reduced(), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=256, remat=False)
    if cfg.family not in ("dense", "moe", "audio", "vlm"):
        raise SystemExit(f"paged serving demo targets attention archs, "
                         f"not {cfg.family}")
    dev = resolve(args.device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    eng = ServeEngine(cfg, model, slots=args.slots, page_size=args.page_size,
                      n_pages=args.pages, device=dev)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size, rng.integers(3, 10)).tolist()
        eng.submit(Request(rid=i, prompt=prompt, max_new=args.max_new))
    t0 = time.time()
    done = eng.run(max_steps=1000)
    dt = time.time() - t0
    print(json.dumps({
        "requests_done": len(done), "engine_steps": eng.steps,
        "tokens_generated": sum(len(r.out) for r in done),
        "pages_free_after": eng.pool_pages.n_free,
        "index_io_reads": eng.table.index.io.reads,
        "wall_s": round(dt, 2),
        "device": str(dev),
        "sample_output": done[0].out if done else [],
    }, indent=1))


if __name__ == "__main__":
    main()
