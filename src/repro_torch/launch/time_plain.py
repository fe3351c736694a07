"""Time K1's plain version (``lookup_plain``, the monolithic one-shard read
that every ``device="cpu"`` engine runs) from several source trees of the
port, interleaved in one process on one mirror, so that two versions are
compared on one host:

    python -m repro_torch.launch.time_plain --keys 20000000 --device cuda \\
        --tree before=/path/to/other/checkout/src --tree after=src

Each ``--tree NAME=SRC`` loads ``SRC/repro_torch`` as a package of its own
(the mirror is built by the running package and shared).  Per tree and
overlay case it prints, as JSON, the median wall time of a call (host and
device, synchronized), on the card also its device time with the stream
held until the call is enqueued, and the aten operations one call runs.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np
import torch

HOLD_CYCLES = 100_000_000   # about 50 ms of spinning at the H100's clocks
QUERIES = 8192              # the serving step's get batch
ROUNDS = 2                  # the second in reverse tree order


def _load_tree(name: str, src: str):
    init = pathlib.Path(src).resolve() / "repro_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(name + ".kernels.fused_lookup.ops")


def _wall_ms(fn, reps: int, cuda: bool) -> float:
    ts = []
    for _ in range(reps):
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def _device_ms(fn, reps: int) -> float:
    evs = []
    for _ in range(reps):
        torch.cuda._sleep(HOLD_CYCLES)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
        torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in evs]))


def _aten_ops(fn) -> int:
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("aten::"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=20_000_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=SRC: time SRC/repro_torch's lookup_plain")
    args = ap.parse_args(argv)

    from ..core import Aulid, BlockDevice
    from ..core.device_index import build_device_index
    from ..core.keys import keys_to_tensor
    from ..core.lookup import device_arrays, overlay_from_numpy
    from ..core.workloads import make_dataset, payloads_for
    from ..device import resolve

    dev = resolve(args.device)
    cuda = dev.type == "cuda"
    trees = {}
    for spec in args.tree:
        name, src = spec.split("=", 1)
        trees[name] = _load_tree(f"_plain_tree_{name}", src)
    keys = make_dataset("covid", args.keys, seed=3)
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    arrs = device_arrays(di, dev)
    h = max(di.max_inner_height, 3)
    rng = np.random.default_rng(7)
    n_abs = QUERIES // 10
    q = np.concatenate([rng.choice(keys, QUERIES - n_abs),
                        rng.integers(int(keys[0]), int(keys[-1]), n_abs,
                                     dtype=np.uint64)])
    qt = keys_to_tensor(q, dev)
    pack = np.full((3, 8192), np.iinfo(np.uint64).max, dtype=np.uint64)
    ov = np.sort(rng.choice(keys, 4096, replace=False))
    pack[0, :4096], pack[1, :4096], pack[2, :4096] = ov, ov * 3, ov % 2
    cases = {"no overlay": None, "overlay": overlay_from_numpy(pack, dev)}
    ref = None
    for name, ops in trees.items():
        got = [t.cpu() for t in ops.lookup_plain(arrs, cases["overlay"], qt,
                                                 h)]
        ref = ref or (name, got)
        if not all(torch.equal(a, b) for a, b in zip(got, ref[1])):
            raise AssertionError(f"tree {name} disagrees with {ref[0]}")
    card = torch.cuda.get_device_name(dev) if cuda else "cpu"
    print(json.dumps({"device": card, "keys": args.keys,
                      "queries": QUERIES, "height": h,
                      "trees": list(trees)}), flush=True)
    order = list(trees)
    for r in range(ROUNDS):
        for name in (order if r % 2 == 0 else order[::-1]):
            ops = trees[name]
            for case, ovr in cases.items():
                def fn():
                    return ops.lookup_plain(arrs, ovr, qt, h)
                fn()
                out = {"round": r, "tree": name, "case": case,
                       "wall_ms": _wall_ms(fn, args.reps, cuda),
                       "aten_ops": _aten_ops(fn)}
                if cuda:
                    out["device_ms"] = _device_ms(fn, args.reps)
                print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
