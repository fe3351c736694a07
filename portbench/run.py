"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout of the repository (the program is
imported from ``src/`` beside this folder).  Without CUDA, or with fewer
cards than the cell asks for, it exits with 2 and prints no result.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: every number compared beside its
limit, which also close standard error.
"""
import time

T0 = time.perf_counter()            # set-up is timed from process start

import argparse                     # noqa: E402
import json                         # noqa: E402
import os                           # noqa: E402
import sys                          # noqa: E402

from . import spec                  # noqa: E402
from .check import checks_entry, correct  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Every build and kernel cache in fixed folders of the checkout, and
    the host's numeric libraries on one thread each: the load comes from
    one process with few threads."""
    cache = spec.PKG / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    for v in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[v] = "1"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's, its
    relatives' or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    _environment()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    src = spec.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        log(f"the program is not in this checkout ({src}/repro_torch)")
        return 2
    sys.path.insert(0, str(src))
    from . import index_serving
    out = index_serving.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T0)
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)} (JAX or the JAX "
            "package): no result")
        return 3
    counts = out["counts"]
    ok = correct(counts)
    result = {"correct": ok, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": {},
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": cell.chips,
                         "memory_peak_bytes": out["memory_peak_bytes"]}}
    if args.trace:
        tdata = out["trace"]
        dev = tdata["device"]
        result["device"]["busy_s"] = dev["busy_s"]
        result["device"]["window_s"] = dev["window_s"]
        for m in cell.per_layer:
            v = spec.reader(m["name"])(tdata)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
        result["breakdown"] = {"device_ops": dev["device_ops"],
                               "idle_gaps": dev["idle_gaps"]}
    else:
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = out["metrics"][m["name"]]
    log(f"{cell.name} seed {args.seed}: {out['steps']} steps in "
        f"{out['window_s']:.3f} s, {out['attempted']} requests, "
        f"engine {json.dumps(out['engine'])}")
    result["checks"] = checks_entry(counts)
    for k, v in result["checks"].items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
