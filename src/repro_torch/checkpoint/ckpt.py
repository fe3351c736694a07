"""Sharded checkpoints with a learned (AULID) manifest — the port of
``src/repro/checkpoint/ckpt.py``, without JAX.

Layout on disk (the reference's, byte for byte in its names and manifest):
  <dir>/step_<n>/shard_<i>.npz   — flattened leaves, round-robin over shards
  <dir>/step_<n>/manifest.json   — path -> (shard, entry, shape, dtype) + meta
  <dir>/step_<n>/manifest.idx.npz— AULID bulkload arrays: fnv1a(path) -> slot
  <dir>/part_<n>/partition.npz   — RangePartition bounds + per-shard items
  <dir>/part_<n>/partition.json  — boundary-table version + AulidConfig

A tree is nested dicts, lists and tuples (named tuples too) of numpy
arrays, numpy or Python scalars and torch tensors; ``None`` is an empty
subtree.  :func:`_flatten` walks it in JAX's leaf order (dict keys sorted)
and names each leaf by JAX's ``keystr`` path (``"['params']['embed']"``,
``"[0]"``, ``".field"``), so the round-robin shard of each leaf and
``manifest.json`` equal the reference's, and a checkpoint written by
either package restores in the other.  A tensor is saved as the numpy
array of its values (``tree.leaf_numpy``).  numpy has no ``bfloat16``: the
port carries its bits as a 2-byte void array (:data:`BF16_BITS`), the form
``np.load`` gives the reference's ml_dtypes leaves in.  Such a leaf is
written under the
manifest dtype ``"bfloat16"`` with the ``'<V2'`` header ml_dtypes writes,
so each shard entry's bytes equal the reference's (whole ``.npz`` files
never do: the zip stamps the time), and :func:`leaf_tensor` reads it back
as a bfloat16 tensor.

The JSON manifest is the source of truth; the learned index over path-hash
keys serves partial reads (:func:`restore_params_subset`: one lookup a
leaf).  :func:`restore_checkpoint` returns numpy leaves, or, given a
matching tree of torch devices, tensors placed there: the elastic path,
since no layout is baked into the files.  Writes are atomic (tmp dir +
rename) so a failure mid-save never corrupts the latest complete
checkpoint; ``latest_step`` scans completed dirs only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import zipfile

import numpy as np
import torch

from ..core.aulid import Aulid, AulidConfig
from ..core.blockdev import BlockDevice
from ..core.partition import RangePartition
from ..tree import BF16_BITS, leaf_numpy, leaf_tensor
from ..tree import leaves_with_path as _leaves
from ..tree import unflatten as _unflatten

SHARDS = 8


def _fnv1a(s: str) -> np.uint64:
    h = np.uint64(0xCBF29CE484222325)
    for c in s.encode():
        h = np.uint64((int(h) ^ c) * 0x100000001B3 % (1 << 64))
    return h


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == BF16_BITS else str(arr.dtype)


def _savez(path: pathlib.Path, arrays: dict) -> None:
    """``np.savez``, but a bfloat16 leaf's bits get the ``'<V2'`` header
    that ``np.savez`` writes for an ml_dtypes ``bfloat16`` array."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            with zf.open(f"{name}.npy", "w", force_zip64=True) as f:
                if arr.dtype != BF16_BITS:
                    np.lib.format.write_array(f, arr)
                    continue
                np.lib.format.write_array_header_1_0(
                    f, {"descr": "<V2", "fortran_order": False,
                        "shape": arr.shape})
                f.write(np.ascontiguousarray(arr).tobytes())


def _flatten(tree) -> list[tuple[str, np.ndarray]]:
    return [(p, leaf_numpy(v)) for p, v in _leaves(tree)]


def save_checkpoint(dirpath: str, step: int, tree, extra: dict | None = None):
    """Atomically write one checkpoint. ``extra`` = loader state etc."""
    base = pathlib.Path(dirpath)
    final = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = _flatten(tree)
    manifest = {"step": step, "extra": extra or {}, "entries": {}}
    shards: list[dict] = [{} for _ in range(SHARDS)]
    for i, (path, arr) in enumerate(leaves):
        s = i % SHARDS
        name = f"e{len(shards[s])}"
        shards[s][name] = arr
        manifest["entries"][path] = {
            "shard": s, "entry": name, "shape": list(arr.shape),
            "dtype": _dtype_name(arr), "key": int(_fnv1a(path)),
        }
    for s, d in enumerate(shards):
        _savez(tmp / f"shard_{s}.npz", d)
    # learned manifest: hash(path) -> packed (shard, entry_idx)
    keys = np.array(sorted(e["key"] for e in manifest["entries"].values()),
                    dtype=np.uint64)
    payload_by_key = {e["key"]: (e["shard"] << 32) | int(e["entry"][1:])
                      for e in manifest["entries"].values()}
    pays = np.array([payload_by_key[int(k)] for k in keys], dtype=np.uint64)
    np.savez(tmp / "manifest.idx.npz", keys=keys, pays=pays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def latest_step(dirpath: str) -> int | None:
    base = pathlib.Path(dirpath)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def load_manifest(ckpt_dir: str) -> tuple[dict, Aulid]:
    """Manifest dict + the learned manifest index (bulkloaded)."""
    d = pathlib.Path(ckpt_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    idx_arrays = np.load(d / "manifest.idx.npz")
    idx = Aulid(BlockDevice())
    idx.bulkload(idx_arrays["keys"], idx_arrays["pays"])
    return manifest, idx


def restore_checkpoint(ckpt_dir: str, tree_like, devices=None):
    """Restore into the structure of ``tree_like``: numpy leaves (a
    ``"bfloat16"`` entry as its bits, :data:`BF16_BITS`), or with
    ``devices`` (a matching tree of torch devices) tensors placed on them
    (bfloat16 entries as bfloat16) — the elastic path: the target devices
    may differ from the saver's.  Returns (tree, manifest)."""
    d = pathlib.Path(ckpt_dir)
    manifest = json.loads((d / "manifest.json").read_text())
    cache: dict[int, dict] = {}

    def load(path: str):
        e = manifest["entries"][path]
        s = e["shard"]
        if s not in cache:
            cache[s] = np.load(d / f"shard_{s}.npz")
        return cache[s][e["entry"]]

    paths = [p for p, _ in _leaves(tree_like)]
    if devices is None:
        out = [load(p) for p in paths]
    else:
        devs = [dev for _, dev in _leaves(devices)]
        if len(devs) != len(paths):
            raise ValueError(f"devices has {len(devs)} leaves, the tree "
                             f"{len(paths)}")
        out = [leaf_tensor(load(p)).to(dev) for p, dev in zip(paths, devs)]
    return _unflatten(tree_like, iter(out)), manifest


# --------------------------------------------------- RangePartition snapshots
#
# A serving-engine partition checkpoint (DESIGN.md §12): per-shard resident
# items + the CURRENT boundary table.  Version history and pins are in-flight
# state — a restore by definition has no in-flight steps or builds, so it
# lands on the newest version with an empty pin table and a single-entry
# history, and routes identically to the saved partition.


def save_partition(dirpath: str, step: int, part: RangePartition) -> str:
    """Atomically snapshot a :class:`RangePartition` (same tmp+rename
    protocol as ``save_checkpoint``)."""
    base = pathlib.Path(dirpath)
    final = base / f"part_{step:08d}"
    tmp = base / f".tmp_part_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: dict[str, np.ndarray] = {
        "bounds": np.asarray(part.bounds, dtype=np.uint64)}
    for s in range(part.num_shards):
        keys, pays = part.shard_items(s)
        arrays[f"keys_{s}"] = keys
        arrays[f"pays_{s}"] = pays
    np.savez(tmp / "partition.npz", **arrays)
    meta = {
        "step": int(step),
        "version": int(part.version),
        "num_shards": int(part.num_shards),
        "cfg": dataclasses.asdict(part.shards[0].cfg),
    }
    (tmp / "partition.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    os.rename(tmp, final)
    return str(final)


def latest_partition_step(dirpath: str) -> int | None:
    base = pathlib.Path(dirpath)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.glob("part_*")
             if (p / "partition.json").exists()]
    return max(steps) if steps else None


def load_partition(ckpt_dir: str) -> RangePartition:
    """Rebuild a :class:`RangePartition` from a ``save_partition`` snapshot.

    The restored partition lands on the snapshot's (newest) boundary-table
    version with zero pins and a one-entry history — retired versions only
    ever existed to serve in-flight work, and a restore has none."""
    d = pathlib.Path(ckpt_dir)
    meta = json.loads((d / "partition.json").read_text())
    arrays = np.load(d / "partition.npz")
    cfg_dict = dict(meta["cfg"])
    cfg_dict["pa_classes"] = tuple(cfg_dict["pa_classes"])
    cfg = AulidConfig(**cfg_dict)
    shards = []
    for s in range(meta["num_shards"]):
        sh = Aulid(BlockDevice(block_bytes=cfg.block_bytes), cfg=cfg)
        sh.bulkload(arrays[f"keys_{s}"], arrays[f"pays_{s}"])
        shards.append(sh)
    part = RangePartition(arrays["bounds"].astype(np.uint64), shards,
                          version=int(meta["version"]))
    part.check_invariants()
    return part


def restore_params_subset(ckpt_dir: str, paths: list[str]) -> dict:
    """Partial restore through the LEARNED manifest: each path costs one
    AULID lookup (O(1) block fetches) + one shard-entry read."""
    d = pathlib.Path(ckpt_dir)
    manifest, idx = load_manifest(ckpt_dir)
    out = {}
    cache: dict[int, dict] = {}
    for path in paths:
        packed = idx.lookup(int(_fnv1a(path)))
        assert packed is not None, f"{path} not in manifest index"
        s, entry = packed >> 32, packed & 0xFFFFFFFF
        if s not in cache:
            cache[s] = np.load(d / f"shard_{s}.npz")
        out[path] = cache[s][f"e{entry}"]
    return out
