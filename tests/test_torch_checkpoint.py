"""The port's checkpointing == the reference's: the cases of
``tests/test_checkpoint.py`` on the port, then cross-loads both ways (a
lived partition and a tree saved by either package restore in the other,
with equal manifests, arrays, routing, lookups and scans), and
``restore_params_subset`` on the tree of a tiny qwen3 config.  Every
comparison is exact."""
import collections
import pathlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax

from repro import checkpoint as ref_ckpt
from repro.checkpoint import ckpt as ref_ckpt_mod
from repro.core import AulidConfig as RefConfig
from repro.core import partition_bulkload as ref_partition

from repro_torch.checkpoint import (latest_partition_step, latest_step,
                                    load_manifest, load_partition,
                                    restore_checkpoint, restore_params_subset,
                                    save_checkpoint, save_partition)
from repro_torch.checkpoint import ckpt as port_ckpt_mod
from repro_torch.core import AulidConfig, partition_bulkload
from repro_torch.core.workloads import make_dataset, payloads_for

SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)
Pair = collections.namedtuple("Pair", "lo hi")


@pytest.fixture
def tree():
    rng = np.random.default_rng(0)
    return {
        "params": {"embed": rng.normal(size=(64, 16)).astype(np.float32),
                   "layers": {"w": rng.normal(size=(4, 16, 16))
                              .astype(np.float32),
                              "b": np.zeros(16, np.float32)}},
        "opt": {"mu": {"x": np.ones(3)}, "step": np.int32(7)},
    }


def _jax_leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _same_leaves(a, b):
    la, lb = _jax_leaves(a), _jax_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (_, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------ the reference's cases
def test_roundtrip(tmp_path, tree):
    p = save_checkpoint(str(tmp_path), 10, tree,
                        extra={"loader": {"epoch": 1}})
    out, manifest = restore_checkpoint(p, tree)
    _same_leaves(tree, out)
    assert manifest["extra"]["loader"]["epoch"] == 1


def test_latest_step_and_overwrite(tmp_path, tree):
    save_checkpoint(str(tmp_path), 5, tree)
    save_checkpoint(str(tmp_path), 15, tree)
    assert latest_step(str(tmp_path)) == 15
    save_checkpoint(str(tmp_path), 15, tree)  # idempotent overwrite
    assert latest_step(str(tmp_path)) == 15


def test_incomplete_checkpoint_ignored(tmp_path, tree):
    save_checkpoint(str(tmp_path), 5, tree)
    (tmp_path / "step_00000009").mkdir()  # crashed mid-write: no manifest
    assert latest_step(str(tmp_path)) == 5


def test_partial_restore_via_learned_manifest(tmp_path, tree):
    p = save_checkpoint(str(tmp_path), 3, tree)
    manifest, idx = load_manifest(p)
    paths = list(manifest["entries"])
    sub = restore_params_subset(p, paths[:3])
    for path in paths[:3]:
        assert list(sub[path].shape) == manifest["entries"][path]["shape"]
    for path, e in manifest["entries"].items():
        assert idx.lookup(e["key"]) is not None


def test_elastic_restore_structs(tmp_path, tree):
    p = save_checkpoint(str(tmp_path), 2, tree)
    out, _ = restore_checkpoint(p, tree, devices=None)
    assert out["opt"]["step"] == 7


def test_elastic_restore_onto_devices(tmp_path, tree):
    """A matching tree of torch devices places each leaf as a tensor."""
    p = save_checkpoint(str(tmp_path), 2, tree)
    devs = jax.tree.map(lambda _: torch.device("cpu"), tree)
    out, _ = restore_checkpoint(p, tree, devices=devs)
    assert isinstance(out["params"]["embed"], torch.Tensor)
    _same_leaves(tree, jax.tree.map(lambda t: t.numpy(), out))
    with pytest.raises(ValueError, match="leaves"):
        restore_checkpoint(p, tree, devices={"params": devs["params"]})


def _split_partition(make=partition_bulkload, cfg=AulidConfig):
    """A partition that has LIVED: one split applied, so its boundary
    version is > 0 and its shard layout differs from any fresh bulkload."""
    keys = make_dataset("covid", 900, seed=1)
    part = make(keys, payloads_for(keys), 3, cfg=cfg(**SMALL_GEOM))
    sk = part.plan_split(0)
    ks, ps = part.shard_items(0)
    cut = int(np.searchsorted(ks, np.uint64(sk), side="right"))
    left, right = part.spawn_index(), part.spawn_index()
    left.bulkload(ks[:cut], ps[:cut])
    right.bulkload(ks[cut:], ps[cut:])
    part.apply_split(0, sk, left, right)
    return keys, part


def _same_partition(out, part, keys):
    assert out.version == part.version > 0
    assert out.num_shards == part.num_shards
    np.testing.assert_array_equal(out.bounds, part.bounds)
    assert vars(out.shards[0].cfg) == vars(part.shards[0].cfg)
    probes = np.concatenate([keys[:: len(keys) // 50],
                             [np.uint64(0), np.uint64(2**62)]])
    for k in probes:
        assert out.shard_of(int(k)) == part.shard_of(int(k))
        assert out.lookup(int(k)) == part.lookup(int(k))
    for start in (int(keys[0]), int(keys[len(keys) // 2]), 0):
        assert out.scan(start, 40) == part.scan(start, 40)


def test_partition_roundtrip_newest_version_zero_pins(tmp_path):
    keys, part = _split_partition()
    pin = part.pin()                      # in-flight state must NOT persist
    save_partition(str(tmp_path), 4, part)
    part.unpin(pin)
    out = load_partition(str(tmp_path / "part_00000004"))
    assert out.pinned_versions() == {}
    assert set(out.history) == {out.version}
    _same_partition(out, part, keys)


def test_partition_latest_and_atomicity(tmp_path):
    _, part = _split_partition()
    assert latest_partition_step(str(tmp_path)) is None
    save_partition(str(tmp_path), 1, part)
    save_partition(str(tmp_path), 9, part)
    assert latest_partition_step(str(tmp_path)) == 9
    save_partition(str(tmp_path), 9, part)    # idempotent overwrite
    assert latest_partition_step(str(tmp_path)) == 9
    (tmp_path / "part_00000011").mkdir()      # crashed mid-write: no json
    assert latest_partition_step(str(tmp_path)) == 9


# ------------------------------------------------------------ cross-loads
def test_flatten_paths_are_jax_keystr():
    """Dict keys sorted, sequences by index, named tuples by field, None
    an empty subtree: JAX's leaf order and ``keystr`` names."""
    tree = {"b": [np.ones(2), (np.int32(3), None, Pair(np.zeros(1), 2.5))],
            "a": {"z": np.float64(1.0), "y": [[np.arange(3)]]},
            "c": None, "d": torch.arange(4)}
    got = port_ckpt_mod._flatten(tree)
    exp = _jax_leaves(jax.tree.map(
        lambda v: v.numpy() if isinstance(v, torch.Tensor) else v, tree))
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (_, a), (_, b) in zip(got, exp):
        np.testing.assert_array_equal(a, b)
    assert port_ckpt_mod._fnv1a("['params']['embed']") == \
        ref_ckpt_mod._fnv1a("['params']['embed']")


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_tree_cross_load(tmp_path, tree, saver):
    """A tree saved by either package restores in the other, and both
    packages write the same manifest for it."""
    ref_dir = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 6, tree,
                                       extra={"k": 1})
    port_tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)),
                             tree) if saver == "port" else tree
    port_dir = save_checkpoint(str(tmp_path / "port"), 6, port_tree,
                               extra={"k": 1})
    assert (pathlib.Path(ref_dir) / "manifest.json").read_text() == \
        (pathlib.Path(port_dir) / "manifest.json").read_text()
    for name in ("manifest.idx.npz",) + tuple(
            f"shard_{s}.npz" for s in range(port_ckpt_mod.SHARDS)):
        a = np.load(pathlib.Path(ref_dir) / name)
        b = np.load(pathlib.Path(port_dir) / name)
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            np.testing.assert_array_equal(a[f], b[f])
    src = port_dir if saver == "port" else ref_dir
    got_port, _ = restore_checkpoint(src, tree)
    got_ref, _ = ref_ckpt.restore_checkpoint(src, tree)
    _same_leaves(tree, got_port)
    _same_leaves(tree, got_ref)


@pytest.mark.parametrize("saver", ["reference", "port"])
def test_partition_cross_load(tmp_path, saver):
    """A lived partition saved by either package loads in the other with
    equal bounds, version, cfg, routing, lookups and scans."""
    keys, ref_part = _split_partition(ref_partition, RefConfig)
    _, port_part = _split_partition()
    np.testing.assert_array_equal(ref_part.bounds, port_part.bounds)
    if saver == "reference":
        ref_ckpt.save_partition(str(tmp_path), 3, ref_part)
        out = load_partition(str(tmp_path / "part_00000003"))
        _same_partition(out, ref_part, keys)
    else:
        save_partition(str(tmp_path), 3, port_part)
        out = ref_ckpt.load_partition(str(tmp_path / "part_00000003"))
        _same_partition(out, port_part, keys)
    assert latest_partition_step(str(tmp_path)) == \
        ref_ckpt.latest_partition_step(str(tmp_path)) == 3


def test_restore_params_subset_on_qwen3_tree(tmp_path):
    """The parameter tree of a tiny qwen3 config (``numpy_from_params``)
    saved by the port: its learned manifest equals the reference's and
    both packages' partial restores return the same arrays."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import numpy_from_params
    cfg = dataclasses.replace(get_config("qwen3-4b").reduced(), n_layers=2,
                              d_model=32, n_heads=2, n_kv_heads=1,
                              head_dim=16, d_ff=64, vocab_size=64)
    model = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params = numpy_from_params(model)
    p = save_checkpoint(str(tmp_path / "port"), 1, params)
    r = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 1, params)
    manifest, idx = load_manifest(p)
    ref_manifest, ref_idx = ref_ckpt.load_manifest(r)
    assert manifest == ref_manifest
    paths = sorted(manifest["entries"])
    assert "['layers']['attn']['wq']" in paths
    got = restore_params_subset(p, paths)
    exp = ref_ckpt.restore_params_subset(p, paths)
    assert got.keys() == exp.keys() == set(paths)
    for path in paths:
        np.testing.assert_array_equal(got[path], exp[path])
        assert idx.lookup(manifest["entries"][path]["key"]) == \
            ref_idx.lookup(manifest["entries"][path]["key"])
    flat = dict(_jax_leaves(params))
    for path in paths:
        np.testing.assert_array_equal(got[path], flat[path])
