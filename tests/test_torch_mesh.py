"""The port's index mesh: the mesh engine == the port's one-device engine,
request for request, and the mesh functions == their one-device twins
(the scenarios of ``tests/mesh_equiv_driver.py``), on a mesh that names
the CPU D times (D in 1, 2, 4; 1500 keys, the small geometry).  The
one-device engine is held to the reference by
``tests/test_torch_sharded_engine.py``.

* ``func``  — ``lookup_batch_sharded_mesh`` and the scans (with and
  without the overlay) against the one-device functions on the same
  stack: found and payload everywhere, leaf rows where found, shard ids
  where the query is real, scan entries where valid;
* ``mixed`` — a mixed get/insert/delete/scan stream, across an async
  compaction drained through ``ManualExecutor``;
* ``split`` — the same with ``repartition=True`` and forced splits;
* ``wmerge`` — a write-heavy stream against the full-repack engine, and
  ``overlay_merge_stacked_mesh`` against the one-device stacked merge.

Run as a script (``python test_torch_mesh.py``) under 4 forced host
devices, the file holds the port's mesh functions and mesh engine against
the reference's on the same inputs (``test_port_mesh_equals_reference``).
"""
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from test_async_compaction import ManualExecutor

from repro_torch.core import AulidConfig, partition_bulkload
from repro_torch.core.delta_overlay import UINT64_MAX
from repro_torch.core.keys import (bits_from_tensor, keys_from_tensor,
                                   keys_to_tensor)
from repro_torch.core.lookup import (lookup_batch_sharded,
                                     lookup_batch_sharded_mesh,
                                     lookup_batch_sharded_overlay,
                                     lookup_batch_sharded_overlay_mesh,
                                     scan_batch_sharded,
                                     scan_batch_sharded_mesh,
                                     scan_batch_sharded_overlay,
                                     scan_batch_sharded_overlay_mesh)
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.kernels.overlay_merge.ops import (
    overlay_merge_stacked, overlay_merge_stacked_mesh)
from repro_torch.parallel import index_mesh
from repro_torch.serving import ShardedIndexEngine
from repro_torch.serving import index_engine as ie_mod
from repro_torch.serving.index_engine import pad_queries

SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)
DEVICES = (1, 2, 4)


def _dataset(n=1500):
    keys = make_dataset("covid", n, seed=1)
    return keys, payloads_for(keys)


def _mk(keys, pay, num_shards=3, mesh=None, **kw):
    part = partition_bulkload(keys, pay, num_shards,
                              cfg=AulidConfig(**SMALL_GEOM))
    return ShardedIndexEngine(part, gamma=0.05, mesh=mesh,
                              device=None if mesh else "cpu", **kw)


def _mesh(D):
    return index_mesh(D, devices=["cpu"] * D)


def _queries(keys, rng, q=64):
    lo, hi = int(keys[0]), int(keys[-1])
    mix = np.concatenate([
        rng.choice(keys, q // 2),
        rng.integers(lo, hi + (hi - lo) // 4, q // 4).astype(np.uint64),
        rng.integers(0, 2**63, q // 4).astype(np.uint64)])
    return pad_queries(np.sort(mix))


def _same_reads(one, mesh_out, real):
    pb, fb, gb = one[:3]
    pm, fm, gm = mesh_out[:3]
    assert torch.equal(fb, fm)
    assert torch.equal(pb, pm)
    assert torch.equal(gb[fb], gm[fb])
    if len(one) > 3:
        assert torch.equal(one[3][real], mesh_out[3][real])


def _same_scans(one, mesh_out):
    kb, vb, mb = one
    km, vm, mm = mesh_out
    assert torch.equal(mb, mm)
    assert torch.equal(kb[mb], km[mb])
    assert torch.equal(vb[mb], vm[mb])


def _check_pairs(pairs):
    for a, b in pairs:
        assert a.done and b.done, (a.op, a.key)
        assert a.result == b.result, (a.op, a.key, a.result, b.result)


def _mixed_stream(base, meng, keys, seed, steps=3):
    rng = np.random.default_rng(seed)
    for step in range(steps):
        pairs = []
        for i in range(18):
            k = (int(rng.choice(keys)) if rng.random() < 0.6
                 else int(rng.integers(0, 2**50)))
            pairs.append((base.get(k), meng.get(k)))
        for i in range(10):
            k = (int(rng.integers(0, 2**50)) if rng.random() < 0.7
                 else int(rng.choice(keys)))
            p = step * 100 + i
            pairs.append((base.insert(k, p), meng.insert(k, p)))
        for i in range(5):
            k = (int(rng.choice(keys)) if rng.random() < 0.6
                 else int(rng.integers(0, 2**50)))
            pairs.append((base.delete(k), meng.delete(k)))
        for i in range(4):
            k = int(rng.choice(keys)) if rng.random() < 0.8 \
                else int(rng.integers(0, 2**50))
            c = int(rng.integers(9, 16))
            pairs.append((base.scan(k, c), meng.scan(k, c)))
        base.step()
        meng.step()
        _check_pairs(pairs)


@pytest.fixture
def pool(monkeypatch):
    """A hand-pumped build pool for the port's engines."""
    out = ManualExecutor()
    monkeypatch.setattr(ie_mod, "_COMPACT_POOL", out)
    return out


# ------------------------------------------------------------- scenarios
def scenario_func(D):
    keys, pay = _dataset()
    base = _mk(keys, pay)
    mesh = _mesh(D)
    meng = _mk(keys, pay, mesh=mesh)
    h = base._height()
    assert meng._height() == h
    # writes so that the overlay holds entries and tombstones
    rng = np.random.default_rng(2)
    for eng in (base, meng):
        r = np.random.default_rng(2)
        for k in r.integers(0, 2**50, 20):
            eng.insert(int(k), int(k) % 97)
        for k in r.choice(keys, 6):
            eng.delete(int(k))
        eng.step()
    snap_b, snap_m = base._snap(), meng._snap()
    for trial in range(3):
        qn = _queries(keys, rng)
        q = keys_to_tensor(qn, "cpu")
        real = torch.from_numpy(qn != UINT64_MAX)
        for qcap in (None, len(qn)):
            _same_reads(lookup_batch_sharded(snap_b, q, height=h),
                        lookup_batch_sharded_mesh(mesh, snap_m, q, height=h,
                                                  qcap=qcap), real)
            _same_reads(lookup_batch_sharded_overlay(snap_b, base._ov(), q,
                                                     height=h),
                        lookup_batch_sharded_overlay_mesh(
                            mesh, snap_m, meng._ov(), q, height=h,
                            qcap=qcap), real)
        # the engine's own routing bound: a tight window per position
        meng._route_q = qn
        qcap = meng._mesh_qcap(snap_m)
        _same_reads(lookup_batch_sharded(snap_b, q, height=h),
                    lookup_batch_sharded_mesh(mesh, snap_m, q, height=h,
                                              qcap=qcap), real)
        _same_scans(scan_batch_sharded(snap_b, q, count=12, height=h),
                    scan_batch_sharded_mesh(mesh, snap_m, q, count=12,
                                            height=h, qcap=qcap))
        _same_scans(scan_batch_sharded_overlay(snap_b, base._ov(), q,
                                               count=12, height=h),
                    scan_batch_sharded_overlay_mesh(
                        mesh, snap_m, meng._ov(), q, count=12, height=h,
                        qcap=qcap))
    # an empty batch and an all-sentinel one
    for qn in (np.empty(0, np.uint64), np.full(8, UINT64_MAX)):
        q = keys_to_tensor(qn, "cpu")
        pm, fm, gm, sm = lookup_batch_sharded_mesh(mesh, snap_m, q, height=h,
                                                   qcap=8)
        assert pm.shape == (len(qn),) and not fm.any() \
            and not gm.any() and not sm.any()


def scenario_mixed(D):
    keys, pay = _dataset()
    base = _mk(keys, pay)
    meng = _mk(keys, pay, mesh=_mesh(D))
    assert meng.stats()["mesh_devices"] == D
    assert base.stats()["mesh_devices"] == 0
    _mixed_stream(base, meng, keys, seed=7)
    assert ie_mod._COMPACT_POOL.pump() > 0          # both engines' builds
    base.drain_compactions()
    meng.drain_compactions()
    _mixed_stream(base, meng, keys, seed=13, steps=1)
    pairs = [(base.get(int(k)), meng.get(int(k))) for k in keys[:60]]
    base.step()
    meng.step()
    _check_pairs(pairs)
    st = meng.stats()
    assert st["compactions"] == base.stats()["compactions"] > 0
    assert st["failed_swaps"] == 0


def scenario_split(D):
    keys, pay = _dataset(600)
    frz = _mk(keys, pay)
    rep = _mk(keys, pay, mesh=_mesh(D), repartition=True, split_ratio=1e9,
              min_split_items=16)
    pool = ie_mod._COMPACT_POOL
    for step in range(4):
        _mixed_stream(frz, rep, keys, seed=100 + step, steps=1)
        pool.pump()
        if step % 2 == 1:
            rep.drain_compactions()
            sizes = [sh.idx.n_items for sh in rep.shards]
            assert rep.request_split(
                max(range(len(sizes)), key=sizes.__getitem__))
    pool.pump()
    rep.drain_compactions()
    frz.drain_compactions()
    pairs = [(frz.get(int(k)), rep.get(int(k))) for k in keys[::7]]
    frz.step()
    rep.step()
    _check_pairs(pairs)
    st = rep.stats()
    assert st["num_shards"] > 3 and st["repart_failures"] == 0
    S = sum(m.shape[0] for m in rep._snap()["meta"])
    assert S % D == 0, (S, D)
    for sh in rep.shards:
        sh.idx.check_invariants()


def _rand_pack(rng, cap, n):
    ks = np.sort(np.unique(
        rng.integers(0, 2**50, 4 * n).astype(np.uint64))[:n])
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UINT64_MAX
    m = ks.size
    pack[0, :m] = ks
    pack[1, :m] = rng.integers(0, 2**40, m).astype(np.uint64)
    pack[2, :m] = (rng.random(m) < 0.2).astype(np.uint64)
    return pack


def _pack_tensor(packs):
    out = np.empty(packs.shape, dtype=np.int64)
    out[:, 0] = (packs[:, 0] ^ np.uint64(1 << 63)).view(np.int64)
    out[:, 1] = packs[:, 1].view(np.int64)
    out[:, 2] = packs[:, 2] != 0
    return torch.from_numpy(out)


def scenario_wmerge(D):
    keys, pay = _dataset()
    base = _mk(keys, pay, overlay_merge=False)
    mesh = _mesh(D)
    meng = _mk(keys, pay, mesh=mesh)
    rng = np.random.default_rng(17)
    for step in range(4):
        pairs = []
        for i in range(24):
            k = (int(rng.integers(0, 2**50)) if rng.random() < 0.7
                 else int(rng.choice(keys)))
            pairs.append((base.insert(k, step * 100 + i),
                          meng.insert(k, step * 100 + i)))
        for i in range(6):
            k = int(rng.choice(keys))
            pairs.append((base.delete(k), meng.delete(k)))
        for i in range(16):
            k = (int(rng.choice(keys)) if rng.random() < 0.5
                 else int(rng.integers(0, 2**50)))
            pairs.append((base.get(k), meng.get(k)))
        base.step()
        meng.step()
        _check_pairs(pairs)
    assert meng.stats()["overlay_merges"] > 0, meng.stats()
    assert meng._ov()["ov_replicas"] == ()        # one distinct device
    # each position merges its own rows; equal to the one-device merge
    packs = _pack_tensor(np.stack([_rand_pack(rng, 32, 24)
                                   for _ in range(2 * D)]))
    batches = _pack_tensor(np.stack([_rand_pack(rng, 8, 6)
                                     for _ in range(2 * D)]))
    got = overlay_merge_stacked_mesh(mesh, packs, batches, 64)
    assert torch.equal(got, overlay_merge_stacked(packs, batches, 64))
    with pytest.raises(ValueError, match="divisible"):
        overlay_merge_stacked_mesh(_mesh(4), packs[:3], batches[:3], 64)


SCENARIOS = {"func": scenario_func, "mixed": scenario_mixed,
             "split": scenario_split, "wmerge": scenario_wmerge}


@pytest.mark.parametrize("D", DEVICES)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_mesh_engine_equals_one_device(name, D, pool):
    SCENARIOS[name](D)


# --------------------------------------------------- against the reference
def test_port_mesh_equals_reference(device_count):
    """This file as a script under 4 forced host devices: the port's mesh
    functions and mesh engine against the reference's."""
    out = device_count(4, __file__, "4")
    assert "ALL OK" in out, out


def _ref_pair(D):
    """The reference's jnp mesh engine and the port's, over the same
    keys, with hand-pumped build pools."""
    from repro.core import AulidConfig as RefConfig
    from repro.core import partition_bulkload as ref_partition
    from repro.parallel import index_mesh as ref_index_mesh
    from repro.serving import ShardedIndexEngine as RefEngine
    keys, pay = _dataset()
    ref = RefEngine(ref_partition(keys, pay, 3, cfg=RefConfig(**SMALL_GEOM)),
                    gamma=0.05, backend="jnp", mesh=ref_index_mesh(D))
    return keys, ref, _mk(keys, pay, mesh=_mesh(D))


def reference_main(D):
    import jax
    from repro.core.lookup import lookup_batch_sharded_mesh as ref_lookup
    from repro.core.lookup import scan_batch_sharded_mesh as ref_scan
    from repro.serving import index_engine as ref_ie
    assert jax.device_count() >= D, jax.device_count()
    ref_ie._COMPACT_POOL = ManualExecutor()
    ie_mod._COMPACT_POOL = ManualExecutor()
    keys, ref, port = _ref_pair(D)
    h = ref._height()
    assert port._height() == h
    rng = np.random.default_rng(11)
    for trial in range(3):
        qn = _queries(keys, rng)
        q = keys_to_tensor(qn, "cpu")
        real = qn != UINT64_MAX
        pr, fr, gr, sr = (np.asarray(a) for a in ref_lookup(
            ref.mesh, ref._snap(), qn, height=h))
        pp, fp, gp, sp = lookup_batch_sharded_mesh(port.mesh, port._snap(), q,
                                                   height=h)
        fp = fp.numpy()
        np.testing.assert_array_equal(fr, fp)
        np.testing.assert_array_equal(pr, bits_from_tensor(pp))
        np.testing.assert_array_equal(gr[fr], gp.numpy()[fp])
        np.testing.assert_array_equal(sr[real], sp.numpy()[real])
        kr, vr, mr = (np.asarray(a) for a in ref_scan(
            ref.mesh, ref._snap(), qn, count=12, height=h))
        kp, vp, mp = scan_batch_sharded_mesh(port.mesh, port._snap(), q,
                                             count=12, height=h)
        mp = mp.numpy()
        np.testing.assert_array_equal(mr.astype(bool), mp)
        np.testing.assert_array_equal(kr[mp], keys_from_tensor(kp)[mp])
        np.testing.assert_array_equal(vr[mp], bits_from_tensor(vp)[mp])
    print(f"OK func D={D}")
    _mixed_stream(ref, port, keys, seed=7)
    ref_ie._COMPACT_POOL.pump()
    ie_mod._COMPACT_POOL.pump()
    ref.drain_compactions()
    port.drain_compactions()
    _mixed_stream(ref, port, keys, seed=13, steps=1)
    assert ref.stats()["mesh_devices"] == port.stats()["mesh_devices"] == D
    assert ref.stats()["compactions"] == port.stats()["compactions"]
    print(f"OK mixed D={D}")


if __name__ == "__main__":
    for D in [int(d) for d in sys.argv[1].split(",")]:
        reference_main(D)
    print("ALL OK")
