"""K3 ``overlay_probe``: the port's plain version == the JAX reference, bit
for bit, on the same numpy inputs; and the staged read merged with it ==
the reference's overlay-merged read.

The reference runs as ``tests/test_kernels.py`` runs it on the CPU: the
Pallas kernel in interpret mode and its jnp oracle (``use_ref=True``), over
``DeltaOverlay.arrays()``; the port probes the same pools carried over into
its (3, cap) pack with ``overlay_from_numpy``.  Payload (at the rank,
whether or not it hit; 0 past the last key), hit and tombstone must be
identical, on overlays of inserts and tombstones, the empty overlay, the
u64 extremes and the ``UINT64_MAX`` query (which meets the padding: hit,
not a tombstone, payload 0).  (The CUDA kernel is held to its plain version
in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import Aulid, AulidConfig, BlockDevice, DeltaOverlay
from repro.core import lookup as ref
from repro.core.device_index import _STACK_2D, _STACK_3D, build_device_index
from repro.core.workloads import make_dataset, payloads_for
from repro.kernels.overlay_probe.ops import overlay_probe as ref_probe

from repro_torch.core import lookup as port
from repro_torch.core.keys import bits_from_tensor, keys_to_tensor
from repro_torch.kernels import ProbeIndex, inner_probe_lookup, overlay_probe

UM = 2**64 - 1
EXTREMES = [0, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 2]


def _port_overlay(ov) -> dict:
    a = ov.arrays()
    return port.overlay_from_numpy(
        np.stack([a["ov_keys"], a["ov_pay"], a["ov_tomb"].astype(np.uint64)]),
        "cpu")


def _same(ov, q):
    got = overlay_probe(_port_overlay(ov), keys_to_tensor(q, "cpu"))
    for kw in (dict(interpret=True), dict(use_ref=True)):
        exp = ref_probe(ov.arrays(), q, **kw)
        assert (bits_from_tensor(got[0]) == np.asarray(exp[0])).all(), kw
        assert (got[1].numpy() == np.asarray(exp[1])).all(), kw
        assert (got[2].numpy() == np.asarray(exp[2])).all(), kw
    return bits_from_tensor(got[0]), got[1].numpy(), got[2].numpy()


def _overlay(rng, n_ops: int) -> tuple[DeltaOverlay, np.ndarray]:
    ov = DeltaOverlay()
    keys = rng.choice(2**62, n_ops, replace=False).astype(np.uint64)
    for i, k in enumerate(keys):
        if i % 4 == 3:
            ov.record_delete(int(k))
        else:
            ov.record_insert(int(k), int(k) + 5)
    return ov, keys


@pytest.mark.parametrize("n_ops", [1, 40, 300])
def test_overlay_probe_matches_reference(n_ops):
    rng = np.random.default_rng(n_ops)
    ov, keys = _overlay(rng, n_ops)
    q = np.concatenate([keys, rng.integers(0, 2**62, 64, dtype=np.uint64),
                        np.array(EXTREMES + [UM], dtype=np.uint64)])
    pay, hit, tomb = _same(ov, q)
    for i, k in enumerate(q[:-1].tolist()):
        e = ov.get(k)
        assert hit[i] == (e is not None)
        if e is not None:
            assert tomb[i] == e[1]
            if not e[1]:
                assert int(pay[i]) == e[0]
    assert hit[-1] and not tomb[-1] and pay[-1] == 0     # padding
    assert (pay[~hit] != 0).any()                        # unmasked payload


def test_overlay_probe_empty_overlay():
    q = np.array(EXTREMES + [12345, UM], dtype=np.uint64)
    pay, hit, tomb = _same(DeltaOverlay(), q)
    assert list(hit) == [False] * len(EXTREMES) + [False, True]
    assert not tomb.any() and not pay.any()


def test_overlay_probe_u64_extremes_and_full_pack():
    """Keys across the 2**32 and 2**63 boundaries; a pack with no padding
    left, so queries above its last key have rank == cap (payload 0)."""
    ov = DeltaOverlay()
    for k in EXTREMES:
        ov.record_insert(k, k + 1)
    cap = ov.arrays()["ov_keys"].shape[0]
    rng = np.random.default_rng(8)
    for k in rng.choice(2**40, cap - len(EXTREMES), replace=False):
        ov.record_insert(int(k) + 2**33, 3)
    assert (ov.arrays()["ov_keys"] < np.uint64(UM)).all()
    q = np.array(EXTREMES + [1, 2**33, UM], dtype=np.uint64)
    pay, hit, tomb = _same(ov, q)
    assert hit[:len(EXTREMES)].all() and not hit[len(EXTREMES):].any()
    assert (pay[:len(EXTREMES)] == q[:len(EXTREMES)] + 1).all()
    assert pay[-1] == 0 and not tomb.any()


def test_staged_read_with_overlay_matches_reference():
    """The slice end to end: the staged read merged with K3 by the rule of
    the reference's ``overlay_probe`` (hit & ~tomb -> overlay payload, tomb
    -> miss, else the snapshot) == the reference's ``lookup_batch_overlay``
    on found and on the payload where found."""
    keys = make_dataset("osm", 20_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(
        block_bytes=512, leaf_capacity=32, mixed_slots_per_block=16,
        pa_classes=(4, 8, 16), bt_max_children=4, bt_child_capacity=7))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    pools = {f: getattr(di, f) for f, _ in _STACK_2D + _STACK_3D}
    pools.update(root_node=di.root_node, last_leaf_row=di.last_leaf_row,
                 last_leaf_min=di.last_leaf_min)
    pi = ProbeIndex(port.mirror_from_numpy(pools, "cpu"), di.inner_height)
    rng = np.random.default_rng(6)
    ov = DeltaOverlay()
    for k in rng.integers(0, 2**62, 64, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 48):
        ov.record_insert(int(k), int(k) + 77)
    for k in rng.choice(keys, 48):
        ov.record_delete(int(k))
    ok = ov.arrays()["ov_keys"]
    q = np.concatenate([rng.choice(keys, 400), ok[:96],
                        rng.integers(0, 2**64 - 1, 100, dtype=np.uint64),
                        np.array([0, 2**63, UM], dtype=np.uint64)])
    qt = keys_to_tensor(q, "cpu")
    snap_pay, snap_found = inner_probe_lookup(pi, qt)
    opay, hit, tomb = overlay_probe(_port_overlay(ov), qt)
    found = torch.where(hit, ~tomb, snap_found)
    pay = torch.where(hit & ~tomb, opay, snap_pay)
    ref_ov = ref.overlay_arrays(ov)
    exp_pay, exp_found, _ = ref.lookup_batch_overlay(
        ref.device_arrays(di), ref_ov, q, height=max(di.max_inner_height, 3))
    assert (found.numpy() == np.asarray(exp_found)).all()
    f = found.numpy()
    assert (bits_from_tensor(pay)[f] == np.asarray(exp_pay)[f]).all()
    assert f[:400].any() and not f[-3:-1].any()
