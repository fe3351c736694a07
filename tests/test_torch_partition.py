"""The port's range partition and stacked (sharded) read path == the JAX
reference's, bit for bit.

The copied ``RangePartition`` routes, plans and applies splits and merges,
and pins boundary versions exactly like the reference's (the cases of
``tests/test_partition.py``, run on both and compared).  The same numpy
stacked mirror — the reference's ``stack_device_indexes`` over
``partition_bulkload`` shards, carried over with ``stacked_device_arrays``
— is read by the reference's jnp path, by its fused Pallas kernel in
interpret mode (the ``cfg.sharded`` branch) and by the port's plain version
of K1's shard route on the CPU: payload, found, global leaf row and shard
id must be identical, with and without an overlay, over four datasets at
the scaled 512-B geometry, S = 1, 3 and 5 live shards padded to 8 slots,
on edge keys and on every bound and its neighbours.  Scans that cross
shard boundaries and the in-place ``update_stacked_shard`` after
``restack_shard`` are held the same way.  (The CUDA kernel is held to its
plain version in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import AulidConfig as RefConfig
from repro.core import DeltaOverlay as RefOverlay
from repro.core import lookup as ref
from repro.core import partition_bulkload as ref_partition
from repro.core.device_index import _STACK_2D, _STACK_3D
from repro.core.device_index import build_device_index as ref_build
from repro.core.device_index import refresh_device_index as ref_refresh
from repro.core.device_index import restack_shard as ref_restack
from repro.core.device_index import stack_device_indexes as ref_stack
from repro.core.workloads import make_dataset, payloads_for
from repro.kernels.fused_lookup import (fused_lookup_batch_sharded,
                                        fused_lookup_batch_sharded_overlay)

from repro_torch.core import AulidConfig, partition_bulkload
from repro_torch.core import lookup as port
from repro_torch.core.device_index import (build_device_index,
                                           refresh_device_index,
                                           restack_shard,
                                           stack_device_indexes)
from repro_torch.core.keys import (bits_from_tensor, keys_from_tensor,
                                   keys_to_tensor)
from repro_torch.kernels.fused_lookup import ops as k1

DATASETS = ("covid", "planet", "genome", "osm")
GEOM_512B = dict(block_bytes=512, leaf_capacity=32, mixed_slots_per_block=16,
                 pa_classes=(4, 8, 16), bt_max_children=4,
                 bt_child_capacity=7)
SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)
# (live shards, shard slots): exact fits and placeholder-padded slots
LAYOUTS = [(1, 0), (3, 0), (5, 8)]
N_KEYS = 20_000
UM = 2**64 - 1

_CACHE: dict = {}


def _ref_stack(name, live, slots):
    """(keys, reference partition, reference stacked mirror, height).  The
    four datasets of a layout share their pool shapes (``min_caps``) and
    their height, so the reference compiles each read once a layout."""
    if (name, live, slots) not in _CACHE:
        built = {}
        for d in DATASETS:
            keys = make_dataset(d, N_KEYS, seed=1)
            part = ref_partition(keys, payloads_for(keys), live,
                                 cfg=RefConfig(**GEOM_512B))
            dis = [ref_build(sh) for sh in part.shards]
            built[d] = keys, part, dis
        stacks = {d: ref_stack(dis, part.bounds, min_shards=slots)
                  for d, (_, part, dis) in built.items()}
        caps = {f: tuple(np.max([getattr(st, f).shape[1:]
                                 for st in stacks.values()], axis=0))
                for f, _ in _STACK_2D + _STACK_3D}
        h = max(max(st.max_inner_height, 3) for st in stacks.values())
        for d, (keys, part, dis) in built.items():
            sdi = ref_stack(dis, part.bounds, min_shards=slots,
                            min_caps=caps)
            _CACHE[(d, live, slots)] = (keys, part, sdi, h, caps)
    return _CACHE[(name, live, slots)][:4]


def _queries(keys, bounds, seed, n_hit=300, n_miss=100) -> np.ndarray:
    """Present, absent and edge keys, and every bound with its
    neighbours (UINT64_MAX placeholder bounds included)."""
    rng = np.random.default_rng(seed)
    near = [int(b) + d for b in bounds for d in (-1, 0, 1)
            if 0 <= int(b) + d <= UM]
    edges = [0, max(int(keys[0]) - 1, 0), int(keys[0]), int(keys[-1]),
             int(keys[-1]) + 1, 2**63, UM - 1, UM]
    return np.concatenate([rng.choice(keys, n_hit),
                           rng.integers(0, UM, n_miss, dtype=np.uint64),
                           np.array(near + edges, dtype=np.uint64)])


def _overlay(keys, seed) -> RefOverlay:
    rng = np.random.default_rng(seed)
    ov = RefOverlay()
    for k in rng.integers(0, 2**62, 48, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 40):
        ov.record_insert(int(k), int(k) + 77)
    for k in rng.choice(keys, 40):
        ov.record_delete(int(k))
    return ov


def _same(got, exp):
    """Port outputs (torch) == reference outputs (jax), field by field:
    payload bits, found, global leaf row[, shard id]."""
    assert (bits_from_tensor(got[0]) == np.asarray(exp[0])).all()
    for g, e in zip(got[1:], exp[1:]):
        assert (g.numpy() == np.asarray(e)).all()


# ------------------------------------------------------------ the partition
def _routing(pkg):
    keys = make_dataset("covid", 3_000, seed=1)
    part = pkg["partition"](keys, payloads_for(keys), 4,
                            cfg=pkg["cfg"](**SMALL_GEOM))
    probes = np.concatenate([keys[::37], part.bounds, part.bounds + 1,
                             np.array([0, UM - 1, UM], dtype=np.uint64)])
    part.check_invariants()
    return (part.bounds.tolist(), [sh.n_items for sh in part.shards],
            part.shard_of_batch(probes).tolist(),
            [part.shard_of(int(k)) for k in probes[::5]],
            [part.lookup(int(k)) for k in probes[::3]],
            part.scan(int(part.bounds[0]) - 5, 20))


def _split_merge_pins(pkg):
    keys = make_dataset("covid", 1_200, seed=1)
    part = pkg["partition"](keys, payloads_for(keys), 3,
                            cfg=pkg["cfg"](**SMALL_GEOM))
    log = [part.pin(), part.pin(0), part.pinned_versions()]
    for s in (1, 0):
        sk = part.plan_split(s)
        ks, ps = part.shard_items(s)
        cut = int(np.searchsorted(ks, np.uint64(sk), side="right"))
        left, right = part.spawn_index(), part.spawn_index()
        left.bulkload(ks[:cut], ps[:cut])
        right.bulkload(ks[cut:], ps[cut:])
        log += [sk, part.apply_split(s, sk, left, right),
                sorted(part.history), part.bounds.tolist()]
    part.unpin(0)
    log.append(sorted(part.history))
    part.unpin(0)
    log.append(sorted(part.history))
    ka, pa = part.shard_items(0)
    kb, pb = part.shard_items(1)
    merged = part.spawn_index()
    merged.bulkload(np.concatenate([ka, kb]), np.concatenate([pa, pb]))
    log += [part.apply_merge(0, merged), part.bounds.tolist(),
            [part.lookup(int(k)) for k in keys[::29]],
            part.bounds_at().tolist()]
    part.check_invariants()
    with pytest.raises(AssertionError):
        part.unpin(0)
    with pytest.raises(AssertionError):
        part.apply_split(0, int(part.bounds[0]), part.spawn_index(),
                         part.spawn_index())
    return log


def _edge_partitions(pkg):
    cfg = pkg["cfg"](**SMALL_GEOM)
    dup = np.sort(np.array([7] * 500 + [9] * 500, dtype=np.uint64))
    empty = pkg["partition"](np.empty(0, np.uint64), np.empty(0, np.uint64),
                             4, cfg=cfg)
    one = pkg["partition"](np.array([7], np.uint64), np.array([8], np.uint64),
                           1, cfg=cfg)
    same = pkg["partition"](np.full(50, 5, np.uint64), np.full(50, 6,
                                                             np.uint64),
                            1, cfg=cfg)
    d = pkg["partition"](dup, payloads_for(dup), 4, cfg=cfg)
    return (d.num_shards, d.bounds.tolist(), d.n_items, empty.num_shards,
            empty.lookup(5), one.plan_split(0), same.plan_split(0))


PKGS = {"ref": {"partition": ref_partition, "cfg": RefConfig},
        "port": {"partition": partition_bulkload, "cfg": AulidConfig}}


@pytest.mark.parametrize("scenario", [_routing, _split_merge_pins,
                                      _edge_partitions],
                         ids=["routing", "split-merge-pins", "edges"])
def test_partition_matches_reference(scenario):
    assert scenario(PKGS["port"]) == scenario(PKGS["ref"])


@pytest.mark.parametrize("live,slots", LAYOUTS, ids=["s1", "s3", "s5of8"])
def test_port_stack_equals_reference(live, slots):
    """The copied partition + stacking build the reference's pools, and
    the carried-over tensors hold them in K1's layout."""
    keys, part, sdi, _ = _ref_stack("osm", live, slots)
    caps = _CACHE[("osm", live, slots)][4]
    mine_part = partition_bulkload(keys, payloads_for(keys), live,
                                   cfg=AulidConfig(**GEOM_512B))
    mine = stack_device_indexes([build_device_index(sh)
                                 for sh in mine_part.shards],
                                mine_part.bounds, min_shards=slots,
                                min_caps=caps)
    for f, _ in _STACK_2D + _STACK_3D:
        assert np.array_equal(getattr(mine, f), getattr(sdi, f)), f
    for f in ("meta", "last_leaf_min", "bounds", "leaf_next_chain"):
        assert np.array_equal(getattr(mine, f), getattr(sdi, f)), f
    stk = port.stacked_device_arrays(mine, 7, "cpu")
    for f, dt in k1.POOL_DTYPES.items():
        assert stk[f].dtype == dt and stk[f].is_contiguous(), f
        assert stk[f].shape[0] == max(live, slots), f
    assert (keys_from_tensor(stk["bounds"]) == sdi.bounds).all()
    assert (keys_from_tensor(stk["leaf_keys"]) == sdi.leaf_keys).all()
    assert stk["meta"].tolist() == sdi.meta.tolist()
    assert stk["bounds_version"] == 7


def test_512b_osm_shards_cover_every_tag():
    _, _, sdi, _ = _ref_stack("osm", 3, 0)
    tags = set(np.unique(sdi.slot_tag).tolist())
    assert {k1.TAG_DATA, k1.TAG_PA, k1.TAG_BT, k1.TAG_MIXED} <= tags


# ---------------------------------------------------------- the read path
@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("live,slots", LAYOUTS, ids=["s1", "s3", "s5of8"])
def test_sharded_lookup_matches_reference(name, live, slots):
    keys, part, sdi, h = _ref_stack(name, live, slots)
    q = _queries(keys, sdi.bounds, seed=3)
    ref_stk = ref.stacked_device_arrays(sdi)
    stk = port.stacked_device_arrays(sdi, device="cpu")
    qt = keys_to_tensor(q, "cpu")
    got = port.lookup_batch_sharded(stk, qt, height=h)
    _same(got, ref.lookup_batch_sharded(ref_stk, q, height=h))
    _same(got, fused_lookup_batch_sharded(ref_stk, q, height=h,
                                          interpret=True))
    assert (got[3].numpy() == part.shard_of_batch(q)).all()
    assert int(got[3].max()) < live, "a placeholder slot got a query"
    ref_ov = ref.overlay_arrays(_overlay(keys, seed=5))
    ov = port.overlay_from_numpy(np.asarray(ref_ov["ov_pack"]), "cpu")
    got = port.lookup_batch_sharded_overlay(stk, ov, qt, height=h)
    _same(got, ref.lookup_batch_sharded_overlay(ref_stk, ref_ov, q,
                                                height=h))
    _same(got, fused_lookup_batch_sharded_overlay(ref_stk, ref_ov, q,
                                                  height=h, interpret=True))
    assert got[1][:300].any() and not got[1][300:400].all()


def test_one_shard_stack_is_the_monolithic_read():
    """The monolithic K1 plain version is the one-shard stack: equal to
    the sharded form over a stack of the same mirror."""
    keys, part, sdi, h = _ref_stack("genome", 1, 0)
    di = sdi.dis[0]
    arrs = port.device_arrays(di, "cpu")
    q = keys_to_tensor(_queries(keys, [], seed=9), "cpu")
    mono = port.lookup_batch(arrs, q, height=h)
    sharded = port.lookup_batch_sharded(
        port.stacked_device_arrays(ref_stack([di], np.empty(0, np.uint64)),
                                   device="cpu"), q, height=h)
    for a, b in zip(mono, sharded[:3]):
        assert torch.equal(a, b)
    assert not sharded[3].any()


def _starts(keys, bounds):
    """Scan starts: a few keys before each real bound (the scan crosses
    into the next shard), the gap after a bound, and the key range's
    edges."""
    out = []
    for b in bounds:
        if int(b) == UM:
            continue
        i = int(np.searchsorted(keys, np.uint64(b)))
        out += [int(keys[max(i - 3, 0)]), int(b) + 1]
    out += [0, int(keys[0]), int(keys[len(keys) // 2]), int(keys[-1]),
            int(keys[-1]) + 1, UM]
    return np.array(out, dtype=np.uint64)


def test_sharded_scans_match_reference():
    keys, part, sdi, h = _ref_stack("osm", 5, 8)
    q = _starts(keys, sdi.bounds)
    ref_stk = ref.stacked_device_arrays(sdi)
    stk = port.stacked_device_arrays(sdi, device="cpu")
    qt = keys_to_tensor(q, "cpu")
    ks, ps, vs = port.scan_batch_sharded(stk, qt, count=40, height=h)
    rk, rp, rv = ref.scan_batch_sharded(ref_stk, q, count=40, height=h)
    assert (keys_from_tensor(ks) == np.asarray(rk)).all()
    assert (bits_from_tensor(ps) == np.asarray(rp)).all()
    assert (vs.numpy() == np.asarray(rv)).all()
    for i, start in enumerate(q[:-1]):      # the host partition agrees
        n = int(vs[i].sum())
        assert list(zip(keys_from_tensor(ks[i, :n]).tolist(),
                        bits_from_tensor(ps[i, :n]).tolist())) == \
            part.scan(int(start), 40)
    ov = _overlay(keys, seed=13)
    ref_ov = ref.overlay_arrays(ov)
    pov = port.overlay_from_numpy(np.asarray(ref_ov["ov_pack"]), "cpu")
    bound = 1 << (len(ov) - 1).bit_length()
    got = port.scan_batch_sharded_overlay(stk, pov, qt, count=24, height=h,
                                          ov_bound=bound)
    exp = ref.scan_batch_sharded_overlay(ref_stk, ref_ov, q, count=24,
                                         height=h, ov_bound=bound)
    assert (keys_from_tensor(got[0]) == np.asarray(exp[0])).all()
    assert (bits_from_tensor(got[1]) == np.asarray(exp[1])).all()
    assert (got[2].numpy() == np.asarray(exp[2])).all()


# ---------------------------------------------------------------- installs
def test_update_stacked_shard_matches_reference():
    """After a hot shard's refresh, ``restack_shard`` + the port's in-place
    ``update_stacked_shard`` give the reference's patched stack; cold
    slices and any dict sharing the pools see the same tensors."""
    keys = make_dataset("covid", 2_000, seed=1)
    ref_part = ref_partition(keys, payloads_for(keys), 3,
                             cfg=RefConfig(**SMALL_GEOM))
    part = partition_bulkload(keys, payloads_for(keys), 3,
                              cfg=AulidConfig(**SMALL_GEOM))
    ref_sdi = ref_stack([ref_build(sh) for sh in ref_part.shards],
                        ref_part.bounds)
    sdi = stack_device_indexes([build_device_index(sh)
                                for sh in part.shards], part.bounds)
    ref_stk = ref.stacked_device_arrays(ref_sdi)
    stk = port.stacked_device_arrays(sdi, device="cpu")
    old = dict(stk)
    cold = stk["leaf_keys"][0].clone()
    lo, hi = int(part.bounds[0]) + 1, int(part.bounds[1])
    hot = [int(k) for k in keys if lo <= int(k) <= hi][:40]
    for p in (ref_part, part):
        for k in hot:
            assert p.update(k, k + 77)
    ref_sdi.dis[1] = ref_refresh(ref_part.shards[1], ref_sdi.dis[1])
    sdi.dis[1] = refresh_device_index(part.shards[1], sdi.dis[1])
    assert ref_restack(ref_sdi, 1) and restack_shard(sdi, 1)
    ref_stk = ref.update_stacked_shard(ref_stk, ref_sdi, [1])
    stk = port.update_stacked_shard(stk, sdi, [1])
    for f, _ in _STACK_2D + _STACK_3D:
        exp = np.asarray(ref_stk[f])
        got = stk[f].numpy()
        if f in k1.KEY_FIELDS:
            got = keys_from_tensor(stk[f])
        elif f == "leaf_pay":
            got = bits_from_tensor(stk[f])
        assert np.array_equal(got, exp), f
        assert stk[f] is old[f], "installs write the pools in place"
    assert torch.equal(stk["leaf_keys"][0], cold)
    assert (stk["leaf_next_chain"].numpy()
            == np.asarray(ref_stk["leaf_next_chain"])).all()
    q = np.array(hot[:8] + [int(keys[0])], dtype=np.uint64)
    h = max(sdi.max_inner_height, 3)
    got = port.lookup_batch_sharded(stk, keys_to_tensor(q, "cpu"), height=h)
    _same(got, ref.lookup_batch_sharded(ref_stk, q, height=h))
    assert bits_from_tensor(got[0])[:8].tolist() == [k + 77 for k in hot[:8]]
