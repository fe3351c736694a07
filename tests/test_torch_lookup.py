"""The port's read path == the JAX reference's, bit for bit.

The same numpy mirror (the reference's ``DeviceIndex``, carried over with
``mirror_from_numpy``) is served by the reference's jnp path, by its fused
Pallas kernel in interpret mode, and by the port's plain PyTorch version of
K1 on the CPU: payloads, found flags and leaf rows must be identical.  Four
datasets x two geometries (the default 4 KB and the scaled 512 B one, where
50k ``osm`` keys give DATA, PA, BT and MIXED slots at inner height 3) plus
the empty mirror.  Scans with ``ov_bound`` are held to the reference the
same way, and the port's copied ``Aulid`` + ``build_device_index`` must
build pools equal to the reference's.  (The CUDA kernel is held to its
plain version in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import (Aulid as RefAulid, AulidConfig as RefConfig,
                        BlockDevice as RefBlockDevice,
                        DeltaOverlay as RefOverlay)
from repro.core import lookup as ref
from repro.core.device_index import _STACK_2D, _STACK_3D
from repro.core.device_index import build_device_index as ref_build
from repro.core.workloads import make_dataset, payloads_for
from repro.kernels.fused_lookup import fused_lookup_batch_overlay

from repro_torch.core import Aulid, AulidConfig, BlockDevice
from repro_torch.core import lookup as port
from repro_torch.core.device_index import (build_device_index,
                                           refresh_device_index)
from repro_torch.core.keys import (BIASED_MAX, bits_from_tensor,
                                   keys_from_tensor, keys_to_tensor)
from repro_torch.kernels.fused_lookup import ops as k1

DATASETS = ("covid", "planet", "genome", "osm")
# the scaled 512-B block geometry of the benchmarks (leaf 32 pairs, B+-tree
# fanout 7): 50k keys reach the inner-height regime of far larger inputs
GEOMS = {"4k": {}, "512b": dict(block_bytes=512, leaf_capacity=32,
                                mixed_slots_per_block=16,
                                pa_classes=(4, 8, 16), bt_max_children=4,
                                bt_child_capacity=7)}
N_KEYS = {"4k": 20_000, "512b": 50_000}
CASES = [(d, g) for g in GEOMS for d in DATASETS]
_IDS = [f"{d}-{g}" for d, g in CASES]

_CACHE: dict = {}


def _mirror(name, geom):
    """(keys, reference DeviceIndex, height), built once per case."""
    if (name, geom) not in _CACHE:
        keys = make_dataset(name, N_KEYS[geom], seed=1)
        idx = RefAulid(RefBlockDevice(), cfg=RefConfig(**GEOMS[geom]))
        idx.bulkload(keys, payloads_for(keys))
        di = ref_build(idx)
        _CACHE[(name, geom)] = (keys, di, max(di.max_inner_height, 3))
    return _CACHE[(name, geom)]


def _pools(di) -> dict:
    pools = {f: getattr(di, f) for f, _ in _STACK_2D + _STACK_3D}
    pools.update(root_node=di.root_node, last_leaf_row=di.last_leaf_row,
                 last_leaf_min=di.last_leaf_min)
    return pools


def _queries(keys, seed, n_hit=600, n_miss=200) -> np.ndarray:
    """Present, absent, below-min, above-max and padding keys."""
    rng = np.random.default_rng(seed)
    hits = rng.choice(keys, n_hit)
    misses = rng.integers(0, 2**64 - 1, n_miss, dtype=np.uint64)
    edges = np.array([0, max(int(keys[0]) - 1, 0), int(keys[0]), int(keys[-1]),
                      int(keys[-1]) + 1, 2**63, 2**64 - 2, 2**64 - 1],
                     dtype=np.uint64)
    return np.concatenate([hits, misses, edges])


def _overlay(keys, seed):
    """A reference overlay holding fresh inserts, upserts of snapshot keys
    and tombstones of snapshot keys."""
    rng = np.random.default_rng(seed)
    ov = RefOverlay()
    for k in rng.integers(0, 2**62, 64, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 48):
        ov.record_insert(int(k), int(k) + 77)
    for k in rng.choice(keys, 48):
        ov.record_delete(int(k))
    return ov


def _same_read(got, exp):
    pay, found, leaf = got
    assert (bits_from_tensor(pay) == np.asarray(exp[0])).all()
    assert (found.numpy() == np.asarray(exp[1])).all()
    assert (leaf.numpy() == np.asarray(exp[2])).all()


@pytest.mark.parametrize("name,geom", CASES, ids=_IDS)
def test_lookup_matches_reference(name, geom):
    keys, di, h = _mirror(name, geom)
    q = _queries(keys, seed=3)
    arrs = port.mirror_from_numpy(_pools(di), "cpu")
    qt = keys_to_tensor(q, "cpu")
    ref_arrs = ref.device_arrays(di)
    _same_read(port.lookup_batch(arrs, qt, height=h),
               ref.lookup_batch(ref_arrs, q, height=h))
    # the overlay-merged read against the jnp path and the Pallas kernel
    ref_ov = ref.overlay_arrays(_overlay(keys, seed=5))
    ov = port.overlay_from_numpy(np.asarray(ref_ov["ov_pack"]), "cpu")
    got = port.lookup_batch_overlay(arrs, ov, qt, height=h)
    _same_read(got, ref.lookup_batch_overlay(ref_arrs, ref_ov, q, height=h))
    _same_read(got, fused_lookup_batch_overlay(ref_arrs, ref_ov, q, height=h,
                                               interpret=True))
    assert got[1][:600].sum() > 0 and not got[1][600:800].all()


def test_512b_osm_covers_every_tag():
    _, di, h = _mirror("osm", "512b")
    tags = set(np.unique(di.slot_tag).tolist())
    assert {k1.TAG_DATA, k1.TAG_PA, k1.TAG_BT, k1.TAG_MIXED} <= tags
    assert di.inner_height == 3 and h == 3


def test_empty_mirror():
    idx = RefAulid(RefBlockDevice())
    di = ref_build(idx)
    assert di.root_node == -1
    q = np.array([0, 5, 2**50, 2**64 - 1], dtype=np.uint64)
    arrs = port.mirror_from_numpy(_pools(di), "cpu")
    got = port.lookup_batch(arrs, keys_to_tensor(q, "cpu"), height=3)
    _same_read(got, ref.lookup_batch(ref.device_arrays(di), q, height=3))
    assert not got[1][:3].any()


@pytest.mark.parametrize("name,geom", [("osm", "512b"), ("covid", "4k")],
                         ids=["osm-512b", "covid-4k"])
def test_scans_match_reference(name, geom):
    keys, di, h = _mirror(name, geom)
    q = _queries(keys, seed=11, n_hit=24, n_miss=8)
    arrs = port.mirror_from_numpy(_pools(di), "cpu")
    ref_arrs = ref.device_arrays(di)
    qt = keys_to_tensor(q, "cpu")
    ks, ps, vs = port.scan_batch(arrs, qt, count=16, height=h)
    rk, rp, rv = ref.scan_batch(ref_arrs, q, count=16, height=h)
    assert (keys_from_tensor(ks) == np.asarray(rk)).all()
    assert (bits_from_tensor(ps) == np.asarray(rp)).all()
    assert (vs.numpy() == np.asarray(rv)).all()
    ov = _overlay(keys, seed=13)
    ref_ov = ref.overlay_arrays(ov)
    pov = port.overlay_from_numpy(np.asarray(ref_ov["ov_pack"]), "cpu")
    bound = 1 << (len(ov) - 1).bit_length()
    for count, ov_bound in ((16, bound), (16, None)):
        got = port.scan_batch_overlay(arrs, pov, qt, count=count, height=h,
                                      ov_bound=ov_bound)
        exp = ref.scan_batch_overlay(ref_arrs, ref_ov, q, count=count,
                                     height=h, ov_bound=ov_bound)
        assert (keys_from_tensor(got[0]) == np.asarray(exp[0])).all()
        assert (bits_from_tensor(got[1]) == np.asarray(exp[1])).all()
        assert (got[2].numpy() == np.asarray(exp[2])).all()


def _union_sort(ks, ps, vs, pack, q, count, hide):
    """The reference's overlay-scan union, transcribed: every snapshot
    candidate and the first ``hide`` overlay slots, argsorted whole."""
    keys, cap = pack[0], pack.shape[1]
    pos = torch.searchsorted(keys, ks)
    vs = vs & ~((pos < cap) & (keys[pos.clamp(0, cap - 1)] == ks))
    keys, pays, tombs = keys[:hide], pack[1, :hide], pack[2, :hide] != 0
    Q = q.shape[0]
    ov_v = (keys[None] != BIASED_MAX) & ~tombs[None] & (keys[None] >= q[:, None])
    comb_k = torch.cat([ks, keys[None].expand(Q, hide)], 1)
    comb_p = torch.cat([ps, pays[None].expand(Q, hide)], 1)
    comb_v = torch.cat([vs, ov_v], 1)
    order = torch.argsort(torch.where(comb_v, comb_k, BIASED_MAX), dim=1,
                          stable=True)[:, :count]
    return (comb_k.gather(1, order), comb_p.gather(1, order),
            comb_v.gather(1, order))


@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (64, 64), (64, 70),
                                 (300, 17)])
def test_first_true_is_the_stable_argsort(n, k):
    rng = np.random.default_rng(n * 100 + k)
    rows = [rng.random(n) < p for p in (0.0, 0.05, 0.5, 0.95, 1.0)]
    mask = torch.from_numpy(np.stack(rows))
    exp = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :k]
    assert torch.equal(port._first_true(mask, k), exp)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("count,hide", [(1, 8), (5, 40), (16, 4), (16, 64)])
def test_overlay_scan_merge_equals_the_whole_union(seed, count, hide):
    """Each side cut to ``count`` columns by prefix counts gives the whole
    union's sort: owned candidates, tombstones, rows with fewer valid
    entries than ``count`` (the invalid tail), a full pack (no padding)
    and valid keys equal to ``BIASED_MAX``."""
    rng = np.random.default_rng(seed)
    Q, cap, base = 10, 64, count + hide
    lo = -(2**40)
    fill = cap if seed % 3 == 0 else int(rng.integers(0, cap))
    pk = np.full(cap, int(BIASED_MAX), np.int64)
    pk[:fill] = np.sort(rng.choice(400, fill, replace=False)) + lo
    if seed % 4 == 1 and fill:
        pk[fill - 1] = int(BIASED_MAX)
    pack = torch.from_numpy(np.stack([
        pk, rng.integers(-2**62, 2**62, cap),
        (rng.random(cap) < 0.3).astype(np.int64)]))
    q = torch.from_numpy(rng.integers(0, 300, Q) + lo)
    ks = rng.integers(-2**62, 2**62, (Q, base))
    vs = np.zeros((Q, base), bool)
    for i in range(Q):
        nv = int(rng.integers(0, base + 1))
        ks[i, :nv] = np.sort(rng.choice(500, nv, replace=False)) \
            + int(q[i])
        if seed % 2 and nv:
            ks[i, nv - 1] = int(BIASED_MAX)
        vs[i, :nv] = True
    ks = torch.from_numpy(ks)
    ps = torch.from_numpy(rng.integers(-2**62, 2**62, (Q, base)))
    vs = torch.from_numpy(vs)
    got = port._overlay_scan_merge(ks.clone(), ps.clone(), vs.clone(), pack,
                                   q, count, hide)
    exp = _union_sort(ks, ps, vs, pack, q, count, hide)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


@pytest.mark.parametrize("name,geom", CASES, ids=_IDS)
def test_copied_builder_matches_reference_pools(name, geom):
    keys, di, _ = _mirror(name, geom)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS[geom]))
    idx.bulkload(keys, payloads_for(keys))
    mine = build_device_index(idx)
    for f, _ in _STACK_2D + _STACK_3D:
        assert np.array_equal(getattr(mine, f), getattr(di, f)), f
    assert (mine.root_node, mine.last_leaf_row, mine.last_leaf_min,
            mine.inner_height) == (di.root_node, di.last_leaf_row,
                                   di.last_leaf_min, di.inner_height)


def test_mirror_layout_and_carry_over():
    """device_arrays builds the kernel's layout directly, and carrying the
    reference's pools over gives the same mirror as the copied builder."""
    keys, di, _ = _mirror("planet", "512b")
    arrs = port.mirror_from_numpy(_pools(di), "cpu")
    for f, dt in k1.POOL_DTYPES.items():
        assert arrs[f].dtype == dt and arrs[f].is_contiguous(), f
    assert (keys_from_tensor(arrs["leaf_keys"]) == di.leaf_keys).all()
    assert (bits_from_tensor(arrs["leaf_pay"]) == di.leaf_pay).all()
    assert arrs["meta"].tolist() == [di.root_node, di.last_leaf_row]
    again = port.device_arrays(di, "cpu")
    for f in k1.POOL_DTYPES:
        assert torch.equal(again[f], arrs[f]), f


def test_update_leaf_rows_is_out_of_place():
    """A fast-path refresh patches only the touched rows, into new tensors:
    readers of the old dict keep the old snapshot."""
    keys = make_dataset("covid", 4_000, seed=2)
    idx = Aulid(BlockDevice())
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    arrs = port.device_arrays(di, "cpu")
    before = {f: arrs[f].clone() for f in ("leaf_keys", "leaf_pay")}
    idx.update(int(keys[300]), 4242)
    idx.delete(int(keys[301]))
    assert refresh_device_index(idx, di) is di
    new = port.update_leaf_rows(arrs, di)
    for f, t in before.items():
        assert torch.equal(arrs[f], t), f
    assert (keys_from_tensor(new["leaf_keys"]) == di.leaf_keys).all()
    assert (bits_from_tensor(new["leaf_pay"]) == di.leaf_pay).all()
    assert (new["leaf_count"].numpy() == di.leaf_count).all()
    assert new is not arrs


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("n", [1, 3_000, 40_000])
def test_port_datasets_equal_reference(name, n):
    """The port's dataset recipes (sort-based de-duplication) draw exactly
    the reference's keys, and the same payloads."""
    from repro_torch.core import workloads as port_wl
    got = port_wl.make_dataset(name, n, seed=5)
    exp = make_dataset(name, n, seed=5)
    assert got.dtype == exp.dtype and np.array_equal(got, exp)
    assert np.array_equal(port_wl.payloads_for(got), payloads_for(exp))


def test_time_plain_compares_trees_on_cpu(capsys):
    """``repro_torch.launch.time_plain`` loads each ``--tree`` as a package
    of its own, checks that their plain reads agree, and prints one reading
    per round, tree and overlay case, the second round in reverse order."""
    import json
    import pathlib

    from repro_torch.launch import time_plain

    src = str(pathlib.Path(k1.__file__).resolve().parents[3])
    assert time_plain.main(["--device", "cpu", "--keys", "20000", "--reps",
                            "1", "--tree", f"a={src}",
                            "--tree", f"b={src}"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    head, rows = lines[0], lines[1:]
    assert head["device"] == "cpu" and head["trees"] == ["a", "b"]
    assert [(r["round"], r["tree"]) for r in rows] == [
        (0, "a"), (0, "a"), (0, "b"), (0, "b"),
        (1, "b"), (1, "b"), (1, "a"), (1, "a")]
    assert all(r["wall_ms"] > 0 and "device_ms" not in r for r in rows)
    ops = {(r["tree"], r["case"]): r["aten_ops"] for r in rows}
    assert ops[("a", "overlay")] == ops[("b", "overlay")] \
        > ops[("a", "no overlay")] == ops[("b", "no overlay")] > 0
