"""K1's shared-memory plan (``fused_lookup.ops._stage_plan``) on the CPU:
slice bytes at the mirrors' own geometries, blocks an SM, the 16- or
8-byte copy width chosen from the row caps and base alignment, and the
``ValueError`` where a leaf row passes a block's shared memory.  (The
kernel it sizes is held to its plain version in ``test_torch_gpu.py``.)
Also K1's bytes bound (``k1_bytes``), which counts a slot record only for
the queries that enter the inner tree (``k1_walks``)."""
import numpy as np
import pytest
import torch

from repro_torch.core import Aulid, AulidConfig, BlockDevice
from repro_torch.core import lookup as L
from repro_torch.core import partition_bulkload
from repro_torch.core.device_index import (build_device_index,
                                           stack_device_indexes)
from repro_torch.core.keys import keys_to_tensor
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.kernels.fused_lookup import ops as k1

GEOMS = {"4k": {}, "512b": dict(block_bytes=512, leaf_capacity=32,
                                mixed_slots_per_block=16,
                                pa_classes=(4, 8, 16), bt_max_children=4,
                                bt_child_capacity=7),
         "leaf33": dict(leaf_capacity=33), "leaf34": dict(leaf_capacity=34),
         "no-pa": dict(lipp_inner=True)}
ALL = k1.WIDE_LEAF | k1.WIDE_PA | k1.WIDE_BT
SMEM_SM, SMEM_RESERVED = 233_472, 1024   # an H100 SM; a block's share
WARPS_SM = 64                 # resident warps an SM at 32 registers


def _blocks_per_sm(plan):
    """Blocks of ``plan`` resident on one SM: the warp limit or the
    shared-memory limit, whichever is lower."""
    return min(WARPS_SM // plan.warps,
               SMEM_SM // (plan.smem_bytes + SMEM_RESERVED))


def _caps(geom):
    keys = make_dataset("osm", 20_000, seed=1)
    cfg = AulidConfig(**GEOMS[geom])
    idx = Aulid(BlockDevice(block_bytes=cfg.block_bytes), cfg=cfg)
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    return (di.leaf_keys.shape[1], di.pa_keys.shape[1], di.bt_keys.shape[1])


# geometry -> (leaf cap, warps, bytes a block, blocks an SM, pools copied
# 8 bytes at a time)
MIRRORS = {"4k": (256, 8, 16384, 8, 0), "512b": (32, 8, 2048, 8, 0),
           "leaf33": (33, 8, 2176, 8, k1.WIDE_LEAF),
           "leaf34": (34, 8, 2176, 8, 0),
           "no-pa": (256, 8, 16384, 8, k1.WIDE_PA | k1.WIDE_BT)}


@pytest.mark.parametrize("geom", list(MIRRORS))
def test_stage_plan_at_mirror_geometries(geom):
    leaf_cap, warps, nbytes, blocks, narrow = MIRRORS[geom]
    caps = _caps(geom)
    assert caps[0] == leaf_cap
    if geom == "no-pa":           # no PA or BT node: caps of 1
        assert caps[1:] == (1, 1)
    plan = k1._stage_plan(*caps)
    assert (plan.warps, plan.smem_bytes) == (warps, nbytes)
    assert plan.slice_keys >= leaf_cap and plan.slice_keys % 2 == 0
    assert _blocks_per_sm(plan) == blocks
    # odd caps copy 8 bytes at a time; even ones 16
    assert plan.wide & narrow == 0
    for bit, cap in zip((k1.WIDE_LEAF, k1.WIDE_PA, k1.WIDE_BT), caps):
        assert bool(plan.wide & bit) == (cap % 2 == 0)


# (leaf, pa, bt caps, aligned bases) -> (warps, bytes, slice keys, wide,
# blocks an SM)
PLANS = [
    ((256, 64, 1020), (True,) * 3, (8, 16384, 256, ALL, 8)),
    ((256, 64, 1020), (True, False, True),
     (8, 16384, 256, k1.WIDE_LEAF | k1.WIDE_BT, 8)),
    ((1, 1, 1), (True,) * 3, (8, 128, 2, 0, 8)),
    ((1024, 64, 7), (True,) * 3, (8, 65536, 1024, k1.WIDE_LEAF | k1.WIDE_PA,
                                 3)),
    ((4001, 2, 2), (True,) * 3, (7, 224112, 4002, k1.WIDE_PA | k1.WIDE_BT,
                                 1)),
    ((29_056, 2, 2), (True,) * 3, (1, 232_448, 29_056, ALL, 1)),
]


@pytest.mark.parametrize("caps,aligned,want", PLANS,
                         ids=["default", "unaligned-pa", "caps-1",
                              "above-48k", "7-warps", "one-warp"])
def test_stage_plan_shapes(caps, aligned, want):
    plan = k1._stage_plan(*caps, aligned)
    assert tuple(plan) == want[:4]
    assert _blocks_per_sm(plan) == want[4]
    assert plan.smem_bytes <= k1.SMEM_BLOCK_MAX
    assert (plan.smem_bytes > 48 * 1024) == (caps[0] >= 1024)


@pytest.mark.parametrize("caps", [(29_057, 2, 2), (1 << 20, 64, 64),
                                  (0, 1, 1), (256, 0, 1)],
                         ids=["past-limit", "huge", "leaf-0", "pa-0"])
def test_stage_plan_rejects(caps):
    with pytest.raises(ValueError):
        k1._stage_plan(*caps)


CPU = torch.device("cpu")


def test_k1_bound_counts_no_slot_on_a_page_table():
    """An LM page table's mirror is one leaf row with no inner node (root
    < 0): no query enters the tree, so the bound counts queries, outputs
    and the row, and no slot record."""
    from repro_torch.launch.time_plain import _lm_case
    arrs, keys, h = _lm_case(CPU)
    q = keys_to_tensor(keys, CPU)
    assert int(arrs["meta"][0]) < 0 and k1.k1_walks(arrs, q) == 0
    rows = int(torch.unique(k1.fused_lookup(arrs, None, q, h)[2]).numel())
    assert (q.shape[0], rows, arrs["leaf_keys"].shape[1]) == (256, 1, 256)
    assert k1.k1_bytes(256, 0, rows, 256, False) == 256 * 29 + 2048 == 9472


# (Q, walks, rows, cap, overlay, sharded, bounds) -> bytes
BYTES = [((256, 256, 1, 256, False, False, 0), 256 * 49 + 2048),
         ((8192, 8000, 7000, 256, True, False, 0),
          8192 * 37 + 8000 * 20 + 7000 * 2048),
         ((8192, 0, 7000, 256, True, True, 7), 8192 * 41 + 7000 * 2048 + 56)]


@pytest.mark.parametrize("args,want", BYTES, ids=["all-walk", "overlay",
                                                  "sharded-none-walk"])
def test_k1_bytes(args, want):
    assert k1.k1_bytes(*args) == want


@pytest.mark.parametrize("layout", [None, (3, 0), (6, 8)],
                         ids=["flat", "s3", "s6of8"])
def test_k1_walks_match_the_route(layout):
    """``k1_walks`` == the queries whose shard (searchsorted over the
    bounds, placeholder shards included) has a root and a last-leaf
    minimum above the key; keys past every shard's minimum walk no tree."""
    keys = make_dataset("osm", 20_000, seed=1)
    if layout is None:
        idx = Aulid(BlockDevice())
        idx.bulkload(keys, payloads_for(keys))
        arrs = L.device_arrays(build_device_index(idx), CPU)
        stk = k1._as_stack(arrs)
    else:
        part = partition_bulkload(keys, payloads_for(keys), layout[0])
        arrs = stk = L.stacked_device_arrays(stack_device_indexes(
            [build_device_index(sh) for sh in part.shards], part.bounds,
            min_shards=layout[1]), device=CPU)
    rng = np.random.default_rng(4)
    qn = np.concatenate([rng.choice(keys, 900), keys[-100:],
                         np.array([0, np.iinfo(np.uint64).max], np.uint64)])
    q = keys_to_tensor(qn, CPU)
    sid = torch.searchsorted(stk["bounds"], q, side="left")
    want = (q < stk["last_leaf_min"][sid]) & (stk["meta"][sid, 0] >= 0)
    got = k1.k1_walks(arrs, q)
    assert got == int(want.sum())
    assert 0 < got < q.shape[0]
