"""The frozen byte counts equal the program's and the smoke's today."""
import sys

import numpy as np
import pytest
import torch

from portbench import bounds, spec
from portbench.tests.small import small_cell  # noqa: F401  (puts src on the path)


@pytest.mark.parametrize("args", [
    (8192, 7000, 8100, 255, True), (8192, 0, 1, 255, False),
    (16, 16, 16, 255, True, True, 7), (4096, 3000, 3900, 1020, True, True, 7),
])
def test_k1_bytes_equal_the_programs(args):
    from repro_torch.kernels.fused_lookup import ops
    assert bounds.k1_bytes(*args) == ops.k1_bytes(*args)
    assert bounds.HBM_BYTES_PER_S == ops.HBM_BYTES_PER_S


@pytest.mark.parametrize("shards", [1, 8])
def test_k1_walks_equal_the_programs(shards):
    from repro_torch.core import Aulid, BlockDevice, partition_bulkload
    from repro_torch.core.keys import keys_to_tensor
    from repro_torch.kernels.fused_lookup import ops
    from repro_torch.serving import IndexEngine, ShardedIndexEngine
    from portbench import index_traffic
    keys, _ = index_traffic.draw_keys(
        small_cell("covid-200M.w1-lookup").config["dataset"], 1, "cpu")
    if shards == 1:
        idx = Aulid(BlockDevice())
        idx.bulkload(keys, keys + np.uint64(1))
        mirror = IndexEngine(idx, device="cpu").arrs
    else:
        mirror = ShardedIndexEngine(partition_bulkload(
            keys, keys + np.uint64(1), shards), device="cpu").stk
    rng = np.random.default_rng(0)
    q = np.concatenate([rng.choice(keys, 500), rng.integers(
        0, 2**64 - 2, 500, dtype=np.uint64), keys[-3:], [2**64 - 1]])
    qt = keys_to_tensor(q.astype(np.uint64), "cpu")

    def host(t):
        return t.numpy().reshape(-1)
    bnd = host(mirror["bounds"]) if "bounds" in mirror else \
        np.empty(0, np.int64)
    got = bounds.k1_walks(host(mirror["last_leaf_min"]),
                          host(mirror["meta"])[::2], bnd, host(qt))
    assert got == ops.k1_walks(mirror, qt)
    assert 0 < got < q.shape[0]


def test_k2_bytes_equal_the_smokes():
    sys.path.insert(0, str(spec.ROOT))
    import chip_smoke
    for args in [(28160, 512, 28522, 0), (0, 8, 8, 100), (5, 5, 5, 5)]:
        assert bounds.k2_live_bytes(*args) == chip_smoke.k2_live_bytes(*args)


def test_bound_seconds():
    assert bounds.bound_s(3.35e12) == pytest.approx(1.0)
    assert torch.tensor(0).item() == 0
