"""Card-only tests: each hand-written CUDA kernel == its plain PyTorch
version on the same tensors, exactly, and the engine on the card == the
engine on the CPU, request for request.

Every test here is marked ``gpu`` and skips without a CUDA device (the
kernels have no CPU mode).  This file imports only the port, so it runs
where the JAX reference is not installed:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import Aulid, AulidConfig, BlockDevice, DeltaOverlay
from repro_torch.core import lookup as port
from repro_torch.core.device_index import build_device_index
from repro_torch.core.keys import keys_to_tensor
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.kernels.fused_lookup import ops as k1
from repro_torch.kernels.overlay_merge import ops as k2
from repro_torch.serving import IndexEngine

pytestmark = pytest.mark.gpu

GEOMS = {"4k": {}, "512b": dict(block_bytes=512, leaf_capacity=32,
                                mixed_slots_per_block=16,
                                pa_classes=(4, 8, 16), bt_max_children=4,
                                bt_child_capacity=7)}
CASES = [(d, g) for g in GEOMS for d in ("covid", "planet", "genome", "osm")]
UM = np.uint64(2**64 - 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _queries(keys, rng):
    edges = np.array([0, int(keys[0]), int(keys[-1]), int(keys[-1]) + 1,
                      2**63, 2**64 - 1], dtype=np.uint64)
    return np.concatenate([rng.choice(keys, 3000),
                           rng.integers(0, 2**64 - 1, 1000, dtype=np.uint64),
                           edges])


@pytest.mark.parametrize("name,geom", CASES,
                         ids=[f"{d}-{g}" for d, g in CASES])
def test_fused_lookup_kernel_matches_plain(cuda, name, geom):
    keys = make_dataset(name, 50_000, seed=1)
    idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS[geom]))
    idx.bulkload(keys, payloads_for(keys))
    di = build_device_index(idx)
    h = max(di.max_inner_height, 3)
    rng = np.random.default_rng(7)
    ov = DeltaOverlay()
    for k in rng.integers(0, 2**62, 200, dtype=np.uint64):
        ov.record_insert(int(k), int(k) % 1009)
    for k in rng.choice(keys, 100):
        ov.record_insert(int(k), 5)
    for k in rng.choice(keys, 100):
        ov.record_delete(int(k))
    arrs = port.device_arrays(di, cuda)
    q = keys_to_tensor(_queries(keys, rng), cuda)
    for ovr in (None, port.overlay_arrays(ov, cuda)):
        n = k1.fused_lookup.launches
        got = k1.fused_lookup(arrs, ovr, q, h)
        assert k1.fused_lookup.launches == n + 1
        exp = k1.lookup_plain(arrs, ovr, q, h)
        torch.cuda.synchronize()
        for g, e in zip(got, exp):
            assert torch.equal(g, e)
        assert got[1][:3000].any()


def test_fused_lookup_empty_mirror(cuda):
    arrs = port.device_arrays(build_device_index(Aulid()), cuda)
    q = keys_to_tensor(np.array([0, 5, 2**50, 2**64 - 1], np.uint64), cuda)
    got = k1.fused_lookup(arrs, None, q, 3)
    exp = k1.lookup_plain(arrs, None, q, 3)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)


def _pack(rng, keys, cap):
    keys = np.sort(np.asarray(keys, dtype=np.uint64))
    n = keys.shape[0]
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UM
    pack[0, :n] = keys
    pack[1, :n] = rng.integers(0, 2**63, n, dtype=np.uint64)
    pack[2, :n] = rng.random(n) < 0.25
    return pack


def _merge_cases():
    rng = np.random.default_rng(0)
    pool = rng.choice(2**60, size=40_000, replace=False).astype(np.uint64)
    yield "empty-pack", _pack(rng, [], 64), _pack(rng, pool[:40], 64), 64
    yield "empty-batch", _pack(rng, pool[:50], 64), _pack(rng, [], 8), 64
    yield "all-overlap", _pack(rng, pool[:512], 1024), \
        _pack(rng, pool[:512], 512), 1024
    yield "cap-growth", _pack(rng, pool[:1000], 1024), \
        _pack(rng, pool[900:1400], 512), 2048
    yield "multi-chunk-batch", _pack(rng, pool[:3000], 4096), \
        _pack(rng, pool[2000:5000], 4096), 8192
    yield "big-pack", _pack(rng, pool[:30_000], 1 << 20), \
        _pack(rng, pool[29_800:30_312], 512), 1 << 20


MERGE_CASES = list(_merge_cases())


@pytest.mark.parametrize("name,a,b,cap_out", MERGE_CASES,
                         ids=[c[0] for c in MERGE_CASES])
def test_overlay_merge_kernel_matches_plain(cuda, name, a, b, cap_out):
    pa = port.overlay_from_numpy(a, cuda)["ov_pack"]
    pb = port.overlay_from_numpy(b, cuda)["ov_pack"]
    n = k2.overlay_merge.launches
    got = k2.overlay_merge(pa, pb, cap_out)
    assert k2.overlay_merge.launches == n + 1
    exp = k2.merge_overlay_pack_torch(pa, pb, cap_out)
    torch.cuda.synchronize()
    assert torch.equal(got, exp)


def _drive(eng, trace):
    out = []
    for step in trace:
        reqs = [eng.submit(*args) for args in step]
        eng.step()
        if eng._inflight is not None:
            # let the background build finish, so that every engine installs
            # it at the next step boundary whatever its thread's speed
            eng._inflight.result()
        out.extend((r.op, r.key, tuple(r.result) if isinstance(r.result, list)
                    else r.result) for r in reqs)
    return out


@pytest.mark.parametrize("async_compact", [False, True],
                         ids=["sync", "async"])
def test_engine_on_card_matches_cpu(cuda, async_compact):
    keys = make_dataset("osm", 4_000, seed=1)
    rng = np.random.default_rng(3)
    trace = []
    for _ in range(8):
        fresh = rng.integers(1, 2**60, 40, dtype=np.uint64)
        trace.append([("insert", int(k), int(k) % 91) for k in fresh]
                     + [("delete", int(k)) for k in rng.choice(keys, 10)]
                     + [("get", int(k)) for k in rng.choice(keys, 60)]
                     + [("get", int(k)) for k in fresh[:10]]
                     + [("scan", int(k), 0, 50) for k in rng.choice(keys, 4)])
    engines = []
    for device in ("cpu", cuda):
        idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOMS["512b"]))
        idx.bulkload(keys, payloads_for(keys))
        engines.append(IndexEngine(idx, device=device, gamma=0.02,
                                   async_compact=async_compact))
    n1, n2 = k1.fused_lookup.launches, k2.overlay_merge.launches
    out = [_drive(e, trace) for e in engines]
    for e in engines:
        e.drain_compactions()
    assert out[0] == out[1]
    assert k1.fused_lookup.launches > n1 and k2.overlay_merge.launches > n2
    st = [e.stats() for e in engines]
    assert st[1]["read_backend"] == "cuda"
    assert st[0]["compactions"] == st[1]["compactions"] >= 1
