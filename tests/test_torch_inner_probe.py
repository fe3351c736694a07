"""K5 ``inner_probe`` and the staged block-at-a-time read: the port's plain
path == the JAX reference, bit for bit, on the same numpy inputs.

Both sides are built from one reference ``Aulid``: the reference's
``ProbeIndex`` over its ``DeviceIndex``, the port's ``ProbeIndex`` over the
same pools carried over with ``mirror_from_numpy``.  One probe round is
held against ``probe_level_ref`` (numpy) and the Pallas ``probe_level`` in
interpret mode; the whole read against the reference's
``inner_probe_lookup`` (interpret mode): payload at the leaf rank (also for
absent keys), found, and ``count_rounds``.  The four datasets on the 512-B
geometry (whose slot counts are not multiples of 128), a deep index after
inserts, the empty mirror and the quickstart's flow.  (The CUDA kernels are
held to their plain versions in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import Aulid, AulidConfig, BlockDevice
from repro.core.device_index import _STACK_2D, _STACK_3D, build_device_index
from repro.core.workloads import make_dataset, payloads_for
from repro.kernels.inner_probe.inner_probe import probe_level as ref_probe
from repro.kernels.inner_probe.ops import ProbeIndex as RefProbeIndex
from repro.kernels.inner_probe.ops import inner_probe_lookup as ref_lookup
from repro.kernels.inner_probe.ref import probe_level_ref
from repro.kernels.leaf_search.ops import split_u64

from repro_torch.core import lookup as port
from repro_torch.core.keys import bits_from_tensor, key_f64, keys_to_tensor
from repro_torch.kernels import ProbeIndex, inner_probe_lookup
from repro_torch.kernels.inner_probe.ops import (SPB, probe_level,
                                                 probe_level_plain)
from repro_torch.kernels.leaf_search.ops import leaf_search_plain

DATASETS = ("covid", "planet", "genome", "osm")
GEOM_512B = dict(block_bytes=512, leaf_capacity=32, mixed_slots_per_block=16,
                 pa_classes=(4, 8, 16), bt_max_children=4,
                 bt_child_capacity=7)

_CACHE: dict = {}


def _build(idx):
    """(reference ProbeIndex, port ProbeIndex) of one reference Aulid."""
    di = build_device_index(idx)
    pools = {f: getattr(di, f) for f, _ in _STACK_2D + _STACK_3D}
    pools.update(root_node=di.root_node, last_leaf_row=di.last_leaf_row,
                 last_leaf_min=di.last_leaf_min)
    arrs = port.mirror_from_numpy(pools, "cpu")
    return RefProbeIndex(di), ProbeIndex(arrs, di.inner_height)


def _mirror(name):
    if name not in _CACHE:
        keys = make_dataset(name, 20_000, seed=1)
        idx = Aulid(BlockDevice(), cfg=AulidConfig(**GEOM_512B))
        idx.bulkload(keys, payloads_for(keys))
        _CACHE[name] = (keys, idx) + _build(idx)
    return _CACHE[name]


def _queries(keys, seed, n_hit=200, n_miss=48):
    rng = np.random.default_rng(seed)
    edges = np.array([0, int(keys[0]), int(keys[-1]), int(keys[-1]) + 1,
                      2**63, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
    return np.concatenate([rng.choice(keys, n_hit),
                           rng.integers(0, 2**64 - 1, n_miss,
                                        dtype=np.uint64), edges])


def _same_probe(rpi, pi, slots, q):
    slots = np.asarray(slots, np.int32)
    qh, ql = split_u64(q)
    kind, val = probe_level(pi.arrs, torch.from_numpy(slots),
                            keys_to_tensor(q, "cpu"))
    pools = (rpi.tag_b, rpi.kh_b, rpi.kl_b, rpi.ptr_b, rpi.succ_b,
             rpi.nocc_b)
    kr, vr = probe_level_ref(slots, qh, ql, *pools)
    assert (kind.numpy() == kr).all() and (val.numpy() == vr).all()
    kk, vk = ref_probe(slots, qh, ql, *pools, interpret=True)
    assert (kind.numpy() == np.asarray(kk)).all()
    assert (val.numpy() == np.asarray(vk)).all()
    return kind.numpy()


def _same_lookup(rpi, pi, q):
    got = inner_probe_lookup(pi, keys_to_tensor(q, "cpu"), count_rounds=True)
    exp = ref_lookup(rpi, q, interpret=True, count_rounds=True)
    assert (bits_from_tensor(got[0]) == exp[0]).all()
    assert (got[1].numpy() == exp[1]).all()
    assert got[2] == exp[2]
    return bits_from_tensor(got[0]), got[1].numpy()


@pytest.mark.parametrize("name", DATASETS)
def test_probe_level_matches_reference(name):
    """Root predictions plus random slots (stale hops, chains leaving the
    block, chain ends), and every slot of the last, partial block."""
    keys, _, rpi, pi = _mirror(name)
    S = pi.arrs["slot_tag"].shape[0]
    assert S % SPB != 0
    rng = np.random.default_rng(4)
    q = _queries(keys, seed=2, n_hit=120, n_miss=24)
    slots = pi.predict(torch.zeros(len(q), dtype=torch.int64),
                       key_f64(keys_to_tensor(q, "cpu"))).numpy()
    assert (slots == rpi.predict(np.zeros(len(q), np.int64), q)).all()
    kinds = _same_probe(rpi, pi, slots, q)
    assert (kinds != 0).all()
    tail = np.arange(S - S % SPB, S)
    rand = rng.integers(0, S, 128 - len(tail))
    _same_probe(rpi, pi, np.concatenate([tail, rand]),
                rng.choice(q, 128))


@pytest.mark.parametrize("name", DATASETS)
def test_staged_lookup_matches_reference(name):
    keys, idx, rpi, pi = _mirror(name)
    q = _queries(keys, seed=3)
    pay, found = _same_lookup(rpi, pi, q)
    for k, p, f in zip(q.tolist(), pay.tolist(), found.tolist()):
        exp = idx.lookup(k)
        assert (exp is None) == (not f)
        if f:
            assert p == exp


def test_staged_lookup_deep_index_after_inserts():
    """Mixed depth > 1 after hot inserts (as ``test_kernels.py``), so rounds
    descend through MIXED slots and walk successor chains."""
    rng = np.random.default_rng(2)
    keys = np.unique(rng.integers(0, 2**60, 20_000).astype(np.uint64))
    idx = Aulid(BlockDevice(), cfg=AulidConfig(
        leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15))
    idx.bulkload(keys, keys + np.uint64(1))
    hot = np.unique(rng.integers(10**9, 10**9 + 10**6, 4_000)
                    ).astype(np.uint64)
    for k in hot:
        idx.insert(int(k), int(k) + 1)
    rpi, pi = _build(idx)
    assert pi.inner_height >= 2
    q = np.concatenate([hot[:120], keys[:100],
                        rng.integers(0, 2**60, 36, dtype=np.uint64)])
    pay, found = _same_lookup(rpi, pi, q)
    assert found[:220].all() and (pay[:220] == q[:220] + 1).all()


@pytest.mark.parametrize("name", ("osm", "deep"))
def test_staged_lookup_trace(name):
    """``trace`` records every kernel call of the read: one per round, so
    its length is ``count_rounds``; each output is the plain version's on
    the recorded inputs; the last call searches the leaf rows read."""
    if name == "deep":
        rng = np.random.default_rng(2)
        keys = np.unique(rng.integers(0, 2**60, 5_000).astype(np.uint64))
        idx = Aulid(BlockDevice(), cfg=AulidConfig(
            leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15))
        idx.bulkload(keys, keys + np.uint64(1))
        for k in np.unique(rng.integers(10**9, 10**9 + 10**5, 1_000)):
            idx.insert(int(k), int(k) + 1)
        _, pi = _build(idx)
        assert pi.inner_height >= 2
    else:
        keys, _, _, pi = _mirror(name)
    q = keys_to_tensor(_queries(keys, seed=5), "cpu")
    trace = []
    pay, found, rounds = inner_probe_lookup(pi, q, count_rounds=True,
                                            trace=trace)
    assert len(trace) == rounds
    plain = {"probe_level": probe_level_plain,
             "leaf_search": leaf_search_plain}
    for fn, args, out in trace:
        for g, e in zip(out, plain[fn](*args)):
            assert torch.equal(g, e)
    fn, (lk, _, rows, tq), (tpay, tfound) = trace[-1]
    assert fn == "leaf_search" and lk is pi.arrs["leaf_keys"]
    assert tq is q and torch.equal(tpay, pay) and torch.equal(tfound, found)
    assert bool(((rows >= 0) & (rows < lk.shape[0])).all())


def test_staged_lookup_empty_mirror():
    rpi, pi = _build(Aulid(BlockDevice()))
    assert pi.root_node < 0
    q = np.array([0, 5, 2**50, 2**63, 2**64 - 1], dtype=np.uint64)
    _, found = _same_lookup(rpi, pi, q)
    assert not found[:4].any()


def test_quickstart_staged_read():
    """``examples/quickstart.py`` §3: 512 genome keys of an index that took
    5,000 inserts, all hit through the staged read.  The reference runs in
    two batches of 256 (per-query results do not depend on the batch)."""
    keys = make_dataset("genome", 100_000)
    idx = Aulid(BlockDevice(), cfg=AulidConfig())
    idx.bulkload(keys, payloads_for(keys))
    rng = np.random.default_rng(0)
    for k in rng.integers(0, 2**48, 5_000):
        idx.insert(int(k), int(k) + 1)
    rpi, pi = _build(idx)
    q = keys[:512]
    pay, found = inner_probe_lookup(pi, keys_to_tensor(q, "cpu"))
    assert found.all() and (bits_from_tensor(pay) == q + 1).all()
    for half in (q[:256], q[256:]):
        _same_lookup(rpi, pi, half)
