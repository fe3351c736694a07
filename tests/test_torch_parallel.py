"""The port's index-mesh rules and placement == the reference's
(``tests/test_mesh_placement.py``): ``spec_for``, ``stacked_spec``,
``mesh_num_devices`` and ``index_mesh`` on the shape-only ``FakeMesh``
cases, each port spec tuple equal to ``tuple(PartitionSpec)``; the
engine's slot ratchet rounded to a device multiple; placeholder slots
behind u64-max bounds on the last slice; and ``place_stacked`` /
``place_overlay_pack`` on a mesh that names one device several times."""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.parallel import INDEX_RULES as REF_RULES
from repro.parallel import spec_for as ref_spec_for
from repro.parallel.index_placement import mesh_num_devices as ref_num
from repro.parallel.index_placement import stacked_spec as ref_stacked_spec

from repro_torch.core import AulidConfig, partition_bulkload
from repro_torch.core.delta_overlay import UINT64_MAX
from repro_torch.core.lookup import stacked_device_arrays
from repro_torch.core.workloads import make_dataset, payloads_for
from repro_torch.parallel import (INDEX_RULES, REPLICATED_FIELDS, index_mesh,
                                  mesh_local_shards, mesh_num_devices,
                                  place_overlay_pack, place_stacked, spec_for,
                                  stacked_spec)
from repro_torch.serving import ShardedIndexEngine

SMALL_GEOM = dict(leaf_capacity=16, pa_classes=(4, 8), bt_child_capacity=15)


class FakeMesh:
    """Shape-only stand-in so rule tests can use production axis sizes."""
    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


MESH8 = FakeMesh({"shards": 8})
SPEC_CASES = [((16, 512), ("shards", None)),       # leading axis sharded
              ((3, 512), ("shards", None)),        # 3 % 8: replicated
              ((16, 16), ("shards", "shards")),    # no axis reuse
              ((8,), ("shards",)), ((4, 2), (None, "shards")),
              ((24, 3), ("shards", None)), ((1,), (None,))]
STACKED_CASES = [("leaf_keys", (16, 64, 16)), ("leaf_keys", (12, 64, 16)),
                 ("meta", (8, 2)), ("slot_key", (3, 100)),
                 ("last_leaf_min", (16,))] \
    + [(f, (16,)) for f in sorted(REPLICATED_FIELDS)]


def test_index_rules_are_the_references():
    assert INDEX_RULES == REF_RULES


@pytest.mark.parametrize("shape,axes", SPEC_CASES)
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_spec_for(shape, axes, n):
    mesh = FakeMesh({"shards": n})
    assert spec_for(shape, axes, mesh, INDEX_RULES) == \
        tuple(ref_spec_for(shape, axes, mesh, REF_RULES))


@pytest.mark.parametrize("name,shape", STACKED_CASES)
def test_stacked_spec(name, shape):
    assert stacked_spec(name, shape, MESH8) == \
        tuple(ref_stacked_spec(name, shape, MESH8))


def test_reference_cases():
    assert spec_for((16, 512), ("shards", None), MESH8,
                    INDEX_RULES) == ("shards", None)
    assert stacked_spec("leaf_keys", (12, 64, 16), MESH8) == \
        (None, None, None)
    assert spec_for((16, 16), ("shards", "shards"), MESH8,
                    INDEX_RULES) == ("shards", None)
    for f in sorted(REPLICATED_FIELDS):
        assert stacked_spec(f, (16,), MESH8) == ()
    assert mesh_num_devices(None) == ref_num(None) == 0
    assert mesh_num_devices(MESH8) == ref_num(MESH8) == 8


def test_index_mesh_validates_device_count():
    m = index_mesh(1, devices=["cpu"])
    assert mesh_num_devices(m) == 1
    assert m.axis_names == ("shards",) and m.shape == {"shards": 1}
    m = index_mesh(3, devices=["cpu"] * 4)
    assert m.shape == {"shards": 3}
    assert m.devices == (torch.device("cpu"),) * 3
    assert m.distinct_devices() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="n_devices"):
        index_mesh(10_000, devices=["cpu"])
    with pytest.raises(ValueError, match="n_devices"):
        index_mesh(0, devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            index_mesh()
    assert mesh_local_shards(8, m.__class__((torch.device("cpu"),) * 4)) == 2
    with pytest.raises(ValueError, match="divisible"):
        mesh_local_shards(6, m.__class__((torch.device("cpu"),) * 4))


def _engine(mesh=None, **kw):
    keys = make_dataset("covid", 800, seed=1)
    part = partition_bulkload(keys, payloads_for(keys), 3,
                              cfg=AulidConfig(**SMALL_GEOM))
    return ShardedIndexEngine(part, gamma=0.05, mesh=mesh,
                              device=None if mesh else "cpu", **kw)


def test_slot_ratchet_rounds_to_device_multiple(monkeypatch):
    eng = _engine(repartition=True)
    monkeypatch.setattr(eng, "_mesh_devices", lambda: 4)
    for n in (3, 4, 5, 9):
        slots = eng._shard_slots(n)
        assert slots % 4 == 0 and slots >= n
    assert eng._shard_slots(3) >= eng._shard_slots(9)


def test_slot_ratchet_pads_even_without_repartition(monkeypatch):
    eng = _engine()
    monkeypatch.setattr(eng, "_mesh_devices", lambda: 4)
    assert eng._shard_slots(3) % 4 == 0
    eng = _engine(index_mesh(4, devices=["cpu"] * 4))
    assert eng._snap()["meta"][0].shape[0] == 1      # 3 shards in 4 slots
    assert eng.stats()["mesh_devices"] == 4


def test_placeholders_behind_umax_bounds_on_last_slice():
    eng = _engine(repartition=True)
    snap = eng._snap()
    S = int(snap["meta"].shape[0])
    real = len(eng.shards)
    assert S > real, "ratchet should have padded placeholder slots"
    bounds = eng.sdi.bounds
    assert (bounds[real - 1:] == UINT64_MAX).all()
    assert (bounds[: real - 1] < UINT64_MAX).all()
    assert (snap["meta"][real:, 0] == -1).all()


def test_place_stacked_views_and_copies():
    """A mesh naming one device D times holds one stack: every pool slice
    is a view of the pool, a replicated field is the tensor itself; on
    the host-built stack, each distinct device gets one copy."""
    eng = _engine(repartition=True)
    stk = stacked_device_arrays(eng.sdi, 3, "cpu")
    S = stk["meta"].shape[0]
    mesh = index_mesh(4, devices=["cpu"] * 4)
    placed = place_stacked(stk, mesh)
    assert placed["bounds_version"] == 3
    for f, v in stk.items():
        if not isinstance(v, torch.Tensor):
            continue
        assert len(placed[f]) == 4
        if f in REPLICATED_FIELDS:
            assert all(t is v for t in placed[f])
        else:
            assert all(t.data_ptr() == v[d * (S // 4)].data_ptr()
                       for d, t in enumerate(placed[f]))
            assert torch.equal(torch.cat(placed[f]), v)
    # not divisible: replicated whole (the reference's fallback)
    odd = place_stacked({"meta": stk["meta"][:3]}, mesh)["meta"]
    assert all(t.shape[0] == 3 for t in odd)
    ovr = {"ov_pack": torch.zeros((3, 8), dtype=torch.int64), "ov_fill": 2}
    out = place_overlay_pack(ovr, mesh)
    assert out["ov_pack"] is ovr["ov_pack"] and out["ov_replicas"] == ()
    assert out["ov_fill"] == 2


def test_mesh_engine_device_must_be_the_mesh_first():
    mesh = index_mesh(2, devices=["cpu"] * 2)
    assert _engine(mesh).device == torch.device("cpu")
    keys = make_dataset("covid", 200, seed=1)
    part = partition_bulkload(keys, payloads_for(keys), 2)
    eng = ShardedIndexEngine(part, mesh=mesh, device="cpu")
    assert eng.device == torch.device("cpu")
    with pytest.raises((ValueError, RuntimeError)):
        ShardedIndexEngine(part, mesh=mesh, device="cuda:0")
    np.testing.assert_array_equal(eng.stk["route_bounds"], part.bounds)
