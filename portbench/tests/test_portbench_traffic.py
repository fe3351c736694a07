"""Each mix is the same for the same seed, other for another, and gives its
counts; a window's steps are fixed by the mix and the seconds; the shard
bounds are the program's."""
import numpy as np
import pytest

from portbench import index_traffic
from portbench.tests.small import cells, sharded_cell, small_cell


def _traffic(c, seed, steps=16):
    return index_traffic.for_cell(c.config, c.traffic, seed, steps, "cpu")


def test_keys_are_seeded_sorted_unique():
    ds = small_cell("covid-200M.w1-lookup").config["dataset"]
    a = index_traffic.draw_keys(ds, 2**31 + 5, "cpu", 5000, 500)
    b = index_traffic.draw_keys(ds, 2**31 + 5, "cpu", 5000, 500)
    o = index_traffic.draw_keys(ds, 2**31 + 6, "cpu", 5000, 500)
    assert all((x == y).all() for x, y in zip(a, b))
    assert not np.array_equal(a[0], o[0])
    keys, pool = a
    assert keys.dtype == np.uint64 and keys.shape[0] == 5000
    assert (np.diff(keys.astype(np.float64)) > 0).all()
    assert keys[0] >= ds["lo"] and keys[-1] < ds["hi"]
    assert pool.shape[0] == 500 and not np.isin(pool, keys).any()
    full, none = index_traffic.draw_keys(ds, 2**31 + 5, "cpu")
    assert full.shape[0] == ds["keys"] and none.shape[0] == 0
    # the sample and the rest partition the data set; a longer pool
    # begins with the shorter one
    assert np.isin(keys, full).all() and np.isin(pool, full).all()
    longer = index_traffic.draw_keys(ds, 2**31 + 5, "cpu", 5000, 900)[1]
    assert (longer[:500] == pool).all()


@pytest.mark.parametrize("seconds,steps", [(30, None), (0.01, 1)])
def test_window_steps_follow_the_mix(seconds, steps):
    mix = small_cell("covid-200M.w4-read-heavy").traffic
    n = index_traffic.window_steps(mix, seconds)
    assert n == (steps or round(mix["window_steps_per_s"] * seconds))


@pytest.mark.parametrize("name", cells() + ["sharded"])
def test_mix_is_deterministic_and_counted(name):
    c = sharded_cell() if name == "sharded" else small_cell(name)
    keys, t = _traffic(c, 2**32 + 11)
    _, t2 = _traffic(c, 2**32 + 11)
    _, t3 = _traffic(c, 2**32 + 12)
    mix = c.traffic
    for s in (0, 1, 12):
        a, b = t.step(s), t2.step(s)
        assert (a.keys == b.keys).all() and (a.pays == b.pays).all()
        assert (a.scan_check == b.scan_check).all()
        assert a.keys.shape[0] == mix["clients"] == len(t.ops)
    assert not np.array_equal(t.step(1).keys, t3.step(1).keys)
    # a run of fewer steps draws the same steps; none past the last
    short = _traffic(c, 2**32 + 11, steps=13)[1]
    assert (short.step(12).keys == t.step(12).keys).all()
    with pytest.raises(IndexError):
        short.step(13)
    st = t.step(5)
    w = mix.get("writes", {}).get("count", 0)
    g = mix.get("gets", {}).get("count", 0)
    s_ = mix.get("scans", {}).get("count", 0)
    assert t.ops.count("get") == g and t.ops.count("scan") == s_
    assert t.ops.count("insert") + t.ops.count("delete") == w
    assert st.scan_check.shape[0] == min(s_, 16)
    gets = st.keys[w:w + g]
    n_abs = int(g * mix.get("gets", {}).get("absent_share", 0))
    n_ins = int(g * mix.get("gets", {}).get("inserted_share", 0))
    present = np.isin(gets, keys).sum()
    assert present >= g - n_abs - n_ins
    if n_ins:
        assert np.isin(gets, t.pool[:t.inserted_by(5)]).sum() == n_ins
    ref = t.ref_step(5)
    assert (ref["gkeys"] == gets).all()
    assert (ref["wkeys"] == st.keys[:w]).all()
    assert ref["skeys"].shape[0] == ref["scounts"].shape[0] == min(s_, 16)


def test_w4_samples_its_initial_index_and_inserts_the_rest_in_order():
    c = small_cell("covid-200M.w4-read-heavy")
    keys, t = _traffic(c, 99, steps=5)
    assert keys.shape[0] == c.traffic["bulkload"]["sample"]
    w = c.traffic["writes"]["count"]
    assert t.pool.shape[0] == 5 * w
    got = np.concatenate([t.step(s).keys[:w] for s in range(5)])
    assert (got == t.pool).all() and not np.isin(got, keys).any()
    assert (t.step(0).pays[:w] == t.pool[:w] + np.uint64(1)).all()
    # the sample is spread over the whole data set, not its first keys
    ds = c.config["dataset"]
    assert keys[-1] - keys[0] > 0.9 * (ds["hi"] - ds["lo"])


def test_sharded_writes_and_bound_scans():
    keys, t = _traffic(sharded_cell(), 5)
    bounds = t.bounds
    st = t.step(3)
    hot = (int(bounds[3]) + 1, int(bounds[4]) + 1)
    ins = st.keys[:t.n_ins]
    assert ((ins >= hot[0]) & (ins < hot[1])).all()
    near = st.keys[t.nw + t.ng:][:t.n_near]
    # each near scan starts within 50 keys below a bound (so crosses it)
    pos = np.searchsorted(keys, near)
    ends = np.searchsorted(keys, bounds, side="right")
    assert all(((ends - p >= 1) & (ends - p <= 50)).any() for p in pos)


def test_bounds_are_the_programs():
    from repro_torch.core import partition_bulkload
    keys, _ = index_traffic.draw_keys(
        small_cell("covid-200M.w1-lookup").config["dataset"], 3, "cpu")
    part = partition_bulkload(keys, keys + np.uint64(1), 8)
    assert (index_traffic.quantile_bounds(keys, 8) == part.bounds).all()
