"""The reference equals a brute-force dict and sorted list on a small
stream of inserts, updates, deletes and scans across shard bounds; its
float32 control does not."""
import numpy as np
import pytest

from portbench import check
from portbench.reference import index_view as iv


def _stream(seed=3, n=3000, steps=12):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(10**12, 10**12 + n * 1000, n * 2,
                                  dtype=np.uint64))[:n]
    bounds = keys[[n // 4, n // 2, 3 * n // 4]]
    out = []
    for _ in range(steps):
        wk = np.concatenate([
            rng.integers(keys[0], keys[-1], 20, dtype=np.uint64),  # fresh
            rng.choice(keys, 10), rng.choice(keys, 8)])            # upd, del
        wk[-3:] = wk[:3]                  # same key twice in one step
        wo = np.array([iv.INSERT] * 30 + [iv.DELETE] * 8, np.int8)
        wp = rng.integers(0, 2**40, wk.shape[0], dtype=np.uint64)
        near = keys[np.searchsorted(keys, rng.choice(bounds, 4),
                                    side="right") - rng.integers(1, 30, 4)]
        out.append({"wkeys": wk, "wops": wo, "wpays": wp,
                    "gkeys": np.concatenate([rng.choice(keys, 60), wk[:10],
                                             rng.integers(keys[0], keys[-1],
                                                          10, np.uint64)]),
                    "skeys": np.concatenate([near, rng.choice(keys, 4)]),
                    "scounts": np.array([100, 7, 100, 60, 100, 1, 30, 100])})
    return keys, out


def _brute(keys, steps):
    view = {int(k): int(k) + 1 for k in keys}
    acks, gets, scans = [], [], []
    for st in steps:
        for k, o, p in zip(st["wkeys"].tolist(), st["wops"].tolist(),
                           st["wpays"].tolist()):
            if o == iv.INSERT:
                view[k] = p
                acks.append(True)
            else:
                acks.append(view.pop(k, None) is not None)
        gets += [view.get(k) for k in st["gkeys"].tolist()]
        order = sorted(view)
        for k, c in zip(st["skeys"].tolist(), st["scounts"].tolist()):
            i = np.searchsorted(np.array(order, dtype=np.uint64),
                                np.uint64(k))
            scans.append([(x, view[x]) for x in order[i:i + c]])
    return {"acks": acks, "gets": gets, "scans": scans, "unanswered": 0}, \
        len(view)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_equals_brute_force(seed):
    keys, steps = _stream(seed)
    got, live = _brute(keys, steps)
    counts, ref_live = check.compare(keys, steps, got)
    assert counts == {k: 0 for k in check.LIMITS}
    assert ref_live == live
    assert any(not a for a in got["acks"])           # deletes of absent keys


def test_comparison_catches_each_kind_of_fault():
    keys, steps = _stream(4)
    good, _ = _brute(keys, steps)
    for kind, hurt in (("writes_wrong", lambda g: g["acks"].__setitem__(
                            -1, not g["acks"][-1])),
                       ("gets_wrong", lambda g: g["gets"].__setitem__(
                            5, (g["gets"][5] or 0) + 1)),
                       ("scans_wrong", lambda g: g["scans"][3].pop()),
                       ("unanswered", lambda g: g.__setitem__(
                           "unanswered", 1))):
        bad = {k: (list(v) if isinstance(v, list) else v)
               for k, v in good.items()}
        bad["scans"] = [list(r) for r in good["scans"]]
        hurt(bad)
        counts, _ = check.compare(keys, steps, bad)
        assert counts[kind] > 0 and not check.correct(counts)


def test_control_is_not_correct():
    keys, steps = _stream(5)
    counts, _ = check.compare(keys, steps, check.control_answers(keys, steps))
    assert not check.correct(counts)
    assert counts["gets_wrong"] > 0 and counts["scans_wrong"] > 0
