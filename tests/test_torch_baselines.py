"""The port's copies of the paper's five baselines (``repro_torch.core.
baselines``) and of ``pla.build_segments`` == the reference's.

The cases of ``tests/test_baselines.py`` (bulkload and lookup, insert and
lookup, scan, I/O accounting) run each baseline of both packages over the
same keys from the ``datasets`` fixture, operation by operation: every
payload, every scan's (key, payload) pairs and the ``BlockDevice``
counters (reads, i.e. the fetched blocks, the paper's metric; writes,
allocations, frees) and storage bytes after every operation must be
equal, and each case's own checks (the dict oracle) hold.  Every
comparison is exact.
"""
import numpy as np
import pytest

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core import pla as ref_pla
from repro.core.baselines import ALL_BASELINES as REF_BASELINES
from repro.core.workloads import payloads_for

from repro_torch.core import pla
from repro_torch.core.baselines import ALL_BASELINES


class Both:
    """One baseline of each package, driven op by op in lockstep."""

    def __init__(self, name: str):
        self.ref, self.port = REF_BASELINES[name](), ALL_BASELINES[name]()

    def _counts(self, idx) -> tuple:
        s = idx.io
        return s.reads, s.writes, s.allocs, s.frees, idx.storage_bytes

    def __call__(self, op: str, *args):
        exp = getattr(self.ref, op)(*args)
        got = getattr(self.port, op)(*args)
        assert got == exp, (op, args, got, exp)
        assert self._counts(self.port) == self._counts(self.ref), (op, args)
        return got


def test_all_baselines_named_as_the_references():
    assert list(ALL_BASELINES) == list(REF_BASELINES) == [
        "btree", "pgm", "fiting", "alex", "lipp"]
    for name, cls in ALL_BASELINES.items():
        assert cls.__module__.startswith("repro_torch.core.baselines.")
        assert cls.__name__ == REF_BASELINES[name].__name__


@pytest.fixture(params=sorted(ALL_BASELINES))
def both(request):
    return Both(request.param)


def test_bulkload_lookup(both, datasets):
    keys = datasets["genome"][:8_000]
    both("bulkload", keys, payloads_for(keys))
    for k in keys[::53]:
        assert both("lookup", int(k)) == int(k) + 1
    present = set(keys.tolist())
    rng = np.random.default_rng(0)
    for k in rng.integers(0, 2**38, 100):
        if int(k) not in present:
            assert both("lookup", int(k)) is None


def test_insert_lookup(both, datasets):
    keys = datasets["covid"][:4_000]
    both("bulkload", keys, payloads_for(keys))
    rng = np.random.default_rng(1)
    new = np.unique(rng.integers(1_500_000_000_000, 1_700_000_000_000, 1_500))
    new = np.setdiff1d(new, keys)  # baselines differ on duplicate updates
    for k in new:
        both("insert", int(k), int(k) + 7)
    for k in new[::29]:
        assert both("lookup", int(k)) == int(k) + 7
    for k in keys[::371]:
        assert both("lookup", int(k)) == int(k) + 1


def test_scan(both, datasets):
    keys = datasets["planet"][:6_000]
    both("bulkload", keys, payloads_for(keys))
    start = 411
    got = both("scan", int(keys[start]), 50)
    assert got == [(int(k), int(k) + 1) for k in keys[start: start + 50]]
    for s in (0, 2_999, 5_990):   # from the first key, mid-array, past the end
        both("scan", int(keys[s]), 50)
    both("scan", 0, 10)


def test_io_accounting_nonzero(both, datasets):
    keys = datasets["covid"][:4_000]
    both("bulkload", keys, payloads_for(keys))
    both("reset_io")
    both("lookup", int(keys[123]))
    assert both.port.io.reads >= 1
    assert both.port.storage_bytes > 0


@pytest.mark.parametrize("eps", [2, 8, 32])
@pytest.mark.parametrize("name", ["covid", "osm"])
def test_build_segments_equal_the_references(datasets, name, eps):
    keys = datasets[name][:6_000]
    got = pla.build_segments(keys, eps)
    exp = ref_pla.build_segments(keys, eps)
    assert len(got) > 1
    assert [vars(s) for s in got] == [vars(s) for s in exp]
    dup = np.repeat(keys[:300], 2)            # the duplicate-key branch
    assert [vars(s) for s in pla.build_segments(dup, eps)] == \
        [vars(s) for s in ref_pla.build_segments(dup, eps)]
    assert pla.build_segments(keys[:0], eps) == []
