"""K4 ``leaf_search``: the port's plain version == the JAX reference, bit for
bit, on the same numpy inputs.

The reference runs as ``tests/test_kernels.py`` runs it on the CPU: the
Pallas kernel in interpret mode and its jnp oracle (``use_ref=True``).  Both
must equal the port's plain PyTorch version on payload (the payload at the
rank, whether or not the key matched; 0 when the rank is the row width) and
found.  Keys cover the u64 extremes, queries present, absent and above
every key of their row.  (The CUDA kernel is held to its plain version in
``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.kernels.leaf_search.ops import leaf_search as ref_leaf_search

from repro_torch.core.keys import bits_from_tensor, keys_to_tensor
from repro_torch.kernels.leaf_search.ops import leaf_search

UM = 2**64 - 1
EXTREMES = [0, 2**63 - 1, 2**63, 2**64 - 2, UM]


def _pools(rng, L: int, C: int):
    """(L, C) sorted u64 rows: full rows of random keys, rows padded with
    u64 max, a row of the u64 extremes, and payloads of all 64 bits."""
    keys = np.sort(rng.integers(0, UM, (L, C), dtype=np.uint64), axis=1)
    for r in range(1, L, 3):                 # a padded tail on every third
        keys[r, rng.integers(1, C):] = np.uint64(UM)
    ext = np.sort(np.array(EXTREMES * (C // len(EXTREMES) + 1),
                           dtype=np.uint64)[:C])
    keys[0] = ext
    pay = rng.integers(0, UM, (L, C), dtype=np.uint64)
    return keys, pay


def _same(keys, pay, rows, q):
    pk = keys_to_tensor(keys.reshape(-1), "cpu").reshape(keys.shape)
    pp = torch.from_numpy(pay.view(np.int64).copy())
    got_pay, got_found = leaf_search(pk, pp, torch.from_numpy(rows),
                                     keys_to_tensor(q, "cpu"))
    for kw in (dict(interpret=True), dict(use_ref=True)):
        exp_pay, exp_found = ref_leaf_search(keys, pay, rows, q, **kw)
        assert (bits_from_tensor(got_pay) == np.asarray(exp_pay)).all(), kw
        assert (got_found.numpy() == np.asarray(exp_found)).all(), kw
    return bits_from_tensor(got_pay), got_found.numpy()


@pytest.mark.parametrize("C", [32, 256])
def test_leaf_search_matches_reference(C):
    rng = np.random.default_rng(C)
    L, Q = 24, 256
    keys, pay = _pools(rng, L, C)
    rows = rng.integers(0, L, Q).astype(np.int32)
    cols = rng.integers(0, C, Q)
    q = keys[rows, cols].copy()                          # present
    q[1::4] = rng.integers(0, UM, len(q[1::4]), dtype=np.uint64)  # absent
    q[2::8] = np.uint64(2**64 - 2)                       # above most rows
    full = np.nonzero(keys[:, -1] < np.uint64(UM))[0]
    top = rng.choice(full, 16).astype(np.int32)
    rows[-16:] = top                                     # rank == C
    q[-16:] = keys[top, -1] + np.uint64(1)
    rows[:len(EXTREMES)] = 0
    q[:len(EXTREMES)] = np.array(EXTREMES, dtype=np.uint64)
    got_pay, found = _same(keys, pay, rows, q)
    assert found[:4].all() and not found[-16:].any()
    assert (got_pay[-16:] == 0).all()                   # rank == C -> 0
    absent = ~found
    assert (got_pay[absent] != 0).any()                 # unmasked payload


def test_leaf_search_pa_rows_carry_leaf_ids():
    """The staged read's PA/BT use: payloads are int32 leaf rows widened to
    int64, where the reference passes a zero hi plane."""
    rng = np.random.default_rng(9)
    keys, _ = _pools(rng, 8, 16)
    ptrs = rng.integers(0, 2**31 - 1, keys.shape).astype(np.uint64)
    rows = rng.integers(0, 8, 64).astype(np.int32)
    q = rng.integers(0, UM, 64, dtype=np.uint64)
    got_pay, _ = _same(keys, ptrs, rows, q)
    assert (got_pay < np.uint64(2**31)).all()
