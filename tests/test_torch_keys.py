"""The port's u64 key codec: round trips, order, and the f64 key value."""
import numpy as np
import torch

from repro_torch.core.keys import (BIASED_MAX, bias_np, bits_from_tensor,
                                   key_f64, keys_from_tensor, keys_to_tensor,
                                   unbias_np)


def _keys():
    rng = np.random.default_rng(0)
    edges = np.array([0, 1, 2**32 - 1, 2**32, 2**53 - 1, 2**53, 2**53 + 1,
                      2**62, 2**63 - 1, 2**63, 2**63 + 1, 2**64 - 2049,
                      2**64 - 2, 2**64 - 1], dtype=np.uint64)
    return np.concatenate([edges,
                           rng.integers(0, 2**64 - 1, 4000, dtype=np.uint64),
                           rng.integers(2**63, 2**64 - 1, 1000,
                                        dtype=np.uint64)])


def test_round_trip():
    k = _keys()
    assert (unbias_np(bias_np(k)) == k).all()
    assert (keys_from_tensor(keys_to_tensor(k, "cpu")) == k).all()
    assert (bits_from_tensor(torch.from_numpy(k.view(np.int64))) == k).all()
    assert keys_to_tensor(k, "cpu").dtype == torch.int64


def test_order_is_kept():
    """Signed order on biased keys is unsigned order on the keys, also for
    keys >= 2^63 and for the UINT64_MAX padding."""
    k = _keys()
    t = keys_to_tensor(k, "cpu")
    assert (np.argsort(k, kind="stable")
            == torch.argsort(t, stable=True).numpy()).all()
    i, j = np.random.default_rng(1).integers(0, k.size, (2, 20000))
    assert ((t[i] < t[j]).numpy() == (k[i] < k[j])).all()
    assert int(keys_to_tensor(np.array([2**64 - 1], np.uint64), "cpu")) \
        == BIASED_MAX
    assert BIASED_MAX == torch.iinfo(torch.int64).max


def test_f64_value_equals_numpy_cast():
    k = _keys()
    got = key_f64(keys_to_tensor(k, "cpu")).numpy()
    assert got.dtype == np.float64
    assert (got == k.astype(np.float64)).all()
