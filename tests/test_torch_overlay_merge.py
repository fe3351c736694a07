"""The port's overlay merge == the JAX reference's, bit for bit.

The same random sorted packs (numpy, from a seed) go through the
reference's ``merge_overlay_pack_jnp``, its Pallas kernel in interpret mode
(``overlay_merge_pack``) and the port's plain PyTorch version of K2 on the
CPU.  Cases: empty pack, all-padding batch, all-overlap, tombstones, cap
growth, random mixes.  The live-prefix invariant the CUDA kernel's
rank arithmetic rests on (padding sorts last, so live entries are a prefix)
is asserted on every input and output.  (The CUDA kernel is held to its
plain version in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core.lookup import merge_overlay_pack_jnp
from repro.kernels.overlay_merge import overlay_merge_pack

from repro_torch.core import lookup as port
from repro_torch.core.keys import BIASED_MAX, bits_from_tensor
from repro_torch.kernels.overlay_merge import ops as k2

UM = np.uint64(2**64 - 1)


def _pack(rng, n, cap, keys=None):
    """Sorted (3, cap) u64 overlay pack of n entries (random or given keys),
    a quarter of them tombstones, u64-max padded."""
    if keys is None:
        keys = rng.choice(2**50, size=n, replace=False).astype(np.uint64)
    keys = np.sort(np.asarray(keys, dtype=np.uint64))
    n = keys.shape[0]
    pack = np.zeros((3, cap), dtype=np.uint64)
    pack[0] = UM
    pack[0, :n] = keys
    pack[1, :n] = rng.integers(0, 2**63, n, dtype=np.uint64)
    pack[2, :n] = rng.random(n) < 0.25
    return pack


def _live_prefix(pack_u64) -> int:
    """Number of live entries; asserts they form a sorted unique prefix."""
    k = pack_u64[0]
    live = k != UM
    n = int(live.sum())
    assert live[:n].all() and not live[n:].any(), "live entries not a prefix"
    assert (np.diff(k[:n].astype(object)) > 0).all() if n > 1 else True
    assert (pack_u64[1, n:] == 0).all() and (pack_u64[2, n:] == 0).all()
    return n


def _cases():
    rng = np.random.default_rng(0)
    shared = rng.choice(2**50, size=40, replace=False).astype(np.uint64)
    yield "empty-pack", _pack(rng, 0, 32), _pack(rng, 12, 16), 32
    yield "empty-batch", _pack(rng, 20, 32), _pack(rng, 0, 16), 32
    yield "all-overlap", _pack(rng, 0, 32, shared[:16]), \
        _pack(rng, 0, 16, shared[:16]), 32
    yield "partial-overlap", _pack(rng, 0, 32, shared[:24]), \
        _pack(rng, 0, 16, shared[16:32]), 32
    yield "cap-growth", _pack(rng, 30, 32), _pack(rng, 16, 16), 64
    yield "full-both", _pack(rng, 32, 32), _pack(rng, 16, 16), 64
    for s in range(4):
        r = np.random.default_rng(100 + s)
        a = _pack(r, int(r.integers(0, 28)), 32)
        live = a[0][a[0] != UM]
        take = live[: int(r.integers(0, min(len(live), 8) + 1))]
        fresh = r.choice(2**50, size=int(r.integers(0, 9)), replace=False)
        b = _pack(r, 0, 16, np.unique(np.concatenate(
            [take, fresh.astype(np.uint64)])))
        yield f"random-{s}", a, b, 64


CASES = list(_cases())


@pytest.mark.parametrize("name,a,b,cap_out", CASES,
                         ids=[c[0] for c in CASES])
def test_merge_matches_reference(name, a, b, cap_out):
    _live_prefix(a)
    _live_prefix(b)
    exp = np.asarray(merge_overlay_pack_jnp(a, b, cap_out))
    assert (np.asarray(overlay_merge_pack(a, b, cap_out, interpret=True))
            == exp).all()
    pa = port.overlay_from_numpy(a, "cpu")["ov_pack"]
    pb = port.overlay_from_numpy(b, "cpu")["ov_pack"]
    got = k2.overlay_merge(pa, pb, cap_out)
    assert got.shape == (3, cap_out) and got.dtype == torch.int64
    assert (port.overlay_from_numpy(exp, "cpu")["ov_pack"] == got).all()
    n = _live_prefix(exp)
    assert (got[0, n:] == BIASED_MAX).all()
    # the dict-union oracle: the batch wins, tombstones stay entries
    union = {int(k): (int(p), int(t)) for k, p, t in a.T if k != UM}
    union.update({int(k): (int(p), int(t)) for k, p, t in b.T if k != UM})
    assert n == len(union)
    assert [int(k) for k in exp[0, :n]] == sorted(union)
    assert [int(p) for p in bits_from_tensor(got[1, :n])] == \
        [union[k][0] for k in sorted(union)]


def test_merge_overlay_pack_uploads_only_the_batch():
    rng = np.random.default_rng(4)
    a = _pack(rng, 20, 64)
    ovr = port.overlay_from_numpy(a, "cpu")
    bk = np.sort(rng.choice(2**50, 5, replace=False).astype(np.uint64))
    batch = (bk, bk + np.uint64(1), np.array([0, 1, 0, 0, 1], dtype=bool))
    new, nbytes = port.merge_overlay_pack(ovr, batch, 64)
    assert nbytes == 3 * 8 * 8                   # padded to the 8-slot floor
    assert new["ov_pack"] is not ovr["ov_pack"]
    bpack = np.zeros((3, 8), dtype=np.uint64)
    bpack[0] = UM
    bpack[:, :5] = np.stack([batch[0], batch[1], batch[2]])
    exp = np.asarray(merge_overlay_pack_jnp(a, bpack, 64))
    assert (port.overlay_from_numpy(exp, "cpu")["ov_pack"]
            == new["ov_pack"]).all()


def test_empty_overlay_pack():
    p = port.empty_overlay_pack(16, "cpu")
    assert (p[0] == BIASED_MAX).all() and (p[1:] == 0).all()
