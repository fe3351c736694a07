"""The port's overlay merge == the JAX reference's, bit for bit.

The same random sorted packs (numpy, from a seed) go through the
reference's ``merge_overlay_pack_jnp``, its Pallas kernel in interpret mode
(``overlay_merge_pack``) and the port's plain PyTorch version of K2 on the
CPU.  Cases: empty pack, all-padding batch, all-overlap, tombstones, cap
growth, random mixes; the stacked (S, 3, C) form row by row against the
reference's ``overlay_merge_pack_stacked``.  The live-prefix invariant the
CUDA kernel's rank arithmetic rests on (padding sorts last, so live entries
are a prefix) is asserted on every input and output.  (The CUDA kernel is held to its
plain version in ``test_torch_gpu.py``.)

The merge into a target (``merge_overlay_into_torch``, the kernel's write
set): chains of merges into two alternating buffers equal the fresh merge
and the reference at every link, with stale live prefixes, a target
filled past the merged count, fresh targets, cap growth, empty batches,
all-overlap and tombstones, flat and stacked (a fill a row); the engines'
two packs (``core.lookup.merge_overlay_pack``, reseeds into the spare) keep
padding past every pack's fill.
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.core.lookup import merge_overlay_pack_jnp
from repro.kernels.overlay_merge import overlay_merge_pack
from repro.kernels.overlay_merge.ops import overlay_merge_pack_stacked

from repro_torch.core import lookup as port
from repro_torch.core.delta_overlay import next_pow2
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


def _stacked_cases():
    """(S, 3, Ca) packs and (S, 3, Cb) batches, rows of every kind: empty
    pack, empty batch, all-overlap, tombstones, cap growth, random."""
    rng = np.random.default_rng(21)
    shared = rng.choice(2**50, size=64, replace=False).astype(np.uint64)
    rows = [(_pack(rng, 0, 32), _pack(rng, 12, 16)),
            (_pack(rng, 20, 32), _pack(rng, 0, 16)),
            (_pack(rng, 0, 32, shared[:16]), _pack(rng, 0, 16, shared[:16])),
            (_pack(rng, 28, 32), _pack(rng, 16, 16)),
            (_pack(rng, 0, 32, shared[16:40]),
             _pack(rng, 0, 16, shared[30:46])),
            (_pack(rng, 0, 32), _pack(rng, 0, 16)),
            (_pack(rng, 31, 32), _pack(rng, 9, 16)),
            (_pack(rng, 5, 32), _pack(rng, 16, 16))]
    yield "s8-mixed", np.stack([a for a, _ in rows]), \
        np.stack([b for _, b in rows]), 64
    yield "s1", rows[3][0][None], rows[3][1][None], 64
    yield "s3-empty", np.stack([_pack(rng, 0, 8)] * 3), \
        np.stack([_pack(rng, 0, 8)] * 3), 8


STACKED = list(_stacked_cases())


@pytest.mark.parametrize("name,a,b,cap_out", STACKED,
                         ids=[c[0] for c in STACKED])
def test_stacked_merge_matches_reference(name, a, b, cap_out):
    """K2's stacked form == the reference's ``overlay_merge_pack_stacked``
    (its vmapped oracle and its Pallas kernel in interpret mode), each row
    merged on its own."""
    exp = np.asarray(overlay_merge_pack_stacked(a, b, cap_out, use_ref=True))
    assert (np.asarray(overlay_merge_pack_stacked(a, b, cap_out,
                                                  interpret=True))
            == exp).all()
    pa = torch.stack([port.overlay_from_numpy(r, "cpu")["ov_pack"]
                      for r in a])
    pb = torch.stack([port.overlay_from_numpy(r, "cpu")["ov_pack"]
                      for r in b])
    got = k2.overlay_merge_stacked(pa, pb, cap_out)
    assert got.shape == (a.shape[0], 3, cap_out) and got.dtype == torch.int64
    for s in range(a.shape[0]):
        assert (port.overlay_from_numpy(exp[s], "cpu")["ov_pack"]
                == got[s]).all(), f"row {s}"
        _live_prefix(exp[s])
        assert torch.equal(got[s], k2.overlay_merge(pa[s], pb[s], cap_out))


# ------------------------------------------------------- merges into targets
SENTINEL = 12345


def _poisoned(rng, cap: int, fill: int) -> torch.Tensor:
    """A (3, cap) target holding garbage in [0, fill) and padding after."""
    t = port.empty_overlay_pack(cap, "cpu")
    f = min(fill, cap)
    t[:, :f] = torch.from_numpy(rng.integers(-9, 9, (3, f)))
    return t


def _link(pack, batch, cap_out, out, out_fill):
    """One merge into ``out``: it equals the fresh merge and the
    reference's, past ``max(n_out, out_fill)`` it is untouched; returns the
    new fill."""
    before = out.clone()
    fresh = k2.merge_overlay_pack_torch(pack, batch, cap_out)
    exp = np.asarray(merge_overlay_pack_jnp(_u64(pack), _u64(batch),
                                            cap_out))
    assert torch.equal(port.overlay_from_numpy(exp, "cpu")["ov_pack"], fresh)
    n = k2.overlay_merge(pack, batch, cap_out, out=out, out_fill=out_fill)
    assert n.dtype == torch.int32 and int(n) == _live_prefix(exp)
    hi = max(int(n), min(out_fill, cap_out))
    assert torch.equal(out[:, :hi], fresh[:, :hi])
    assert torch.equal(out[:, hi:], before[:, hi:])
    return int(n)


def _u64(t: torch.Tensor) -> np.ndarray:
    """A port pack back in the reference's u64 layout."""
    out = t.numpy().copy().view(np.uint64)
    out[0] ^= np.uint64(1 << 63)
    return out


def _chains():
    """(name, start pack, spare, spare fill, [(batch keys, cap_out)])."""
    rng = np.random.default_rng(31)
    pool = rng.choice(2**50, size=4000, replace=False).astype(np.uint64)
    a = _pack(rng, 0, 64, pool[:30])
    yield ("stale-prefix", a, _pack(rng, 0, 64, pool[:20]), 20,
           [(pool[30:38], 64), (pool[25:33], 64), (pool[38:50], 64),
            (pool[50:52], 64)])
    yield ("fill-past-n_out", _pack(rng, 0, 64, pool[:5]),
           _pack(rng, 0, 64, pool[100:160]), 60,
           [(pool[5:9], 64), (pool[9:12], 64), (pool[12:13], 64)])
    yield "fresh-target", a, None, 64, [(pool[60:70], 64), (pool[:8], 64)]
    yield ("cap-growth", _pack(rng, 0, 32, pool[:28]),
           _pack(rng, 0, 32, pool[:20]), 20,
           [(pool[28:31], 32), (pool[31:40], 64), (pool[40:44], 64),
            (pool[44:46], 64)])
    yield ("empty-batch", a, _pack(rng, 0, 64, pool[:25]), 25,
           [(pool[:0], 64), (pool[70:72], 64), (pool[:0], 64)])
    yield ("all-overlap", a, _pack(rng, 0, 64, pool[:29]), 29,
           [(pool[:30], 64), (pool[:30], 64), (pool[10:20], 64)])
    yield ("tombstones", _pack(rng, 0, 128, pool[200:300]),
           _pack(rng, 0, 128, pool[200:290]), 90,
           [(pool[250:320], 128), (pool[290:330], 128)])


CHAINS = list(_chains())


@pytest.mark.parametrize("name,start,spare,spare_fill,links", CHAINS,
                         ids=[c[0] for c in CHAINS])
def test_merge_into_chain_matches_reference(name, start, spare, spare_fill,
                                            links):
    """Merges into two alternating buffers, each link's target holding
    garbage below its fill (the stale live prefix the kernel overwrites)
    and padding after: every link equals ``merge_overlay_pack_torch`` and
    the reference, and writes nothing past ``max(n_out, target fill)``; a
    link that grows the capacity merges into a fresh target."""
    rng = np.random.default_rng(len(name))
    served = port.overlay_from_numpy(start, "cpu")["ov_pack"]
    fill = _live_prefix(start)
    cap0 = start.shape[1]
    tgt = _poisoned(rng, cap0, spare_fill) if spare is not None \
        else torch.from_numpy(rng.integers(-9, 9, (3, cap0)))
    for i, (keys, cap_out) in enumerate(links):
        bnp = _pack(rng, 0, 8 if len(keys) <= 8 else 128, keys)
        batch = port.overlay_from_numpy(bnp, "cpu")["ov_pack"]
        if tgt.shape[1] != cap_out:       # growth: a fresh target
            tgt, spare_fill = torch.full((3, cap_out), SENTINEL), cap_out
        n = _link(served, batch, cap_out, tgt, spare_fill)
        if name == "fill-past-n_out" and i == 0:
            assert n < spare_fill        # pads [n_out, f_T)
        served, tgt, spare_fill, fill = tgt, served, fill, n


def test_merge_into_rejects_a_low_fill():
    rng = np.random.default_rng(5)
    pa = port.overlay_from_numpy(_pack(rng, 20, 32), "cpu")["ov_pack"]
    pb = port.overlay_from_numpy(_pack(rng, 4, 8), "cpu")["ov_pack"]
    out = port.empty_overlay_pack(32, "cpu")
    with pytest.raises(ValueError, match="fill"):
        k2.overlay_merge(pa, pb, 32, out=out, fill=19)
    assert int(k2.overlay_merge(pa, pb, 32, out=out, fill=20)) == \
        _live_prefix(np.asarray(merge_overlay_pack_jnp(
            _u64(pa), _u64(pb), 32)))


@pytest.mark.parametrize("name,a,b,cap_out", STACKED,
                         ids=[c[0] for c in STACKED])
def test_stacked_merge_into_matches_reference(name, a, b, cap_out):
    """The stacked merge into a target with a fill a row (rows poisoned
    below it, a sentinel past it) == the reference row by row, and writes
    nothing past each row's ``max(n_out, fill)``."""
    rng = np.random.default_rng(a.shape[0])
    S = a.shape[0]
    exp = np.asarray(overlay_merge_pack_stacked(a, b, cap_out, use_ref=True))
    pa = torch.stack([port.overlay_from_numpy(r, "cpu")["ov_pack"]
                      for r in a])
    pb = torch.stack([port.overlay_from_numpy(r, "cpu")["ov_pack"]
                      for r in b])
    fills = [int(x) for x in rng.integers(0, cap_out + 1, S)]
    out = torch.full((S, 3, cap_out), SENTINEL)
    for s, f in enumerate(fills):
        out[s, :, :f] = torch.from_numpy(rng.integers(-9, 9, (3, f)))
    before = out.clone()
    n = k2.overlay_merge_stacked(pa, pb, cap_out, out=out, out_fill=fills,
                                 fill=[_live_prefix(r) for r in a])
    assert n.shape == (S,) and n.dtype == torch.int32
    for s in range(S):
        want = port.overlay_from_numpy(exp[s], "cpu")["ov_pack"]
        hi = max(int(n[s]), fills[s])
        assert int(n[s]) == _live_prefix(exp[s]), f"row {s}"
        assert torch.equal(out[s, :, :hi], want[:, :hi]), f"row {s}"
        assert torch.equal(out[s, :, hi:], before[s, :, hi:]), f"row {s}"


def check_buffers(ovr: dict) -> None:
    """The padding invariant of an overlay dict's two packs: every slot
    from a pack's fill bound on is padding, the spare is another buffer."""
    packs = [(ovr["ov_pack"], ovr["ov_fill"])]
    if "ov_spare" in ovr:
        packs.append(ovr["ov_spare"])
        assert ovr["ov_spare"][0].data_ptr() != ovr["ov_pack"].data_ptr()
    for t, f in packs:
        assert 0 <= f <= t.shape[1]
        assert (t[0, f:] == BIASED_MAX).all() and (t[1:, f:] == 0).all()


def check_served(ref_ovr: dict, port_ovr: dict) -> None:
    """The port's served pack == the reference engine's, bit for bit, and
    the port's two packs keep the padding invariant."""
    exp = port.overlay_from_numpy(np.asarray(ref_ovr["ov_pack"]),
                                  "cpu")["ov_pack"]
    assert torch.equal(port_ovr["ov_pack"], exp)
    check_buffers(port_ovr)


def test_merge_overlay_pack_ping_pong():
    """The engines' two packs: each merge writes into the spare (the pack
    served before the last one) and keeps the pack it read as the new
    spare; a growth drops the spare and merges into a fresh target; a
    reseed uploads into the spare when the capacity matches and drops it
    when not.  Every served pack equals the reference chain, and every
    pack keeps padding past its fill bound."""
    rng = np.random.default_rng(12)
    pool = rng.choice(2**50, size=3000, replace=False).astype(np.uint64)
    ovr = port.overlay_from_numpy(_pack(rng, 0, 64, pool[:10]), "cpu")
    assert ovr["ov_fill"] == 10 and "ov_spare" not in ovr
    ref = _u64(ovr["ov_pack"])
    seen = []
    for i, (lo, hi, cap) in enumerate([(10, 20, 64), (15, 30, 64),
                                       (30, 31, 64), (31, 80, 128),
                                       (80, 90, 128), (90, 95, 128)]):
        keys = np.sort(pool[lo:hi])
        batch = (keys, keys + np.uint64(3), (keys % np.uint64(5)) == 0)
        old = ovr
        ovr, _ = port.merge_overlay_pack(ovr, batch, cap)
        bpack = np.zeros((3, next_pow2(max(len(keys), 8))), np.uint64)
        bpack[0] = UM
        bpack[:, :len(keys)] = np.stack([batch[0], batch[1],
                                         batch[2].astype(np.uint64)])
        ref = np.asarray(merge_overlay_pack_jnp(ref, bpack, cap))
        check_served({"ov_pack": ref}, ovr)
        assert "ov_spare" not in old          # a spare is taken once
        if old["ov_pack"].shape[1] == cap:
            assert ovr["ov_spare"][0] is old["ov_pack"]
        else:
            assert "ov_spare" not in ovr
        assert ovr["ov_fill"] >= _live_prefix(ref)
        seen.append(ovr["ov_pack"])
    # two buffers alternate at each capacity; the growth (i = 3) and the
    # merge after it (no spare of 128 slots yet) take fresh targets
    assert seen[1] is not seen[0] and seen[2] is seen[0]
    assert seen[4] is not seen[3] and seen[5] is seen[3]
    # a reseed of the same capacity uploads into the spare
    spare = ovr["ov_spare"][0]
    served = ovr["ov_pack"]
    re = port.overlay_from_numpy(_pack(rng, 0, 128, pool[:7]), "cpu",
                                 prev=ovr)
    assert re["ov_pack"] is spare and re["ov_spare"][0] is served
    assert re["ov_fill"] == 7
    check_buffers(re)
    # one of another capacity drops the spare; the served pack cannot stay
    re2 = port.overlay_from_numpy(_pack(rng, 0, 256, pool[:3]), "cpu",
                                  prev=re)
    assert "ov_spare" not in re2 and "ov_spare" not in re
    check_buffers(re2)
