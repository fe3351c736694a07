"""K6 ``paged_attention``: the port's plain version == the JAX reference on
the same numpy inputs.

The reference runs as ``tests/test_kernels.py::TestPagedAttention`` runs it
on the CPU: the Pallas kernel in interpret mode and its jnp oracle
(``use_ref=True``).  Tolerances are the reference's own: 1e-5 in float32
(the online softmax and the full softmax sum in other orders), 3e-2 in
bfloat16 (one bf16 rounding of the output).  bf16 inputs reach the port as
the same bf16 values (exact through float32).  (The CUDA kernel is held to
its plain version in ``test_torch_gpu.py``.)
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax.numpy as jnp

from repro.kernels.paged_attention.ops import paged_attention as ref_pa

from repro_torch.kernels import paged_attention, paged_attention_plain
from repro_torch.kernels.paged_attention import ops

# (B, H, Hkv, Dh, page, P, NP): the geometries of test_kernels.py:144-148
GEOMS = [(4, 8, 2, 64, 16, 64, 8),     # GQA g=4
         (2, 16, 16, 128, 64, 32, 4),  # MHA
         (1, 4, 1, 32, 8, 16, 3)]      # MQA, tiny pages
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(geom, dt, rng, lens=None, table=None):
    B, H, hk, dh, page, P, NP = geom
    jdt, tdt, _ = DTYPES[dt]
    qa = jnp.asarray(rng.normal(size=(B, H, dh)), jdt)
    kp = jnp.asarray(rng.normal(size=(P, page, hk, dh)), jdt)
    vp = jnp.asarray(rng.normal(size=(P, page, hk, dh)), jdt)
    if table is None:
        table = rng.integers(0, P, (B, NP)).astype(np.int32)
    if lens is None:
        lens = rng.integers(1, NP * page, B).astype(np.int32)
    port = [torch.from_numpy(np.asarray(table, np.int32)),
            torch.from_numpy(np.asarray(lens, np.int32))]
    port += [torch.from_numpy(np.array(a, np.float32)).to(tdt)
             for a in (qa, kp, vp)]
    return (table, lens, qa, kp, vp), port


def _close(got: torch.Tensor, exp, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(exp, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("use_ref", [False, True], ids=["interpret", "ref"])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("geom", GEOMS, ids=["gqa", "mha", "mqa"])
def test_plain_matches_reference(geom, dt, use_ref):
    rng = np.random.default_rng(geom[0] * geom[1])
    ref_in, port_in = _inputs(geom, dt, rng)
    exp = ref_pa(*ref_in, interpret=True, use_ref=use_ref)
    got = paged_attention(*port_in)     # CPU tensors: the plain version
    assert got.dtype == DTYPES[dt][1] and got.shape == port_in[2].shape
    _close(got, exp, DTYPES[dt][2])


@pytest.mark.parametrize("dt", list(DTYPES))
def test_length_edges_match_reference(dt):
    """Length 0 (every logit -1e30: the plain mean of v over the table's
    tokens), exactly NP * page, above it ("all live"), and 1."""
    geom = (4, 8, 2, 64, 16, 64, 8)
    NP, page = geom[6], geom[4]
    rng = np.random.default_rng(11)
    lens = np.array([0, NP * page, NP * page + 5, 1], np.int32)
    ref_in, port_in = _inputs(geom, dt, rng, lens=lens)
    got = paged_attention_plain(*port_in)
    for interp in (False, True):
        _close(got, ref_pa(*ref_in, interpret=True, use_ref=not interp),
               DTYPES[dt][2])
    # row 0 is the mean of v over all NP * page tokens of its table
    table, _, _, _, vp = port_in
    B, H, hk, dh = 4, 8, 2, 64
    v0 = vp[table[0].long()].float().reshape(NP * page, hk, dh).mean(0)
    _close(got[0].reshape(hk, H // hk, dh),
           v0[:, None, :].expand(hk, H // hk, dh).numpy(), DTYPES[dt][2])


def test_shared_page_matches_reference():
    """Two rows whose tables share physical pages (a shared prefix)."""
    geom = (3, 8, 2, 32, 8, 16, 4)
    rng = np.random.default_rng(5)
    table = rng.integers(0, 16, (3, 4)).astype(np.int32)
    table[1, :2] = table[0, :2]
    table[2, 3] = table[0, 0]
    ref_in, port_in = _inputs(geom, "f32", rng, table=table)
    got = paged_attention_plain(*port_in)
    for use_ref in (False, True):
        _close(got, ref_pa(*ref_in, interpret=True, use_ref=use_ref), 1e-5)


def test_matches_dense_attention():
    """Paged (table-indirected) == dense contiguous attention (the check of
    test_kernels.py:165-196, on the port)."""
    rng = np.random.default_rng(9)
    B, H, hk, dh, page, NP = 2, 4, 2, 32, 8, 4
    S = NP * page
    kd = rng.normal(size=(B, S, hk, dh)).astype(np.float32)
    vd = rng.normal(size=(B, S, hk, dh)).astype(np.float32)
    qa = rng.normal(size=(B, H, dh)).astype(np.float32)
    lens = np.array([S, S // 2 + 3], np.int32)
    P = B * NP
    perm = rng.permutation(P)
    kp = np.zeros((P, page, hk, dh), np.float32)
    vp = np.zeros((P, page, hk, dh), np.float32)
    table = np.zeros((B, NP), np.int32)
    for b in range(B):
        for p in range(NP):
            phys = perm[b * NP + p]
            table[b, p] = phys
            kp[phys] = kd[b, p * page:(p + 1) * page]
            vp[phys] = vd[b, p * page:(p + 1) * page]
    out = paged_attention(*(torch.from_numpy(a)
                            for a in (table, lens, qa, kp, vp)))
    g = H // hk
    qf = qa.reshape(B, hk, g, dh)
    logits = np.einsum("bkgd,bskd->bkgs", qf, kd) / np.sqrt(dh)
    mask = np.arange(S)[None, :] < lens[:, None]
    logits = np.where(mask[:, None, None, :], logits, -1e30)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    exp = np.einsum("bkgs,bskd->bkgd", w, vd).reshape(B, H, dh)
    np.testing.assert_allclose(out.numpy(), exp, atol=1e-4)


def test_out_of_range_page_ids_are_clamped():
    """Ids outside [0, P) read the nearest valid page, never out of
    bounds (the reference leaves them undefined)."""
    geom = (2, 4, 1, 32, 8, 8, 3)
    rng = np.random.default_rng(2)
    table = np.array([[-5, 3, 99], [0, 3, 7]], np.int32)
    _, port_in = _inputs(geom, "f32", rng, table=table,
                         lens=np.array([24, 24], np.int32))
    got = paged_attention_plain(*port_in)
    port_in[0] = torch.tensor([[0, 3, 7], [0, 3, 7]], dtype=torch.int32)
    assert torch.equal(got, paged_attention_plain(*port_in))


# ---- the kernel's split plan and its split-and-combine arithmetic ---------
# (the CUDA kernel itself runs only on the card: test_torch_gpu.py)

@pytest.mark.parametrize("B,Hkv,NP,page", [
    (1, 1, 1, 16), (1, 8, 1, 4), (8, 8, 32, 16), (16, 8, 256, 16),
    (4, 2, 8, 16), (2, 16, 4, 64), (1, 1, 3, 8), (3, 2, 5, 16),
    (1, 1, 1000, 1), (64, 8, 256, 16), (2, 4, 7, 3), (256, 8, 64, 16)])
def test_split_plan_covers_every_page_once(B, Hkv, NP, page):
    pps, n = ops._split_plan(B, Hkv, NP, page)
    assert pps >= 1 and n >= 1 and n * pps >= NP
    assert (n - 1) * pps < NP               # no split starts past the table
    cover = np.zeros(NP, int)
    for s in range(n):
        cover[s * pps:min((s + 1) * pps, NP)] += 1
    assert (cover == 1).all()
    if NP == 1:
        assert n == 1


def test_split_plan_shapes_of_the_served_and_long_context_paths():
    """Two pages a block at the served shape (8 slots x 8 kv heads, 32
    pages of 16), at least 2 x 132 blocks at the long-context one (16 rows
    x 8 kv heads, 256 pages of 16, lengths 2048-4096: 128-256 live pages)."""
    assert ops._split_plan(8, 8, 32, 16) == (2, 16)
    pps, n = ops._split_plan(16, 8, 256, 16)
    assert 16 * 8 * (128 // pps) >= 2 * 132
    with pytest.raises(ValueError):
        ops._split_plan(1, 1, 0, 16)


def _split_model(table, lengths, q, k_pages, v_pages):
    """The kernel's arithmetic in plain PyTorch: each split of ``_split_plan``
    keeps (m, l, acc) over its pages of the row's walk with the -1e30 rule
    (a split past the walk is empty), and the splits combine by weights
    exp(m_i - M)."""
    B, H, Dh = q.shape
    P, page, n_kv, _ = k_pages.shape
    NP = table.shape[1]
    g = H // n_kv
    pps, n_splits = ops._split_plan(B, n_kv, NP, page)
    out = torch.empty(B, H, Dh)
    for b in range(B):
        n = int(lengths[b])
        walk = min(-(-n // page), NP) if n >= 1 else NP
        ids = table[b].long().clamp(0, P - 1)
        k = k_pages[ids].reshape(NP * page, n_kv, Dh).float()
        v = v_pages[ids].reshape(NP * page, n_kv, Dh).float()
        qf = q[b].float().reshape(n_kv, g, Dh)
        parts = []
        for s in range(n_splits):
            if s * pps >= walk:
                continue                      # empty: skipped by the combine
            t = torch.arange(s * pps * page, min((s + 1) * pps, walk) * page)
            logit = torch.einsum("kgd,skd->kgs", qf, k[t]) / torch.sqrt(
                torch.tensor(Dh, dtype=torch.float32))
            logit = torch.where(t < n, logit, -1e30)
            m = torch.maximum(logit.amax(-1), torch.tensor(-1e30))
            p = torch.exp(logit - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgs,skd->kgd", p, v[t])))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - M) for m, _, _ in parts]
        l_sum = sum(wi * li for wi, (_, li, _) in zip(w, parts))
        acc = sum(wi[..., None] * ai for wi, (_, _, ai) in zip(w, parts))
        out[b] = (acc / torch.clamp(l_sum, min=1e-30)[..., None]).reshape(H, Dh)
    return out.to(q.dtype)


@pytest.mark.parametrize("use_ref", [False, True], ids=["interpret", "ref"])
@pytest.mark.parametrize("geom", GEOMS, ids=["gqa", "mha", "mqa"])
def test_split_model_matches_reference(geom, use_ref):
    """The split-and-combine arithmetic == the plain version == the JAX
    reference (float32, 1e-5) on the reference's geometries, with rows of
    length 0, 1, all live and at a split's boundary and either side."""
    B, H, hk, dh, page, P, NP = geom
    pps, n_splits = ops._split_plan(B, hk, NP, page)
    edge = pps * page                         # the first split's last token
    lens = [0, 1, NP * page, edge - 1, edge, edge + 1,
            min(2 * edge, NP * page), NP * page - 1]
    rng = np.random.default_rng(7 + B)
    for lo in range(0, len(lens), B):
        row = np.array((lens[lo:lo + B] + [1] * B)[:B], np.int32)
        ref_in, port_in = _inputs(geom, "f32", rng, lens=row)
        got = _split_model(*port_in)
        _close(got, ref_pa(*ref_in, interpret=True, use_ref=use_ref), 1e-5)
        _close(got, paged_attention_plain(*port_in).numpy(), 1e-5)


def test_split_model_length_zero_row_spans_several_splits():
    """A length-0 row whose table spans several splits: every split has m =
    -1e30, every weight is 1, the result is the mean of v over all NP *
    page tokens of the table; a row sharing its pages with it is exact."""
    B, H, hk, dh, page, P, NP = 2, 8, 2, 32, 4, 16, 12
    assert ops._split_plan(B, hk, NP, page)[1] > 1
    rng = np.random.default_rng(13)
    table = rng.integers(0, P, (B, NP)).astype(np.int32)
    table[1, :5] = table[0, 3:8]
    ref_in, port_in = _inputs((B, H, hk, dh, page, P, NP), "f32", rng,
                              lens=np.array([0, 29], np.int32), table=table)
    got = _split_model(*port_in)
    _close(got, paged_attention_plain(*port_in).numpy(), 1e-5)
    _close(got, ref_pa(*ref_in, interpret=True, use_ref=True), 1e-5)
    v0 = port_in[4][port_in[0][0].long()].reshape(NP * page, hk, dh).mean(0)
    _close(got[0].reshape(hk, H // hk, dh),
           v0[:, None, :].expand(hk, H // hk, dh).numpy(), 1e-5)
