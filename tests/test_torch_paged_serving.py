"""The port's LM serving path == the JAX reference on the CPU: the learned
page table, ``paged_decode_step`` step for step, and ``ServeEngine`` trace
for trace — including the reference's empty-slot defect (ROADMAP Queue 3),
which the port reproduces rather than fixes.

Weights come from the reference's ``init_params`` and reach the port
through ``params_from_numpy``.  The reference runs as
``tests/test_serving.py`` runs it (its K6 in interpret mode).  Tolerances:
logits 1e-4 (abs and rel) at every step, the page pools 1e-5 after every
step — float32 on both sides, summed in other orders by the two frameworks.
Tokens must be equal; where a greedy token could part, the test requires
the reference's top-2 logit margin at that step to be below 1e-4.

Importing ``repro.core.lookup`` (which the reference's ``translate_batch``
does) turns on JAX's x64 mode for the whole process; every check here holds
with it on or off.
"""
import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")   # the reference; absent where only the port runs

import jax

from repro.configs import get_config as ref_config
from repro.models import model as ref_model
from repro.serving import engine as ref_engine
from repro.serving import LearnedPageTable as RefTable
from repro.serving import PagePool as RefPool
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefEngine
from repro.serving.paged_model import init_page_pool as ref_pool
from repro.serving.paged_model import paged_decode_step as ref_step

from repro_torch.configs import get_config
from repro_torch.kernels import paged_attention_plain
from repro_torch.models.model import params_from_numpy
from repro_torch.serving import LearnedPageTable, PagePool, Request, ServeEngine
from repro_torch.serving.paged_model import init_page_pool, paged_decode_step

LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
POOL_TOL = dict(atol=1e-5, rtol=1e-5)
MARGIN = 1e-4


def _cfgs(**kw):
    """The tiny config of test_serving.py:17-21 (both packages)."""
    base = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                d_ff=128, vocab_size=128, remat=False,
                compute_dtype="float32", param_dtype="float32")
    base.update(kw)
    return (dataclasses.replace(ref_config("qwen3-4b").reduced(), **base),
            dataclasses.replace(get_config("qwen3-4b").reduced(), **base))


def _models(rcfg, pcfg, seed=0):
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
    return params, params_from_numpy(pcfg, jax.device_get(params), "cpu")


def _io(table) -> tuple:
    return dataclasses.astuple(table.index.io)


# ------------------------------------------------------------- page table
def _same_tables(ref, port) -> None:
    assert _io(ref) == _io(port)
    assert ref.pool.free == port.pool.free and ref.pool.used == port.pool.used
    assert ref._pages_of == port._pages_of


def test_page_table_matches_reference():
    """The alloc / translate / free sequence of test_serving.py:24-52."""
    ref, port = RefTable(RefPool(32)), LearnedPageTable(PagePool(32), "cpu")
    for seq in (1, 2, 3):
        for lp in range(4):
            assert ref.alloc_page(seq, lp) == port.alloc_page(seq, lp)
    for seq in (1, 2, 3, 4):
        for lp in range(5):
            assert ref.translate(seq, lp) == port.translate(seq, lp)
    assert ref.free_seq(2) == port.free_seq(2) == 4
    for seq, lp in ((2, 0), (1, 3), (3, 1)):
        assert ref.translate(seq, lp) == port.translate(seq, lp)
    assert port.pool.n_free == 32 - 8
    _same_tables(ref, port)

    ref, port = RefTable(RefPool(128)), LearnedPageTable(PagePool(128), "cpu")
    rng = np.random.default_rng(0)
    seqs, lps = [], []
    for step in range(3):
        for seq in range(1 + 8 * step, 9 + 8 * step):
            for lp in range(rng.integers(1, 6)):
                assert ref.alloc_page(seq, lp) == port.alloc_page(seq, lp)
            seqs += [seq] * 6
            lps += list(range(6))
        ref.free_seq(1 + 8 * step)
        port.free_seq(1 + 8 * step)
        s, lp = np.array(seqs + [0]), np.array(lps + [0])
        exp = ref.translate_batch(s, lp)
        got = port.translate_batch(s, lp)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), exp)
        assert (exp == -1).any() and (exp >= 0).any()   # absent and present
        host = [port.translate(int(a), int(b)) for a, b in zip(s, lp)]
        assert host == [ref.translate(int(a), int(b)) for a, b in zip(s, lp)]
        assert [-1 if h is None else h for h in host] == got.tolist()
        _same_tables(ref, port)


# -------------------------------------------------------- paged_decode_step
def _shuffled_tables(B, NP, seed=3):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(B * NP) + 1  # leave page 0 unused
    return (perm.reshape(B, NP) - 1).astype(np.int32)


def _decode_both(rcfg, pcfg, steps, B, page, NP, seed):
    params, model = _models(rcfg, pcfg)
    toks = np.random.default_rng(seed).integers(
        0, rcfg.vocab_size, (B, steps)).astype(np.int32)
    n_pages = B * NP + 3
    rpool = ref_pool(rcfg, n_pages=n_pages, page_size=page)
    ppool = init_page_pool(pcfg, n_pages, page, "cpu")
    tables = _shuffled_tables(B, NP)
    for t in range(steps):
        pos = np.full((B,), t, np.int64)
        lg, nxt = ref_step(rcfg, params, toks[:, t:t + 1], pos, rpool, tables,
                           page)
        trace = []
        plg, pnxt = paged_decode_step(pcfg, model, toks[:, t:t + 1], pos,
                                      ppool, torch.from_numpy(tables), page,
                                      trace=trace)
        assert len(trace) == pcfg.n_layers      # one K6 call a layer
        for args, att in trace[:1]:
            assert torch.equal(att, paged_attention_plain(*args))
        np.testing.assert_allclose(plg.numpy(), lg, **LOGIT_TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(ppool[k].numpy(), rpool[k], **POOL_TOL)
        top2 = np.sort(lg, -1)[:, -2:]
        same = pnxt.numpy() == nxt
        assert (same | (top2[:, 1] - top2[:, 0] < MARGIN)).all(), t


def test_paged_decode_step_matches_reference():
    """32 teacher-forced steps (both sides get the same tokens) over the
    same shuffled tables, on the tiny config."""
    _decode_both(*_cfgs(), steps=32, B=2, page=8, NP=4, seed=1)


def test_paged_decode_step_reduced_qwen3_4b():
    """A few steps on ``get_config("qwen3-4b").reduced()`` (4 layers,
    d_model 256, 4 heads of 64, vocab 512) in float32."""
    kw = dict(compute_dtype="float32")
    rcfg = dataclasses.replace(ref_config("qwen3-4b").reduced(), **kw)
    pcfg = dataclasses.replace(get_config("qwen3-4b").reduced(), **kw)
    _decode_both(rcfg, pcfg, steps=3, B=2, page=4, NP=2, seed=2)


def test_paged_decode_step_other_layer_options():
    """The branches qwen3 leaves off: post-sublayer norms, the embedding
    scale, a final-logit softcap and tied embeddings."""
    _decode_both(*_cfgs(post_norm=True, embed_scale=True,
                        logit_softcap=30.0, tie_embeddings=True),
                 steps=4, B=2, page=4, NP=2, seed=4)


def test_write_conflicts_keep_the_last_row():
    """Two batch rows writing one (page, slot): the higher row wins, as
    numpy's assignment in the reference."""
    rcfg, pcfg = _cfgs()
    params, model = _models(rcfg, pcfg)
    tables = np.array([[2, 1], [2, 0]], np.int32)
    pos = np.array([1, 1], np.int64)              # both rows: (2, slot 1)
    toks = np.array([[5], [9]], np.int32)
    rpool = ref_pool(rcfg, n_pages=7, page_size=4)
    ppool = init_page_pool(pcfg, 7, 4, "cpu")
    lg, _ = ref_step(rcfg, params, toks, pos, rpool, tables, 4)
    plg, _ = paged_decode_step(pcfg, model, toks, pos, ppool,
                               torch.from_numpy(tables), 4)
    np.testing.assert_allclose(plg.numpy(), lg, **LOGIT_TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(ppool[k].numpy(), rpool[k], **POOL_TOL)


# -------------------------------------------------------------- ServeEngine
def _engines(rcfg, pcfg, **kw):
    params, model = _models(rcfg, pcfg)
    return (RefEngine(rcfg, params, **kw),
            ServeEngine(pcfg, model, device="cpu", **kw))


def _submit(engines, reqs) -> None:
    ref, port = engines
    for rid, prompt, max_new in reqs:
        ref.submit(RefRequest(rid=rid, prompt=list(prompt), max_new=max_new))
        port.submit(Request(rid=rid, prompt=list(prompt), max_new=max_new))


def _state(eng):
    return ([r.rid for r in eng.completed],
            [(r.rid, r.out, r.done) for r in eng.completed],
            [(r.rid, list(r.out)) if r else None for r in eng.slots],
            eng.slot_seq.tolist(), eng.slot_pos.tolist(), eng.steps,
            list(eng.pool_pages.free), _io(eng.table))


def _lockstep(engines, monkeypatch, max_steps=200):
    """Step both engines together; after each step the logits agree (1e-4),
    the pools agree (1e-5), and the whole engine state is equal: completion
    order, every request's tokens, slots, positions, the free list and the
    index's io counters."""
    ref, port = engines
    seen = []

    def spy(*a, **kw):
        out = ref_step(*a, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(ref_engine, "paged_decode_step", spy)
    while (ref.queue or any(r is not None for r in ref.slots)) \
            and ref.steps < max_steps:
        before = len(seen)
        ref.step()
        plg = port.step()
        if len(seen) == before:
            assert plg is None
            continue
        lg, nxt = seen[-1]
        np.testing.assert_allclose(plg.numpy(), lg, **LOGIT_TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(port.kv[k].numpy(), ref.kv[k],
                                       **POOL_TOL)
        pnxt = plg.argmax(-1).numpy()
        if not (pnxt == nxt).all():
            # a near tie may part the greedy streams: only where the
            # reference's own top-2 margin is below MARGIN
            top2 = np.sort(lg, -1)[:, -2:]
            assert (top2[pnxt != nxt, 1] - top2[pnxt != nxt, 0]
                    < MARGIN).all()
            return
        assert _state(ref) == _state(port)


def test_engine_churn_matches_reference(monkeypatch):
    """The churn trace of test_serving.py:99-113."""
    engines = _engines(*_cfgs(), slots=2, page_size=8, n_pages=64,
                       max_pages_per_seq=8)
    rng = np.random.default_rng(1)
    _submit(engines, [(i, rng.integers(1, 100, 4).tolist(), 3)
                      for i in range(7)])
    _lockstep(engines, monkeypatch)
    ref, port = engines
    assert len(port.completed) == 7
    assert all(len(r.out) == 3 for r in port.completed)
    assert port.pool_pages.n_free == 64
    assert _state(ref) == _state(port)


def test_engine_exhaustion_matches_reference(monkeypatch):
    """The exhaustion trace of test_serving.py:115-123: both raise at the
    same step, in the same state."""
    engines = _engines(*_cfgs(), slots=4, page_size=2, n_pages=3,
                       max_pages_per_seq=4)
    _submit(engines, [(i, [1, 2, 3, 4], 4) for i in range(4)])
    for eng in engines:
        with pytest.raises(RuntimeError, match="exhausted"):
            eng.run(max_steps=50)
    assert _state(engines[0]) == _state(engines[1])


# the token streams of the reference's defect (ROADMAP Queue 3)
EMPTY_SLOT = {"one-slot": (1, False, [20, 80, 112, 39]),
              "empty-slot": (2, False, [39, 0, 39, 88]),
              "companion": (2, True, [20, 39, 88, 123])}


@pytest.mark.parametrize("case", list(EMPTY_SLOT))
def test_engine_empty_slot_trace_matches_reference(monkeypatch, case):
    """The reference defect (ROADMAP Queue 3): an empty slot keeps decoding
    into physical page 0, which the live sequence owns, so one request's
    tokens depend on the other slot; the port gives the same tokens.  One
    layer, pages of 4, 16 pages, 4 a sequence."""
    slots, companion, stream = EMPTY_SLOT[case]
    engines = _engines(*_cfgs(n_layers=1), slots=slots, page_size=4,
                       n_pages=16, max_pages_per_seq=4)
    _submit(engines, [(0, [1, 2, 3], 10)]
            + ([(1, [5], 1)] if companion else []))
    _lockstep(engines, monkeypatch)
    ref, port = engines
    out = {r.rid: r.out for r in port.completed}
    assert out == {r.rid: r.out for r in ref.completed}
    assert len(out[0]) == 10 and out[0][:4] == stream
    assert port.pool_pages.n_free == 16


def test_engine_empty_slot_overrun_raises_on_both(monkeypatch):
    """An empty slot's position keeps growing; once its page index passes
    ``max_pages_per_seq`` both sides raise IndexError, at the same step.
    Slot 0's request ends at position 2; slot 1's second request (admitted
    a step later) is still live when slot 0 reaches position 4."""
    engines = _engines(*_cfgs(n_layers=1), slots=2, page_size=2, n_pages=8,
                       max_pages_per_seq=2)
    _submit(engines, [(0, [1, 2, 3], 1), (1, [4], 1), (2, [5, 6, 7], 2)])
    for eng in engines:
        with pytest.raises(IndexError):
            eng.run(max_steps=20)
    ref, port = engines
    assert ref.steps == port.steps == 4
    assert _state(ref) == _state(port)
