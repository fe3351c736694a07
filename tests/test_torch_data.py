"""The port's data pipeline (``repro_torch.data``: the packed block store
with its AULID sample index over the port's ``core.aulid``, and the sharded
loader) — the six cases of tests/test_data_pipeline.py on the port, and
its documents, index reads and batches equal to the JAX reference's bit
for bit, across a snapshot/restore and an elastic re-shard."""
import numpy as np
import pytest

from repro_torch.data import PackedDocStore, ShardedLoader, synth_corpus


@pytest.fixture(scope="module")
def store():
    s = PackedDocStore(block_tokens=128)
    s.build(synth_corpus(200, 1024, seed=7, mean_len=96))
    return s


def test_get_roundtrip(store):
    docs = synth_corpus(200, 1024, seed=7, mean_len=96)
    for i in (0, 7, 99, 199):
        assert (store.get(i) == docs[i]).all()


def test_streaming_append():
    s = PackedDocStore(block_tokens=128)
    s.build(synth_corpus(200, 1024, seed=7, mean_len=96))
    doc = np.arange(77, dtype=np.int32)
    did = s.append(doc)
    assert (s.get(did) == doc).all()


def test_index_io_is_constant_per_sample(store):
    """Random access costs O(1) learned-index lookups, not scans."""
    store.index.reset_io()
    for i in np.random.default_rng(0).integers(0, 200, 50):
        store.index.lookup(int(i))
    assert store.index.io.reads / 50 <= 4.0


def test_loader_determinism_and_resume(store):
    a = ShardedLoader(store, batch=2, seq_len=64, seed=3)
    b = ShardedLoader(store, batch=2, seq_len=64, seed=3)
    for _ in range(3):
        ba, bb = a.next_batch(), b.next_batch()
        assert (ba["tokens"] == bb["tokens"]).all()
    snap = a.snapshot()
    x1 = a.next_batch()
    a.restore(snap)
    x2 = a.next_batch()
    assert (x1["tokens"] == x2["tokens"]).all()


def test_labels_are_shifted_tokens(store):
    b = ShardedLoader(store, batch=2, seq_len=64).next_batch()
    m = b["labels"] >= 0
    assert (b["labels"][:, :-1][m[:, :-1]]
            == b["tokens"][:, 1:][m[:, :-1]]).all()
    assert m.any()


def test_elastic_reshard_covers_all_samples(store):
    """dp_size change mid-epoch: the union of shards still follows ONE
    global order (no sample loss)."""
    loaders = [ShardedLoader(store, 1, 32, dp_rank=r, dp_size=4, seed=5)
               for r in range(4)]
    for _ in range(5):
        for ld in loaders:
            ld.next_batch()
    assert len({ld.state.cursor for ld in loaders}) == 1
    l2 = [ShardedLoader(store, 1, 32, dp_rank=r, dp_size=2, seed=5)
          for r in range(2)]
    for ld in l2:
        ld.restore(loaders[0].snapshot())
    for ld in l2:
        ld.next_batch()
    assert l2[0].state.cursor == l2[1].state.cursor


# ------------------------------------------------------- against the reference

pytest.importorskip("jax")   # the reference; absent where only the port runs

from repro.data import PackedDocStore as RefStore  # noqa: E402
from repro.data import ShardedLoader as RefLoader  # noqa: E402
from repro.data import synth_corpus as ref_corpus  # noqa: E402


@pytest.fixture(scope="module")
def stores():
    docs = synth_corpus(300, 512, seed=11, mean_len=80)
    for a, b in zip(docs, ref_corpus(300, 512, seed=11, mean_len=80)):
        assert a.dtype == b.dtype and (a == b).all()
    port, ref = PackedDocStore(block_tokens=64), RefStore(block_tokens=64)
    port.build(docs)
    ref.build(docs)
    return port, ref


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        np.testing.assert_array_equal(a[k], b[k])


def test_store_equals_the_references(stores):
    """Every document, the blocks and index reads each fetch costs, and a
    streamed append."""
    port, ref = stores
    for i in range(port.n_docs):
        np.testing.assert_array_equal(port.get(i), ref.get(i))
    assert port.dev.stats.reads == ref.dev.stats.reads
    assert port.index.dev.stats.reads == ref.index.dev.stats.reads
    assert port.io_per_sample == ref.io_per_sample
    doc = np.arange(5, 140, dtype=np.int32)
    assert port.append(doc) == ref.append(doc)
    np.testing.assert_array_equal(port.get(port.n_docs - 1),
                                  ref.get(ref.n_docs - 1))


def test_batches_equal_the_references_across_restore_and_reshard(stores):
    """Bit for bit: an epoch boundary crossed, a snapshot restored into a
    fresh loader, then an elastic re-shard from 4 ranks to 3 replaying the
    same global order."""
    port, ref = stores
    kw = dict(batch=7, seq_len=48, seed=9)
    pl = [ShardedLoader(port, dp_rank=r, dp_size=4, **kw) for r in range(4)]
    rl = [RefLoader(ref, dp_rank=r, dp_size=4, **kw) for r in range(4)]
    for _ in range(45):             # 45 * 7 > 301 documents: one epoch a rank
        for p, r in zip(pl, rl):
            _same(p.next_batch(), r.next_batch())
    snap = pl[0].snapshot()
    assert snap == rl[0].snapshot() and snap["epoch"] >= 1
    pn = [ShardedLoader(port, dp_rank=r, dp_size=3, **kw) for r in range(3)]
    rn = [RefLoader(ref, dp_rank=r, dp_size=3, **kw) for r in range(3)]
    for p, r in zip(pn, rn):
        p.restore(snap)
        r.restore(rl[0].snapshot())
    for _ in range(5):
        for p, r in zip(pn, rn):
            _same(p.next_batch(), r.next_batch())
    pn[1].set_shard(0, 1)
    rn[1].set_shard(0, 1)
    _same(pn[1].next_batch(), rn[1].next_batch())
    assert pn[1].snapshot() == rn[1].snapshot()
