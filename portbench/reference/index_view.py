"""The served view of an index under a stream of steps, in plain NumPy.

This is the benchmark's reference for the index cells.  It imports nothing
of the program: it works the view out again from the keys the benchmark
drew (each bulkloaded with payload key + 1) and the requests the
benchmark sent, under the guarantees the configurations state:

* unique-key upserts: ``insert`` sets the key's payload whether or not the
  key exists and is acknowledged True; ``delete`` removes the key and is
  acknowledged with whether it existed;
* step-level consistency: a step applies its writes in submission order,
  then answers its reads, each of which sees every write of the step and of
  every step before;
* exact answers over u64 keys: a get returns the payload of the key's
  latest write (or key + 1 if it was bulkloaded and never written), or
  None; a scan returns the first ``count`` live (key, payload) pairs with
  key >= its start, in key order.

``precision="f32"`` is the control: the same view with every comparison of
keys made after rounding them to float32 (24 bits of significand), the step
below the u64 keys that the configuration states.  A get then answers with
the first stored key that rounds as it does, a scan starts at the first
key that rounds at or above its start.  The comparison must fail it.
"""
from __future__ import annotations

import numpy as np

NONE = np.uint64(2**64 - 1)       # a get that found nothing
INSERT, DELETE = 1, 2


def _cmp(a: np.ndarray, precision: str) -> np.ndarray:
    """The keys as the view compares them."""
    a = np.asarray(a, dtype=np.uint64)
    if precision == "u64":
        return a
    if precision == "f32":
        return a.astype(np.float32).astype(np.float64)
    raise ValueError(f"no precision {precision!r}")


class IndexView:
    """Answers of a stream of steps over ``keys`` (sorted unique uint64).

    ``steps`` is a list of dicts: ``wkeys``/``wops``/``wpays`` (the step's
    writes in order), ``gkeys`` (its gets), ``skeys``/``scounts`` (the
    scans whose rows are compared)."""

    def __init__(self, keys: np.ndarray, precision: str = "u64"):
        self.keys = np.asarray(keys, dtype=np.uint64)
        self.precision = precision
        self.ck = _cmp(self.keys, precision)

    def answers(self, steps: list) -> dict:
        """``acks`` (bool a write), ``gets`` (uint64 payload a get, NONE
        when absent), ``scans`` (a list of (key, payload) pairs a compared
        scan), each over all steps in order, and ``live``: the keys live
        after the last step."""
        p = self.precision
        nw = np.array([s["wkeys"].shape[0] for s in steps], dtype=np.int64)
        lim = np.cumsum(nw)                      # writes up to step s's end
        wk = _concat([s["wkeys"] for s in steps], np.uint64)
        wo = _concat([s["wops"] for s in steps], np.int8)
        wp = _concat([s["wpays"] for s in steps], np.uint64)
        self._wk = wk                            # as sent, for the scans
        cw = _cmp(wk, p)
        order = np.argsort(cw, kind="stable")    # by key, then by sequence
        sk, so, sp = cw[order], wo[order], wp[order]
        # a delete's acknowledgement: whether the key lived just before it
        same_prev = np.r_[False, sk[1:] == sk[:-1]] if sk.size else \
            np.empty(0, bool)
        prev_live = np.r_[False, so[:-1] == INSERT] if sk.size else \
            np.empty(0, bool)
        existed = np.empty(wk.shape[0], dtype=bool)
        existed[order] = np.where(same_prev, prev_live, self._in_base(sk))
        acks = np.where(wo == INSERT, True, existed)
        # gets: the latest write of the key at or before the step, else
        # the bulkload
        gk = _concat([s["gkeys"] for s in steps], np.uint64)
        gstep = np.repeat(np.arange(len(steps)),
                          [s["gkeys"].shape[0] for s in steps])
        gets = self._base_pay(_cmp(gk, p))
        j, ok = self._latest(sk, _cmp(gk, p), order, lim[gstep])
        jj = np.clip(j, 0, max(sk.size - 1, 0))
        if sk.size:
            gets = np.where(ok, np.where(so[jj] == INSERT, sp[jj], NONE),
                            gets)
        scans = []
        for s, step in enumerate(steps):
            for k, c in zip(step["skeys"].tolist(), step["scounts"].tolist()):
                scans.append(self._scan(k, c, sk, so, sp, order, lim[s]))
        # keys live at the end: the bulkload, less the written keys whose
        # last write deleted them, plus the new ones whose last inserted
        last = np.r_[sk[1:] != sk[:-1], True] if sk.size else \
            np.empty(0, bool)
        fin_live = so[last] == INSERT
        in_base = self._in_base(sk[last])
        live = self.keys.shape[0] + int((fin_live & ~in_base).sum()) \
            - int((~fin_live & in_base).sum())
        return {"acks": acks, "gets": gets, "scans": scans, "live": live}

    # --------------------------------------------------------------- parts
    def _pos(self, ck: np.ndarray) -> np.ndarray:
        # sorted queries walk the keys in order: far fewer cache misses
        order = np.argsort(ck, kind="stable")
        pos = np.empty(ck.shape[0], dtype=np.int64)
        pos[order] = np.searchsorted(self.ck, ck[order], side="left")
        return pos

    def _in_base(self, ck: np.ndarray) -> np.ndarray:
        n = self.ck.shape[0]
        pos = np.minimum(self._pos(ck), n - 1)
        return self.ck[pos] == ck

    def _base_pay(self, ck: np.ndarray) -> np.ndarray:
        n = self.ck.shape[0]
        pos = np.minimum(self._pos(ck), n - 1)
        hit = self.ck[pos] == ck
        return np.where(hit, self.keys[pos] + np.uint64(1), NONE)

    @staticmethod
    def _latest(sk, q, order, lim):
        """For each query key ``q[i]``: the index into the key-sorted writes
        of its latest write with sequence below ``lim[i]``, and whether
        there is one."""
        if not sk.size:
            z = np.zeros(q.shape[0], np.int64)
            return z, z.astype(bool)
        lo = np.searchsorted(sk, q, side="left")
        hi = np.searchsorted(sk, q, side="right")
        # within a key's run the sequence numbers (``order``) ascend
        seq = order.astype(np.int64)
        n = seq.shape[0] + 1
        run = np.searchsorted(np.unique(sk), sk)        # run id a write
        comp = run.astype(np.int64) * n + seq           # ascending
        rq = np.searchsorted(np.unique(sk), q)
        j = np.searchsorted(comp, rq.astype(np.int64) * n + lim,
                            side="left") - 1
        ok = (hi > lo) & (j >= lo) & (j < hi)
        return j, ok

    def _scan(self, start, count, sk, so, sp, order, lim) -> list:
        p = self.precision
        keys, ck, n = self.keys, self.ck, self.keys.shape[0]
        cstart = _cmp(np.array([start], np.uint64), p)[0]
        i = int(np.searchsorted(ck, cstart, side="left"))
        c = count + 16
        while True:
            end = min(i + c, n)
            cand = keys[i:end]
            view = dict(zip(cand.tolist(),
                            (cand + np.uint64(1)).tolist()))
            top = None if end == n else ck[end - 1]
            a = int(np.searchsorted(sk, cstart, side="left"))
            b = sk.shape[0] if top is None else \
                int(np.searchsorted(sk, top, side="right"))
            if b > a:
                seg = np.arange(a, b)
                seg = seg[order[seg] < lim]
                for t in seg.tolist():          # key, then sequence order
                    k = int(self._orig_key(order[t]))
                    if so[t] == INSERT:
                        view[k] = int(sp[t])
                    else:
                        view.pop(k, None)
            live = sorted(view.items())
            if len(live) >= count or end == n:
                return live[:count]
            c *= 2

    def _orig_key(self, seq: int):
        return self._wk[seq]


def _concat(parts: list, dtype) -> np.ndarray:
    return np.concatenate(parts).astype(dtype, copy=False) if parts else \
        np.empty(0, dtype)


def answers(keys: np.ndarray, steps: list, precision: str = "u64") -> dict:
    """The reference's (or, with ``precision="f32"``, the control's)
    answers to ``steps`` over ``keys``."""
    return IndexView(keys, precision).answers(steps)
