"""The keys and the request traffic of the index cells, from ``--seed``.

``draw_keys`` makes a configuration's data set on the device the run
uses (one ``torch.Generator`` there, a few large calls): covid-like keys
are uniform integers in [lo, hi), sorted and de-duplicated, the first
``keys`` kept (the recipe of ``repro_torch.core.workloads.covid_like``).
The payload of a bulkloaded key is key + 1 (the paper's, §5.1.2).  A mix
with ``bulkload.sample`` builds its initial index from a random sample of
that many keys and inserts the rest, in a random order (the protocol of
W3-W6, as ``repro_torch.core.workloads.run_workload`` states it); without
it every key is bulkloaded.

``IndexTraffic`` reads a mix file (``traffic/<mix>.json``) and makes a
run's steps, all of them during set-up: a closed loop of ``clients``
clients, each with one request outstanding, so a step holds one request
of every client, in the same counts every step.  The window serves a
fixed number of steps, ``window_steps(mix, seconds)``, so that every run
of a cell at one ``--seconds`` serves the same requests, however fast the
program serves them.  A step's requests are its writes (inserts, updates,
deletes, in that order), then its gets, then its scans.  Steps are drawn
in blocks of ``block_steps``, each from its own generator seeded by
(seed, block).

The mix's keys (all optional but ``clients`` and ``window_steps_per_s``)::

    {"kind": "index_requests", "clients": C, "warmup_steps": 3,
     "window_steps_per_s": R,       # the window serves round(R * seconds)
     "bulkload": {"sample": N},     # the initial index: N random keys
     "writes": {"count": W, "insert_share": .6, "update_share": .3,
                "delete_share": .1,
                "insert_keys": "rest" | "range" | "shard_range",
                "hot_shard": 4},
     "gets": {"count": G, "absent_share": .1, "inserted_share": .5},
     "scans": {"count": S, "length": 100, "near_bound_share": .5,
               "near_bound_within": 50, "checked_per_step": 16}}

``W + G + S`` must equal ``clients``.  Counts split as the smoke's
``make_step`` split them: ``int(W * insert_share)`` inserts,
``int(W * update_share)`` updates, the rest deletes; ``int(G *
absent_share)`` absent gets, ``int(G * inserted_share)`` gets of keys
inserted so far.  Fresh inserts take the keys left out of the bulkload in
their order (``rest``), or uniform keys of the data set's range or of one
shard's (``shard_range``, a sharded configuration's).
"""
from __future__ import annotations

import dataclasses

import numpy as np

INSERT, DELETE = 1, 2


def window_steps(mix: dict, seconds: float) -> int:
    """The steps a window of ``seconds`` serves: the mix's nominal step
    rate times the seconds, at least one."""
    return max(1, round(float(mix["window_steps_per_s"]) * float(seconds)))


def pool_size(mix: dict, steps: int) -> int:
    """The keys left out of the bulkload that ``steps`` steps insert."""
    w = mix.get("writes", {})
    if w.get("insert_keys") != "rest":
        return 0
    return int(steps) * int(int(w["count"]) * w.get("insert_share", 0.0))


def draw_keys(dataset: dict, seed: int, device, sample: int = 0,
              pool: int = 0):
    """(bulkload keys, insert pool): sorted unique uint64 keys and the
    first ``pool`` keys of the rest in a random order, both numpy, made on
    ``device`` from ``seed``.  With ``sample``, the bulkload keys are that
    many drawn at random from the data set; without, all of it."""
    import torch
    if dataset.get("kind") != "covid-like":
        raise ValueError(f"no key recipe {dataset.get('kind')!r}")
    n, lo, hi = int(dataset["keys"]), int(dataset["lo"]), int(dataset["hi"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2**63)
    draws = int(n * float(dataset.get("oversample", 1.05)))
    k = torch.randint(lo, hi, (draws,), generator=g, device=device,
                      dtype=torch.int64)
    k = torch.unique(k, sorted=True)
    if k.numel() < n:
        raise RuntimeError(f"drew {k.numel()} unique keys of {n}")
    k = k[:n]
    rest = k[:0]
    if sample:
        if sample + pool > n:
            raise ValueError(f"{sample} bulkloaded and {pool} inserted "
                             f"keys of {n}")
        perm = torch.randperm(n, generator=g, device=device)
        rest = k[perm[sample:sample + pool]]
        k = torch.sort(k[perm[:sample]]).values
    elif pool:
        raise ValueError("inserts of the rest need a bulkload sample")
    return (k.cpu().numpy().view(np.uint64),
            rest.cpu().numpy().view(np.uint64))


def quantile_bounds(keys: np.ndarray, shards: int) -> np.ndarray:
    """The inclusive upper key of each shard but the last, for ``shards``
    equal-count range shards of the sorted ``keys`` (the rule of
    ``repro_torch.core.partition.partition_bulkload``, worked out again
    here so the traffic depends on nothing the program made)."""
    n = keys.shape[0]
    cuts = [int(np.searchsorted(keys, keys[max((s + 1) * n // shards - 1,
                                                0)], side="right"))
            for s in range(shards - 1)]
    cuts = sorted(set(c for c in cuts if 0 < c < n))
    return np.array([keys[c - 1] for c in cuts], dtype=np.uint64)


def for_cell(config: dict, mix: dict, seed: int, steps: int, device):
    """(bulkload keys, ``IndexTraffic``) of ``steps`` steps of ``mix``
    over ``config``'s data set, drawn from ``seed`` (a run's and the
    control's alike)."""
    keys, pool = draw_keys(config["dataset"], seed, device,
                           int(mix.get("bulkload", {}).get("sample", 0)),
                           pool_size(mix, steps))
    shards = int(config.get("shards", 1))
    bounds = quantile_bounds(keys, shards) if shards > 1 else None
    return keys, IndexTraffic(mix, keys, pool, seed, steps, bounds)


@dataclasses.dataclass
class Step:
    """One step's requests, in submission order: ``keys`` and ``pays``
    cover every request (writes, gets, scans); ``wops`` holds INSERT or
    DELETE a write; ``scan_check`` the scans whose rows are compared."""
    keys: np.ndarray
    pays: np.ndarray
    wops: np.ndarray
    scan_check: np.ndarray


class IndexTraffic:
    """The ``steps`` steps of one mix over one data set (module
    docstring)."""

    def __init__(self, mix: dict, keys: np.ndarray, pool: np.ndarray,
                 seed: int, steps: int, bounds: np.ndarray | None = None):
        if mix.get("kind") != "index_requests":
            raise ValueError(f"mix kind {mix.get('kind')!r}")
        self.keys, self.pool, self.seed = keys, pool, int(seed)
        self.bounds = bounds
        self.block = int(mix.get("block_steps", 32))
        w, g, s = (mix.get(k, {}) for k in ("writes", "gets", "scans"))
        self.nw, self.ng, self.ns = (int(d.get("count", 0)) for d in (w, g, s))
        if self.nw + self.ng + self.ns != int(mix["clients"]):
            raise ValueError("writes + gets + scans must equal clients")
        self.n_ins = int(self.nw * w.get("insert_share", 0.0))
        self.n_upd = int(self.nw * w.get("update_share", 0.0))
        self.n_del = self.nw - self.n_ins - self.n_upd
        if self.n_del and not w.get("delete_share", 0.0):
            raise ValueError("write shares must sum to 1")
        self.ins_kind = w.get("insert_keys", "range")
        self.n_abs = int(self.ng * g.get("absent_share", 0.0))
        self.n_from_ins = int(self.ng * g.get("inserted_share", 0.0))
        self.length = int(s.get("length", 100))
        self.n_near = int(self.ns * s.get("near_bound_share", 0.0))
        self.near = int(s.get("near_bound_within", 50))
        self.n_check = min(self.ns, int(s.get("checked_per_step", 16)))
        if self.n_ins and self.ins_kind == "rest" and \
                pool.shape[0] < steps * self.n_ins:
            raise ValueError(f"{steps} steps insert {steps * self.n_ins} "
                             f"keys; the pool holds {pool.shape[0]}")
        if self.n_from_ins and self.ins_kind != "rest":
            raise ValueError("gets of inserted keys need inserts of the rest")
        if (self.n_near or self.ins_kind == "shard_range") and \
                (bounds is None or not bounds.size):
            raise ValueError("this mix needs a sharded configuration")
        self.lo, self.hi = int(keys[0]), int(keys[-1]) + 1
        if self.ins_kind == "shard_range":
            s_hot = int(w["hot_shard"])
            b = bounds
            self.hot = (0 if s_hot == 0 else int(b[s_hot - 1]) + 1,
                        2**64 - 1 if s_hot == len(b) else int(b[s_hot]) + 1)
        # the same for every step: what submit() is called with
        self.ops = (["insert"] * (self.n_ins + self.n_upd)
                    + ["delete"] * self.n_del + ["get"] * self.ng
                    + ["scan"] * self.ns)
        self.counts = [0] * (self.nw + self.ng) + [self.length] * self.ns
        self.wops = np.array([INSERT] * (self.n_ins + self.n_upd)
                             + [DELETE] * self.n_del, dtype=np.int8)
        self.steps: list[Step] = []
        for b in range((int(steps) + self.block - 1) // self.block):
            self.steps += self._draw_block(b)
        del self.steps[int(steps):]

    def step(self, s: int) -> Step:
        """Step ``s``; a step past those drawn is an error, never drawn
        in the window."""
        return self.steps[s]

    def ref_step(self, s: int) -> dict:
        """Step ``s`` in the reference's form (``reference.index_view``):
        its writes, its gets and the scans whose rows are compared."""
        st = self.steps[s]
        nw, ng = self.nw, self.ng
        return {"wkeys": st.keys[:nw], "wpays": st.pays[:nw],
                "wops": st.wops, "gkeys": st.keys[nw:nw + ng],
                "skeys": st.keys[nw + ng:][st.scan_check],
                "scounts": np.full(st.scan_check.shape[0], self.length)}

    def inserted_by(self, s: int) -> int:
        """Keys of the pool inserted by the end of step ``s``."""
        return (s + 1) * self.n_ins

    def _draw_block(self, b: int) -> list[Step]:
        rng = np.random.default_rng([self.seed, b])
        B, keys, n = self.block, self.keys, self.keys.shape[0]
        s0 = b * B
        steps = np.arange(s0, s0 + B)
        # writes: fresh inserts, updates, deletes
        if self.ins_kind == "rest":
            j = steps[:, None] * self.n_ins + np.arange(self.n_ins)
            ins = self.pool[np.minimum(j, self.pool.shape[0] - 1)] \
                if self.n_ins else np.empty((B, 0), np.uint64)
            ins_p = ins + np.uint64(1)
        else:
            lo, hi = self.hot if self.ins_kind == "shard_range" else \
                (self.lo, self.hi)
            ins = rng.integers(lo, hi, (B, self.n_ins), dtype=np.uint64)
            ins_p = ins % np.uint64(1_000_003) + np.uint64(7)
        upd = keys[rng.integers(0, n, (B, self.n_upd))]
        upd_p = upd * np.uint64(3) % np.uint64(2**61)
        dele = keys[rng.integers(0, n, (B, self.n_del))]
        # gets: present, absent (uniform over the key range), inserted
        n_pres = self.ng - self.n_abs - self.n_from_ins
        pres = keys[rng.integers(0, n, (B, n_pres))]
        absent = rng.integers(self.lo, self.hi, (B, self.n_abs),
                              dtype=np.uint64)
        if self.n_from_ins:
            have = np.array([self.inserted_by(s) for s in steps])
            j = (rng.random((B, self.n_from_ins)) * have[:, None]).astype(
                np.int64)
            from_ins = self.pool[np.minimum(j, self.pool.shape[0] - 1)]
        else:
            from_ins = np.empty((B, 0), np.uint64)
        # scans: near_bound_share of them ending within `near` keys of a
        # shard bound, the rest from uniform keys
        if self.n_near:
            bnd = self.bounds[rng.integers(0, self.bounds.shape[0],
                                           (B, self.n_near))]
            ends = np.searchsorted(keys, bnd, side="right")
            near = keys[np.maximum(
                ends - rng.integers(1, self.near + 1, (B, self.n_near)), 0)]
        else:
            near = np.empty((B, 0), np.uint64)
        far = keys[rng.integers(0, n, (B, self.ns - self.n_near))]
        zeros = np.zeros((B, self.ng + self.ns), np.uint64)
        all_keys = np.concatenate([ins, upd, dele, pres, absent, from_ins,
                                   near, far], axis=1)
        all_pays = np.concatenate(
            [ins_p, upd_p, np.zeros((B, self.n_del), np.uint64), zeros],
            axis=1)
        out = []
        for i in range(B):
            check = np.sort(rng.choice(self.ns, self.n_check, replace=False)) \
                if self.n_check else np.empty(0, np.int64)
            out.append(Step(all_keys[i], all_pays[i], self.wops, check))
        return out
