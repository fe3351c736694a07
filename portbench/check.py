"""The comparison that decides ``correct`` for the index cells.

The program's answers, as the benchmark's clients read them after each
step, are held to the reference's (``reference/index_view.py``) request
for request: every write's acknowledgement, every get's payload and the
rows of every scan that the mix compares.  Each count below is compared
with its limit, 0: the comparison is exact (a wrong answer is wrong, a
request that was never answered is wrong too).
"""
from __future__ import annotations

import numpy as np

from .reference.index_view import NONE, answers

MISSING = object()                 # a request the step left unanswered
NOT_DONE = np.uint64(2**64 - 2)    # its code among get payloads
BAD = np.uint64(2**64 - 3)         # a payload that is no u64
LIMITS = {"writes_wrong": 0, "gets_wrong": 0, "scans_wrong": 0,
          "unanswered": 0}


def get_codes(results: list) -> np.ndarray:
    """Get answers (payload, None or MISSING) as uint64 codes: a payload
    that is no u64 below the codes, or an answer of another type, is
    BAD."""
    none = int(NONE)
    if all(x is None or type(x) is int for x in results):
        try:                   # the usual case, without a call an answer
            out = np.fromiter((none if x is None else x for x in results),
                              dtype=np.uint64, count=len(results))
            if int((out >= BAD).sum()) == results.count(None):
                return out
        except OverflowError:
            pass

    def code(x):
        if x is None:
            return NONE
        if x is MISSING:
            return NOT_DONE
        return x if type(x) is int and 0 <= x < 2**64 - 3 else BAD
    return np.fromiter((code(x) for x in results), dtype=np.uint64,
                       count=len(results))


def compare(keys: np.ndarray, steps: list, got: dict) -> tuple[dict, int]:
    """Counts of wrong answers (``LIMITS``' names) and the keys live at
    the end.  ``steps`` as ``reference.index_view.answers`` takes them;
    ``got``: ``acks`` (a list of a write's results), ``gets`` (a list of a
    get's), ``scans`` (a list of a compared scan's rows, in the order of
    ``steps``' scans) and ``unanswered`` (requests not done, of any kind).
    """
    exp = answers(keys, steps)
    acks = got["acks"]
    writes_wrong = sum(a is MISSING or not isinstance(a, (bool, np.bool_))
                       or bool(a) != e
                       for a, e in zip(acks, exp["acks"].tolist()))
    writes_wrong += abs(len(acks) - exp["acks"].shape[0])
    g = get_codes(got["gets"])
    gets_wrong = int((g != exp["gets"]).sum()) if g.shape == \
        exp["gets"].shape else max(g.shape[0], exp["gets"].shape[0])
    scans_wrong = sum(r is MISSING or r != e
                      for r, e in zip(got["scans"], exp["scans"]))
    scans_wrong += abs(len(got["scans"]) - len(exp["scans"]))
    counts = {"writes_wrong": int(writes_wrong), "gets_wrong": gets_wrong,
              "scans_wrong": int(scans_wrong),
              "unanswered": int(got["unanswered"])}
    return counts, exp["live"]


def control_answers(keys: np.ndarray, steps: list) -> dict:
    """The control put in the program's place: the reference computed with
    keys compared in float32, in the form the clients read answers."""
    exp = answers(keys, steps, "f32")
    return {"acks": exp["acks"].tolist(),
            "gets": [None if v == int(NONE) else v
                     for v in exp["gets"].tolist()],
            "scans": exp["scans"], "unanswered": 0}


def correct(counts: dict) -> bool:
    return all(counts[k] <= lim for k, lim in LIMITS.items())


def checks_entry(counts: dict) -> dict:
    """The numbers compared, each with its limit (the result line's last
    key, and the last lines on standard error)."""
    return {k: {"value": counts[k], "limit": LIMITS[k]} for k in LIMITS}
