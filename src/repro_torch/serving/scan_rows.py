"""A scan's answer as two owned uint64 columns.

A scan's answer is its first ``count`` live ``(key, payload)`` rows at or
above its start, in key order.  :class:`ScanRows` holds those rows as the
request's own NumPy arrays, ``keys`` and ``payloads`` (one row each), cut
from the scan batch's fetched ``(Q, bucket)`` arrays by a copy, so that a
kept answer keeps its own rows and not the batch's.

It is a sequence of ``(int, int)`` pairs equal to the list of those pairs:
indexing, slicing and iteration box a row into a tuple of Python ints
where it is read.  A client that reads every pair pays that boxing on its
own side; one that wants columns reads ``keys`` and ``payloads``.
"""
from __future__ import annotations

import operator
from collections.abc import Sequence

import numpy as np


class ScanRows(Sequence):
    """A scan's rows: ``keys`` and ``payloads``, owned uint64 arrays of one
    length.  Equality is the list comparison of the pairs: against a
    ``ScanRows`` the columns are compared, against a ``list`` or a
    ``tuple`` ``list(self) == list(other)``; anything else is
    ``NotImplemented`` (``!=`` is the negation)."""

    __slots__ = ("keys", "payloads")
    __hash__ = None

    def __init__(self, keys: np.ndarray, payloads: np.ndarray):
        self.keys = keys
        self.payloads = payloads

    def __len__(self) -> int:
        return self.keys.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(zip(self.keys[i].tolist(), self.payloads[i].tolist()))
        i = operator.index(i)
        return int(self.keys[i]), int(self.payloads[i])

    def __iter__(self):
        return zip(self.keys.tolist(), self.payloads.tolist())

    def __eq__(self, other):
        if isinstance(other, ScanRows):
            return (np.array_equal(self.keys, other.keys)
                    and np.array_equal(self.payloads, other.payloads))
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return repr(list(self))
