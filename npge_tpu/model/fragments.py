"""FragmentTable — struct-of-arrays fragment storage.

Array-based replacement for the reference's per-object ``Fragment``
(``src/model/Fragment.hpp`` ⚠[B], SURVEY.md §2.1). A fragment is an interval
on a sequence plus an orientation.

Coordinate convention (deliberately different from the reference's
min_pos/max_pos pair, chosen so interval machinery never branches on
orientation):
    - ``start``  = minimum occupied position (0-based)
    - ``length`` = number of occupied positions; occupied = [start, start+length)
    - ``ori``    = +1 / -1; text of an ori=-1 fragment is the reverse
      complement of the occupied range.
"""

from __future__ import annotations

import numpy as np


class FragmentTable:
    """Columns: seq_id, start, length, ori — all int32, same length F."""

    __slots__ = ("seq_id", "start", "length", "ori")

    def __init__(self, seq_id, start, length, ori):
        self.seq_id = np.asarray(seq_id, dtype=np.int32)
        self.start = np.asarray(start, dtype=np.int32)
        self.length = np.asarray(length, dtype=np.int32)
        self.ori = np.asarray(ori, dtype=np.int32)
        n = len(self.seq_id)
        if not (len(self.start) == len(self.length) == len(self.ori) == n):
            raise ValueError("column length mismatch")

    def __len__(self) -> int:
        return len(self.seq_id)

    @property
    def end(self) -> np.ndarray:
        """Exclusive end of the occupied interval."""
        return self.start + self.length

    def row(self, i: int) -> tuple[int, int, int, int]:
        return (
            int(self.seq_id[i]),
            int(self.start[i]),
            int(self.length[i]),
            int(self.ori[i]),
        )

    def take(self, idx) -> "FragmentTable":
        return FragmentTable(
            self.seq_id[idx], self.start[idx], self.length[idx], self.ori[idx]
        )

    def concat(self, other: "FragmentTable") -> "FragmentTable":
        return FragmentTable(
            np.concatenate([self.seq_id, other.seq_id]),
            np.concatenate([self.start, other.start]),
            np.concatenate([self.length, other.length]),
            np.concatenate([self.ori, other.ori]),
        )

    def sort_order(self) -> np.ndarray:
        """Canonical deterministic order: (seq_id, start, length, ori)."""
        return np.lexsort((self.ori, self.length, self.start, self.seq_id))

    def key_tuples(self) -> list[tuple[int, int, int, int]]:
        return [self.row(i) for i in range(len(self))]

    @staticmethod
    def empty() -> "FragmentTable":
        z = np.zeros(0, dtype=np.int32)
        return FragmentTable(z, z, z, z)

    @staticmethod
    def from_rows(rows) -> "FragmentTable":
        rows = list(rows)
        if not rows:
            return FragmentTable.empty()
        a = np.asarray(rows, dtype=np.int32)
        return FragmentTable(a[:, 0], a[:, 1], a[:, 2], a[:, 3])


def frag_spans(start: int, length: int, seq_len: int):
    """Occupied interval(s) of a fragment as 1-2 half-open spans.

    A *wrap* fragment on a circular sequence has start + length > seq_len and
    occupies [start, seq_len) ++ [0, start + length - seq_len). Wrap
    fragments are produced only on circular sequences (origin joins in
    algo/joiner, origin-merged Rest runs); every interval consumer must go
    through this helper instead of assuming start + length <= seq_len
    (round-1 advisor finding: establisher/checker disagreement)."""
    end = start + length
    if end <= seq_len:
        return [(start, end)]
    return [(start, seq_len), (0, end - seq_len)]
