"""GenomeArena — all input sequences in one flat device-friendly array.

Array-based replacement for the reference's per-object ``Sequence`` /
``InMemorySequence`` / ``CompactSequence`` (``src/model/Sequence.hpp`` ⚠[B],
SURVEY.md §2.1): instead of one heap object per sequence, every genome is
concatenated into a single uint8 code array (struct-of-arrays), so device
kernels scan *all* genomes in one grid and per-sequence boundaries are just an
offsets table. The 2-bit packed variant lives in ``npge_tpu.ops.pack``.

Sequence naming follows the reference convention ``GENOME&CHROMOSOME&c|l``
(circular/linear) [A].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from npge_tpu.util import codes as C


@dataclass(frozen=True)
class SeqName:
    genome: str
    chromosome: str
    circular: bool

    @staticmethod
    def parse(name: str) -> "SeqName":
        parts = name.split("&")
        if len(parts) == 3:
            g, ch, circ = parts
            if circ not in ("c", "l"):
                raise ValueError(f"bad circularity flag in sequence name {name!r}")
            return SeqName(g, ch, circ == "c")
        # tolerate plain names (treated as one-chromosome linear genome)
        return SeqName(name, "chr", False)

    def __str__(self) -> str:
        return f"{self.genome}&{self.chromosome}&{'c' if self.circular else 'l'}"


class GenomeArena:
    """Immutable set of input sequences, concatenated.

    Attributes:
        names:    list of full sequence names (``GENOME&CHR&c|l``)
        codes:    uint8[T] concatenated base codes (0..4; never GAP)
        offsets:  int64[n+1] start offset of each sequence in ``codes``
    """

    def __init__(self, names: list[str], seqs: list[np.ndarray]):
        if len(names) != len(seqs):
            raise ValueError("names/seqs length mismatch")
        if len(set(names)) != len(names):
            raise ValueError("duplicate sequence names")
        self.names: list[str] = list(names)
        self.parsed: list[SeqName] = [SeqName.parse(n) for n in names]
        seqs = [np.ascontiguousarray(s, dtype=np.uint8) for s in seqs]
        for n, s in zip(names, seqs):
            if s.ndim != 1 or (s.size and s.max() > C.N):
                raise ValueError(f"sequence {n!r} must be 1-D codes 0..4")
        self.offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
        np.cumsum([len(s) for s in seqs], out=self.offsets[1:])
        self.codes = (
            np.concatenate(seqs) if seqs else np.zeros(0, dtype=np.uint8)
        )
        self._name_to_id = {n: i for i, n in enumerate(names)}

    # ---- basic accessors ----
    @property
    def n_seqs(self) -> int:
        return len(self.names)

    @property
    def total_length(self) -> int:
        return int(self.offsets[-1])

    def seq_len(self, seq_id: int) -> int:
        return int(self.offsets[seq_id + 1] - self.offsets[seq_id])

    def seq_id(self, name: str) -> int:
        return self._name_to_id[name]

    def seq_codes(self, seq_id: int) -> np.ndarray:
        return self.codes[self.offsets[seq_id] : self.offsets[seq_id + 1]]

    def genomes(self) -> list[str]:
        """Distinct genome names, in first-appearance order."""
        seen: dict[str, None] = {}
        for p in self.parsed:
            seen.setdefault(p.genome, None)
        return list(seen)

    def genome_id_of_seq(self) -> np.ndarray:
        """int32[n_seqs]: genome index (into ``genomes()``) of each sequence."""
        gmap = {g: i for i, g in enumerate(self.genomes())}
        return np.array([gmap[p.genome] for p in self.parsed], dtype=np.int32)

    def seq_id_of_pos(self) -> np.ndarray:
        """int32[T]: sequence id owning each arena position."""
        out = np.zeros(self.total_length, dtype=np.int32)
        starts = self.offsets[1:-1]
        np.add.at(out, starts[starts < self.total_length], 1)
        return np.cumsum(out, dtype=np.int32) if out.size else out

    def circular(self, seq_id: int) -> bool:
        return self.parsed[seq_id].circular

    # ---- fragment text ----
    def circ_codes(self, seq_id: int, lo: int, length: int) -> np.ndarray:
        """Codes of ``length`` positions starting at ``lo`` (mod seq length),
        wrapping past the origin of a circular sequence when needed."""
        s = self.seq_codes(seq_id)
        L = len(s)
        if L == 0:
            if length:
                raise ValueError(
                    f"circ_codes: nonempty read from empty sequence {seq_id}"
                )
            return s[:0]
        lo %= L
        if lo + length <= L:
            return s[lo : lo + length]
        return np.concatenate([s[lo:], s[: lo + length - L]])

    def fragment_codes(
        self, seq_id: int, start: int, length: int, ori: int
    ) -> np.ndarray:
        """Text of a fragment. ``start`` is the *minimum* position on the
        sequence regardless of orientation (see model.fragments); ori=-1
        returns the reverse complement of the occupied range.

        ``start + length > seq_len`` marks a *wrap* fragment spanning the
        origin of a circular sequence (positions start..L-1 then 0..rest);
        wrap fragments are produced by origin joins (algo.joiner) and by
        origin-merged Rest runs (algo.rest); every interval consumer goes
        through model.fragments.frag_spans."""
        if start + length > self.seq_len(seq_id):
            if not self.circular(seq_id):
                raise ValueError(
                    f"fragment [{start}, {start}+{length}) overruns linear "
                    f"sequence {seq_id} (len {self.seq_len(seq_id)})"
                )
            s = self.circ_codes(seq_id, start, length)
        else:
            s = self.seq_codes(seq_id)[start : start + length]
        return C.revcomp(s) if ori == -1 else s

    @staticmethod
    def from_strings(named_seqs: dict[str, str]) -> "GenomeArena":
        names = list(named_seqs)
        return GenomeArena(names, [C.encode(named_seqs[n]) for n in names])
