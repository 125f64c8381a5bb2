"""AnchorFinder — exact k-mer anchor groups across genomes and strands.

Pipeline equivalent of the reference's ``AnchorFinder`` processor
(``src/algo/AnchorFinder.cpp`` ⚠[B], SURVEY.md §2.3 / §3.2): find short exact
matches occurring >= 2 times (across or within genomes), strand-canonical.
The device pass (ops/kmers.py) does the scan + minimizer sampling + key sort;
this module forms groups on host and emits candidate fragments.

Differences from the reference, by design (north star: hashed k-mer anchors
replace BLAST; SURVEY §2.6):
  - perfect 2-bit k-mer keys, no hash collisions, no Bloom filter;
  - optional minimizer sampling (MINIMIZER_WINDOW>1) thins the candidate set
    shift-invariantly instead of emitting every repeated window;
  - groups larger than MAX_ANCHOR_FRAGMENTS are dropped (repeat guard).
"""

from __future__ import annotations

from dataclasses import dataclass


import numpy as np

from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.ops.kmers import find_anchor_occurrences

# wall per phase across find_anchors calls (anchors-stage attribution;
# reset alongside ops.kmers.SCAN_TIMINGS)
ANCHOR_TIMINGS = {"occurrences": 0.0, "groups": 0.0, "dedupe": 0.0}


def reset_anchor_timings() -> dict:
    prev = dict(ANCHOR_TIMINGS)
    for k_ in ANCHOR_TIMINGS:
        ANCHOR_TIMINGS[k_] = 0.0
    return prev


@dataclass
class AnchorGroups:
    """Ragged groups of anchor occurrences (CSR layout).

    Occurrence m of group g (offsets[g] <= m < offsets[g+1]):
      pos[m]     arena-global start of the k-mer window
      seq_id[m]  owning sequence
      strand[m]  +1 if forward text equals the canonical form, else -1
    """

    k: int
    offsets: np.ndarray  # int64 [G+1]
    pos: np.ndarray      # int64 [M]
    seq_id: np.ndarray   # int32 [M]
    strand: np.ndarray   # int8  [M]

    @property
    def n_groups(self) -> int:
        return len(self.offsets) - 1

    def group(self, g: int):
        a, b = self.offsets[g], self.offsets[g + 1]
        return self.pos[a:b], self.seq_id[a:b], self.strand[a:b]

    def sizes(self) -> np.ndarray:
        return np.diff(self.offsets)


def _dedupe_keep_mask_exact(groups: AnchorGroups, window: int) -> np.ndarray:
    """Reference (per-group Python) keep mask — parity oracle for tests."""
    from collections import defaultdict

    keep = np.ones(groups.n_groups, dtype=bool)
    by_key: dict[tuple, list[tuple[int, int]]] = defaultdict(list)
    for g in range(groups.n_groups):
        a, b = groups.offsets[g], groups.offsets[g + 1]
        pos = groups.pos[a:b]
        key = (
            groups.seq_id[a:b].tobytes(),
            groups.strand[a:b].tobytes(),
            (pos[1:] - pos[:-1]).tobytes(),
        )
        by_key[key].append((int(pos[0]), g))
    for lst in by_key.values():
        lst.sort()
        last = None
        for p0, g in lst:
            if last is not None and p0 - last <= window:
                keep[g] = False
            else:
                last = p0
    return keep


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mixer (splitmix64 finalizer), vectorized."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _dedupe_keep_mask(groups: AnchorGroups, window: int) -> np.ndarray:
    """Vectorized keep mask: the per-group key (seqs, strands, position
    deltas) is replaced by a 128-bit order-sensitive rolling hash computed
    with array ops (the Python tobytes loop dominated host time at scale);
    greedy window suppression runs per hash-bucket on the tiny buckets."""
    G = groups.n_groups
    sizes = groups.sizes()
    first = groups.offsets[:-1]
    gid = np.repeat(np.arange(G, dtype=np.int64), sizes)
    M = len(groups.pos)
    delta = np.zeros(M, np.int64)
    if M > 1:
        delta[1:] = groups.pos[1:] - groups.pos[:-1]
    delta[first] = 0  # first position is NOT part of the key
    row = (
        (groups.seq_id.astype(np.uint64) << np.uint64(34))
        ^ ((groups.strand.astype(np.int64) & 0x3).astype(np.uint64)
           << np.uint64(32))
        ^ delta.astype(np.uint64)
    )
    # order-sensitive segment hash: sum_i mix(row_i) * P^(i - first_g)
    # (two independent mixes -> 128 bits; uint64 wraparound is the
    # modulus). P^(i - first) is computed as cumprod(P)[i] * inv(P)^first
    # — P is odd, hence invertible mod 2^64 (Newton inverse), and the
    # global cumulative product replaces M modular exponentiations
    # (~100 ns each; 5.3M rows at the 56 Mbp scale).
    def _seg_pows(P: int) -> np.ndarray:
        Pu = np.uint64(P)
        inv = Pu  # Newton: x *= 2 - P*x doubles correct bits; 6 steps
        with np.errstate(over="ignore"):
            for _ in range(6):
                inv = inv * (np.uint64(2) - Pu * inv)
            cp = np.multiply.accumulate(
                np.concatenate([[np.uint64(1)], np.full(M - 1, Pu)])
            )  # cp[i] = P^i
            icp = np.multiply.accumulate(
                np.concatenate([[np.uint64(1)], np.full(M - 1, inv)])
            )  # icp[i] = P^-i
            return cp * icp[first[gid]]

    with np.errstate(over="ignore"):
        pw1 = _seg_pows(0x100000001B3)
        pw2 = _seg_pows(0x9E3779B97F4A7C15 | 1)
        t1 = _splitmix64(row) * pw1
        t2 = _splitmix64(row ^ np.uint64(0xA5A5A5A5A5A5A5A5)) * pw2
    # segments are contiguous in occurrence order -> reduceat segment sums.
    # Deliberate trade-off: hash equality REPLACES exact key comparison, so
    # a 128-bit collision between distinct keys would silently merge their
    # dedupe buckets and drop a real anchor group. At ~2^-128 per pair
    # (buckets further partitioned by group size) this is accepted.
    h1 = np.add.reduceat(t1, first).astype(np.uint64)
    h2 = np.add.reduceat(t2, first).astype(np.uint64)
    p0 = groups.pos[first]
    order = np.lexsort((p0, sizes, h2, h1))
    h1s, h2s, ss = h1[order], h2[order], sizes[order]
    new_bucket = np.ones(G, dtype=bool)
    new_bucket[1:] = (
        (h1s[1:] != h1s[:-1]) | (h2s[1:] != h2s[:-1]) | (ss[1:] != ss[:-1])
    )
    keep = np.ones(G, dtype=bool)
    starts = np.flatnonzero(new_bucket)
    ends = np.append(starts[1:], G)
    p0s = p0[order]
    for a, b in zip(starts, ends):
        if b - a == 1:
            continue
        last = p0s[a]
        for i in range(a + 1, b):
            if p0s[i] - last <= window:
                keep[order[i]] = False
            else:
                last = p0s[i]
    return keep


def dedupe_parallel_groups(
    groups: AnchorGroups, window: int
) -> AnchorGroups:
    """Drop groups that are shifted copies of a nearby kept group.

    Adjacent minimizers of one conserved locus yield many groups whose
    occurrence sets are parallel translates (same sequences, same strands,
    identical position deltas). Extending every one is redundant — they all
    grow into the same block and lose in overlap resolution. Key = (seqs,
    strands, position deltas); within a key, groups whose first position is
    within ``window`` of the previously kept group are dropped (the kept
    seed's extension covers the same regions). Deterministic: groups are
    scanned in canonical (key-sorted) order. Vectorized keying
    (``_dedupe_keep_mask``), parity-tested against the exact per-group
    oracle.
    """
    if groups.n_groups == 0:
        return groups
    keep = _dedupe_keep_mask(groups, window)
    if keep.all():
        return groups
    sizes = groups.sizes()[keep]
    keep_m = np.repeat(keep, groups.sizes())
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return AnchorGroups(
        groups.k,
        offsets,
        groups.pos[keep_m],
        groups.seq_id[keep_m],
        groups.strand[keep_m],
    )


def _cyclic_scan(arena: GenomeArena, k: int, w: int):
    """Anchor occurrences with a cyclic halo on circular sequences.

    Each circular sequence of length >= k gets its first k+w-2 bases appended
    (same seq_id), so (a) k-mer windows crossing the origin exist and (b)
    minimizer selection near the origin sees the same cyclic windows it would
    after any rotation. Scanned occurrences map back to original coordinates;
    halo duplicates are deduped; windows that would wrap the origin are
    dropped (their fragments would be wrap fragments at birth, which the
    extender cannot grow — origin *joins* heal the origin instead; see
    algo/joiner). SURVEY §2.1 Sequence circularity [A]."""
    halos = np.array(
        [
            min(k + w - 2, arena.seq_len(i))
            if (arena.circular(i) and arena.seq_len(i) >= k)
            else 0
            for i in range(arena.n_seqs)
        ],
        np.int64,
    )
    parts = []
    eoff = np.zeros(arena.n_seqs + 1, np.int64)
    for i in range(arena.n_seqs):
        s = arena.seq_codes(i)
        seg = np.concatenate([s, s[: halos[i]]]) if halos[i] else s
        parts.append(seg)
        eoff[i + 1] = eoff[i] + len(seg)
    codes_ext = np.concatenate(parts)
    # device-built seq ids from the extended offsets (no 4 B/pos upload)
    h, l, pos, strand = find_anchor_occurrences(
        codes_ext, None, k, w, offsets=eoff
    )
    seq = np.searchsorted(eoff, pos, side="right") - 1
    lens = (arena.offsets[seq + 1] - arena.offsets[seq]).astype(np.int64)
    local = pos - eoff[seq]
    local = np.where(local >= lens, local - lens, local)
    keep = local + k <= lens  # drop origin-wrapping windows
    seq, local = seq[keep], local[keep]
    h, l, strand = h[keep], l[keep], strand[keep]
    pos = arena.offsets[seq] + local
    order = np.lexsort((pos, l, h))
    h, l, pos, strand = h[order], l[order], pos[order], strand[order]
    if len(h):  # dedupe halo copies of the same (key, position)
        uniq = np.ones(len(h), bool)
        uniq[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1]) | (pos[1:] != pos[:-1])
        h, l, pos, strand = h[uniq], l[uniq], pos[uniq], strand[uniq]
    return h, l, pos, strand


def find_anchors(
    arena: GenomeArena,
    cfg: Config,
    codes_dev=None,
    seq_id_dev=None,
    k: int | None = None,
) -> AnchorGroups:
    """Find anchor groups over the whole arena.

    With ``codes_dev`` (the device copy of ``arena.codes`` the extension
    stage uploads anyway) the scan reuses it and pads on device, saving a
    second padded-arena upload. Without it the scan uploads host codes
    padded host-side (no per-size device pad program — the reseed
    consensus arenas change size every round; see ops.kmers). Arenas with circular
    sequences take the cyclic-halo scan."""
    k = k or cfg.ANCHOR_SIZE
    w = cfg.MINIMIZER_WINDOW
    if any(
        arena.circular(i) and arena.seq_len(i) >= k
        for i in range(arena.n_seqs)
    ):
        h, l, pos, strand = _cyclic_scan(arena, k, w)
        return form_groups(h, l, pos, strand, arena, cfg, k)
    # seq ids are built on device from the tiny offsets table; the scan
    # returns device-derived group ids — the 64-bit keys stay on device
    # (one uint32/row is read back instead of three)
    import time as _time

    _t0 = _time.perf_counter()
    gid, pos, strand = find_anchor_occurrences(
        arena.codes if codes_dev is None else codes_dev,
        seq_id_dev, k, cfg.MINIMIZER_WINDOW,
        offsets=arena.offsets, want_gid=True,
        max_group=cfg.MAX_ANCHOR_FRAGMENTS,
    )
    ANCHOR_TIMINGS["occurrences"] += _time.perf_counter() - _t0
    return form_groups_gid(gid, pos, strand, arena, cfg, k)


def form_groups(h, l, pos, strand, arena: GenomeArena, cfg: Config, k: int) -> AnchorGroups:
    """Group key-sorted occurrences, apply size bounds and parallel-group
    dedupe. Shared by the cyclic, mesh-sharded, and multihost paths so all
    are bit-identical by construction."""
    if len(h) == 0:
        return AnchorGroups(
            k,
            np.zeros(1, np.int64),
            np.asarray(pos, np.int64),
            np.zeros(0, np.int32),
            np.asarray(strand, np.int8),
        )
    new = np.ones(len(h), dtype=bool)
    new[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1])
    gid = np.cumsum(new) - 1
    return form_groups_gid(gid, pos, strand, arena, cfg, k)


def form_groups_gid(
    gid, pos, strand, arena: GenomeArena, cfg: Config, k: int
) -> AnchorGroups:
    """Group formation from precomputed group ids of key-sorted
    occurrences (same-key runs, ids dense ascending)."""
    import time as _time

    _t0 = _time.perf_counter()
    if len(gid) == 0:
        return AnchorGroups(
            k,
            np.zeros(1, np.int64),
            np.asarray(pos, np.int64),
            np.zeros(0, np.int32),
            np.asarray(strand, np.int8),
        )
    sizes = np.bincount(gid)
    keep_g = (sizes >= 2) & (sizes <= cfg.MAX_ANCHOR_FRAGMENTS)
    keep_m = keep_g[gid]
    pos, strand, gid = pos[keep_m], strand[keep_m], gid[keep_m]
    # re-number kept groups compactly, preserving sorted-key order
    kept_sizes = sizes[keep_g]
    offsets = np.zeros(len(kept_sizes) + 1, np.int64)
    np.cumsum(kept_sizes, out=offsets[1:])
    seq_id = (
        np.searchsorted(arena.offsets, pos, side="right").astype(np.int32) - 1
    )
    groups = AnchorGroups(
        k, offsets, pos.astype(np.int64), seq_id, strand.astype(np.int8)
    )
    ANCHOR_TIMINGS["groups"] += _time.perf_counter() - _t0
    _t0 = _time.perf_counter()
    if cfg.ANCHOR_DEDUPE_WINDOW > 0:
        groups = dedupe_parallel_groups(groups, cfg.ANCHOR_DEDUPE_WINDOW)
    ANCHOR_TIMINGS["dedupe"] += _time.perf_counter() - _t0
    return groups
