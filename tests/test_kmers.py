"""Anchor-finding device ops vs brute-force NumPy oracles (SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np
import pytest

from npge_tpu.algo.anchors import find_anchors
from npge_tpu.config import default_config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.ops.kmers import kmer_scan, minimizer_mask
from npge_tpu.util import codes as C
from npge_tpu.util.synthetic import synthetic_arena


def oracle_kmer(codes: np.ndarray, seq_id: np.ndarray, k: int):
    """Brute-force canonical kmer per position (Python ints)."""
    T = len(codes)
    keys = np.zeros(T, dtype=np.uint64)
    strand = np.zeros(T, dtype=np.int8)
    valid = np.zeros(T, dtype=bool)
    for p in range(T - k + 1):
        win = codes[p : p + k]
        if (win >= 4).any() or seq_id[p] != seq_id[p + k - 1]:
            continue
        fwd = 0
        for b in win:
            fwd = fwd * 4 + int(b)
        rc = 0
        for b in (3 - win)[::-1]:
            rc = rc * 4 + int(b)
        valid[p] = True
        if fwd < rc:
            keys[p], strand[p] = fwd, 1
        elif rc < fwd:
            keys[p], strand[p] = rc, -1
        else:
            keys[p], strand[p] = fwd, 0
    return keys, strand, valid


@pytest.mark.parametrize("k", [5, 16, 21, 32])
def test_kmer_scan_matches_oracle(k):
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=300).astype(np.uint8)  # includes Ns
    # two sequences
    seq_id = np.zeros(300, np.int32)
    seq_id[170:] = 1
    hi, lo, strand, valid = kmer_scan(
        jnp.asarray(codes), jnp.asarray(seq_id), k
    )
    got_keys = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    want_keys, want_strand, want_valid = oracle_kmer(codes, seq_id, k)
    np.testing.assert_array_equal(np.asarray(valid), want_valid)
    v = want_valid
    np.testing.assert_array_equal(got_keys[v], want_keys[v])
    np.testing.assert_array_equal(np.asarray(strand)[v], want_strand[v])


def test_minimizer_mask_matches_oracle():
    rng = np.random.default_rng(2)
    codes = rng.integers(0, 4, size=500).astype(np.uint8)
    seq_id = np.zeros(500, np.int32)
    k, w = 7, 5
    hi, lo, strand, valid = kmer_scan(jnp.asarray(codes), jnp.asarray(seq_id), k)
    sel = np.asarray(minimizer_mask(hi, lo, valid, w))
    keys = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        lo
    ).astype(np.uint64)
    vmask = np.asarray(valid)
    keys_masked = np.where(vmask, keys, np.uint64(0xFFFFFFFFFFFFFFFF))
    want = np.zeros(500, bool)
    T = 500
    for s in range(T - w + 1):
        window = keys_masked[s : s + w]
        m = window.min()
        for j in range(w):
            if window[j] == m:
                want[s + j] = True
    want &= vmask
    np.testing.assert_array_equal(sel, want)


def test_minimizers_shift_invariant_sampling():
    """Homologous (identical) loci in two genomes sample the same k-mers."""
    rng = np.random.default_rng(3)
    core = rng.integers(0, 4, size=400).astype(np.uint8)
    a = np.concatenate([rng.integers(0, 4, size=37).astype(np.uint8), core])
    b = np.concatenate([rng.integers(0, 4, size=80).astype(np.uint8), core])
    arena = GenomeArena(["A&c&l", "B&c&l"], [a, b])
    cfg = default_config().replace(ANCHOR_SIZE=15, MINIMIZER_WINDOW=8)
    groups = find_anchors(arena, cfg)
    # every group of size 2 should pair identical text across the genomes
    assert groups.n_groups > 10
    covered = 0
    for g in range(groups.n_groups):
        pos, sid, strand = groups.group(g)
        texts = set()
        for p, s, st in zip(pos, sid, strand):
            local = p - arena.offsets[s]
            t = arena.fragment_codes(int(s), int(local), 15, int(st))
            texts.add(C.decode(t))
        assert len(texts) == 1, "anchor group must be exact"
        covered += 1


def test_find_anchors_reverse_strand():
    seq = "ATCGGCTAAGCTTCCGGAATC"
    rc = C.decode(C.revcomp(C.encode(seq)))
    arena = GenomeArena.from_strings({"A&c&l": seq, "B&c&l": rc})
    cfg = default_config().replace(ANCHOR_SIZE=21, MINIMIZER_WINDOW=1)
    groups = find_anchors(arena, cfg)
    assert groups.n_groups == 1
    pos, sid, strand = groups.group(0)
    assert set(sid.tolist()) == {0, 1}
    assert strand[0] != strand[1]  # opposite strands


def test_find_anchors_on_synthetic():
    arena = synthetic_arena(n_genomes=2, length=3000, seed=5, indel_rate=0.0)
    cfg = default_config().replace(ANCHOR_SIZE=21, MINIMIZER_WINDOW=8)
    groups = find_anchors(arena, cfg)
    assert groups.n_groups > 20
    sizes = groups.sizes()
    assert (sizes >= 2).all()


def test_kmer_scan_dyn_matches_static():
    """kmer_scan_dyn (traced k, one compile for all k) must be bit-identical
    to the static-k kmer_scan for every k and across sequence boundaries."""
    import jax.numpy as jnp

    from npge_tpu.ops.kmers import kmer_scan, kmer_scan_dyn

    rng = np.random.default_rng(13)
    codes = rng.integers(0, 5, 3000).astype(np.uint8)  # with N codes
    sid = np.zeros(3000, np.int32)
    sid[1100:] = 1
    sid[2300:] = 2
    cj, sj = jnp.asarray(codes), jnp.asarray(sid)
    for k in (1, 2, 13, 16, 17, 21, 31, 32):
        a = kmer_scan(cj, sj, k)
        b = kmer_scan_dyn(cj, sj, k)
        for x, y, name in zip(a, b, ("hi", "lo", "strand", "valid")):
            np.testing.assert_array_equal(
                np.asarray(x), np.asarray(y), err_msg=f"k={k} {name}"
            )


def test_pad_ratchet_invariance():
    """find_anchor_occurrences results must not depend on the pad ratchet:
    padding the scan to a much larger floor (the device path's
    executable-count saver) yields bit-identical occurrences."""
    from npge_tpu.ops.kmers import find_anchor_occurrences, set_pad_ratchet

    arena = synthetic_arena(n_genomes=2, length=2000, seed=9)
    cj = jnp.asarray(arena.codes)
    off = arena.offsets
    base = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
    assert len(base[0]) > 0
    try:
        set_pad_ratchet(True)
        # seed the floor with a scan over a much larger arena
        big = synthetic_arena(n_genomes=2, length=9000, seed=10)
        find_anchor_occurrences(
            jnp.asarray(big.codes), None, 15, 8, offsets=big.offsets
        )
        ratcheted = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
    finally:
        set_pad_ratchet(None)
    for a, b, name in zip(base, ratcheted, ("hi", "lo", "pos", "strand")):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_scan_empty_selection():
    """All-N arena selects nothing; the compact path returns empty arrays."""
    from npge_tpu.ops.kmers import find_anchor_occurrences

    codes = np.full(64, 4, np.uint8)
    off = np.array([0, 64], np.int64)
    h, l, p, s = find_anchor_occurrences(
        jnp.asarray(codes), None, 15, 8, offsets=off
    )
    assert len(h) == len(l) == len(p) == len(s) == 0


def test_sid_from_offsets_matches_host():
    """Device-built per-position sequence ids (from the offsets table) must
    equal the host arena.seq_id_of_pos(), with -1 on padding."""
    import jax.numpy as jnp
    from npge_tpu.ops.kmers import _sid_from_offsets
    from npge_tpu.util.synthetic import synthetic_arena

    arena = synthetic_arena(n_genomes=3, length=1000, seed=2)
    T = arena.total_length
    Tp = 1 << (T - 1).bit_length()
    codes_p = jnp.zeros(Tp, jnp.uint8)
    sid = np.asarray(
        _sid_from_offsets(jnp.asarray(arena.offsets.astype(np.int64)), codes_p)
    )
    np.testing.assert_array_equal(sid[:T], arena.seq_id_of_pos())
    assert (sid[T:] == -1).all()


def test_dedupe_vectorized_matches_exact_oracle():
    """The vectorized hash-keyed dedupe must keep exactly the same groups
    as the per-group exact-key oracle, across random ragged group sets."""
    from npge_tpu.algo.anchors import (
        AnchorGroups,
        _dedupe_keep_mask,
        _dedupe_keep_mask_exact,
    )

    rng = np.random.default_rng(31)
    for trial in range(30):
        G = int(rng.integers(2, 60))
        sizes = rng.integers(2, 6, G)
        offsets = np.zeros(G + 1, np.int64)
        np.cumsum(sizes, out=offsets[1:])
        M = int(offsets[-1])
        # build clusters of parallel translates: a few base patterns,
        # each repeated at shifted positions
        pos = np.zeros(M, np.int64)
        seq = np.zeros(M, np.int32)
        strand = np.zeros(M, np.int8)
        for g in range(G):
            a, b = offsets[g], offsets[g + 1]
            pat = int(rng.integers(0, 4))
            r = np.random.default_rng(pat)  # same pattern -> same deltas
            deltas = r.integers(50, 5000, b - a - 1)
            base = int(rng.integers(0, 40)) * 7  # clustered first positions
            pos[a] = base
            pos[a + 1 : b] = base + np.cumsum(deltas)
            seq[a:b] = r.integers(0, 3, b - a)
            strand[a:b] = r.choice([-1, 1], b - a)
        g = AnchorGroups(15, offsets, pos, seq, strand)
        for window in (0, 5, 25, 100):
            want = _dedupe_keep_mask_exact(g, window)
            got = _dedupe_keep_mask(g, window)
            np.testing.assert_array_equal(got, want, err_msg=f"t{trial} w{window}")


def test_kmer_scan_ladder_matches_dyn():
    """The log-step ladder scan must be bit-identical to the fori-loop
    formulation for every k, across sequence boundaries and N runs."""
    from npge_tpu.ops.kmers import kmer_scan_dyn, kmer_scan_ladder

    rng = np.random.default_rng(17)
    codes = rng.integers(0, 5, 4000).astype(np.uint8)  # with N codes
    sid = np.zeros(4000, np.int32)
    sid[900:] = 1
    sid[2100:] = 2
    cj, sj = jnp.asarray(codes), jnp.asarray(sid)
    for k in range(1, 33):
        a = kmer_scan_dyn(cj, sj, k)
        b = kmer_scan_ladder(cj, sj, k)
        v = np.asarray(a[3])
        np.testing.assert_array_equal(
            v, np.asarray(b[3]), err_msg=f"k={k} valid"
        )
        # values at INVALID positions are unspecified garbage in both
        # formulations (masked by every consumer); compare valid ones
        for x, y, name in zip(a[:3], b[:3], ("hi", "lo", "strand")):
            np.testing.assert_array_equal(
                np.asarray(x)[v], np.asarray(y)[v], err_msg=f"k={k} {name}"
            )


def test_fused_scan_truncation_retry():
    """The device path's fused scan returns rows truncated to cap
    when count > cap and the caller retries with a raised floor: results
    must still be bit-identical to the count-first CPU path."""
    from npge_tpu.ops.kmers import find_anchor_occurrences, set_pad_ratchet

    # big enough that the selected count exceeds the 1<<14 starting cap
    arena = synthetic_arena(n_genomes=2, length=100_000, seed=4)
    cj = jnp.asarray(arena.codes)
    off = arena.offsets
    base = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
    assert len(base[0]) > (1 << 14), "world too small to force truncation"
    try:
        set_pad_ratchet(True)
        fused = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
    finally:
        set_pad_ratchet(None)
    for a, b, name in zip(base, fused, ("hi", "lo", "pos", "strand")):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_fused_scan_speculative_prefix_paths():
    """The ratchet path's single-readback speculative prefix (count packed
    into column 0, rows device-sorted) must be bit-identical to the CPU
    path regardless of the guess: absent (count-first), exact, too small
    (top-up fetch), and too large."""
    from npge_tpu.ops.kmers import (
        _N_GUESS, find_anchor_occurrences, set_pad_ratchet,
    )

    arena = synthetic_arena(n_genomes=3, length=4000, seed=21)
    cj = jnp.asarray(arena.codes)
    off = arena.offsets
    base = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
    n = len(base[0])
    assert n > 0
    Tp = 1 << (arena.total_length - 1).bit_length()
    try:
        set_pad_ratchet(True)
        for guess in (None, n, 1, Tp):  # absent / exact / short / huge
            _N_GUESS.clear()
            if guess is not None:
                _N_GUESS[Tp] = guess
            got = find_anchor_occurrences(cj, None, 15, 8, offsets=off)
            for a, b, name in zip(
                base, got, ("hi", "lo", "pos", "strand")
            ):
                np.testing.assert_array_equal(
                    a, b, err_msg=f"guess={guess} {name}"
                )
            assert _N_GUESS[Tp] == n  # guess updated to the real count
    finally:
        set_pad_ratchet(None)


def test_find_anchors_gid_filtered_path_matches_cpu():
    """The ratchet gid path (device sort + new-group flags + on-device
    group-size filter, 1 uint32/row fetch) must produce the exact anchor
    groups of the unratcheted path, including MAX_ANCHOR_FRAGMENTS
    filtering and dedupe."""
    from npge_tpu.algo.anchors import find_anchors
    from npge_tpu.config import default_config
    from npge_tpu.ops.kmers import set_pad_ratchet

    arena = synthetic_arena(
        n_genomes=3, length=9000, seed=13, sub_rate=0.01, indel_rate=0.001
    )
    # small repeat guard so the size filter actually drops groups
    cfg = default_config().replace(
        ANCHOR_SIZE=15, MINIMIZER_WINDOW=4, MAX_ANCHOR_FRAGMENTS=3
    )
    base = find_anchors(arena, cfg)
    try:
        set_pad_ratchet(True)
        ratcheted = find_anchors(arena, cfg)
    finally:
        set_pad_ratchet(None)
    assert base.n_groups == ratcheted.n_groups > 10
    np.testing.assert_array_equal(base.offsets, ratcheted.offsets)
    np.testing.assert_array_equal(base.pos, ratcheted.pos)
    np.testing.assert_array_equal(base.seq_id, ratcheted.seq_id)
    np.testing.assert_array_equal(base.strand, ratcheted.strand)


def test_gid_filtered_scan_fuzz():
    """Fuzz the ratchet gid path (device sort + filter + 1-word fetch)
    against the plain path over random worlds: N runs, tiny arenas, many
    sequences, varied k/w/MAX_ANCHOR_FRAGMENTS, repeated scans at shared
    padded sizes (exercising the per-size guess/cap floors)."""
    from npge_tpu.algo.anchors import find_anchors
    from npge_tpu.config import default_config
    from npge_tpu.ops.kmers import set_pad_ratchet

    rng = np.random.default_rng(99)
    worlds = []
    for t in range(12):
        n = int(rng.integers(1, 5))
        L = int(rng.integers(40, 4000))
        arena = synthetic_arena(
            n_genomes=n, length=L, seed=int(rng.integers(1 << 30)),
            sub_rate=float(rng.uniform(0, 0.05)),
            indel_rate=float(rng.uniform(0, 0.005)),
        )
        # sprinkle N runs directly into the codes (assembly gaps)
        for s in range(arena.n_seqs):
            c = arena.seq_codes(s)
            if len(c) > 30 and rng.random() < 0.7:
                p = int(rng.integers(0, len(c) - 10))
                c[p : p + int(rng.integers(1, 9))] = 4
        cfg = default_config().replace(
            ANCHOR_SIZE=int(rng.integers(5, 32)),
            MINIMIZER_WINDOW=int(rng.integers(1, 12)),
            MAX_ANCHOR_FRAGMENTS=int(rng.integers(2, 300)),
        )
        worlds.append((arena, cfg))
    base = [find_anchors(a, c) for a, c in worlds]
    try:
        set_pad_ratchet(True)
        for (a, c), want in zip(worlds, base):
            got = find_anchors(a, c)
            assert got.n_groups == want.n_groups, (c.ANCHOR_SIZE, c.MINIMIZER_WINDOW)
            np.testing.assert_array_equal(got.offsets, want.offsets)
            np.testing.assert_array_equal(got.pos, want.pos)
            np.testing.assert_array_equal(got.seq_id, want.seq_id)
            np.testing.assert_array_equal(got.strand, want.strand)
    finally:
        set_pad_ratchet(None)
