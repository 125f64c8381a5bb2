"""Gapped flank extension — grow admitted blocks through indels.

Equivalent of the reference's gapped ``FragmentsExtender`` semantics
(``src/algo/FragmentsExtender.cpp`` ⚠[B], SURVEY.md §2.3): extend every
block's fragments by a bounded flank window, re-align the extended flanks,
and trim back to the last good column, so homology containing indels joins
the block instead of stopping it (the gapless lockstep extender stops at the
first frame shift).

Batched decomposition (instead of the reference's per-block host DP):

  1. Flank *endpoints* for all (block, side, fragment) pairs are computed by
     ONE batched banded-SW x-drop pass (ops/sw.py: the CUDA kernel on the
     GPU, its bit-identical NumPy mirror on the CPU), pairing each fragment's
     flank against the block's representative (fragment 0) flank.
  2. The lockstep advance A of the representative is min over fragments of
     the query endpoint.  Only pairs that actually extend pay for step 3.
  3. Per accepted pair, a small host NW (vectorized rows, fixed query A,
     free target end) recovers the alignment path; paths merge into one
     flank MSA by center-star on the representative's positions.
  4. The MSA is trimmed to the last column that keeps the whole block good:
     column good (identical+gapless), cumulative identity >= MIN_IDENTITY,
     and the trailing MIN_END window all-good.

Runs AFTER overlap resolution on the admitted (non-overlapping) blocks, with
per-fragment room taken from the shared FragmentIndex (model/fragindex.py) —
shared gaps are split deterministically so extensions can never collide, and
the partition invariant is preserved by construction.

Side geometry rides the doubled rc-arena (ops/extend.py codes2): every
flank, both sides, both orientations, is a contiguous ascending read; left-
side reads come out complemented uniformly across fragments, which is
harmless for alignment (equality is complement-invariant) and undone at
splice time (reverse columns + complement codes).
"""

from __future__ import annotations

import numpy as np

from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.blocks import Block, BlockSet
from npge_tpu.model.fragindex import FragmentIndex
from npge_tpu.model.fragments import FragmentTable
from npge_tpu.model.stats import column_classes
from npge_tpu.util import codes as C


def host_codes2(arena: GenomeArena) -> np.ndarray:
    """Host copy of the doubled rc-arena (codes ++ revcomp(codes)), cached
    on the arena object (arenas are immutable)."""
    c2 = getattr(arena, "_codes2_host", None)
    if c2 is None:
        codes = arena.codes
        comp = np.where(codes < 4, 3 - codes, codes).astype(np.uint8)
        c2 = np.concatenate([codes, comp[::-1]])
        arena._codes2_host = c2
    return c2


def _side_bases(frags: FragmentTable, arena: GenomeArena):
    """(base_left, base_right) int64 per fragment — forward-window bases into
    codes2 (same convention as ops.extend.bases_for_groups)."""
    T = arena.total_length
    lo = arena.offsets[frags.seq_id] + frags.start.astype(np.int64)
    hi = lo + frags.length
    ori = frags.ori.astype(np.int64)
    base_r = np.where(ori == 1, hi, 2 * T - lo)
    base_l = np.where(ori == 1, 2 * T - lo, hi)
    return base_l, base_r


def _nw_traceback(H, q, t, match: int, mismatch: int, gap: int):
    """Path recovery from a filled H grid (deterministic tie-breaks:
    smallest target end, diag > up > left). Returns (aligned, ins) — see
    :func:`_nw_fixed_query`."""
    A = len(q)
    j = int(np.argmax(H[A]))  # smallest j on ties
    aligned = np.full(A, -1, np.int16)
    ins: list[list[int]] = [[] for _ in range(A + 1)]
    i = A
    while i > 0 or j > 0:
        if i > 0 and j > 0 and H[i, j] == H[i - 1, j - 1] + (
            match if (t[j - 1] == q[i - 1] and q[i - 1] < 4) else mismatch
        ):
            aligned[i - 1] = t[j - 1]
            i -= 1
            j -= 1
        elif i > 0 and H[i, j] == H[i - 1, j] + gap:
            i -= 1
        else:
            ins[i].append(int(t[j - 1]))
            j -= 1
    return aligned, [np.array(x[::-1], np.uint8) for x in ins]


def _nw_fixed_query_batch(
    pairs: list, match: int, mismatch: int, gap: int,
    chunk_bytes: int = 1 << 28, no_fast: bool = False,
):
    """Batched :func:`_nw_fixed_query` over (q, t) pairs — bit-identical
    results (VERDICT r2 item 7: the per-pair row loop dominated gapext's
    host wall; here the A-row recurrence runs once per chunk, vectorized
    over pairs and target positions).

    Padding is inert: pair (A_p, T_p) entries of the padded H grid depend
    only on q[:A_p] / t[:T_p] (the running-max transform accumulates left
    to right), so every traceback reads exactly the values the per-pair
    code would produce.

    Exact-prefix fast path: when t[:len(q)] == q (with real bases — the
    sentinel N-codes never match), the NW optimum is the all-diagonal
    path ending at j = len(q) (diag is preferred on traceback ties and
    trailing target positions only add gap penalties, argmax ties break
    to the smallest j), so (aligned=q-window of t, no insertions) is
    bit-identical to the DP result. High-identity worlds resolve most
    flank pairs this way, skipping both the grid and the per-pair
    traceback loop (the dominant gapext host cost at 100 genomes)."""
    out = [None] * len(pairs)
    exact = []
    for p, (q, t) in enumerate(pairs):
        A = len(q)
        if not no_fast and (
            A == 0
            or (
                len(t) >= A
                and (q < 4).all()
                and np.array_equal(t[:A], q)
            )
        ):
            out[p] = (
                t[: A].astype(np.int16) if A else np.zeros(0, np.int16),
                [np.zeros(0, np.uint8) for _ in range(A + 1)],
            )
            exact.append(p)
    if len(exact) == len(pairs):
        return out
    order = sorted(
        (p for p in range(len(pairs)) if out[p] is None),
        key=lambda p: len(pairs[p][1]),
    )
    pos = 0
    while pos < len(order):
        # group pairs of similar target length to bound padded waste
        sel = [order[pos]]
        Amax = len(pairs[order[pos]][0])
        Tmax = len(pairs[order[pos]][1])
        while pos + len(sel) < len(order):
            np_ = order[pos + len(sel)]
            A2 = max(Amax, len(pairs[np_][0]))
            T2 = max(Tmax, len(pairs[np_][1]))
            if (len(sel) + 1) * (A2 + 1) * (T2 + 1) * 4 > chunk_bytes:
                break
            sel.append(np_)
            Amax, Tmax = A2, T2
        P = len(sel)
        qpad = np.full((P, Amax), 254, np.uint8)  # sentinels never match
        tpad = np.full((P, Tmax), 255, np.uint8)
        for r, p in enumerate(sel):
            q, t = pairs[p]
            qpad[r, : len(q)] = q
            tpad[r, : len(t)] = t
        jj = np.arange(Tmax + 1, dtype=np.int32)
        H = np.empty((P, Amax + 1, Tmax + 1), np.int32)
        H[:, 0] = gap * jj
        for i in range(1, Amax + 1):
            qi = qpad[:, i - 1][:, None]
            # N (code >= 4) never matches anything, including N
            sub = np.where((tpad == qi) & (qi < 4), match, mismatch)
            prev = H[:, i - 1]
            tmp = np.maximum(prev[:, :-1] + sub, prev[:, 1:] + gap)
            y = np.concatenate([prev[:, :1] + gap, tmp], axis=1) - gap * jj
            H[:, i] = np.maximum.accumulate(y, axis=1) + gap * jj
        for r, p in enumerate(sel):
            q, t = pairs[p]
            out[p] = _nw_traceback(
                H[r, : len(q) + 1, : len(t) + 1], q, t, match, mismatch, gap
            )
        pos += P
    return out


def _nw_fixed_query(q: np.ndarray, t: np.ndarray, match: int, mismatch: int,
                    gap: int):
    """Global-extension NW of the full query against a free-ended target.

    Returns (aligned, ins) where aligned[a] is the target code matched to
    query char a (or -1 for a deletion column) and ins[a] is the array of
    target codes inserted immediately BEFORE query char a. Trailing target
    insertions are not consumed. Vectorized by rows (the left dependency is
    a running max via the classic x[j] = H[i,j] - gap*j transform)."""
    return _nw_fixed_query_batch([(q, t)], match, mismatch, gap)[0]


def _merge_center_star(q: np.ndarray, results: list) -> np.ndarray:
    """MSA columns [F, C] from per-fragment (aligned, ins) paths against the
    shared representative q (row 0). Insertion slots between representative
    positions are sized by the max insertion run; runs are left-aligned."""
    A = len(q)
    Fm1 = len(results)
    # per-fragment insertion-run lengths [Fm1, A] (slot A, trailing, dropped)
    run_len = np.zeros((Fm1, A), np.int64)
    for fi, (aligned, ins) in enumerate(results):
        run_len[fi] = [len(ins[a]) for a in range(A)]
    n_ins = run_len.max(axis=0) if Fm1 else np.zeros(A, np.int64)
    # column layout: [ins slot a][match col a] repeated — match_col[a] is
    # the a-th match column, ins runs are left-aligned in their slot
    match_col = np.cumsum(n_ins) + np.arange(A)
    ins_col0 = match_col - n_ins
    Ccols = A + int(n_ins.sum())
    cols = np.full((Fm1 + 1, Ccols), C.GAP, np.uint8)
    cols[0, match_col] = q
    for fi, (aligned, ins) in enumerate(results, start=1):
        has = aligned >= 0
        cols[fi, match_col[has]] = aligned[has].astype(np.uint8)
        for a in np.flatnonzero(run_len[fi - 1]):
            c0 = int(ins_col0[a])
            cols[fi, c0 : c0 + int(run_len[fi - 1, a])] = ins[a]
    return cols


def _trim_good(cols: np.ndarray, good0: int, total0: int, cfg: Config) -> int:
    """Largest c such that columns [0, c) keep the extended block good:
    column c-1 good, trailing min(c, MIN_END) columns all good, and
    (good0 + good_in_ext) / (total0 + c) >= MIN_IDENTITY. Returns 0 when no
    prefix qualifies."""
    ident, gapless = column_classes(cols)
    good = ident & gapless
    n = len(good)
    if n == 0:
        return 0
    m = cfg.MIN_END
    cum = np.cumsum(good.astype(np.int64))
    # ok_tail[c-1]: the last min(c, m) columns of the prefix are all good
    bad_cum = np.cumsum((~good).astype(np.int64))
    c_arr = np.arange(1, n + 1)
    w = np.minimum(c_arr, m)
    bad_in_tail = bad_cum - np.where(
        c_arr - w > 0, bad_cum[c_arr - w - 1], 0
    )
    ok_tail = bad_in_tail == 0
    num, den = cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den
    ident_ok = (good0 + cum) * den >= num * (total0 + c_arr)
    ok = good & ok_tail & ident_ok
    hits = np.flatnonzero(ok)
    return int(hits[-1]) + 1 if len(hits) else 0


def _apply_side(
    b: Block, arena: GenomeArena, cols: np.ndarray, side: str
) -> Block:
    """Splice accepted extension columns into the block on one side.
    ``cols`` are in side-local space (ascending = outward); the left side is
    reversed + complemented back into block column space."""
    consumed = (cols != C.GAP).sum(axis=1).astype(np.int64)
    f = b.frags
    ori = f.ori.astype(np.int64)
    if side == "R":
        new_start = np.where(ori == 1, f.start, f.start - consumed)
        block_cols = cols
    else:
        new_start = np.where(ori == 1, f.start - consumed, f.start)
        block_cols = C.COMPLEMENT[cols][:, ::-1]
    new_len = f.length + consumed
    nf = FragmentTable(
        f.seq_id, new_start.astype(np.int32), new_len.astype(np.int32), f.ori
    )
    gapless_ext = not (block_cols == C.GAP).any()
    if b.is_gapless and gapless_ext:
        return Block(nf, None)
    rows = b.rows(arena)
    aln = (
        np.concatenate([rows, block_cols], axis=1)
        if side == "R"
        else np.concatenate([block_cols, rows], axis=1)
    )
    return Block(nf, aln)


def gapped_extend_blocks(
    bs: BlockSet, cfg: Config, timings=None, probe_cache: dict | None = None
) -> int:
    """Extend every multi-fragment block through its free flank room on both
    sides (gapped). Mutates ``bs.blocks`` in place; returns the number of
    side-extensions applied. Deterministic; preserves non-overlap (rooms are
    pre-split per FragmentIndex) and block goodness (trim rule).

    ``probe_cache`` memoizes NO-extension probes across calls, keyed by
    (block object, side, per-fragment caps): a job's outcome is a pure
    function of that key, blocks are immutable, and the pipeline preserves
    object identity for unchanged blocks — so reseed rounds stop re-running
    SW + path recovery on flanks that already proved unextendable (the
    dominant reseed-round host cost, VERDICT r3 weak #1/#3). Entries pin
    their block object, so ids cannot alias."""
    import time as _time

    def _book(phase, t0):
        if timings is not None:
            timings.add(f"gapext.{phase}", _time.perf_counter() - t0)
        return _time.perf_counter()

    _t = _time.perf_counter()
    arena = bs.arena
    blocks = bs.blocks
    multi = [i for i, b in enumerate(blocks) if b.n_frags >= 2]
    if not multi:
        return 0
    idx = FragmentIndex(arena, blocks)
    rr, rf = idx.per_block_rooms()
    codes2 = host_codes2(arena)
    FL = cfg.GAPPED_FLANK
    min_room = cfg.MIN_GAPPED_ROOM
    sw = dict(
        match=cfg.SW_MATCH, mismatch=cfg.SW_MISMATCH, gap=cfg.SW_GAP,
        xdrop=cfg.SW_XDROP,
    )

    # ---- assemble jobs: one per (block, side) with every fragment roomy ----
    # Each job captures its cache key NOW (pinning the ORIGINAL block
    # object): by store time blocks[bi] may already be the other side's
    # splice result, whose stats — and hence trim outcome — differ.
    jobs = []  # (bi, side, caps[F] int64, bases[F] int64, key)
    for bi in multi:
        b = blocks[bi]
        base_l, base_r = _side_bases(b.frags, arena)
        ori = b.frags.ori.astype(np.int64)
        room_rev = rr[bi]
        room_fwd = rf[bi]
        cap_r = np.where(ori == 1, room_fwd, room_rev)
        cap_l = np.where(ori == 1, room_rev, room_fwd)
        side_jobs = []
        for side, base, cap in (("L", base_l, cap_l), ("R", base_r, cap_r)):
            cap = np.minimum(cap, FL)
            if cap.min() >= min_room:
                key = (id(b), side, cap.tobytes())
                side_jobs.append((side, cap, base, key))
        # A cached no-ext outcome is a pure replay only if the sibling side
        # cannot change the block this pass: if the sibling runs fresh and
        # extends, a fresh run would re-probe this side against the spliced
        # block's larger good/total stats and could pass _trim_good where
        # the cached probe failed (round-4 advisor finding). So a hit is
        # honored only when EVERY roomy side of the block is a hit.
        hits = [
            probe_cache is not None and sj[3] in probe_cache
            for sj in side_jobs
        ]
        if side_jobs and all(hits):
            if timings is not None:
                timings.count("cache.gapext_probe_skip", len(side_jobs))
            continue  # proven unextendable under these exact caps
        for side, cap, base, key in side_jobs:
            jobs.append((bi, side, cap, base, b, key))
    if timings is not None:
        timings.count("cache.gapext_probe_run", len(jobs))
    if not jobs:
        return 0
    _t = _book("assemble", _t)

    # ---- one batched device pass for all flank-pair endpoints ----
    def flank(base, cap):
        return codes2[base : base + cap]

    # per-pair window bases/caps assembled VECTORIZED (the per-pair Python
    # slicing here cost seconds at 100+ genomes: ~150k pairs per pass);
    # on the GPU the window gather, padding and kernel run on device from
    # the cached codes2 device copy (ops.sw.sw_extend_windows)
    import jax as _jax

    from npge_tpu.ops.sw import sw_extend_windows

    sw_codes2 = codes2
    if _jax.default_backend() == "gpu":
        sw_codes2 = getattr(arena, "_codes2_dev", None)
        if sw_codes2 is None:
            import jax.numpy as _jnp

            sw_codes2 = _jnp.asarray(codes2)
            arena._codes2_dev = sw_codes2

    n_pairs = np.array([len(c) - 1 for (_b, _s, c, *_r) in jobs], np.int64)
    owner = np.repeat(np.arange(len(jobs)), n_pairs)
    qb = np.concatenate(
        [np.full(len(cap) - 1, base[0]) for (_b, _s, cap, base, *_r) in jobs]
    )
    qcap = np.concatenate(
        [np.full(len(cap) - 1, cap[0]) for (_b, _s, cap, *_r) in jobs]
    )
    tb = np.concatenate([base[1:] for (_b, _s, _c, base, *_r) in jobs])
    tcap = np.concatenate([cap[1:] for (_b, _s, cap, *_r) in jobs])
    n_all = len(qb)
    # multi-process data parallelism (VERDICT r4 weak #8): each process
    # runs the SW endpoint pass on a contiguous slice of the pair list,
    # then the per-pair endpoint rows allgather-merge — the job list is
    # deterministic and identical on every process, so the merged ends
    # (and everything downstream) are bit-identical to the single-process
    # run on every process.
    import jax

    pi, pc = jax.process_index(), jax.process_count()
    adv = np.full(len(jobs), np.int64(1) << 40)
    if pc > 1:
        from jax.experimental import multihost_utils

        from npge_tpu.parallel.distributed import host_slice

        a0, a1 = host_slice(n_all, pi, pc)
        part = sw_extend_windows(
            sw_codes2, qb[a0:a1], qcap[a0:a1], tb[a0:a1], tcap[a0:a1],
            L=FL, **sw,
        )
        cap_rows = -(-n_all // pc)
        buf = np.zeros((cap_rows, 3), np.int32)
        buf[: len(part)] = part
        g = multihost_utils.process_allgather(buf)  # [pc, cap_rows, 3]
        sizes = [
            host_slice(n_all, r, pc) for r in range(pc)
        ]
        ends = np.concatenate(
            [g[r, : b - a] for r, (a, b) in enumerate(sizes)]
        ) if n_all else np.zeros((0, 3), np.int32)
        if timings is not None:
            timings.count("mp.gapext_pairs_owned", a1 - a0)
            timings.count("gapext_pairs", n_all)
        np.minimum.at(adv, owner, ends[:, 1].astype(np.int64))
    else:
        # (a two-phase first-pair prefilter was tried and reverted: on
        # real worlds nearly every job's first pair extends a little, so
        # it saved <1% of pairs and paid a second dispatch per pass)
        ends = sw_extend_windows(sw_codes2, qb, qcap, tb, tcap, L=FL, **sw)
        np.minimum.at(adv, owner, ends[:, 1].astype(np.int64))
        if timings is not None:
            timings.count("gapext_pairs", n_all)

    _t = _book("sw", _t)

    # ---- per-job path recovery, merge, trim, splice ----
    stats_cache: dict[int, tuple[int, int]] = {}

    def block_stats(bi: int) -> tuple[int, int]:
        st = stats_cache.get(bi)
        if st is None:
            ident, gapless = column_classes(blocks[bi].rows(arena))
            st = (int((ident & gapless).sum()), blocks[bi].n_cols)
            stats_cache[bi] = st
        return st

    # ---- batched path recovery across ALL (job, fragment) pairs ----
    nw_pairs = []  # (q, t) in job order
    pair_job = []
    job_q: dict[int, np.ndarray] = {}
    for j, (bi, side, cap, base, _b0, _key) in enumerate(jobs):
        A = int(adv[j])
        if A <= 0:
            continue
        q = flank(int(base[0]), A)
        job_q[j] = q
        for fi in range(1, len(cap)):
            # target window: lockstep advance plus bounded indel slack (the
            # x-drop prefilter tolerates at most ~xdrop/|gap| net indels)
            tcap = int(min(cap[fi], A + cfg.SW_XDROP))
            nw_pairs.append((q, flank(int(base[fi]), max(tcap, 0))))
            pair_job.append(j)
    nw_out = _nw_fixed_query_batch(
        nw_pairs, cfg.SW_MATCH, cfg.SW_MISMATCH, cfg.SW_GAP
    )
    _t = _book("nw", _t)
    job_results: dict[int, list] = {j: [] for j in job_q}
    for r, j in zip(nw_out, pair_job):
        job_results[j].append(r)

    applied = 0
    for j, (bi, side, cap, base, _b0, _key) in enumerate(jobs):
        # no-ext results are cached only while blocks[bi] is still the
        # block the key captured: if the other side's splice already
        # replaced it, this outcome used the spliced block's stats and is
        # not a pure function of the key
        cacheable = probe_cache is not None and blocks[bi] is _b0
        if j not in job_q:
            if cacheable:  # adv <= 0: nothing to extend
                probe_cache[_key] = _b0
            continue
        q = job_q[j]
        cols = _merge_center_star(q, job_results[j])
        good0, total0 = block_stats(bi)
        c = _trim_good(cols, good0, total0, cfg)
        if c == 0:
            if cacheable:
                probe_cache[_key] = _b0
            continue
        cols = cols[:, :c]
        ident, gapless = column_classes(cols)
        blocks[bi] = _apply_side(blocks[bi], arena, cols, side)
        stats_cache[bi] = (
            good0 + int((ident & gapless).sum()), total0 + c
        )
        applied += 1
    _book("apply", _t)
    return applied
