"""Canonical k-mer scan + minimizer sampling + anchor grouping (device).

Device replacement for the reference's ``AnchorFinder`` inner machinery
(``src/algo/AnchorFinder.cpp`` ⚠[B], SURVEY.md §3.2): the reference slides a
polynomial rolling hash per position and uses a Bloom filter to find repeated
hashes. Here instead:

  - the 2-bit k-mer *value* itself is the key (k <= 32, held as a
    (hi, lo) uint32 pair) — a perfect hash, so the reference's
    "verify actual string equality after hash grouping" pass is unnecessary
    by construction (N-containing windows are masked out);
  - strand canonicalization is lexicographic min(kmer, revcomp kmer),
    mirroring the reference's min(hash, complement_hash) [B];
  - repeated-key detection is sort + segment boundaries
    (the data-parallel replacement for the Bloom filter, SURVEY §2.6);
  - optional (w,k)-minimizer sampling thins candidate positions
    shift-invariantly (homologous loci sample the same k-mers), computed as
    window-max of window-min — O(log w) shifted-min passes, all elementwise work.

Everything here is jnp on flat arrays: one fused scan over the whole
concatenated arena, no per-sequence host loop.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

UINT_MAX = jnp.uint32(0xFFFFFFFF)


def _pair_min(ah, al, bh, bl):
    """Lexicographic elementwise min of (hi,lo) uint32 pairs."""
    take_a = (ah < bh) | ((ah == bh) & (al <= bl))
    return jnp.where(take_a, ah, bh), jnp.where(take_a, al, bl)


def _pair_max(ah, al, bh, bl):
    take_a = (ah > bh) | ((ah == bh) & (al >= bl))
    return jnp.where(take_a, ah, bh), jnp.where(take_a, al, bl)


def _shift_pair(h, l, d, fill):
    """(h,l) shifted left by d (x[i] <- x[i+d]), padded with `fill`."""
    h = jnp.concatenate([h[d:], jnp.full((d,), fill, jnp.uint32)])
    l = jnp.concatenate([l[d:], jnp.full((d,), fill, jnp.uint32)])
    return h, l


def _window_reduce_pair(h, l, w, op, fill):
    """Sliding window reduce over windows [i, i+w) via doubling passes."""
    if w <= 1:
        return h, l
    m = 1
    gh, gl = h, l
    while m * 2 <= w:
        sh, sl = _shift_pair(gh, gl, m, fill)
        gh, gl = op(gh, gl, sh, sl)
        m *= 2
    if m < w:
        sh, sl = _shift_pair(gh, gl, w - m, fill)
        gh, gl = op(gh, gl, sh, sl)
    return gh, gl


@partial(jax.jit, static_argnames=("k",))
def kmer_scan(codes: jax.Array, seq_id_of: jax.Array, k: int):
    """Per-position canonical k-mer keys.

    Args:
        codes: uint8[T] base codes (0..4), the whole arena.
        seq_id_of: int32[T] sequence id per position.
        k: k-mer length, 1 <= k <= 32.

    Returns:
        (canon_hi, canon_lo): uint32[T] canonical key (valid positions only)
        strand: int8[T]  +1 if forward form is canonical, -1 if revcomp,
                0 for palindromes (dropped downstream)
        valid: bool[T]   window fits in one sequence and contains no N
    """
    if not (1 <= k <= 32):
        raise ValueError("k must be in [1, 32]")
    T = codes.shape[0]
    c = codes.astype(jnp.uint32)
    pad = jnp.full((k,), 4, jnp.uint32)
    cext = jnp.concatenate([c, pad])
    sid_ext = jnp.concatenate([seq_id_of, jnp.full((k,), -1, jnp.int32)])

    f_hi = jnp.zeros(T, jnp.uint32)
    f_lo = jnp.zeros(T, jnp.uint32)
    r_hi = jnp.zeros(T, jnp.uint32)
    r_lo = jnp.zeros(T, jnp.uint32)
    has_n = jnp.zeros(T, jnp.bool_)
    lo_n = min(k, 16)  # forward: last lo_n bases in lo, first k-lo_n in hi
    for i in range(k):
        ci = jax.lax.dynamic_slice(cext, (i,), (T,))
        has_n = has_n | (ci >= 4)
        cr = 3 - ci  # complement (valid where not N; masked by has_n)
        # forward value: base i contributes at weight 4^(k-1-i)
        if k - 1 - i < 16:
            f_lo = f_lo + (ci << jnp.uint32(2 * (k - 1 - i)))
        else:
            f_hi = f_hi + (ci << jnp.uint32(2 * (k - 1 - i - 16)))
        # revcomp value: complement of base i contributes at weight 4^i
        if i < 16:
            r_lo = r_lo + (cr << jnp.uint32(2 * i))
        else:
            r_hi = r_hi + (cr << jnp.uint32(2 * (i - 16)))

    same_seq = jax.lax.dynamic_slice(sid_ext, (k - 1,), (T,)) == seq_id_of
    valid = same_seq & ~has_n

    fwd_min = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    palindrome = (f_hi == r_hi) & (f_lo == r_lo)
    canon_hi = jnp.where(fwd_min, f_hi, r_hi)
    canon_lo = jnp.where(fwd_min, f_lo, r_lo)
    strand = jnp.where(
        palindrome, jnp.int8(0), jnp.where(fwd_min, jnp.int8(1), jnp.int8(-1))
    )
    return canon_hi, canon_lo, strand, valid


@partial(jax.jit, static_argnames=("w",))
def minimizer_mask(canon_hi, canon_lo, valid, w: int):
    """bool[T]: position is a (w,k)-minimizer occurrence.

    Definition: p is selected iff its key equals the minimum of at least one
    window of w consecutive k-mer keys containing p (all tying positions are
    selected — deterministic superset of leftmost-tie minimizers). Computed as
    windowmax_w(windowmin_w(keys)) == key. w=1 selects every valid position.
    """
    if w <= 1:
        return valid
    h = jnp.where(valid, canon_hi, UINT_MAX)
    l = jnp.where(valid, canon_lo, UINT_MAX)
    # wmin[s] = min over [s, s+w)
    wmin_h, wmin_l = _window_reduce_pair(h, l, w, _pair_min, UINT_MAX)
    # selected[p] <=> max over s in [p-w+1, p] of wmin[s] == key[p]
    # shift so window-max over [p-w+1, p] = reversed-window trick:
    # pad front with 0 (identity for max) by rolling
    T = h.shape[0]
    pad_h = jnp.concatenate([jnp.zeros((w - 1,), jnp.uint32), wmin_h])
    pad_l = jnp.concatenate([jnp.zeros((w - 1,), jnp.uint32), wmin_l])
    mh, ml = _window_reduce_pair(pad_h, pad_l, w, _pair_max, jnp.uint32(0))
    mh, ml = mh[:T], ml[:T]
    return valid & (mh == h) & (ml == l)


@jax.jit
def kmer_scan_dyn(codes: jax.Array, seq_id_of: jax.Array, k):
    """`kmer_scan` with a TRACED k (bit-identical results, tests assert it).

    One compiled executable serves every k in 1..32 for a given arena shape
    — the reseed loop shrinks k each round, and a static k would compile
    once per k. The k-length window accumulation runs as a
    `lax.fori_loop` over the maximum k with masked contributions.
    """
    T = codes.shape[0]
    KMAX = 32
    c = codes.astype(jnp.uint32)
    pad = jnp.full((KMAX,), 4, jnp.uint32)
    cext = jnp.concatenate([c, pad])
    sid_ext = jnp.concatenate([seq_id_of, jnp.full((KMAX,), -1, jnp.int32)])
    k = jnp.asarray(k, jnp.int32)

    def body(i, st):
        f_hi, f_lo, r_hi, r_lo, has_n = st
        ci = jax.lax.dynamic_slice(cext, (i,), (T,))
        on = i < k
        has_n = has_n | (on & (ci >= 4))
        cr = 3 - ci
        # forward: weight 4^(k-1-i); revcomp: complement at weight 4^i
        sf = 2 * (k - 1 - i)
        add_lo = on & (sf < 32)
        add_hi = on & (sf >= 32)
        f_lo = f_lo + jnp.where(
            add_lo, ci << jnp.clip(sf, 0, 31).astype(jnp.uint32), 0
        )
        f_hi = f_hi + jnp.where(
            add_hi, ci << jnp.clip(sf - 32, 0, 31).astype(jnp.uint32), 0
        )
        sr = 2 * i
        r_lo = r_lo + jnp.where(
            on & (sr < 32), cr << jnp.clip(sr, 0, 31).astype(jnp.uint32), 0
        )
        r_hi = r_hi + jnp.where(
            on & (sr >= 32),
            cr << jnp.clip(sr - 32, 0, 31).astype(jnp.uint32),
            0,
        )
        return (f_hi, f_lo, r_hi, r_lo, has_n)

    z = jnp.zeros(T, jnp.uint32)
    f_hi, f_lo, r_hi, r_lo, has_n = jax.lax.fori_loop(
        0, KMAX, body, (z, z, z, z, jnp.zeros(T, jnp.bool_))
    )
    same_seq = jax.lax.dynamic_slice(sid_ext, (k - 1,), (T,)) == seq_id_of
    valid = same_seq & ~has_n
    fwd_min = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    palindrome = (f_hi == r_hi) & (f_lo == r_lo)
    canon_hi = jnp.where(fwd_min, f_hi, r_hi)
    canon_lo = jnp.where(fwd_min, f_lo, r_lo)
    strand = jnp.where(
        palindrome, jnp.int8(0), jnp.where(fwd_min, jnp.int8(1), jnp.int8(-1))
    )
    return canon_hi, canon_lo, strand, valid


def _shl_pair(h, l, s: int):
    """(hi,lo) << s bits, s STATIC in [0, 64]. No carries needed by the
    ladder (shifted-in low bits are always zero before the OR)."""
    if s == 0:
        return h, l
    if s >= 64:
        z = jnp.zeros_like(l)
        return z, z
    if s >= 32:
        return l << jnp.uint32(s - 32) if s > 32 else l, jnp.zeros_like(l)
    return (h << jnp.uint32(s)) | (l >> jnp.uint32(32 - s)), l << jnp.uint32(s)


def _ladder_levels(vals: jax.Array):
    """Doubling ladder of big-endian 2-bit polynomial values.

    vals: uint32[E] base codes over the extended domain. Returns
    {m: (hi, lo)} for m in 1,2,4,8,16,32 where level m holds the value of
    the m-wide window starting at each position (positions whose window
    runs off the end hold garbage — callers mask via the N ladder).
    V_{2m}(t) = V_m(t) << 2m | V_m(t+m): all shifts static, no loops.
    """
    E = vals.shape[0]
    lv = {1: (jnp.zeros(E, jnp.uint32), vals)}
    for m in (1, 2, 4, 8, 16):
        h, l = lv[m]
        sh = jnp.concatenate([h[m:], jnp.zeros(m, jnp.uint32)])
        sl = jnp.concatenate([l[m:], jnp.zeros(m, jnp.uint32)])
        hh, ll = _shl_pair(h, l, 2 * m)
        lv[2 * m] = (hh | sh, ll | sl)
    return lv


def _ladder_n(nmask: jax.Array):
    """{m: bool[E]} OR-ladder: window [t, t+m) contains an N (True fill —
    windows running off the end are invalid)."""
    E = nmask.shape[0]
    lv = {1: nmask}
    for m in (1, 2, 4, 8, 16):
        x = lv[m]
        lv[2 * m] = x | jnp.concatenate(
            [x[m:], jnp.ones(m, jnp.bool_)]
        )
    return lv


def _assemble_k(lv, ln, k, E: int):
    """Combine ladder levels into the k-wide window value (k TRACED).

    Walks k's bits MSB->LSB: acc <<= 2m then ORs in level m at the
    accumulated offset (one traced-start dynamic_slice per level — the
    only dynamic indexing in the whole scan). Returns (hi, lo, has_n)
    over the full extended domain."""
    acc_h = jnp.zeros(E, jnp.uint32)
    acc_l = jnp.zeros(E, jnp.uint32)
    acc_n = jnp.zeros(E, jnp.bool_)
    off = jnp.int32(0)
    zpad = jnp.zeros(32, jnp.uint32)
    npad = jnp.ones(32, jnp.bool_)
    for m in (32, 16, 8, 4, 2, 1):
        take = (k & m) > 0
        h, l = lv[m]
        th = jax.lax.dynamic_slice(jnp.concatenate([h, zpad]), (off,), (E,))
        tl = jax.lax.dynamic_slice(jnp.concatenate([l, zpad]), (off,), (E,))
        tn = jax.lax.dynamic_slice(
            jnp.concatenate([ln[m], npad]), (off,), (E,)
        )
        sh_h, sh_l = _shl_pair(acc_h, acc_l, 2 * m)
        acc_h = jnp.where(take, sh_h | th, acc_h)
        acc_l = jnp.where(take, sh_l | tl, acc_l)
        acc_n = jnp.where(take, acc_n | tn, acc_n)
        off = off + jnp.where(take, jnp.int32(m), jnp.int32(0))
    return acc_h, acc_l, acc_n


@jax.jit
def kmer_scan_ladder(codes: jax.Array, seq_id_of: jax.Array, k):
    """``kmer_scan_dyn`` re-formulated as a log-step ladder (bit-identical,
    tests assert): static-shift doubling levels + six traced-offset
    dynamic slices, NO fori_loop and NO per-iteration dynamic slicing —
    a far smaller compile surface, and plain elementwise work at run
    time. The reverse complement reuses the same ladder on the reversed
    complemented arena: R_k(p) = F_k^{rev-comp}(E - k - p), realized as
    one traced-start slice of the reversed ladder output.
    """
    T = codes.shape[0]
    KMAX = 32
    k = jnp.asarray(k, jnp.int32)
    c = codes.astype(jnp.uint32)
    cext = jnp.concatenate([c, jnp.full((KMAX,), 4, jnp.uint32)])
    E = T + KMAX
    nmask = cext >= 4
    # forward ladder on the arena
    f_h, f_l, has_n = _assemble_k(
        _ladder_levels(cext), _ladder_n(nmask), k, E
    )
    f_hi, f_lo = f_h[:T], f_l[:T]
    has_n = has_n[:T]
    # revcomp via the mirrored ladder: crev[t] = 3 - cext[E-1-t]
    crev = (jnp.uint32(3) - cext[::-1]) & jnp.uint32(0xFFFFFFFF)
    g_h, g_l, _ = _assemble_k(
        _ladder_levels(crev), _ladder_n(nmask[::-1]), k, E
    )
    # R_k(p) = G_k(E - k - p) = rev(G_k)[p + k - 1]
    r_hi = jax.lax.dynamic_slice(
        jnp.concatenate([g_h[::-1], jnp.zeros(KMAX, jnp.uint32)]),
        (k - 1,), (T,),
    )
    r_lo = jax.lax.dynamic_slice(
        jnp.concatenate([g_l[::-1], jnp.zeros(KMAX, jnp.uint32)]),
        (k - 1,), (T,),
    )
    sid_ext = jnp.concatenate([seq_id_of, jnp.full((KMAX,), -1, jnp.int32)])
    same_seq = jax.lax.dynamic_slice(sid_ext, (k - 1,), (T,)) == seq_id_of
    valid = same_seq & ~has_n
    fwd_min = (f_hi < r_hi) | ((f_hi == r_hi) & (f_lo < r_lo))
    palindrome = (f_hi == r_hi) & (f_lo == r_lo)
    canon_hi = jnp.where(fwd_min, f_hi, r_hi)
    canon_lo = jnp.where(fwd_min, f_lo, r_lo)
    strand = jnp.where(
        palindrome, jnp.int8(0), jnp.where(fwd_min, jnp.int8(1), jnp.int8(-1))
    )
    return canon_hi, canon_lo, strand, valid


@partial(jax.jit, static_argnames=("w",))
def _scan_select(codes, seq_id_of, k, w: int):
    """Fused scan + minimizer selection; returns device arrays
    (canon_hi, canon_lo, strand, selection mask, count). Everything stays
    on device — only the int32 count (4 bytes) need cross to the host. k
    is traced (one compile per arena shape, not per k)."""
    canon_hi, canon_lo, strand, valid = kmer_scan_ladder(
        codes, seq_id_of, k
    )
    sel = minimizer_mask(canon_hi, canon_lo, valid, w) & (strand != 0)
    return canon_hi, canon_lo, strand, sel, jnp.sum(sel, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("cap",))
def _compact_rows(canon_hi, canon_lo, strand, sel, cap: int):
    """Device-side compaction of the selected rows (no host
    unpackbits/flatnonzero hop, no index upload). Returns ONE [3, cap]
    uint32 buffer — (key_hi, key_lo, pos|strand-sign<<31) — so the host
    pays a single readback instead of four. The first ``count`` rows are the selected occurrences in ascending
    position order; the tail is fill. Positions are int32 (arena padded
    length < 2^31, guarded by the caller); selected strands are only
    ever +-1 (palindromic windows are excluded upstream), so the sign
    bit losslessly encodes strand."""
    Tp = sel.shape[0]
    idx = jnp.nonzero(sel, size=cap, fill_value=Tp)[0]
    pad = idx >= Tp
    safe = jnp.where(pad, 0, idx)
    h = jnp.where(pad, UINT_MAX, canon_hi[safe])
    l = jnp.where(pad, UINT_MAX, canon_lo[safe])
    neg = (~pad) & (strand[safe] < 0)
    p = jnp.where(pad, Tp, idx).astype(jnp.uint32)
    packed = p | (neg.astype(jnp.uint32) << 31)
    return jnp.stack([h, l, packed])


@partial(jax.jit, static_argnames=("w", "cap"))
def _scan_compact(codes, seq_id_of, k, w: int, cap: int):
    """Fused scan + minimizer selection + compaction in ONE dispatch.

    Returns (buf [3, cap] uint32, count): h rows, l rows, packed
    pos|strand rows (same encoding as _compact_rows). The caller fetches
    the scalar count first (tiny) and then only a pow2-snapped PREFIX of
    the buffer — the full floored cap (50 MB at the 17x1Mb shapes) is
    far larger than the real reseed-round rows (~2 MB). If count > cap the rows are truncated and the
    caller must retry with a larger cap (the cap ratchet makes this a
    once-per-process event)."""
    canon_hi, canon_lo, strand, valid = kmer_scan_ladder(codes, seq_id_of, k)
    sel = minimizer_mask(canon_hi, canon_lo, valid, w) & (strand != 0)
    cnt = jnp.sum(sel, dtype=jnp.uint32)
    Tp = sel.shape[0]
    idx = jnp.nonzero(sel, size=cap, fill_value=Tp)[0]
    pad = idx >= Tp
    safe = jnp.where(pad, 0, idx)
    h = jnp.where(pad, UINT_MAX, canon_hi[safe])
    l = jnp.where(pad, UINT_MAX, canon_lo[safe])
    neg = (~pad) & (strand[safe] < 0)
    p = jnp.where(pad, Tp, idx).astype(jnp.uint32)
    packed = p | (neg.astype(jnp.uint32) << 31)
    return jnp.stack([h, l, packed]), cnt


@jax.jit
def _sort_pack(buf, cnt):
    """Sort compacted rows by (key_hi, key_lo, position) ON DEVICE and
    prepend the count as column 0, so the host learns count AND rows in a
    single readback instead of a count sync followed by a prefix fetch.
    Row keys are unique
    (positions are), so any comparison sort yields np.lexsort's exact
    order; fill rows (key UINT_MAX, pos = padded length > any real pos)
    sort strictly after every real row."""
    h, l, packed = buf[0], buf[1], buf[2]
    pos = packed & jnp.uint32(0x7FFFFFFF)
    order = jnp.lexsort((pos, l, h))
    first = jnp.full((3, 1), cnt, jnp.uint32)
    rows = jnp.stack([h[order], l[order], packed[order]])
    return jnp.concatenate([first, rows], axis=1)


@jax.jit
def _sort_pack_gid(buf, cnt, maxf):
    """:func:`_sort_pack` variant that drops the 64-bit keys from the
    fetched buffer entirely: after the device sort, consumers only need
    GROUP BOUNDARIES (key != previous key), never the key values — so one
    uint32 per row is read back instead of three (the initial 17 Mbp
    scan's row fetch was ~50 MB). The group-SIZE filter also runs
    on device (keep 2 <= size <= maxf, whole groups), so only surviving
    occurrences are fetched at all — most selected k-mers sit in size-1
    groups that the host would discard anyway. Layout per row:
    bit 31 = strand sign, bit 30 = new-group flag, bits 0..29 = position
    (callers guarantee padded arena < 2^30; ops route to the key-carrying
    path above that). Element 0 = kept count, element 1 = selected count
    (the cap-retry signal); rows start at element 2."""
    h, l, packed = buf[0], buf[1], buf[2]
    cap = h.shape[0]
    pos = packed & jnp.uint32(0x7FFFFFFF)
    order = jnp.lexsort((pos, l, h))
    hs, ls, ps = h[order], l[order], packed[order]
    new = jnp.concatenate(
        [
            jnp.ones(1, jnp.bool_),
            (hs[1:] != hs[:-1]) | (ls[1:] != ls[:-1]),
        ]
    )
    i = jnp.arange(cap, dtype=jnp.int32)
    valid = i < cnt.astype(jnp.int32)
    newv = new & valid
    BIG = jnp.int32(cap)
    start = jax.lax.cummax(jnp.where(newv, i, -1))
    nxt = jnp.where(newv, i, BIG)[::-1]
    nxt = jax.lax.cummin(nxt)[::-1]
    # next group start AFTER row i (exclusive): suffix-min shifted by one
    nxt = jnp.concatenate([nxt[1:], jnp.full((1,), BIG, jnp.int32)])
    size = jnp.minimum(nxt, cnt.astype(jnp.int32)) - start
    keep = valid & (size >= 2) & (size <= jnp.asarray(maxf, jnp.int32))
    kept_cnt = jnp.sum(keep, dtype=jnp.uint32)
    idx = jnp.nonzero(keep, size=cap, fill_value=cap)[0]
    pad = idx >= cap
    safe = jnp.where(pad, 0, idx)
    out = jnp.where(
        pad,
        UINT_MAX,
        ps[safe] | (new[safe].astype(jnp.uint32) << 30),
    )
    head = jnp.stack([kept_cnt, cnt.astype(jnp.uint32)])
    return jnp.concatenate([head, out])


@jax.jit
def _sid_from_offsets(offsets, codes_p):
    """int32 sequence id per (padded) position, built ON DEVICE from the
    tiny offsets table. Saves the 4 bytes/position host->device seq_id
    upload, which would recur every reseed round. Padding positions
    (>= offsets[-1]) get -1 (never valid)."""
    pos = jnp.arange(codes_p.shape[0], dtype=jnp.int64)
    sid = jnp.searchsorted(offsets, pos, side="right").astype(jnp.int32) - 1
    return jnp.where(pos >= offsets[-1], jnp.int32(-1), sid)


@jax.jit
def sort_selected(canon_hi, canon_lo, positions, strand):
    """Sort candidate occurrences by (key_hi, key_lo, position).

    Deterministic total order — the backbone of reproducible grouping and of
    the N-host all_gather + dedup merge (SURVEY §7 hard part 4).
    """
    order = jnp.lexsort((positions, canon_lo, canon_hi))
    return (
        canon_hi[order],
        canon_lo[order],
        positions[order],
        strand[order],
    )


# Device-path switch. When on (on the GPU; tests force it on the CPU):
# the fused single-readback scan is used, its compaction cap holds a
# monotone floor (stable executable shape across reseed rounds whose
# counts vary), and the extension row-count floor (ops.extend) engages.
# Arena padding itself is a plain pow2 snap — each pow2 shape compiles
# once per machine (persistent XLA cache; `cli warmup` pre-pays it).
# Padded positions scan as N windows (never valid), so results are
# pad-invariant (tested).
_PAD_FLOOR = [0]  # retained for API compat; no longer consulted
_CAP_FLOOR: dict[int, int] = {}  # per padded-arena-size compaction cap
_RATCHET: list[bool | None] = [None]


def set_pad_ratchet(on: bool | None) -> None:
    """Force the device-path switch on/off (None = auto: on iff the
    backend is "gpu"). Controls the fused-scan path + cap floor here AND the
    extension row-count floor (ops.extend), which keys off the same
    switch."""
    _RATCHET[0] = on
    if not on:
        _PAD_FLOOR[0] = 0
        _CAP_FLOOR.clear()
        _N_GUESS.clear()
        from npge_tpu.ops.extend import reset_rows_floor

        reset_rows_floor()


def _ratchet_on() -> bool:
    if _RATCHET[0] is None:
        return jax.default_backend() == "gpu"
    return _RATCHET[0]


# accumulated wall per phase across calls: scan_sync = dispatch + compute
# + first readback (count+rows fused on the device path); compact_fetch =
# top-up/row readbacks beyond the first; host_sort = np.lexsort — zero on
# the device path, which sorts on device
SCAN_TIMINGS = {"scan_sync": 0.0, "compact_fetch": 0.0, "host_sort": 0.0,
                "calls": 0}

# previous selected-row count per padded arena size: sizes the speculative
# single-readback prefix (reseed rounds scan same-bucket consensus arenas
# whose counts vary slowly)
_N_GUESS: dict[int, int] = {}


def reset_scan_timings() -> dict:
    prev = dict(SCAN_TIMINGS)
    for k_ in SCAN_TIMINGS:
        SCAN_TIMINGS[k_] = 0.0 if k_ != "calls" else 0
    return prev


def find_anchor_occurrences(
    codes: jax.Array, seq_id_of: jax.Array | None, k: int, w: int,
    offsets: np.ndarray | None = None, mesh=None, want_gid: bool = False,
    max_group: int = 1 << 30,
):
    """Full device pass: scan -> minimizer sample -> compact (device).

    Returns host numpy arrays (key_hi, key_lo, pos, strand), sorted by key
    then position, one row per sampled valid non-palindromic occurrence.

    With ``want_gid`` the return is (gid, pos, strand) instead: group ids
    of the sorted occurrences (same-key runs). On the device path this
    reads back only ONE uint32 per row (strand bit 31, new-group
    flag bit 30, position bits 0..29 — see :func:`_sort_pack_gid`); the
    64-bit keys never leave the device. Arenas padded to >= 2^30 fall
    back to the key-carrying fetch with host-derived gids.

    Inputs are padded to a power-of-2 length (N sentinel / seq_id -1) before
    the scan so consensus arenas of nearby sizes hit one compiled scan
    (SURVEY §7 hard part 3); padded positions can never be valid (they scan
    as N windows). Pass ``offsets`` (the arena's offsets table) INSTEAD of
    ``seq_id_of`` to build the per-position sequence ids on device — the
    preferred path on the GPU.

    Host-device traffic per scan: codes upload (1 B/pos), count readback (4 B),
    compact rows readback (13 B/row, row count rounded to a power of two).
    Compaction happens on device (no bitmask readback, no index upload,
    no host unpackbits/flatnonzero over the arena).
    """
    T = int(codes.shape[0])
    # pow2 snap only — no monotone pad floor: the persistent XLA cache +
    # the cli warmup verb make each pow2 shape a once-per-machine compile,
    # and a floor would make every ~1 Mb reseed consensus scan pay the
    # full 2^25-shape compute + fetch of the 17x1Mb world's main scan.
    Tp = 1 << max(0, T - 1).bit_length()
    if Tp >= 1 << 31:
        raise ValueError("arena too large for int32 positions")
    if Tp != T:
        if isinstance(codes, np.ndarray):
            # host-side pad: a device jnp.pad would compile one (tiny)
            # program per arena size, and the reseed loop sees a new size
            # every round
            codes = np.pad(codes, (0, Tp - T), constant_values=4)
        else:
            codes = jnp.pad(codes, (0, Tp - T), constant_values=4)
    if mesh is not None and Tp % mesh.devices.size == 0:
        # position-sharded scan: inputs ride the mesh, XLA SPMD inserts the
        # halo exchanges for the shifted-window ops (SURVEY §2.6); the
        # compacted outputs are replicated, tiny, and bit-identical to the
        # single-device pass (tests assert)
        from jax.sharding import NamedSharding, PartitionSpec as P

        codes = jax.device_put(codes, NamedSharding(mesh, P("d")))
    if seq_id_of is None:
        seq_id_of = _sid_from_offsets(
            jnp.asarray(np.asarray(offsets, np.int64)), codes
        )
    elif Tp != T:
        seq_id_of = jnp.pad(seq_id_of, (0, Tp - T), constant_values=-1)
    if mesh is not None and Tp % mesh.devices.size == 0:
        from jax.sharding import NamedSharding, PartitionSpec as P

        seq_id_of = jax.device_put(seq_id_of, NamedSharding(mesh, P("d")))
    import time as _time

    SCAN_TIMINGS["calls"] += 1
    if _ratchet_on():
        # device path: one fused scan dispatch + one device sort+pack
        # dispatch (both async), then a SINGLE blocking readback of a
        # speculative pow2 prefix — column 0 carries the count, so the
        # common case costs exactly one readback. The prefix is sized by the previous count at this
        # padded arena size; a short guess tops up with a second fetch,
        # a truncated cap (count > cap) retries and raises the floor.
        gid_mode = want_gid and Tp < (1 << 30)
        # cap floor is PER padded arena size: a global floor made every
        # ~2 MB reseed consensus scan sort+compact at the 17 Mbp initial
        # scan's 4M-row cap (device sort over mostly fill rows)
        cap = min(Tp, max(1 << 14, _CAP_FLOOR.get(Tp, 0)))
        while True:
            _t0 = _time.perf_counter()
            buf, cnt = _scan_compact(codes, seq_id_of, k, w, cap)
            out = (
                _sort_pack_gid(buf, cnt, max_group) if gid_mode
                else _sort_pack(buf, cnt)
            )
            guess = _N_GUESS.get(Tp, 0)
            hdr = 2 if gid_mode else 1
            if guess:
                m = min(cap, max(1 << 12, 1 << (guess - 1).bit_length()))
                # eager prefix slice: one tiny XLA program per (cap, m)
                # pair, persistently cached; moves counts + 4 or 12 B * m
                flat = np.asarray(
                    out[: m + hdr] if gid_mode else out[:, : m + 1]
                )
                n = int(flat[0] if gid_mode else flat[0, 0])
                n_sel = int(flat[1]) if gid_mode else n
            else:  # first scan at this size: count-first, then prefix
                n_sel = int(cnt)
                n = None
                m = 0
            SCAN_TIMINGS["scan_sync"] += _time.perf_counter() - _t0
            if n_sel <= cap:
                break
            cap = min(Tp, 1 << (n_sel - 1).bit_length())
        _CAP_FLOOR[Tp] = max(_CAP_FLOOR.get(Tp, 0), cap)
        if n is None:
            if gid_mode:
                # count-first path: the kept count lives in the header
                _t0 = _time.perf_counter()
                n = int(np.asarray(out[:1])[0])
                SCAN_TIMINGS["scan_sync"] += _time.perf_counter() - _t0
            else:
                n = n_sel
        _N_GUESS[Tp] = n
        if n == 0:
            e = np.zeros(0)
            if want_gid:
                return e.astype(np.int64), e.astype(np.int64), e.astype(np.int8)
            return (
                e.astype(np.uint32), e.astype(np.uint32),
                e.astype(np.int64), e.astype(np.int8),
            )
        if n > m:  # no guess, or the speculative prefix fell short
            _t0 = _time.perf_counter()
            m = min(cap, max(1 << 12, 1 << (n - 1).bit_length()))
            flat = np.asarray(
                out[: m + hdr] if gid_mode else out[:, : m + 1]
            )
            SCAN_TIMINGS["compact_fetch"] += _time.perf_counter() - _t0
        if gid_mode:
            rows = flat[2 : n + 2]
            s = np.where(rows >> 31, -1, 1).astype(np.int8)
            gid = (
                np.cumsum((rows >> 30) & np.uint32(1)).astype(np.int64) - 1
            )
            idx = (rows & np.uint32(0x3FFFFFFF)).astype(np.int64)
            return gid, idx, s
        h, l, packed = (
            flat[0, 1 : n + 1], flat[1, 1 : n + 1], flat[2, 1 : n + 1]
        )
        s = np.where(packed >> 31, -1, 1).astype(np.int8)
        idx = (packed & np.uint32(0x7FFFFFFF)).astype(np.int64)
        if want_gid:  # huge-arena fallback: derive gids from the keys
            new = np.ones(n, bool)
            new[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1])
            return np.cumsum(new).astype(np.int64) - 1, idx, s
        return h, l, idx, s  # device-sorted by (key_hi, key_lo, pos)
    else:
        # CPU backend: count-first keeps the compaction sized to the
        # result (no wasted padded compute, no retry re-scan)
        _t0 = _time.perf_counter()
        canon_hi, canon_lo, strand, sel, cnt = _scan_select(
            codes, seq_id_of, k, w
        )
        n = int(cnt)  # 4-byte sync; all big arrays stay device-resident
        SCAN_TIMINGS["scan_sync"] += _time.perf_counter() - _t0
        if n == 0:
            e = np.zeros(0)
            if want_gid:
                return e.astype(np.int64), e.astype(np.int64), e.astype(np.int8)
            return (
                e.astype(np.uint32), e.astype(np.uint32),
                e.astype(np.int64), e.astype(np.int8),
            )
        cap = min(Tp, max(1 << 14, 1 << (n - 1).bit_length()))
        _t0 = _time.perf_counter()
        buf = np.asarray(
            _compact_rows(canon_hi, canon_lo, strand, sel, cap)
        )
        SCAN_TIMINGS["compact_fetch"] += _time.perf_counter() - _t0
        h, l, packed = buf[0, :n], buf[1, :n], buf[2, :n]
    s = np.where(packed >> 31, -1, 1).astype(np.int8)
    _t0 = _time.perf_counter()
    idx = (packed & np.uint32(0x7FFFFFFF)).astype(np.int64)
    order = np.lexsort((idx, l, h))
    SCAN_TIMINGS["host_sort"] += _time.perf_counter() - _t0
    h, l, idx, s = h[order], l[order], idx[order], s[order]
    if want_gid:
        new = np.ones(n, bool)
        new[1:] = (h[1:] != h[:-1]) | (l[1:] != l[:-1])
        return np.cumsum(new).astype(np.int64) - 1, idx, s
    return h, l, idx, s
