"""Batched gapless group extension (device, jnp).

Device analog of the reference's ``FragmentsExtender``
(``src/algo/FragmentsExtender.cpp`` ⚠[B], SURVEY.md §2.3): every anchor
group's fragments are extended column-by-column in lockstep, in both
directions, while the extended prefix stays above MIN_IDENTITY and ends on an
identical column. Identity thresholds are exact integer rationals.

Memory layout trick (uniform forward windows): with the doubled arena
``codes2 = codes ++ revcomp(codes)`` (length 2T), the column-s character of
ANY fragment in ANY direction is ``codes2[base + s]`` for a per-fragment
scalar base:

    right extension:  base = hi            (ori=+1)   | 2T - lo   (ori=-1)
    left  extension:  base = 2T - lo       (ori=+1)*  | hi        (ori=-1)*

(*) the left-side reads come out complemented, which is harmless: the
extension rule only compares characters for equality and N-ness, both
invariant under complement. No per-element orientation selects, no reversal
— and every window is a contiguous ascending read (DMA-able by a future
Pallas kernel). Advancing an extension by e columns is simply ``base += e``
for every fragment, both strands.

Shapes are static: B groups x F fragments x S columns per chunk; ragged
reality is handled by host-side bucketing + masking (SURVEY §7 hard part 2).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def make_codes2(codes: jax.Array) -> jax.Array:
    """codes ++ revcomp(codes); rc[x] = complement(codes[T-1-x])."""
    comp = jnp.where(codes < 4, 3 - codes, codes)
    return jnp.concatenate([codes, comp[::-1]])


_LANE = 128  # row size of the 2-D arena view


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


@partial(jax.jit, static_argnames=("rows",))
def _make_codes2_rows_p(codes: jax.Array, rows: int) -> jax.Array:
    codes2 = make_codes2(codes)
    pad = rows * _LANE - codes2.shape[0]
    return jnp.pad(codes2, (0, pad), constant_values=4).reshape(-1, _LANE)


# row-count floor, mirroring ops.kmers: every arena in a process pads to
# at least the largest row count seen, so the reseed loop's shrinking
# consensus arenas reuse the main arena's compiled extension executables
# instead of compiling one set per power-of-2 size. Controlled by the same
# switch as the scan's cap floor (on iff the backend is "gpu", or forced
# in tests).
_ROWS_FLOOR = [0]


def reset_rows_floor() -> None:
    _ROWS_FLOOR[0] = 0


def make_codes2_rows(codes: jax.Array) -> jax.Array:
    """Doubled arena reshaped to [N, 128] rows (padded with N=4 sentinel).

    The production extension path gathers whole 128-byte rows instead of
    single bytes, then aligns windows in-register with a
    log-step shift (see ``window_rows``). At least one extra all-sentinel row
    is appended so a window's trailing row read never needs clamping logic
    that could alias real data; the row count is rounded up to a power of two
    (and floored process-wide on the GPU) so consensus arenas reuse one
    compiled extension kernel (SURVEY §7 hard part 3: recompilation
    pressure in the fixed-point loop).
    """
    from npge_tpu.ops.kmers import _ratchet_on

    rows = _next_pow2(int(codes.shape[0]) * 2 // _LANE + 2)
    if _ratchet_on():
        rows = max(rows, _ROWS_FLOOR[0])
        _ROWS_FLOOR[0] = rows
    return _make_codes2_rows_p(codes, rows)


@partial(jax.jit, static_argnames=("chunk",))
def window_rows(codes2_rows: jax.Array, base: jax.Array, chunk: int):
    """ch[B, F, S] = codes2[base + s] for s in [0, chunk).

    Row-granular gather (slice size 128 along the minor dim) + 7 log-step
    lane shifts by ``base % 128`` — no per-byte gathers.
    Out-of-range reads return the N sentinel (4); callers mask by cap/bounds
    anyway.
    """
    B, F = base.shape
    R = chunk // _LANE + 1
    row0 = base // _LANE
    rows = row0[..., None] + jnp.arange(R, dtype=base.dtype)
    NR = codes2_rows.shape[0]
    # clamp to the sentinel row (last row is all-N padding)
    rows = jnp.where((rows < 0) | (rows >= NR), NR - 1, rows)
    w = jnp.take(codes2_rows, rows, axis=0)  # [B, F, R, 128]
    w = w.reshape(B, F, R * _LANE)
    off = (base % _LANE)[..., None]
    for b in range(7):  # 2**7 == _LANE
        t = 1 << b
        w = jnp.where((off >> b) & 1 == 1, jnp.roll(w, -t, axis=-1), w)
    return w[..., :chunk]


def _extend_core(ch, within, fmask, carry_len, carry_ident, ident_num, ident_den):
    """Column logic shared by both window producers.

    ch[B,F,S] int32 codes; within[B,F,S] bool (in-cap, in-arena). Returns
    (ext[B], new_len[B], new_ident[B]) — see ``extend_chunk``.
    """
    usable_f = within & (ch < 4)  # per-fragment usable
    # masked min/max over fragments to test all-equal
    BIG, SMALL = jnp.int32(255), jnp.int32(-1)
    eff_for_max = jnp.where(fmask[..., None], jnp.where(usable_f, ch, BIG), SMALL)
    eff_for_min = jnp.where(fmask[..., None], jnp.where(usable_f, ch, BIG), BIG)
    col_max = eff_for_max.max(axis=1)  # [B, S]
    col_min = eff_for_min.min(axis=1)
    col_usable = (fmask[..., None] <= usable_f).all(axis=1)  # mask -> usable
    col_ident = col_usable & (col_min == col_max) & (col_max < 4)

    # hard stop at first unusable column
    usable_prefix = jnp.cumprod(col_usable.astype(jnp.int32), axis=1) == 1
    ident_eff = col_ident & usable_prefix
    cnt = jnp.cumsum(ident_eff.astype(jnp.int32), axis=1)  # [B, S]
    S = ch.shape[-1]
    L = jnp.arange(1, S + 1, dtype=jnp.int32)[None, :]  # candidate lengths
    tot_len = carry_len[:, None] + L
    tot_cnt = carry_ident[:, None] + cnt
    ok = (
        usable_prefix
        & ident_eff  # last added column identical
        & (tot_cnt * jnp.int32(ident_den) >= jnp.int32(ident_num) * tot_len)
    )
    ext = jnp.max(jnp.where(ok, L, 0), axis=1)  # [B]
    # identical count at the chosen length (0 -> carry unchanged)
    i0 = jnp.maximum(ext - 1, 0)
    cnt_at = jnp.take_along_axis(cnt, i0[:, None], axis=1)[:, 0]
    new_ident = carry_ident + jnp.where(ext > 0, cnt_at, 0)
    return ext, carry_len + ext, new_ident


@partial(jax.jit, static_argnames=("chunk",))
def extend_chunk(
    codes2: jax.Array,   # uint8[2T] doubled arena
    base: jax.Array,     # int32[B, F] forward window base per fragment
    fmask: jax.Array,    # bool[B, F] fragment present
    cap: jax.Array,      # int32[B, F] max further columns this side (>=0)
    carry_len: jax.Array,    # int32[B] columns already extended this side
    carry_ident: jax.Array,  # int32[B] identical columns among them
    ident_num: int,
    ident_den: int,
    chunk: int,
):
    """Extend each group by up to `chunk` columns on one side.

    Returns ext[B] (0..chunk): the number of additional columns such that the
    *cumulative* extension (carry + ext) keeps
    identical_columns / total_columns >= ident_num/ident_den and the last
    added column is identical. A column is usable only if every present
    fragment has an in-cap real base there; the first unusable column hard-
    stops the scan.

    This is the byte-gather reference formulation (kept as the parity
    oracle; which formulation the GPU prefers is still open). Production path: ``extend_chunk_rows``.
    """
    s = jnp.arange(chunk, dtype=jnp.int32)  # [S]
    T2 = codes2.shape[0]
    idx = base[..., None] + s  # [B, F, S]
    ch = jnp.take(codes2, jnp.clip(idx, 0, T2 - 1), axis=0).astype(jnp.int32)
    within = (s[None, None, :] < cap[..., None]) & (idx >= 0) & (idx < T2)
    return _extend_core(
        ch, within, fmask, carry_len, carry_ident, ident_num, ident_den
    )


@partial(jax.jit, static_argnames=("chunk",))
def extend_chunk_rows(
    codes2_rows: jax.Array,  # uint8[N, 128] doubled arena, row view
    T2,                      # true (unpadded) doubled-arena length (traced)
    base: jax.Array,
    fmask: jax.Array,
    cap: jax.Array,
    carry_len: jax.Array,
    carry_ident: jax.Array,
    ident_num: int,
    ident_den: int,
    chunk: int,
):
    """``extend_chunk`` with the row-gather window producer.

    Bit-identical results to ``extend_chunk`` (tests assert it); the only
    difference is how the [B, F, S] character windows are materialized:
    128-byte row gathers + log-step lane shifts instead of per-byte gathers.
    """
    s = jnp.arange(chunk, dtype=jnp.int32)
    ch = window_rows(codes2_rows, base, chunk).astype(jnp.int32)
    idx = base[..., None] + s
    within = (s[None, None, :] < cap[..., None]) & (idx >= 0) & (idx < T2)
    return _extend_core(
        ch, within, fmask, carry_len, carry_ident, ident_num, ident_den
    )


@partial(
    jax.jit,
    static_argnames=("ident_num", "ident_den", "chunk", "max_rounds"),
)
def extend_rounds_rows(
    codes2_rows: jax.Array,
    T2,
    base: jax.Array,      # int32[B, F]
    fmask: jax.Array,     # bool[B, F]
    cap: jax.Array,       # int32[B, F]
    ident_num: int,
    ident_den: int,
    chunk: int,
    max_rounds: int,
    carry_len=None,       # int32[B] columns already extended (tail resume)
    carry_ident=None,     # int32[B] identical columns among them
    start_round=None,     # int32 scalar: rounds already executed
):
    """All extension rounds fused into ONE device dispatch.

    Semantically identical to the host loop in :func:`extend_side` (tests
    assert it): after each chunk, groups that did not consume the full chunk
    are frozen (cap -> 0) so results never depend on other groups in the
    batch triggering more rounds (batch-composition determinism, SURVEY §7
    hard part 4). A ``lax.while_loop`` exits early once every group froze —
    no per-round host sync, no per-round dispatch latency.

    ``carry_len``/``carry_ident``/``start_round`` resume a batch whose
    first round(s) already ran (the round-1-for-all + compacted-tail
    scheme in algo/extender): ``base``/``cap`` must already reflect the
    executed rounds; the returned total counts only the NEW rounds here.
    """
    B = base.shape[0]
    z = jnp.zeros(B, jnp.int32)
    cl0 = z if carry_len is None else carry_len
    ci0 = z if carry_ident is None else carry_ident
    r0 = jnp.int32(0) if start_round is None else jnp.asarray(
        start_round, jnp.int32
    )

    def cond(state):
        r, *_rest, cont = state
        return cont & (r < max_rounds)

    def body(state):
        r, base, cap, cl, ci, total, _ = state
        ext, cl, ci = extend_chunk_rows(
            codes2_rows, T2, base, fmask, cap, cl, ci,
            ident_num, ident_den, chunk,
        )
        active = ext == chunk
        base = base + ext[:, None]
        cap = jnp.where(
            active[:, None], jnp.maximum(cap - ext[:, None], 0), 0
        )
        return (r + 1, base, cap, cl, ci, total + ext, active.any())

    state = (r0, base, cap, cl0, ci0, z, jnp.bool_(True))
    state = jax.lax.while_loop(cond, body, state)
    return state[5], state[0]


def extend_sides_fused(
    codes2_rows, T2, base_l, base_r, fmask, cap_l, cap_r,
    ident_num: int, ident_den: int, chunk: int, max_rounds: int,
):
    """Both sides of every group in a single device dispatch.

    Stacks left/right along the batch axis (they are independent problems)
    and runs :func:`extend_rounds_rows` once. Returns device arrays
    (ext_left[B], ext_right[B], rounds_executed) — callers may defer the
    host sync; `rounds_executed` feeds the honest real-cells counter."""
    base = jnp.concatenate([jnp.asarray(base_l), jnp.asarray(base_r)])
    cap = jnp.concatenate([jnp.asarray(cap_l), jnp.asarray(cap_r)])
    fm = jnp.asarray(fmask)
    fm2 = jnp.concatenate([fm, fm])
    B = base_l.shape[0]
    total, rounds = extend_rounds_rows(
        codes2_rows, T2, base, fm2, cap, ident_num, ident_den,
        chunk, max_rounds,
    )
    return total[:B], total[B:], rounds


def extend_side(
    codes2, base, fmask, cap, ident_num, ident_den,
    chunk: int = 512, max_rounds: int = 8,
    codes2_rows=None, T2: int | None = None,
):
    """Host-driven chunked extension on one side. Returns total ext[B].

    Pass ``codes2_rows``+``T2`` (from :func:`make_codes2_rows`) to use the
    row-gather production path; with only ``codes2`` the byte-gather oracle
    formulation runs.
    """
    B = base.shape[0]
    base = jnp.asarray(base)
    cap = jnp.asarray(cap)
    carry_len = jnp.zeros(B, jnp.int32)
    carry_ident = jnp.zeros(B, jnp.int32)
    total = np.zeros(B, np.int32)
    for _ in range(max_rounds):
        if codes2_rows is not None:
            ext, carry_len, carry_ident = extend_chunk_rows(
                codes2_rows, T2, base, fmask, cap, carry_len, carry_ident,
                ident_num, ident_den, chunk,
            )
        else:
            ext, carry_len, carry_ident = extend_chunk(
                codes2, base, fmask, cap, carry_len, carry_ident,
                ident_num, ident_den, chunk,
            )
        ext_np = np.asarray(ext)
        total += ext_np
        if not (ext_np == chunk).any():
            break
        # Groups that did NOT consume the full chunk are frozen (cap -> 0):
        # their result must not depend on other groups in the batch
        # triggering more rounds — batch-composition determinism
        # (SURVEY §7 hard part 4).
        active = jnp.asarray(ext_np == chunk)[:, None]
        e = jnp.asarray(ext_np)[:, None]
        base = base + e
        cap = jnp.where(active, jnp.maximum(cap - e, 0), 0)
    return total


def bases_for_groups(pos, end, ori, T: int):
    """Per-occurrence forward-window bases into codes2 for both sides.

    pos/end: arena-global [lo, hi) of the current interval; ori +-1.
    Returns (base_left, base_right) — see module docstring."""
    pos = np.asarray(pos, np.int64)
    end = np.asarray(end, np.int64)
    ori = np.asarray(ori, np.int64)
    base_r = np.where(ori == 1, end, 2 * T - pos)
    base_l = np.where(ori == 1, 2 * T - pos, end)
    return base_l.astype(np.int32), base_r.astype(np.int32)


def extend_groups(
    codes,
    lo,
    hi,
    ori,
    fmask,
    cap_left,
    cap_right,
    ident_num: int,
    ident_den: int,
    chunk: int = 512,
    max_rounds: int = 8,
    codes2=None,
    T: int | None = None,
    codes2_rows=None,
):
    """Two-sided extension (compatibility API over the codes2 layout).

    ``codes`` may be the plain arena (codes2/codes2_rows built on the fly),
    or pass ``codes2``+``T`` (oracle path) / ``codes2_rows``+``T`` (row-
    gather production path) directly to reuse the doubled arena across calls.
    """
    if codes2 is None and codes2_rows is None:
        T = int(codes.shape[0])
        codes2_rows = make_codes2_rows(jnp.asarray(codes))
    assert T is not None
    T2 = 2 * T
    base_l, base_r = bases_for_groups(
        np.asarray(lo), np.asarray(hi), np.asarray(ori), T
    )
    fmask = jnp.asarray(fmask)
    el = extend_side(
        codes2, base_l, fmask, np.asarray(cap_left, np.int32),
        ident_num, ident_den, chunk, max_rounds,
        codes2_rows=codes2_rows, T2=T2,
    )
    er = extend_side(
        codes2, base_r, fmask, np.asarray(cap_right, np.int32),
        ident_num, ident_den, chunk, max_rounds,
        codes2_rows=codes2_rows, T2=T2,
    )
    return el, er
