"""Banded Smith-Waterman x-drop extension endpoints.

Batched pairwise extension alignment (SURVEY.md §7 step 3), replacing the
reference's per-block ``SimilarAligner``/``FragmentsExtender`` DP
(``src/algo/SimilarAligner.cpp`` ⚠[B]) with an anti-diagonal wavefront over
a fixed band.

Formulation (global-extension H-matrix):
    H(i, j) = best score aligning q[0..i) against t[0..j),
    H(0,0)=0, moves: diag + (MATCH|MISMATCH), up/left + GAP (linear gaps).
    X-drop: cells with H < best_so_far - X are pruned to -inf.
    Result per pair: (best score, best i, best j).

Band geometry (static schedule — no data-dependent control flow):
    On anti-diagonal d (= i + j), the band holds W cells r in [0, W) with
    i = ib(d) + r,  ib(d) = (d+1)//2 - W//2  (may be negative; such cells
    are masked invalid). With this un-clamped center-following schedule the
    wavefront shifts are *fixed per parity of d*:
        diag  source (i-1, j-1) at d-2 -> same band cell r
        up    source (i-1, j)   at d-1 -> r-1 (d even) / r (d odd)
        left  source (i,   j-1) at d-1 -> r   (d even) / r+1 (d odd)

Padded rows (one per pair, L + 2W bytes each, W = 128):
    qp[b, x]  = q_b[x - W]        (fill 254) -> q[i-1] at column W+ib-1+r
    trp[b, x] = t_b[L-1-(x-W-1)]  (fill 255) -> t[j-1] at column
                 W+1+L-d+ib+r
so both character windows of a diagonal ascend with r, and the two fill
values never compare equal.

Implementations, chosen by platform name (:func:`_platform`):
    "cpu" -> :func:`_sw_numpy_core`, the NumPy mirror. It is the
             specification and the reference the GPU path is tested against.
    "gpu" -> the CUDA kernel ``native/sw_hopper.cu`` (ops/sw_cuda.py).
:func:`sw_extend_reference` is the unbanded oracle for tests.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

NEG = -(1 << 29)
Q_FILL, T_FILL = 254, 255


def _platform() -> str:
    """The backend name the SW entry points route on; anything but the
    two supported platforms is an error, never a fallback."""
    p = jax.default_backend()
    if p not in ("gpu", "cpu"):
        raise RuntimeError(f"banded SW has no implementation for platform {p!r}")
    return p


def _pow2_batch(P: int) -> int:
    """Batch bucket of the device path: powers of two bound the compiled
    executables to log2(P) per process."""
    return 1 << max(0, max(P, 128) - 1).bit_length()


def _default_L(q_list, t_list) -> int:
    L = max(max((len(q) for q in q_list), default=1),
            max((len(t) for t in t_list), default=1))
    return max(1, -(-L // 128) * 128)


def pad_rows(q_list, t_list, L: int, W: int = 128):
    """Host padding of window lists (clipped to L) into the padded-row
    layout. Returns (qp, trp uint8[B, L+2W], qlen, tlen int32[B])."""
    B = len(q_list)
    qp = np.full((B, L + 2 * W), Q_FILL, np.uint8)
    trp = np.full((B, L + 2 * W), T_FILL, np.uint8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b, (q, t) in enumerate(zip(q_list, t_list)):
        q = np.asarray(q, np.uint8)[:L]
        t = np.asarray(t, np.uint8)[:L]
        qlen[b] = len(q)
        tlen[b] = len(t)
        qp[b, W : W + len(q)] = q
        trp[b, W + 1 + L - len(t) : W + 1 + L] = t[::-1]
    return qp, trp, qlen, tlen


def sw_extend_numpy(q_list, t_list, L=None, W=128, match=1, mismatch=-2,
                    gap=-3, xdrop=64):
    """NumPy mirror over window lists. Returns int32[B, 3] (best, best_i,
    best_j), bit-identical to the GPU kernel (the chip smoke test asserts
    it)."""
    if L is None:
        L = _default_L(q_list, t_list)
    qp, trp, qlen, tlen = pad_rows(q_list, t_list, L, W)
    return _sw_numpy_core(qp, trp, qlen[:, None], tlen[:, None], L, W, match,
                          mismatch, gap, xdrop)


def _sw_numpy_core(qp, trp, qlen, tlen, L, W, match, mismatch, gap, xdrop):
    """Band recurrence over padded [B, L+2W] rows; qlen/tlen are [B, 1]."""
    B = qp.shape[0]
    band = np.arange(W, dtype=np.int32)[None, :]
    prev2 = np.where(band == W // 2, 0, NEG).astype(np.int64)
    prev2 = np.broadcast_to(prev2, (B, W)).copy()
    i1 = (1 - W // 2) + band
    j1 = 1 - i1
    ok1 = ((i1 == 1) & (j1 == 0) & (qlen >= 1)) | (
        (i1 == 0) & (j1 == 1) & (tlen >= 1)
    )
    prev = np.where(ok1, gap, NEG).astype(np.int64)
    best = np.maximum(0, prev.max(axis=1, keepdims=True))
    bi = np.zeros((B, 1), np.int64)
    bj = np.zeros((B, 1), np.int64)
    for d in range(2, 2 * L + 1):
        ib = (d + 1) // 2 - W // 2
        i = ib + band
        j = d - i
        qs = qp[:, np.clip(W + ib - 1 + band, 0, qp.shape[1] - 1)[0]]
        ts = trp[:, np.clip(W + 1 + L - d + ib + band, 0, trp.shape[1] - 1)[0]]
        sub = np.where(qs == ts, match, mismatch)
        if d % 2 == 0:
            up = np.concatenate([np.full((B, 1), NEG), prev[:, :-1]], axis=1)
            left = prev
        else:
            up = prev
            left = np.concatenate([prev[:, 1:], np.full((B, 1), NEG)], axis=1)
        inside = (i <= qlen) & (j <= tlen)
        s = np.maximum(
            np.where((i >= 1) & (j >= 1) & inside, prev2 + sub, NEG),
            np.maximum(
                np.where((i >= 1) & inside & (j >= 0), up + gap, NEG),
                np.where((j >= 1) & inside & (i >= 0), left + gap, NEG),
            ),
        )
        s = np.where(s < best - xdrop, NEG, s)
        col_best = s.max(axis=1, keepdims=True)
        improved = col_best > best
        first_r = np.where(s == col_best, band, W).min(axis=1, keepdims=True)
        ii = ib + first_r
        jj = d - ii
        bi = np.where(improved, ii, bi)
        bj = np.where(improved, jj, bj)
        best = np.maximum(best, col_best)
        prev2, prev = prev, s
    return np.concatenate([best, bi, bj], axis=1).astype(np.int32)


def _gpu_sw(qp, trp, qlen, tlen, *, L, W, match, mismatch, gap, xdrop):
    """GPU path over padded device rows: int32[P, 3] on device, from the
    CUDA kernel (ops/sw_cuda.py)."""
    if W != 128:
        raise ValueError(f"the GPU SW kernel has a fixed band of 128, got {W}")
    from npge_tpu.ops.sw_cuda import sw_xdrop_cuda

    return sw_xdrop_cuda(qp, trp, qlen, tlen, L=L, match=match,
                         mismatch=mismatch, gap=gap, xdrop=xdrop)


def _window_rows(xp, codes2, qb, qcap, tb, tcap, L, W, q_n, t_n):
    """Padded rows of contiguous windows codes2[qb : qb+qcap] (query) and
    codes2[tb : tb+tcap] (target), caps <= L, N codes (>= 4) mapped to
    q_n/t_n. ``xp`` is numpy or jax.numpy: one function for both paths."""
    s = xp.arange(L)
    hi = codes2.shape[0] - 1
    qwin = codes2[xp.minimum(qb[:, None] + s[None, :], hi)]
    qwin = xp.where(qwin >= 4, xp.uint8(q_n), qwin)
    q_core = xp.where(s[None, :] < qcap[:, None], qwin, xp.uint8(Q_FILL))
    twin = codes2[xp.minimum(tb[:, None] + s[None, :], hi)]
    twin = xp.where(twin >= 4, xp.uint8(t_n), twin)
    t_core = xp.where(s[None, :] < tcap[:, None], twin, xp.uint8(T_FILL))
    P = qb.shape[0]
    q_fill = xp.full((P, W), Q_FILL, xp.uint8)
    t_fill = xp.full((P, W), T_FILL, xp.uint8)
    qp = xp.concatenate([q_fill, q_core.astype(xp.uint8), q_fill], axis=1)
    trp = xp.concatenate(
        [t_fill[:, :1], t_fill, t_core[:, ::-1].astype(xp.uint8),
         t_fill[:, 1:]], axis=1,
    )
    return qp, trp


@partial(jax.jit, static_argnames=("L", "W", "q_n", "t_n"))
def _device_window_rows(codes2, qb, qcap, tb, tcap, *, L, W, q_n, t_n):
    return _window_rows(jnp, codes2, qb, qcap, tb, tcap, L, W, q_n, t_n)


def sw_extend_windows(
    codes2, qb, qcap, tb, tcap, L: int,
    q_n_code: int = 250, t_n_code: int = 251, W: int = 128,
    match: int = 1, mismatch: int = -2, gap: int = -3, xdrop: int = 64,
):
    """Batched x-drop endpoints over CONTIGUOUS windows of a flat array.

    Pair p aligns codes2[qb[p] : qb[p]+qcap[p]] against
    codes2[tb[p] : tb[p]+tcap[p]] (caps clipped to L). Bit-identical to
    building the window lists on host and calling :func:`sw_extend_auto`
    (parity-tested). N codes (>= 4) map to ``q_n_code``/``t_n_code`` so
    query-N never matches target-N, mirroring algo.gapext's sentinel
    convention. On the GPU the window gather runs on device from
    ``codes2`` (a device array there), so the host uploads only the
    (base, cap) descriptors."""
    P = len(qb)
    if P == 0:
        return np.zeros((0, 3), np.int32)
    qb = np.asarray(qb, np.int64)
    tb = np.asarray(tb, np.int64)
    qcap = np.minimum(np.asarray(qcap, np.int64), L)
    tcap = np.minimum(np.asarray(tcap, np.int64), L)
    sw = dict(match=match, mismatch=mismatch, gap=gap, xdrop=xdrop)
    if _platform() == "gpu":
        Bp = _pow2_batch(P)

        def padded(a):  # pad rows: cap 0, base 0 -> all fill
            out = np.zeros(Bp, np.int32)
            out[:P] = a
            return jnp.asarray(out)

        caps = padded(qcap), padded(tcap)
        qp, trp = _device_window_rows(
            jnp.asarray(codes2), padded(qb), caps[0], padded(tb), caps[1],
            L=L, W=W, q_n=q_n_code, t_n=t_n_code,
        )
        out = _gpu_sw(qp, trp, caps[0], caps[1], L=L, W=W, **sw)
        return np.asarray(out)[:P]
    qp, trp = _window_rows(
        np, np.asarray(codes2), qb, qcap, tb, tcap, L, W, q_n_code, t_n_code
    )
    return _sw_numpy_core(
        qp, trp, qcap[:, None], tcap[:, None], L, W, match, mismatch, gap,
        xdrop,
    )


def sw_extend_auto(q_list, t_list, L=None, W=128, match=1, mismatch=-2,
                   gap=-3, xdrop=64):
    """Batched x-drop extension endpoints over window lists, by platform:
    the GPU path on "gpu", the NumPy mirror on "cpu". Returns int32[B, 3]."""
    kw = dict(match=match, mismatch=mismatch, gap=gap, xdrop=xdrop)
    if not q_list:
        return np.zeros((0, 3), np.int32)
    if L is None:
        L = _default_L(q_list, t_list)
    if _platform() == "gpu":
        B = len(q_list)
        pad = [np.zeros(0, np.uint8)] * (_pow2_batch(B) - B)
        rows = pad_rows(list(q_list) + pad, list(t_list) + pad, L, W)
        out = _gpu_sw(*map(jnp.asarray, rows), L=L, W=W, **kw)
        return np.asarray(out)[:B]
    return sw_extend_numpy(q_list, t_list, L=L, W=W, **kw)


def sw_extend_reference(q, t, match=1, mismatch=-2, gap=-3, xdrop=64):
    """Unbanded NumPy oracle of the same x-drop recurrence (for tests).

    Mirrors the banded pruning semantics: pruning compares against the
    best score over strictly earlier anti-diagonals; ties at the
    per-diagonal max resolve to the smallest i (the smallest band index).
    """
    n, m = len(q), len(t)
    H = np.full((n + 1, m + 1), NEG, np.int64)
    H[0, 0] = 0
    best, bi, bj = 0, 0, 0
    for d in range(1, n + m + 1):
        i_lo = max(0, d - m)
        i_hi = min(n, d)
        cand = []
        for i in range(i_lo, i_hi + 1):
            j = d - i
            s = NEG
            if i >= 1 and j >= 1 and H[i - 1, j - 1] > NEG // 2:
                s = max(s, H[i - 1, j - 1] + (match if q[i - 1] == t[j - 1] else mismatch))
            if i >= 1 and H[i - 1, j] > NEG // 2:
                s = max(s, H[i - 1, j] + gap)
            if j >= 1 and H[i, j - 1] > NEG // 2:
                s = max(s, H[i, j - 1] + gap)
            if s < best - xdrop:
                s = NEG
            H[i, j] = s
            cand.append((s, i, j))
        d_best = max(cand, key=lambda c: (c[0], -c[1]))
        if d_best[0] > best:
            best, bi, bj = d_best
    return best, bi, bj
