"""Banded-SW x-drop endpoints: the NumPy mirror (the CPU path) against
the unbanded NumPy oracle, the GPU wrapper's padding, layout and routing,
and (marked ``gpu``) the CUDA path against the NumPy mirror.

Pairs in the oracle tests are kept short enough (< W/2) that the band
covers the whole DP matrix, so banded == unbanded exactly.
"""

import numpy as np
import pytest

from npge_tpu.ops import sw
from npge_tpu.ops.sw import (
    _sw_numpy_core, pad_rows, sw_extend_numpy, sw_extend_reference,
)
from npge_tpu.util import codes as C

SW = dict(match=1, mismatch=-2, gap=-3, xdrop=64)


def run_impl(qs, ts, L=128):
    return sw_extend_numpy(qs, ts, L=L)


def test_identical_sequences():
    q = C.encode("ACGTACGTACGTACGTACGT")
    out = run_impl([q], [q.copy()])
    best, bi, bj = out[0]
    assert (best, bi, bj) == (20, 20, 20)


def test_single_mismatch_and_xdrop_end():
    q = C.encode("ACGTACGTAC")
    t = q.copy()
    t[4] = (t[4] + 1) % 4
    out = run_impl([q], [t])
    assert tuple(out[0]) == sw_extend_reference(q, t)
    assert out[0][0] == 10 - 3  # 9 matches, 1 mismatch (-2)


def test_gap_handling():
    q = C.encode("ACGTACGTACGTACGT")
    t = np.concatenate([q[:8], C.encode("A"), q[8:]])  # insertion in t
    out = run_impl([q], [t])
    assert tuple(out[0]) == sw_extend_reference(q, t)
    # full-length alignment reached despite the gap
    assert out[0][1] == len(q) and out[0][2] == len(t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_pairs_match_oracle(seed):
    rng = np.random.default_rng(seed)
    qs, ts = [], []
    for _ in range(8):
        n = int(rng.integers(5, 60))
        q = rng.integers(0, 4, n).astype(np.uint8)
        t = q.copy()
        for p in range(len(t)):
            if rng.random() < 0.05:
                t[p] = (t[p] + 1) % 4
        if rng.random() < 0.5 and n > 10:
            t = np.delete(t, rng.integers(0, n, 2))
        qs.append(q)
        ts.append(t.astype(np.uint8))
    out = run_impl(qs, ts)
    for b in range(len(qs)):
        want = sw_extend_reference(qs[b], ts[b])
        assert tuple(out[b]) == want, f"pair {b}: got {tuple(out[b])} want {want}"


def test_empty_target():
    q = C.encode("ACGT")
    t = np.zeros(0, np.uint8)
    out = run_impl([q], [t])
    assert tuple(out[0]) == sw_extend_reference(q, t) == (0, 0, 0)


def test_batch_padding_rows_harmless():
    """Empty pairs (the device path's batch padding) score (0, 0, 0) and
    leave their neighbours' results alone."""
    q = C.encode("ACGTACGTACGT")
    e = np.zeros(0, np.uint8)
    out = run_impl([q, e, q], [q.copy(), e, q.copy()])
    assert tuple(out[0]) == tuple(out[2]) == (12, 12, 12)
    assert tuple(out[1]) == (0, 0, 0)


def flank_world(rng, P, L):
    """Flat code array and (qb, qcap, tb, tcap) descriptors of P gapext-like
    flank pairs: the target is the query mutated with substitutions,
    indels and runs of N; caps are ragged, some above L, some zero."""
    chunks, qb, tb = [], [], []
    off = 0
    for _ in range(P):
        q = rng.integers(0, 4, L + 64).astype(np.uint8)
        t = q.copy()
        sub = rng.random(len(t)) < rng.choice([0.0, 0.01, 0.05, 0.3])
        t[sub] = (t[sub] + rng.integers(1, 4, sub.sum())) % 4
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(t)))
            if rng.random() < 0.5:
                t = np.delete(t, slice(p, p + int(rng.integers(1, 9))))
            else:
                t = np.insert(t, p, rng.integers(0, 4, int(rng.integers(1, 9))))
        if rng.random() < 0.2:
            p = int(rng.integers(0, len(t)))
            t[p : p + int(rng.integers(1, 40))] = 4
        if rng.random() < 0.1:
            p = int(rng.integers(0, len(q)))
            q[p : p + int(rng.integers(1, 20))] = 4
        qb.append(off)
        tb.append(off + len(q))
        chunks += [q, t.astype(np.uint8)]
        off += len(q) + len(t)
    codes2 = np.concatenate(chunks)
    caps = lambda: np.where(  # noqa: E731
        rng.random(P) < 0.6, L + 64, rng.integers(0, L + 64, P)
    )
    return codes2, np.array(qb), caps(), np.array(tb), caps()


def test_sw_extend_windows_matches_list_path():
    """sw_extend_windows (vectorized contiguous-window build) must be
    bit-identical to building the window lists and calling
    sw_extend_auto — including N sentinels, cap clipping, and ragged
    caps."""
    from npge_tpu.ops.sw import sw_extend_auto, sw_extend_windows

    rng = np.random.default_rng(27)
    codes2 = rng.integers(0, 4, 8000).astype(np.uint8)
    codes2[rng.random(8000) < 0.01] = 4  # sprinkle N
    P, L = 37, 128
    qb = rng.integers(0, 6000, P)
    tb = np.minimum(qb + rng.integers(-30, 30, P), 6000)
    qcap = rng.integers(0, 200, P)  # some > L to exercise clipping
    tcap = rng.integers(0, 200, P)
    qs, ts = [], []
    for p in range(P):
        q = codes2[qb[p] : qb[p] + qcap[p]]
        t = codes2[tb[p] : tb[p] + tcap[p]]
        qs.append(np.where(q >= 4, np.uint8(250), q))
        ts.append(np.where(t >= 4, np.uint8(251), t))
    want = sw_extend_auto(qs, ts, L=L)
    got = sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L)
    np.testing.assert_array_equal(got, want)


def test_device_window_rows_match_host_rows():
    """The GPU path's on-device window gather builds exactly the padded
    rows the NumPy path builds (layout, fills, N mapping, cap clipping)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    L = 128
    codes2, qb, qcap, tb, tcap = flank_world(rng, 24, L)
    qcap, tcap = np.minimum(qcap, L), np.minimum(tcap, L)
    host = sw._window_rows(np, codes2, qb, qcap, tb, tcap, L, 128, 250, 251)
    dev = sw._device_window_rows(
        jnp.asarray(codes2), *map(jnp.asarray, (qb, qcap, tb, tcap)),
        L=L, W=128, q_n=250, t_n=251,
    )
    for h, d in zip(host, dev):
        assert h.shape == (24, L + 256) and h.dtype == np.uint8
        np.testing.assert_array_equal(np.asarray(d), h)
    lists = pad_rows(
        [np.where(codes2[a : a + c] >= 4, 250, codes2[a : a + c]) for a, c in zip(qb, qcap)],
        [np.where(codes2[a : a + c] >= 4, 251, codes2[a : a + c]) for a, c in zip(tb, tcap)],
        L,
    )
    np.testing.assert_array_equal(lists[0], host[0])
    np.testing.assert_array_equal(lists[1], host[1])


def test_gpu_platform_routes_to_gpu_path(monkeypatch):
    """On "gpu" both entry points pad the batch to a power of two and hand
    the padded rows to the GPU kernel wrapper (here a stand-in computing
    the mirror), never to the NumPy path; an unknown platform raises."""
    import jax

    rng = np.random.default_rng(11)
    L = 128
    codes2, qb, qcap, tb, tcap = flank_world(rng, 37, L)
    want = sw.sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L)
    calls = []

    def fake_gpu_sw(qp, trp, qlen, tlen, *, L, W, **kw):
        calls.append((qp.shape, trp.shape, qlen.shape, tlen.shape))
        return _sw_numpy_core(
            np.asarray(qp), np.asarray(trp), np.asarray(qlen)[:, None],
            np.asarray(tlen)[:, None], L, W, **kw,
        )

    def no_numpy(*a, **k):
        raise AssertionError("the GPU route reached the NumPy mirror")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(sw, "_gpu_sw", fake_gpu_sw)
    monkeypatch.setattr(sw, "_sw_numpy_core", no_numpy)
    got = sw.sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L)
    np.testing.assert_array_equal(got, want)
    qs = [codes2[a : a + min(c, L)] for a, c in zip(qb[:3], qcap[:3])]
    sw.sw_extend_auto(qs, qs, L=L)
    assert calls == [((128, L + 256),) * 2 + ((128,),) * 2] * 2

    monkeypatch.setattr(jax, "default_backend", lambda: "metal")
    with pytest.raises(RuntimeError, match="metal"):
        sw.sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L)
    with pytest.raises(RuntimeError, match="metal"):
        sw.sw_extend_auto(qs, qs, L=L)


def test_gpu_kernel_band_is_fixed():
    with pytest.raises(ValueError, match="band of 128"):
        sw._gpu_sw(None, None, None, None, L=128, W=64, **SW)


def test_pow2_batch_bucket():
    assert [sw._pow2_batch(p) for p in (1, 128, 129, 1000, 4096)] == [
        128, 128, 256, 1024, 4096,
    ]


@pytest.mark.gpu
def test_gpu_path_matches_mirror_at_gapext_shape(gpu):
    """The GPU path (device window gather + kernel) is bit-identical to
    ``_sw_numpy_core`` at the gapext shape W=128, L=512 on 4096 flank
    pairs."""
    L, P = 512, 4096
    codes2, qb, qcap, tb, tcap = flank_world(np.random.default_rng(2024), P, L)
    qcap_c, tcap_c = np.minimum(qcap, L), np.minimum(tcap, L)
    qp, trp = sw._window_rows(np, codes2, qb, qcap_c, tb, tcap_c, L, 128,
                              250, 251)
    want = _sw_numpy_core(qp, trp, qcap_c[:, None], tcap_c[:, None], L, 128,
                          **SW)
    got = sw.sw_extend_windows(codes2, qb, qcap, tb, tcap, L=L, **SW)
    np.testing.assert_array_equal(got, want)
    assert (want[:, 0] > 0).mean() > 0.5  # the pairs do extend
    n = 200  # the window-list entry point takes the same GPU path
    qs = [r[128 : 128 + c] for r, c in zip(qp[:n], qcap_c[:n])]
    ts = [r[129 : 129 + L][::-1][:c] for r, c in zip(trp[:n], tcap_c[:n])]
    np.testing.assert_array_equal(sw.sw_extend_auto(qs, ts, L=L, **SW),
                                  want[:n])
