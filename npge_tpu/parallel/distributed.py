"""Multi-process runtime: jax.distributed + the process-sharded pipeline.

The reference is a single shared-memory process (SURVEY.md §2.6 — no
distributed backend exists there). Here genomes can be processed
data-parallel by several processes, one per card, with the arena
replicated per process; partial results merge via gather + deterministic
sorted dedup so the blockset is bit-identical to a single-process run
(SURVEY §7 step 7).

This module provides:
  - init_distributed(): jax.distributed.initialize from JAX's standard
    settings, one card per process (a no-op without a coordinator);
  - process-partitioned anchor scan: each process scans its slice of
    arena positions (halo-free: the arena is replicated, only the scan
    range is partitioned), then occurrences all-gather over processes via
    jax.experimental.multihost_utils and merge through the same
    deterministic (key, position) sort as the single-process path.
"""

from __future__ import annotations

import os

import numpy as np

from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.algo.anchors import AnchorGroups, form_groups


def init_distributed() -> tuple[int, int]:
    """Start jax.distributed when ``JAX_COORDINATOR_ADDRESS`` is set, with
    ``JAX_NUM_PROCESSES`` processes, this one being ``JAX_PROCESS_ID``.
    Each process opens only its own card (local device ``JAX_PROCESS_ID``
    of one host): a JAX process reserves most of every card it opens, so
    a second process on the same card would fail for want of memory.
    Returns (process_index, process_count)."""
    import jax

    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coord:
        pid = int(os.environ["JAX_PROCESS_ID"])
        jax.distributed.initialize(
            coordinator_address=coord,
            num_processes=int(os.environ["JAX_NUM_PROCESSES"]),
            process_id=pid,
            local_device_ids=[pid],
        )
    return jax.process_index(), jax.process_count()


def host_slice(total: int, pi: int, pc: int) -> tuple[int, int]:
    """Deterministic contiguous partition of [0, total) across processes."""
    per = -(-total // pc)
    lo = min(pi * per, total)
    hi = min(lo + per, total)
    return lo, hi


def scan_slice(
    arena: GenomeArena, cfg: Config, k: int, lo: int, hi: int
):
    """Scan one position slice [lo, hi) with full halo context; returns the
    slice's owned occurrences (h, l, pos, strand). Slicing is exact: the
    union over a partition of [0, T) equals the single-host scan."""
    import jax.numpy as jnp

    from npge_tpu.ops.kmers import kmer_scan, minimizer_mask

    T = arena.total_length
    halo = k - 1 + 2 * cfg.MINIMIZER_WINDOW
    a = max(0, lo - halo)
    b = min(T, hi + halo)
    codes = jnp.asarray(arena.codes[a:b])
    sid = jnp.asarray(arena.seq_id_of_pos()[a:b])
    ch, cl, strand, valid = kmer_scan(codes, sid, k)
    sel = minimizer_mask(ch, cl, valid, cfg.MINIMIZER_WINDOW) & (strand != 0)
    sel_np = np.asarray(sel)
    own0, own1 = lo - a, hi - a
    idx_local = np.flatnonzero(sel_np[own0:own1]) + own0
    h = np.asarray(ch)[idx_local]
    l = np.asarray(cl)[idx_local]
    s = np.asarray(strand)[idx_local]
    pos = idx_local.astype(np.int64) + a
    return h, l, pos, s


def multihost_find_anchors(
    arena: GenomeArena, cfg: Config, k: int | None = None
) -> AnchorGroups:
    """Anchor scan partitioned across processes by arena position, merged
    deterministically. With one process this equals find_anchors bit-for-bit
    (same scan ops, same sort, same group formation).

    Circular arenas take the cyclic-halo scan replicated on every process
    (it is deterministic, so all processes still agree); only the linear
    position-partitioned path is sharded."""
    import jax

    k = k or cfg.ANCHOR_SIZE
    if any(
        arena.circular(i) and arena.seq_len(i) >= k
        for i in range(arena.n_seqs)
    ):
        from npge_tpu.algo.anchors import find_anchors

        return find_anchors(arena, cfg, k=k)
    pi, pc = jax.process_index(), jax.process_count()
    T = arena.total_length
    lo, hi = host_slice(T, pi, pc)
    h, l, pos, s = scan_slice(arena, cfg, k, lo, hi)

    if pc > 1:
        from jax.experimental import multihost_utils

        # fixed-size padded all-gather of this host's occurrences
        counts = multihost_utils.process_allgather(
            np.array([len(pos)], np.int64)
        ).reshape(-1)
        cap = int(counts.max())

        def pad(x, fill):
            out = np.full(cap, fill, x.dtype)
            out[: len(x)] = x
            return out

        gh = multihost_utils.process_allgather(pad(h, 0))
        gl = multihost_utils.process_allgather(pad(l, 0))
        gp = multihost_utils.process_allgather(pad(pos, -1))
        gs = multihost_utils.process_allgather(pad(s, 0))
        h, l, pos, s = [], [], [], []
        for r in range(len(counts)):
            n = int(counts[r])
            h.append(gh[r, :n])
            l.append(gl[r, :n])
            pos.append(gp[r, :n])
            s.append(gs[r, :n])
        h = np.concatenate(h)
        l = np.concatenate(l)
        pos = np.concatenate(pos)
        s = np.concatenate(s)

    order = np.lexsort((pos, l, h))  # deterministic global merge order
    return form_groups(
        h[order], l[order], pos[order], s[order], arena, cfg, k
    )
