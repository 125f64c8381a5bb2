"""Extender — grow anchor groups into candidate gapless blocks.

Pipeline stage wrapping ops/extend.py: computes per-occurrence extension caps
(sequence bounds + half-split gaps between same-group neighbors so a block
can never overlap itself), buckets ragged groups into padded (B, F) batches
(SURVEY.md §7 hard part 2), runs the device kernel per bucket, and emits the
columnar :class:`CandidateBatch` (one gapless candidate per group).

Equivalent role: the reference's ``FragmentsExtender`` + block construction
from anchors (SURVEY §2.3 ⚠[B]).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from npge_tpu.config import Config
from npge_tpu.model.arena import GenomeArena
from npge_tpu.model.blocks import Block
from npge_tpu.model.fragments import FragmentTable
from npge_tpu.algo.anchors import AnchorGroups
from npge_tpu.ops.extend import (
    bases_for_groups,
    extend_rounds_rows,
    make_codes2_rows,
)

# target element budget per (B, F, S) gather to bound device memory
# (int32 window = 4 B/elem; a side-stacked round-1 batch materializes
# 2x this => ~1 GB per dispatch at 2^27, under 2% of the 60 GB that a
# JAX process takes of an 80 GB H100)
_ELEM_BUDGET = 1 << 27

# round-1 + compacted-tail engages at this many groups (list so tests can
# force either path; results are bit-identical — parity-tested)
_SPLIT_TAIL_MIN_GROUPS = [4096]


class CandidateBatch:
    """Columnar gapless candidate set — one group per candidate, SoA.

    The extender used to build one Block object per group (334k Python
    objects + per-group numpy churn at the 56 Mbp scale); the batch keeps
    the CSR arrays and materializes Blocks only on demand. It is a
    sequence of Blocks for API compatibility (iteration, len, indexing),
    and `resolve_overlaps` / `deconseq` consume the arrays directly."""

    __slots__ = ("offsets", "seq", "start", "length", "ori")

    def __init__(self, offsets, seq, start, length, ori):
        self.offsets = offsets
        self.seq = seq
        self.start = start
        self.length = length
        self.ori = ori

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < 0:
            i += len(self)
        if not 0 <= i < len(self):
            raise IndexError(i)
        a, e = int(self.offsets[i]), int(self.offsets[i + 1])
        return Block(
            FragmentTable(
                self.seq[a:e], self.start[a:e],
                self.length[a:e], self.ori[a:e],
            )
        )

    def to_blocks(self) -> list[Block]:
        return list(self)

    @classmethod
    def empty(cls) -> "CandidateBatch":
        z = np.zeros(0, np.int64)
        zi = np.zeros(0, np.int32)
        return cls(np.zeros(1, np.int64), z, zi, zi, zi)

    def select(self, ids: np.ndarray) -> "CandidateBatch":
        """Sub-batch of the given candidate indices (CSR gather)."""
        from npge_tpu.util.csr import csr_gather

        idx, offs = csr_gather(self.offsets, ids)
        return CandidateBatch(
            offs, self.seq[idx], self.start[idx],
            self.length[idx], self.ori[idx],
        )


def _compute_caps(groups: AnchorGroups, arena: GenomeArena):
    """Per-occurrence (cap_left, cap_right) in column space, int64."""
    k = groups.k
    pos = groups.pos
    seq_id = groups.seq_id
    strand = groups.strand.astype(np.int64)
    seq_lo = arena.offsets[seq_id]
    seq_hi = arena.offsets[seq_id + 1]
    end = pos + k
    # sequence-bound caps in *sequence* direction
    room_fwd = seq_hi - end      # room toward larger positions
    room_rev = pos - seq_lo      # room toward smaller positions
    # same-group neighbor gaps (occurrences are key-sorted; sort by pos
    # within each group to find sequence-adjacent same-group neighbors)
    gid = np.repeat(
        np.arange(groups.n_groups, dtype=np.int64), groups.sizes()
    )
    order = np.lexsort((pos, gid))
    inv = np.empty_like(order)
    inv[order] = np.arange(len(order))
    p_s, g_s, sid_s = pos[order], gid[order], seq_id[order]
    end_s = p_s + k
    gap_after = np.full(len(pos), np.int64(1) << 40)
    gap_before = np.full(len(pos), np.int64(1) << 40)
    bad_group = np.zeros(groups.n_groups, dtype=bool)
    if len(pos) > 1:
        same = (g_s[1:] == g_s[:-1]) & (sid_s[1:] == sid_s[:-1])
        ga = np.where(same, p_s[1:] - end_s[:-1], np.int64(1) << 40)
        gap_after[order[:-1]] = ga
        gap_before[order[1:]] = ga
        # tandem repeats with period < k: the anchor windows themselves
        # overlap -> the block would overlap itself at birth; drop the group
        overlapping = same & (ga < 0)
        if overlapping.any():
            bad_group[np.unique(g_s[:-1][overlapping])] = True
    # both neighbors extend into a shared gap: split it deterministically
    room_fwd = np.minimum(room_fwd, gap_after // 2 + gap_after % 2)
    room_rev = np.minimum(room_rev, gap_before // 2)
    # column space: right = sequence-forward for ori=+1, backward for -1
    cap_right = np.where(strand == 1, room_fwd, room_rev)
    cap_left = np.where(strand == 1, room_rev, room_fwd)
    return np.maximum(cap_left, 0), np.maximum(cap_right, 0), bad_group


def _bucket_f(f: int) -> int:
    b = 2
    while b < f:
        b *= 2
    return b


def extend_anchor_groups(
    arena: GenomeArena,
    groups: AnchorGroups,
    cfg: Config,
    codes_dev=None,
    timings=None,
    mesh=None,
    counter_prefix: str = "extend",
) -> CandidateBatch:
    """Extend all groups; return the columnar CandidateBatch of gapless
    candidates (one per group; a lazy sequence of Blocks),
    in deterministic group order. `timings` (StageTimings) receives an
    ``extend_cells`` counter when given.

    With ``mesh`` (1-D jax.sharding.Mesh) the padded (2*Bp, F) extension
    batches are sharded over the group axis — each device computes only its
    1/N slice (the batch dimension is padded to a device-count multiple;
    the arena rows stay replicated for the window gathers). Results are
    bit-identical to the single-device run: the extension rule is
    per-group, and the freeze rule keeps per-group results independent of
    batch composition (VERDICT r2 item 4 / SURVEY §2.6)."""
    if groups.n_groups == 0:
        return CandidateBatch.empty()
    if codes_dev is None:
        codes_dev = jnp.asarray(arena.codes)
    if mesh is not None:
        from npge_tpu.parallel.mesh import replicate

        codes_dev = replicate(mesh, codes_dev)
    T = arena.total_length
    codes2_rows = make_codes2_rows(codes_dev)
    k = groups.k
    cap_l, cap_r, bad_group = _compute_caps(groups, arena)
    sizes = groups.sizes()
    gids = np.arange(groups.n_groups)
    results_l = np.zeros(groups.n_groups, np.int32)
    results_r = np.zeros(groups.n_groups, np.int32)

    num, den = cfg.MIN_IDENTITY.num, cfg.MIN_IDENTITY.den
    chunk = min(cfg.EXTEND_CHUNK, cfg.MAX_EXTEND)
    max_rounds = max(1, -(-cfg.MAX_EXTEND // chunk))

    # multi-process data parallelism (SURVEY §7 step 7 / BASELINE configs
    # 4-5): each process extends a contiguous slice of every F-bucket's
    # groups, then per-group (el, er) scalars allgather-merge. The freeze
    # rule makes per-group results batch-composition-independent, so the
    # merged arrays are bit-identical to the single-process run on every
    # process.
    import jax

    pi, pc = jax.process_index(), jax.process_count()
    proc_shard = pc > 1 and mesh is None

    n_dev = int(mesh.devices.size) if mesh is not None else 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        batch_sharding = NamedSharding(mesh, P("d", None))

    # round-1 + compacted-tail scheme (big single-process calls): the
    # fused while_loop recomputes every round over the WHOLE padded batch,
    # but after round 1 only a small fraction of groups is still active —
    # at 17 Mbp ~85 % of the fused path's cells were frozen rows. Instead:
    # dispatch ONE extend_chunk_rows round per batch (async), fetch all
    # round-1 results in a single concatenated readback, gather the still-
    # active rows into one compacted batch, and resume the fused loop with
    # carried state. Bit-identical by the freeze rule (per-group results
    # never depend on batch composition). Mesh/small calls keep the fused
    # path (an extra sync would dominate their tiny compute).
    split_tail = (
        mesh is None and max_rounds > 1
        and groups.n_groups >= _SPLIT_TAIL_MIN_GROUPS[0]
    )
    round1 = []  # (batch, Bp, base2, cap2, fm2, ext_dev, len_dev, id_dev, n_real)
    pending = []  # (batch_gids, el_dev, er_dev) — sync once at the end
    fbs = sorted({_bucket_f(int(s)) for s in sizes})
    # small calls (every reseed round: a few hundred consensus groups) pad
    # everything into ONE F-bucket: each extra bucket costs a dispatch +
    # host sync, which dwarfs the padded compute at this scale. Per-group results are batch-composition-independent
    # (freeze rule), so results are bit-identical either way.
    single_bucket = (
        mesh is None and groups.n_groups < _SPLIT_TAIL_MIN_GROUPS[0]
    )
    if single_bucket:
        fbs = fbs[-1:]
    for fb in fbs:
        if single_bucket:
            sel = gids[~bad_group]
        else:
            sel = gids[
                (sizes <= fb)
                & (sizes > (fb // 2 if fb > 2 else 1))
                & ~bad_group
            ]
        if proc_shard:
            from npge_tpu.parallel.distributed import host_slice

            if timings is not None:
                timings.count(
                    f"mp.{counter_prefix}_groups_total", len(sel)
                )
            a0, a1 = host_slice(len(sel), pi, pc)
            sel = sel[a0:a1]
            if timings is not None:
                timings.count(
                    f"mp.{counter_prefix}_groups_owned", a1 - a0
                )
        if len(sel) == 0:
            continue
        b_cap = max(256, _ELEM_BUDGET // (fb * chunk))
        b_cap = -(-b_cap // n_dev) * n_dev
        for i0 in range(0, len(sel), b_cap):
            batch = sel[i0 : i0 + b_cap]
            B = len(batch)
            Bp = b_cap  # fixed batch shape per F-bucket -> stable jit cache
            while Bp // 2 >= B and Bp > 256 and (Bp // 2) % n_dev == 0:
                Bp //= 2
            # vectorized ragged->padded gather (slot j of group g reads
            # occurrence offsets[g]+j, masked by group size)
            occ0 = groups.offsets[batch]
            nocc = groups.offsets[batch + 1] - occ0
            slot = np.arange(fb)
            oidx = occ0[:, None] + slot[None, :]
            valid = slot[None, :] < nocc[:, None]
            oidx = np.where(valid, oidx, 0)
            lo = np.zeros((Bp, fb), np.int64)
            hi = np.zeros((Bp, fb), np.int64)
            ori = np.ones((Bp, fb), np.int64)
            fmask = np.zeros((Bp, fb), bool)
            cl = np.zeros((Bp, fb), np.int32)
            cr = np.zeros((Bp, fb), np.int32)
            lo[:B] = np.where(valid, groups.pos[oidx], 0)
            hi[:B] = lo[:B] + k
            ori[:B] = np.where(valid, groups.strand[oidx], 1)
            fmask[:B] = valid
            cl[:B] = np.where(
                valid, np.minimum(cap_l[oidx], cfg.MAX_EXTEND), 0
            )
            cr[:B] = np.where(
                valid, np.minimum(cap_r[oidx], cfg.MAX_EXTEND), 0
            )
            base_l, base_r = bases_for_groups(lo, hi, ori, T)
            # left/right are independent problems: stack along the batch
            # axis on host and run ONE device dispatch (both sides, all
            # rounds fused); under a mesh the stacked batch is sharded
            # over devices (2*Bp stays a device-count multiple)
            base2 = np.concatenate([base_l, base_r])
            cap2 = np.concatenate([cl, cr])
            fm2 = np.concatenate([fmask, fmask])
            if split_tail:
                from npge_tpu.ops.extend import extend_chunk_rows

                z = jnp.zeros(2 * Bp, jnp.int32)
                ext_d, len_d, id_d = extend_chunk_rows(
                    codes2_rows, 2 * T, jnp.asarray(base2),
                    jnp.asarray(fm2), jnp.asarray(cap2), z, z,
                    num, den, chunk,
                )
                round1.append(
                    (batch, Bp, base2, cap2, fm2, ext_d, id_d,
                     int(valid.sum()))
                )
                continue
            if mesh is not None:
                import jax

                base2 = jax.device_put(base2, batch_sharding)
                cap2 = jax.device_put(cap2, batch_sharding)
                fm2 = jax.device_put(fm2, batch_sharding)
            total, rounds = extend_rounds_rows(
                codes2_rows, 2 * T, base2, fm2, cap2,
                num, den, chunk, max_rounds,
            )
            el, er = total[:Bp], total[Bp:]
            # real (unpadded) fragment slots in this batch — the honest
            # cells counter multiplies by rounds actually executed, read
            # back lazily with the results (VERDICT r2 weak #9)
            pending.append((batch, el, er, rounds, int(valid.sum())))
    if round1:
        from npge_tpu.ops.extend import extend_rounds_rows as _err

        # single concatenated readback for every batch's round-1 results
        flat = np.asarray(
            jnp.concatenate(
                [x for (_b, _p, _b2, _c2, _f2, e, i, _n) in round1
                 for x in (e, i)]
            )
        )
        pos = 0
        per_batch = []  # (batch, Bp, el, er)
        tb, tc, tf, tcl, tci, towner = [], [], [], [], [], []
        fb_max = max(b2.shape[1] for (_b, _p, b2, *_r) in round1)
        for batch, Bp, base2, cap2, fm2, _e, _i, n_real in round1:
            n2 = 2 * Bp
            ext = flat[pos : pos + n2]
            ident = flat[pos + n2 : pos + 2 * n2]
            pos += 2 * n2
            if timings is not None:
                timings.count(f"{counter_prefix}_cells", 2 * n_real * chunk)
            # rows still active after round 1: consumed the full chunk and
            # every present fragment has cap room left (a room-less active
            # row would add ext=0 in the fused loop — skipping it is exact)
            rem = np.maximum(cap2 - ext[:, None], 0)
            rem_ok = np.where(fm2, rem, 1 << 30).min(axis=1) > 0
            act = np.flatnonzero((ext == chunk) & rem_ok)
            if len(act):
                pad_f = fb_max - base2.shape[1]

                def wide(a, fill):
                    return (
                        a if pad_f == 0
                        else np.pad(
                            a, ((0, 0), (0, pad_f)), constant_values=fill
                        )
                    )

                tb.append(wide(base2[act] + ext[act, None], 0))
                tc.append(wide(rem[act], 0))
                tf.append(wide(fm2[act], False))
                tcl.append(ext[act])
                tci.append(ident[act])
                towner.append((len(per_batch), act))
            per_batch.append((batch, Bp, ext.copy(), None))
        if tb:
            TB = np.concatenate(tb).astype(np.int32)
            TC = np.concatenate(tc).astype(np.int32)
            TF = np.concatenate(tf)
            TCL = np.concatenate(tcl).astype(np.int32)
            TCI = np.concatenate(tci).astype(np.int32)
            n_tail = len(TB)
            # the tail obeys the same per-dispatch element budget as the
            # round-1 batches: all-active-rows x padded-F x chunk in one
            # dispatch OOMed the 56 Mbp config (21 GB window gather)
            t_cap = max(256, (2 * _ELEM_BUDGET) // (fb_max * chunk))
            tt = np.zeros(n_tail, np.int32)
            tail_pend = []  # async dispatches; ONE concatenated fetch
            for t0 in range(0, n_tail, t_cap):
                t1 = min(n_tail, t0 + t_cap)
                rows_p = max(256, 1 << (t1 - t0 - 1).bit_length())
                pad = rows_p - (t1 - t0)

                def padr(a, fill):
                    return np.pad(
                        a[t0:t1],
                        ((0, pad),) + ((0, 0),) * (a.ndim - 1),
                        constant_values=fill,
                    )

                total_t, r_fin = _err(
                    codes2_rows, 2 * T, jnp.asarray(padr(TB, 0)),
                    jnp.asarray(padr(TF, False)), jnp.asarray(padr(TC, 0)),
                    num, den, chunk, max_rounds,
                    carry_len=jnp.asarray(padr(TCL, 0)),
                    carry_ident=jnp.asarray(padr(TCI, 0)),
                    start_round=jnp.int32(1),
                )
                tail_pend.append((t0, t1, total_t, r_fin))
            flat_t = np.asarray(
                jnp.concatenate(
                    [x for (_a, _b, tot, rf) in tail_pend for x in (tot, rf[None])]
                )
            )
            fp = 0
            tail_cells = 0
            for t0, t1, tot, _rf in tail_pend:
                m_rows = tot.shape[0]
                tt[t0:t1] = flat_t[fp : fp + (t1 - t0)]
                rounds_tail = int(flat_t[fp + m_rows]) - 1
                fp += m_rows + 1
                if rounds_tail > 0:
                    tail_cells += int(TF[t0:t1].sum()) * rounds_tail * chunk
            if timings is not None and tail_cells:
                timings.count(f"{counter_prefix}_cells", tail_cells)
            off = 0
            for pb_i, act in towner:
                batch, Bp, ext, _ = per_batch[pb_i]
                ext[act] += tt[off : off + len(act)]
                off += len(act)
        for batch, Bp, ext, _ in per_batch:
            B = len(batch)
            results_l[batch] = ext[:Bp][:B]
            results_r[batch] = ext[Bp : Bp + B]
    for batch, el, er, rounds, n_real in pending:
        B = len(batch)
        results_l[batch] = np.asarray(el)[:B]
        results_r[batch] = np.asarray(er)[:B]
        if timings is not None:
            # both sides scan up to rounds*chunk columns per real fragment
            timings.count(
                f"{counter_prefix}_cells", 2 * n_real * int(rounds) * chunk
            )
    if proc_shard:
        from jax.experimental import multihost_utils

        # owned entries are exclusive per process, others zero -> sum merge
        g = multihost_utils.process_allgather(
            np.stack([results_l, results_r])
        )
        results_l = g[:, 0].sum(axis=0).astype(np.int32)
        results_r = g[:, 1].sum(axis=0).astype(np.int32)

    # build the columnar candidate batch in one vectorized pass
    from npge_tpu.util.csr import csr_gather

    kept = np.flatnonzero(~bad_group)
    oidx_all, offs = csr_gather(groups.offsets, kept)
    cnt = np.diff(offs)
    gl = np.repeat(results_l[kept].astype(np.int64), cnt)
    gr = np.repeat(results_r[kept].astype(np.int64), cnt)
    p = groups.pos[oidx_all]
    s = groups.strand[oidx_all].astype(np.int64)
    sid = groups.seq_id[oidx_all]
    new_global = np.where(s == 1, p - gl, p - gr)
    local = new_global - arena.offsets[sid]
    length = (k + gl + gr).astype(np.int32)
    return CandidateBatch(
        offs, sid, local.astype(np.int32), length, s.astype(np.int32)
    )
