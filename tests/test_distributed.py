"""Multi-host partitioned scan: slices must union to the single-host scan
bit-for-bit (the distributed correctness bar with the halo recipe)."""

import numpy as np

from npge_tpu.algo.anchors import find_anchors, form_groups
from npge_tpu.config import default_config
from npge_tpu.parallel.distributed import host_slice, multihost_find_anchors, scan_slice
from npge_tpu.util.synthetic import synthetic_arena


def test_host_slice_partition():
    parts = [host_slice(103, i, 4) for i in range(4)]
    assert parts[0][0] == 0 and parts[-1][1] == 103
    for (a, b), (c, d) in zip(parts, parts[1:]):
        assert b == c


def test_sliced_scan_unions_to_single_host():
    arena = synthetic_arena(n_genomes=2, length=6000, seed=31, indel_rate=0.0)
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)
    single = find_anchors(arena, cfg)
    for pc in (2, 5):
        hs, ls, ps, ss = [], [], [], []
        for pi in range(pc):
            lo, hi = host_slice(arena.total_length, pi, pc)
            h, l, p, s = scan_slice(arena, cfg, cfg.ANCHOR_SIZE, lo, hi)
            hs.append(h)
            ls.append(l)
            ps.append(p)
            ss.append(s)
        h = np.concatenate(hs)
        l = np.concatenate(ls)
        p = np.concatenate(ps)
        s = np.concatenate(ss)
        order = np.lexsort((p, l, h))
        merged = form_groups(
            h[order], l[order], p[order], s[order], arena, cfg, cfg.ANCHOR_SIZE
        )
        np.testing.assert_array_equal(merged.offsets, single.offsets)
        np.testing.assert_array_equal(merged.pos, single.pos)
        np.testing.assert_array_equal(merged.strand, single.strand)


def test_multihost_single_process_equals_find_anchors():
    arena = synthetic_arena(n_genomes=2, length=3000, seed=9, indel_rate=0.0)
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=8)
    a = find_anchors(arena, cfg)
    b = multihost_find_anchors(arena, cfg)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    np.testing.assert_array_equal(a.pos, b.pos)


def test_two_process_allgather_merge(tmp_path):
    """Spawn TWO real jax.distributed processes (CPU backend) and assert the
    process_allgather padding/merge path produces, on every process, exactly
    the single-process anchor groups (VERDICT round-1 item 8: this branch
    had never executed)."""
    import hashlib
    import os
    import socket
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "mp_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    outs = [str(tmp_path / f"p{i}.txt") for i in range(2)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # no forced virtual devices in the workers
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", coord, outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-2000:]
    lines = [open(o).read().strip() for o in outs]
    assert lines[0] == lines[1], "processes disagree"

    # single-process expectation through the SAME entry point
    from npge_tpu.config import default_config
    from npge_tpu.parallel.distributed import multihost_find_anchors
    from npge_tpu.util.synthetic import synthetic_arena

    arena = synthetic_arena(
        n_genomes=3, length=20_000, seed=31, sub_rate=0.004,
        indel_rate=0.0005, n_inversions=1,
    )
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=6)
    groups = multihost_find_anchors(arena, cfg)
    d = hashlib.sha256()
    for a in (groups.offsets, groups.pos, groups.seq_id, groups.strand):
        d.update(a.tobytes())
    expected = f"{groups.n_groups} {len(groups.pos)} {d.hexdigest()}"
    assert lines[0] == expected, (lines[0], expected)


def test_two_process_full_pipeline(tmp_path):
    """TWO real jax.distributed processes build the FULL pangenome through
    the process-sharded driver; every process's blockset hash must equal
    the single-process hash (SURVEY §7 step 7 / VERDICT r3 missing #2)."""
    import os
    import socket
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "mp_worker.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    coord = f"localhost:{port}"
    outs = [str(tmp_path / f"pp{i}.txt") for i in range(2)]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # no forced virtual devices in the workers
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", coord, outs[i], "pipeline"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        )
        for i in range(2)
    ]
    for p in procs:
        try:
            _, err = p.communicate(timeout=420)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, err.decode()[-2500:]
    lines = [open(o).read().strip() for o in outs]
    assert lines[0] == lines[1], f"processes disagree: {lines}"

    # sharded-fraction counters (VERDICT r4 weak #8 'done' bar): each
    # process must own a real, non-total share of the extension groups
    # and the gapext SW pairs, and shares must sum to the totals
    def counters(i):
        d = {}
        for ln in open(outs[i] + f".counters{i}").read().splitlines():
            k, v = ln.split()
            d[k] = int(v)
        return d

    c0, c1 = counters(0), counters(1)
    for owned, total in (
        ("mp.extend_groups_owned", "mp.extend_groups_total"),
        ("mp.gapext_pairs_owned", "gapext_pairs"),
    ):
        assert c0[owned] + c1[owned] == c0[total] == c1[total], (c0, c1)
        assert 0 < c0[owned] < c0[total], (owned, c0)
        assert 0 < c1[owned] < c1[total], (owned, c1)

    # single-process expectation: same world, same driver, pc == 1
    from mp_worker import world
    from npge_tpu.algo.pangenome import build_pangenome
    from npge_tpu.config import default_config
    from npge_tpu.model.hashing import blockset_hash

    arena = world()
    cfg = default_config().replace(ANCHOR_SIZE=17, MINIMIZER_WINDOW=6)
    bs, _ = build_pangenome(arena, cfg)
    bs.canonicalize()
    expected = f"{len(bs.blocks)} {blockset_hash(bs)}"
    assert lines[0] == expected, (lines[0], expected)


def test_init_distributed_opens_one_card_per_process(monkeypatch):
    """With JAX's coordinator setting present, jax.distributed starts with
    the given process count and id, and the process opens only its own
    card (local_device_ids == [process id]); without it nothing starts."""
    import jax

    from npge_tpu.parallel import distributed

    seen = []
    monkeypatch.setattr(
        jax.distributed, "initialize", lambda **kw: seen.append(kw)
    )
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert distributed.init_distributed() == (0, 1)
    assert seen == []
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    distributed.init_distributed()
    assert seen == [dict(
        coordinator_address="localhost:12345", num_processes=4,
        process_id=2, local_device_ids=[2],
    )]
