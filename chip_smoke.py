"""Smoke test of the pangenome build on an NVIDIA GPU.

Run from the root of a checkout:

    python chip_smoke.py             # one card: phases 1-4 below
    python chip_smoke.py --chips 4   # the 4-card mesh build only
    JAX_PLATFORMS=cpu python chip_smoke.py --cpu-reference
                                     # CPU build of the main world: prints
                                     # the hash pinned in MAIN_HASH

One process holds the card and drives the CLI in-process
(``npge_tpu.cli.main``); the only subprocess is the CPU comparison run,
started with JAX_PLATFORMS=cpu so it never opens the card. Any failed
phase ends the run with a non-zero exit and no result line.

  1. device: nvidia-smi's name and power limit, jax.devices(); JAX must
     run on "gpu".
  2. SW parity: the tests marked ``gpu`` (the GPU banded-SW path against
     the NumPy mirror, exactly, at W=128, L=512 on 4096 flank pairs), and
     the kernel's DP cells per second.
  3. CPU cross-check: a 3 x 1 Mbp world written as FASTA goes through
     prepare, make-pangenome --platform gpu, check --deep and hash; the
     same verbs in a CPU subprocess must give the same hash.
  4. main: the 17 x 3.3 Mbp world (56 Mbp, the size of the 17-genome
     Brucella collection) through the same verbs: stage table, wall, peak
     device memory; check --deep must pass and the hash must equal
     MAIN_HASH, the CPU build's.
  --chips 4: make-pangenome --devices 4 (the 1-D mesh over four cards) on
     the main world; the hash must equal MAIN_HASH and every card must
     hold part of the work.

The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

MAIN_WORLD = dict(n_genomes=17, length=3_300_000, seed=42, sub_rate=0.002,
                  indel_rate=0.0001, n_inversions=3)
CROSS_WORLD = dict(n_genomes=3, length=1_000_000, seed=7, sub_rate=0.01,
                   indel_rate=0.0002, n_inversions=2)
# blockset hash of MAIN_WORLD built on the CPU from the FASTA files this
# script writes; reproduce with:
#   JAX_PLATFORMS=cpu python chip_smoke.py --cpu-reference
MAIN_HASH = "8d4f12b845ee29eb"


class PhaseFailed(Exception):
    pass


def say(*a):
    print(*a, flush=True)


def require(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def write_world(spec: dict, d: str) -> list[str]:
    from npge_tpu.io.fasta import write_fasta
    from npge_tpu.util.synthetic import synthetic_arena

    arena = synthetic_arena(**spec)
    os.makedirs(d, exist_ok=True)
    paths = []
    for i, name in enumerate(arena.names):
        p = os.path.join(d, f"g{i:02d}.fa")
        with open(p, "w") as fh:
            write_fasta(fh, [(name, arena.seq_codes(i))])
        paths.append(p)
    return paths


def cli(*argv: str) -> tuple[int, str, str]:
    """npge_tpu.cli.main in this process; returns (exit code, stdout,
    stderr)."""
    from npge_tpu.cli import main

    out, err = io.StringIO(), io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            main(list(argv))
        except SystemExit as e:
            if isinstance(e.code, str):
                err.write(e.code + "\n")
                code = 1
            else:
                code = e.code or 0
    return code, out.getvalue(), err.getvalue()


def build(paths: list[str], work: str, platform: str, *extra: str) -> dict:
    """prepare -> make-pangenome --timing -> check --deep -> hash through
    the CLI; fails the phase on any non-zero exit or failed check."""
    code, out, err = cli("prepare", "--fasta", *paths, "-w", work)
    require(code == 0, f"prepare exited {code}: {err[-2000:]}")
    t0 = time.perf_counter()
    code, out, err = cli("make-pangenome", "-w", work, "--platform", platform,
                         "--timing", *extra)
    wall = time.perf_counter() - t0
    require(code == 0, f"make-pangenome exited {code}: {err[-2000:]}")
    summary = json.loads(out.strip().splitlines()[-1])
    require(summary.get("platform") == platform,
            f"make-pangenome ran on {summary.get('platform')}")
    require(summary.get("is_pangenome") is True, "IsPangenome checks failed")
    code, cout, cerr = cli("check", "-w", work, "--deep", "--platform",
                           platform)
    require(code == 0 and cout.startswith("OK"),
            f"check --deep failed ({code}): {cout[-1000:]}{cerr[-1000:]}")
    code, hout, herr = cli("hash", "-w", work)
    require(code == 0, f"hash exited {code}: {herr[-1000:]}")
    return dict(hash=hout.strip(), wall=wall, summary=summary, timing=err)


def cpu_build_subprocess(paths: list[str], work: str) -> subprocess.Popen:
    """The same CLI verbs on the CPU, in a child that never opens a card;
    prints the hash as its last line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = (
        "set -e; "
        f"{sys.executable} -m npge_tpu.cli prepare -w {work} --fasta "
        + " ".join(paths)
        + f"; {sys.executable} -m npge_tpu.cli make-pangenome -w {work}"
        " --platform cpu"
        f"; {sys.executable} -m npge_tpu.cli hash -w {work}"
    )
    return subprocess.Popen(["bash", "-c", cmd], env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def phase_device(n_cards: int) -> dict:
    import jax

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except FileNotFoundError:
        raise PhaseFailed("nvidia-smi not found")
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    say(smi.stdout.strip())
    say(f"jax.devices(): {jax.devices()}")
    dev = jax.devices()[0]
    require(dev.platform == "gpu", f"JAX runs on {dev.platform}, not gpu")
    require(len(jax.devices()) >= n_cards,
            f"{len(jax.devices())} devices, need {n_cards}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": n_cards}


def phase_sw() -> None:
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import test_sw

    marked = [
        f for n, f in sorted(vars(test_sw).items())
        if n.startswith("test_")
        and any(m.name == "gpu" for m in getattr(f, "pytestmark", []))
    ]
    require(marked, "no tests marked gpu")
    for f in marked:
        t0 = time.perf_counter()
        f(gpu=None)
        say(f"  {f.__name__}: passed ({time.perf_counter() - t0:.1f} s)")

    from npge_tpu.ops import sw

    L, W, P = 512, 128, 16384
    rng = np.random.default_rng(0)
    q = rng.integers(0, 4, (P, L)).astype(np.uint8)
    t = q.copy()
    m = rng.random((P, L)) < 0.02
    t[m] = (t[m] + rng.integers(1, 4, int(m.sum()))) % 4
    qp, trp, qlen, tlen = sw.pad_rows(list(q), list(t), L, W)
    args = [jnp.asarray(x) for x in (qp, trp, qlen, tlen)]
    kw = dict(L=L, W=W, match=1, mismatch=-2, gap=-3, xdrop=64)
    sw._gpu_sw(*args, **kw).block_until_ready()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        sw._gpu_sw(*args, **kw).block_until_ready()
        times.append(time.perf_counter() - t0)
    cells = P * W * (2 * L - 1)
    best = min(times)
    say(f"  SW CUDA kernel at W={W}, L={L}, P={P}: "
        f"{best * 1e3:.3f} ms, {cells / best:.4g} DP cells/s "
        f"(median {sorted(times)[2] * 1e3:.3f} ms)")


def phase_cross(tmp: str) -> None:
    paths = write_world(CROSS_WORLD, os.path.join(tmp, "cross_fa"))
    child = cpu_build_subprocess(paths, os.path.join(tmp, "cross_cpu"))
    try:
        g = build(paths, os.path.join(tmp, "cross_gpu"), "gpu")
        say(f"  gpu: {g['summary']}, wall {g['wall']:.2f} s, hash {g['hash']}")
        out, err = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    require(child.returncode == 0, f"CPU run exited {child.returncode}: "
            f"{err[-2000:]}")
    cpu_hash = out.strip().splitlines()[-1]
    say(f"  cpu: hash {cpu_hash}")
    require(g["hash"] == cpu_hash, f"GPU hash {g['hash']} != CPU {cpu_hash}")


def device_peaks() -> list[int]:
    import jax

    return [(d.memory_stats() or {}).get("peak_bytes_in_use", 0)
            for d in jax.devices()]


def phase_main(tmp: str, *extra: str) -> dict:
    paths = write_world(MAIN_WORLD, os.path.join(tmp, "main_fa"))
    g = build(paths, os.path.join(tmp, "main" + "_".join(extra)), "gpu",
              *extra)
    say(g["timing"].rstrip())
    say(f"  {g['summary']}")
    say(f"  wall {g['wall']:.2f} s (make-pangenome, compile included)")
    say(f"  peak device memory (bytes, per device): {device_peaks()}")
    say(f"  hash {g['hash']} (pinned CPU hash {MAIN_HASH})")
    require(g["hash"] == MAIN_HASH, f"hash {g['hash']} != pinned {MAIN_HASH}")
    return g


def cpu_reference() -> None:
    import jax

    from npge_tpu.util.jaxcache import enable_compilation_cache

    enable_compilation_cache()
    require(jax.default_backend() == "cpu", "run with JAX_PLATFORMS=cpu")
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_world(MAIN_WORLD, os.path.join(tmp, "fa"))
        g = build(paths, os.path.join(tmp, "cpu"), "cpu")
    say(g["timing"].rstrip())
    say(f"{g['summary']} wall {g['wall']:.2f} s")
    say(f"MAIN_HASH = {g['hash']!r}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4))
    ap.add_argument("--cpu-reference", action="store_true")
    args = ap.parse_args()
    try:
        if args.cpu_reference:
            cpu_reference()
            return 0
        from npge_tpu.util.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        say("phase 1: device")
        device = phase_device(args.chips)
        with tempfile.TemporaryDirectory() as tmp:
            if args.chips == 4:
                say("phase mesh: make-pangenome --devices 4, 56 Mbp")
                phase_main(tmp, "--devices", "4")
                peaks = device_peaks()[:4]
                require(min(peaks) > 0.05 * max(peaks),
                        f"work did not spread over the four cards: {peaks}")
            else:
                say("phase 2: SW parity")
                phase_sw()
                say("phase 3: CPU cross-check, 3 x 1 Mbp")
                phase_cross(tmp)
                say("phase 4: main, 17 x 3.3 Mbp")
                phase_main(tmp)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
