"""End-to-end CLI workflow in-process (the user surface)."""

import os

import numpy as np
import pytest

from npge_tpu.cli import main
from npge_tpu.io.fasta import write_fasta
from npge_tpu.util.synthetic import synthetic_arena


@pytest.fixture
def world(tmp_path):
    arena = synthetic_arena(
        n_genomes=3, length=5000, seed=33, sub_rate=0.01, indel_rate=0.0005
    )
    paths = []
    for i in range(3):
        p = tmp_path / f"g{i}.fa"
        with open(p, "w") as fh:
            write_fasta(fh, [(arena.names[i], arena.seq_codes(i))])
        paths.append(str(p))
    return tmp_path, paths


def test_cli_full_workflow(world, capsys):
    tmp_path, paths = world
    w = str(tmp_path / "work")
    opts = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3"]
    main(["prepare", "--fasta", *paths, "-w", w])
    main(["examine", "-w", w])
    main(["make-pangenome", "-w", w, *opts])
    out = capsys.readouterr().out
    assert '"is_pangenome": true' in out
    with pytest.raises(SystemExit) as e:
        main(["check", "-w", w, *opts])
    assert e.value.code == 0
    main(["post-processing", "-w", w])
    main(["report", "-w", w])
    main(["run", "Stem", "-w", w, "--stage-name", "stem", *opts])
    main(["hash", "-w", w, "--stage", "stem"])
    for f in (
        "input.bs", "pangenome.bs", "blocks.tsv", "mutations.tsv",
        "distances.tsv", "bsa.tsv", "consensus_tree.nwk", "info.txt",
        "genomes_stats.tsv", "report.html", "stem.bs",
    ):
        assert os.path.exists(os.path.join(w, f)), f


def test_cli_rejects_unknown_option(world):
    tmp_path, paths = world
    w = str(tmp_path / "w2")
    main(["prepare", "--fasta", *paths, "-w", w])
    with pytest.raises(AttributeError):
        main(["check", "-w", w, "-o", "NOT_A_KNOB=1"])


def test_report_has_genome_map_and_table(world, tmp_path):
    """The HTML report (qnpge analog) carries the SVG genome map with
    tooltips + anchors that resolve, and the sortable/filterable table."""
    import re

    tmp, paths = world
    w = str(tmp / "repwork")
    main(["prepare", "--fasta", *paths, "-w", w])
    main(["make-pangenome", "-w", w, "-o", "ANCHOR_SIZE=17",
          "-o", "MIN_LENGTH=60", "-o", "MIN_END=3"])
    main(["report", "-w", w])
    t = open(os.path.join(w, "report.html")).read()
    assert '<svg class="map"' in t
    assert "<title>" in t and "sortTable" in t and "filterTable" in t
    assert "prefers-color-scheme: dark" in t
    ids = set(re.findall(r'id="([^"]+)"', t))
    for m in set(re.findall(r'<a href="#([^"]+)">', t)):
        assert m in ids, f"dangling anchor {m}"


def test_cli_platform_fallback_on_broken_backend(world):
    """--platform gpu without a card ends make-pangenome with one line on
    stderr, a non-zero exit and no traceback (nothing falls back to the
    CPU); --platform cpu builds and names the platform in its JSON line."""
    import json
    import subprocess
    import sys

    tmp_path, paths = world
    w = str(tmp_path / "pw")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    opts = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3"]

    def run(*a):
        return subprocess.run(
            [sys.executable, "-m", "npge_tpu.cli", *a],
            capture_output=True, text=True, env=env, timeout=600,
        )

    r = run("prepare", "--fasta", *paths, "-w", w)
    assert r.returncode == 0, r.stderr[-2000:]
    r = run("make-pangenome", "-w", w, "--platform", "gpu", *opts)
    assert r.returncode != 0
    assert "Traceback" not in r.stderr, r.stderr[-2000:]
    lines = [ln for ln in r.stderr.splitlines() if ln.strip()]
    assert len(lines) == 1 and "platform gpu" in lines[0], r.stderr[-2000:]
    assert r.stdout == ""
    r = run("make-pangenome", "-w", w, "--platform", "cpu", *opts)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["is_pangenome"] is True and out["platform"] == "cpu"


def test_cli_devices_flag_matches_default(world, capsys):
    """make-pangenome --devices N (mesh-sharded build) must produce the
    same blockset hash as the default single-device build."""
    import json

    tmp, paths = world
    opts = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3"]
    hashes = []
    for sub, extra in (("w_single", []), ("w_mesh", ["--devices", "8"])):
        w = str(tmp / sub)
        main(["prepare", "--fasta", *paths, "-w", w])
        main(["make-pangenome", "-w", w, *opts, *extra])
        line = [
            ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")
        ][-1]
        hashes.append(json.loads(line)["blockset_hash"])
    assert hashes[0] == hashes[1]


def test_check_deep_reuses_buildtime_proof(world, capsys):
    """VERDICT r4 weak #9: `check --deep` right after make-pangenome must
    not re-run a full reseed round — the build's exit proved the k=MIN
    probe non-improving and recorded a (hash, cfg) memo. A changed config
    must invalidate the memo."""
    tmp_path, paths = world
    w = str(tmp_path / "deepw")
    opts = ["-o", "ANCHOR_SIZE=17", "-o", "MIN_LENGTH=60", "-o", "MIN_END=3"]
    main(["prepare", "--fasta", *paths, "-w", w])
    main(["make-pangenome", "-w", w, *opts])
    import json as _json

    meta = _json.load(open(os.path.join(w, "pangenome.json")))
    assert meta.get("deep_probe", {}).get("ok") is True
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        main(["check", "-w", w, "--deep", *opts])
    assert e.value.code == 0
    cap = capsys.readouterr()
    assert "reusing build-time proof" in cap.err
    # different config -> memo invalid -> full probe runs (no reuse line)
    with pytest.raises(SystemExit) as e:
        main(["check", "-w", w, "--deep", "-o", "ANCHOR_SIZE=17",
              "-o", "MIN_LENGTH=80", "-o", "MIN_END=3"])
    assert e.value.code == 0
    assert "reusing build-time proof" not in capsys.readouterr().err
