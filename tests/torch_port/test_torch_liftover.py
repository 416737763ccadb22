"""The port's mapping liftover (`liftover.liftover_mappings`, the native
`liftover.c`, the `liftover` target of its command line), after
``tests/test_liftover.py`` and ``tests/test_native_liftover.py``: the
hand-computed coordinate math (+ offset, - flip, out-of-range anchors
dropped, unplaced contigs dropped, self-named scaffolds passed through,
runs merged on one scaffold, monotonic concatenations kept), then the
port's native C path equal to its Python path, byte for byte, on
hand-built and random scenarios, each also equal to ntlink_tpu's output,
and `python -m ntlink_tpu_torch liftover agp= mappings= out=`."""
import numpy as np
import pytest

import ntlink_tpu_torch.native as native_pkg
from ntlink_tpu.liftover import liftover_mappings as ref_liftover
from ntlink_tpu_torch import cli
from ntlink_tpu_torch.liftover import liftover_mappings
from ntlink_tpu_torch.native import liftover_module


def write_agp(path, rows):
    with open(path, "w") as fh:
        for row in rows:
            fh.write("\t".join(str(x) for x in row) + "\n")


def write_verbose(path, rows):
    with open(path, "w") as fh:
        for row in rows:
            fh.write("\t".join(row) + "\n")


def run(tmp_path, agp_rows, verbose_rows, k=10):
    agp = tmp_path / "x.agp"
    verbose = tmp_path / "x.tsv"
    out = tmp_path / "out.tsv"
    write_agp(agp, agp_rows)
    write_verbose(verbose, verbose_rows)
    liftover_mappings(str(verbose), str(agp), str(out), k)
    return [l.rstrip("\n") for l in open(out)]


def test_plus_strand_offset(tmp_path):
    # c1 placed forward at scaffold position 101.. (offset 100), region 11..100
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c1", "2", "20:+_5:+ 30:-_15:-")]
    # new_pos = 100 + (pos - 10): 20 -> 110, 30 -> 120; strands preserved
    assert run(tmp_path, agp, verbose) == [
        "r1\ts0\t2\t110:+_5:+ 120:-_15:-"
    ]


def test_minus_strand_flip(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "-")]
    verbose = [("r1", "c1", "2", "20:+_5:+ 30:-_15:-")]
    # ctg_len = 90; new_pos = 100 + (90 - (pos-10)) - 10 = 190 - pos
    # 20 -> 170 (flip to -), 30 -> 160 (flip to +); order kept, so the
    # concatenation is decreasing -> monotonic, emitted as-is
    assert run(tmp_path, agp, verbose) == [
        "r1\ts0\t2\t170:-_5:+ 160:+_15:-"
    ]


def test_out_of_range_anchors_dropped(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    # pos 5 < ctg_start-1=10; pos 95 > ctg_end-k=90: both dropped
    verbose = [("r1", "c1", "3", "5:+_1:+ 50:+_10:+ 95:+_20:+")]
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t1\t140:+_10:+"]


def test_unplaced_contig_kept_as_is(tmp_path):
    agp = [("s0", 101, 200, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c2", "1", "7:+_3:+")]
    # c2 not in the AGP: with zero adjusted mappings it is dropped
    assert run(tmp_path, agp, verbose) == []


def test_self_named_scaffold_identity(tmp_path):
    # path_id == contig id: coordinates pass through unchanged
    agp = [("c1", 1, 90, 1, "W", "c1", 11, 100, "+")]
    verbose = [("r1", "c1", "1", "50:-_9:+")]
    assert run(tmp_path, agp, verbose) == ["r1\tc1\t1\t50:-_9:+"]


def test_merged_runs_and_non_monotonic_drop(tmp_path):
    # two contigs land in one scaffold; runs merge in order
    agp = [
        ("s0", 1, 90, 1, "W", "c1", 1, 90, "+"),
        ("s0", 101, 190, 3, "W", "c2", 1, 90, "+"),
    ]
    verbose = [
        ("r1", "c1", "1", "10:+_5:+"),
        ("r1", "c2", "1", "20:+_200:+"),
    ]
    # c1 10 -> 10; c2 20 -> 120: merged increasing -> one row on s0
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t2\t10:+_5:+ 120:+_200:+"]
    # rows arrive c2 then c1: concatenated positions 120, 10 -> decreasing,
    # which IS monotonic -> kept
    verbose = [
        ("r1", "c2", "1", "20:+_5:+"),
        ("r1", "c1", "1", "10:+_200:+"),
    ]
    assert run(tmp_path, agp, verbose) == ["r1\ts0\t2\t120:+_5:+ 10:+_200:+"]


def _run_both(tmp_path, monkeypatch, verbose_lines, agp_rows, k=32):
    """(native C output, Python output) of the port on one input; both are
    also ntlink_tpu's output."""
    vp = tmp_path / "verbose.tsv"
    vp.write_text("".join(line + "\n" for line in verbose_lines))
    ap = tmp_path / "round.agp"
    write_agp(ap, agp_rows)

    native_out = tmp_path / "native.tsv"
    assert liftover_module() is not None
    liftover_mappings(str(vp), str(ap), str(native_out), k)
    ref_out = tmp_path / "ref.tsv"
    ref_liftover(str(vp), str(ap), str(ref_out), k)

    python_out = tmp_path / "python.tsv"
    with monkeypatch.context() as m:
        m.setattr(native_pkg, "liftover_module", lambda: None)
        liftover_mappings(str(vp), str(ap), str(python_out), k)
    assert native_out.read_bytes() == ref_out.read_bytes()
    return native_out.read_bytes(), python_out.read_bytes()


def _row(read, ctg, hits):
    body = " ".join(f"{cp}:{cs}_{rp}:{rs}" for cp, cs, rp, rs in hits)
    return f"{read}\t{ctg}\t{len(hits)}\t{body}"


def test_handcrafted_scenarios(tmp_path, monkeypatch):
    # scaffold S1 = ctgA(+) then ctgB(-); ctgC unplaced; ctgD self-named
    agp = [
        ("S1", 1, 1000, 1, "W", "ctgA", 1, 1000, "+"),
        ("S1", 1101, 2100, 3, "W", "ctgB", 1, 1000, "-"),
        ("S1", 1001, 1100, 2, "N", 100, "scaffold", "yes", "paired-ends"),
        ("ctgD", 1, 500, 1, "W", "ctgD", 1, 500, "+"),
    ]
    lines = [
        # same-scaffold merge: A then B rows both land on S1
        _row("r1", "ctgA", [(10, "+", 100, "+"), (200, "+", 300, "+")]),
        _row("r1", "ctgB", [(900, "-", 500, "+"), (700, "-", 700, "+")]),
        # unplaced contig between two sightings: subsume bookkeeping
        _row("r2", "ctgA", [(10, "+", 50, "+")]),
        _row("r2", "ctgC", [(5, "+", 120, "+")]),
        _row("r2", "ctgA", [(400, "+", 400, "+")]),
        # repeated unknown contig subsumes the scaffold between sightings
        _row("r3", "ctgC", [(5, "+", 10, "+")]),
        _row("r3", "ctgB", [(100, "+", 200, "+")]),
        _row("r3", "ctgC", [(50, "+", 400, "+")]),
        # self-named placement passes through untouched
        _row("r4", "ctgD", [(17, "-", 40, "+"), (120, "+", 200, "-")]),
        # out-of-range anchors dropped (pos > ctg_end - k)
        _row("r5", "ctgA", [(995, "+", 10, "+"), (30, "+", 60, "+")]),
        # non-monotonic concatenation across merged rows: dropped
        _row("r6", "ctgA", [(500, "+", 10, "+")]),
        _row("r6", "ctgB", [(900, "-", 200, "+")]),
        _row("r6", "ctgA", [(600, "+", 300, "+")]),
    ]
    got, exp = _run_both(tmp_path, monkeypatch, lines, agp)
    assert got == exp
    assert b"S1" in exp  # something actually lifted


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_scenarios(tmp_path, monkeypatch, seed):
    rng = np.random.default_rng(seed)
    n_ctg = 12
    agp = []
    pos = 1
    # half the contigs placed on two scaffolds, two self rows, rest unplaced
    placed = {}
    for i in range(n_ctg):
        name = f"c{i}"
        if i < 6:
            scaf = "S%d" % (i % 2)
            length = int(rng.integers(300, 1200))
            ori = "+" if rng.random() < 0.5 else "-"
            agp.append((scaf, pos, pos + length - 1, 1, "W", name, 1, length,
                        ori))
            placed[name] = length
            pos += length + 10
        elif i < 8:
            length = int(rng.integers(300, 1200))
            agp.append((name, 1, length, 1, "W", name, 1, length, "+"))
            placed[name] = length
    lines = []
    for r in range(150):
        rpos = 0
        for c in rng.choice(n_ctg, size=int(rng.integers(1, 5)),
                            replace=True):
            name = f"c{c}"
            limit = placed.get(name, 800)
            cps = sorted(int(x) for x in rng.integers(
                0, max(limit + 50, 100), int(rng.integers(1, 6))))
            if rng.random() < 0.5:
                cps = cps[::-1]
            hits = []
            for cp in cps:
                rpos += int(rng.integers(1, 50))
                hits.append((cp, "+" if rng.random() < 0.5 else "-", rpos,
                             "+" if rng.random() < 0.5 else "-"))
            lines.append(_row(f"r{r}", name, hits))
    got, exp = _run_both(tmp_path, monkeypatch, lines, agp)
    assert got == exp
    assert exp.count(b"\n") > 10


def test_liftover_cli_target(tmp_path, monkeypatch, capsys):
    """`python -m ntlink_tpu_torch liftover agp=... mappings=...`: the
    standalone drop-in for the reference's ntlink_liftover_mappings.py."""
    write_agp(tmp_path / "x.agp", [("S1", 1, 1000, 1, "W", "ctgA", 1, 1000,
                                    "+")])
    (tmp_path / "m.tsv").write_text(_row("r1", "ctgA", [(10, "+", 5, "+")])
                                    + "\n")
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["liftover", "agp=x.agp", "mappings=m.tsv", "out=o.tsv",
                   "k=32"])
    assert rc == 0
    assert (tmp_path / "o.tsv").read_text() == "r1\tS1\t1\t10:+_5:+\n"
    assert "Lifted mappings written to o.tsv" in capsys.readouterr().out
    # without agp= the target refuses, as ntlink_tpu's does
    assert cli.main(["liftover", "mappings=m.tsv"]) == 2
