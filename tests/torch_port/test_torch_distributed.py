"""The port's `parallel.distributed` against ntlink_tpu's: tally
serialisation and merge, read-file sharding, and `DirTransport` (rerun over
stale blobs, garbage collection, NTLINK_RUN_ID isolation), each case of
tests/test_distributed.py run through both packages and compared; one
mixed group whose rank 0 is the JAX package's DirTransport and whose rank
1 is the port's; `TorchTransport` over gloo in two processes; and the
transport choice of `maybe_init_distributed`, which imports
``torch.distributed`` only for a coordinator. All comparisons are exact."""
import glob
import os
import pickle
import subprocess
import sys
import threading

import pytest

from ntlink_tpu.mapping import AnchorHit, ContigRun
from ntlink_tpu.pairs import PairTally
from ntlink_tpu.parallel import distributed as ref
from ntlink_tpu_torch.pairs import PairTally as PortTally
from ntlink_tpu_torch.parallel import distributed as port

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
LENGTHS = {"A": 5000, "B": 5000}


def mk_tally(gaps, cls=PairTally):
    t = cls(LENGTHS, 32, 10)
    for g in gaps:
        runs = [
            ContigRun("A", [AnchorHit(1, 4000, "+", 100, "+"),
                            AnchorHit(2, 4500, "+", 600, "+")]),
            ContigRun("B", [AnchorHit(3, 100, "+", 600 + 400 + g + 100, "+"),
                            AnchorHit(4, 600, "+", 600 + 400 + g + 600, "+")]),
        ]
        t.add_read(runs, 50000)
    return t


def test_serialize_and_merge_match_the_jax_package():
    combined = mk_tally([10, 20, 30, 40], PortTally)
    parts = [mk_tally([10, 20], PortTally), mk_tally([30, 40], PortTally)]
    blobs = [port.serialize_tally(p) for p in parts]
    r_blobs = [ref.serialize_tally(mk_tally(g)) for g in ([10, 20], [30, 40])]
    # the same wire content, so ranks of both packages can share a group
    assert [pickle.loads(b) for b in blobs] == [
        pickle.loads(b) for b in r_blobs]
    merged = port.merge_tallies(PortTally(LENGTHS, 32, 10), blobs)
    r_merged = ref.merge_tallies(PairTally(LENGTHS, 32, 10), blobs)
    assert list(merged.pairs) == list(combined.pairs)
    fields = lambda k: (k.source, k.source_ori, k.target, k.target_ori)
    assert [fields(k) for k in merged.pairs] == [
        fields(k) for k in r_merged.pairs]
    for (key, ev), r_ev in zip(combined.pairs.items(),
                               r_merged.pairs.values()):
        assert merged.pairs[key].gap_estimates == ev.gap_estimates
        assert merged.pairs[key].anchor == ev.anchor
        assert merged.pairs[key].gap_estimate() == ev.gap_estimate()
        assert (r_ev.gap_estimates, r_ev.anchor) == (
            ev.gap_estimates, ev.anchor)


def test_shard_read_files():
    files = [f"r{i}" for i in range(5)]
    for n in (1, 2, 3):
        shards = [port.shard_read_files(files, p, n) for p in range(n)]
        assert shards == [ref.shard_read_files(files, p, n)
                          for p in range(n)]
        assert sorted(sum(shards, [])) == sorted(files)
    assert port.shard_read_files(files, 1, 2) == ["r1", "r3"]


def _run_dir_group(base, per_rank_blobs, classes):
    """One thread per rank, rank r through classes[r].DirTransport."""
    n = len(per_rank_blobs)
    outs = [[] for _ in range(n)]
    errs = []

    def worker(rank):
        try:
            t = classes[rank].DirTransport(base, rank, n, timeout=30.0)
            for blob in per_rank_blobs[rank]:
                outs[rank].append(t.allgather(blob))
        except BaseException as exc:  # surfaced by the assert below
            errs.append(exc)

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not errs, errs
    return outs


GROUPS = {"port": (port, port), "jax-rank0-port-rank1": (ref, port),
          "port-rank0-jax-rank1": (port, ref)}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_dir_transport_rerun_ignores_stale_blobs(tmp_path, group):
    base = str(tmp_path / "group")
    outs1 = _run_dir_group(base, [[b"r0-run1"], [b"r1-run1"]], GROUPS[group])
    assert outs1[0][0] == outs1[1][0] == [b"r0-run1", b"r1-run1"]
    # rerun with different payloads: must see ONLY run-2 blobs
    outs2 = _run_dir_group(base, [[b"r0-run2"], [b"r1-run2"]], GROUPS[group])
    assert outs2[0][0] == outs2[1][0] == [b"r0-run2", b"r1-run2"]


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_dir_transport_gc_and_run_id(tmp_path, monkeypatch, group):
    monkeypatch.setenv("NTLINK_RUN_ID", "testrun")
    base = str(tmp_path / "group")
    blobs = [[b"a0", b"b0", b"c0"], [b"a1", b"b1", b"c1"]]
    outs = _run_dir_group(base, blobs, GROUPS[group])
    assert outs[0] == outs[1] == [
        [b"a0", b"a1"], [b"b0", b"b1"], [b"c0", b"c1"]
    ]
    run_dir = os.path.join(base, "run-testrun")
    attempts = glob.glob(os.path.join(run_dir, "attempt-*"))
    assert len(attempts) == 1, attempts
    left = sorted(
        os.path.basename(p) for p in glob.glob(f"{attempts[0]}/*")
        if os.path.basename(p)[0].isdigit()
    )
    # only the final collective's blobs remain
    assert left == ["2.0", "2.1"], left


def test_dir_transport_run_id_rerun_is_isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("NTLINK_RUN_ID", "pinned")
    base = str(tmp_path / "group")
    outs1 = _run_dir_group(base, [[b"r0-a"], [b"r1-a"]], (port, port))
    assert outs1[0][0] == [b"r0-a", b"r1-a"]
    outs2 = _run_dir_group(base, [[b"r0-b"], [b"r1-b"]], (port, port))
    assert outs2[0][0] == outs2[1][0] == [b"r0-b", b"r1-b"]


def test_file_tallies_and_parts_merge_in_file_order(tmp_path, monkeypatch):
    """One process: `all_gather_file_tallies` merges by file index, not by
    insertion, and `merge_file_parts` concatenates in file order and
    removes the parts."""
    monkeypatch.setattr(port, "_TRANSPORT", port.LocalTransport())
    per_file = {1: mk_tally([30, 40], PortTally), 0: mk_tally([10, 20],
                                                              PortTally)}
    merged = port.all_gather_file_tallies(per_file, PortTally(LENGTHS, 32, 10))
    want = mk_tally([10, 20, 30, 40], PortTally)
    assert [(k, e.gap_estimates, e.anchor) for k, e in merged.pairs.items()] \
        == [(k, e.gap_estimates, e.anchor) for k, e in want.pairs.items()]
    parts = {}
    for fi, text in ((1, b"second\n"), (0, b"first\n")):
        parts[fi] = str(tmp_path / f"out.part{fi}")
        with open(parts[fi], "wb") as fh:
            fh.write(text)
    port.merge_file_parts(str(tmp_path / "out"), parts)
    assert (tmp_path / "out").read_bytes() == b"first\nsecond\n"
    assert sorted(os.listdir(tmp_path)) == ["out"]


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


GLOO_RANK = """
import sys
from ntlink_tpu_torch.parallel import distributed as d
pid, n = d.maybe_init_distributed()
t = d.get_transport()
assert type(t).__name__ == "TorchTransport" and (t.process_id, t.n_processes) == (pid, n)
blobs = [b"x" * (3 + 40 * pid), b"", bytes(range(256)) * (pid + 1)]
for b in blobs:
    print(repr(t.allgather(b)))
assert "jax" not in sys.modules
"""


def test_torch_transport_allgathers_over_gloo():
    """Two processes, blobs of unequal and of zero length."""
    for attempt in range(2):  # the free port can be taken before the bind
        env = {**os.environ, "PYTHONPATH": REPO, "NTLINK_NUM_PROCESSES": "2",
               "NTLINK_COORDINATOR": f"127.0.0.1:{_free_port()}"}
        env.pop("NTLINK_GROUP_DIR", None)
        ranks = [subprocess.Popen(
            [sys.executable, "-c", GLOO_RANK],
            env={**env, "NTLINK_PROCESS_ID": str(pid)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ) for pid in range(2)]
        outs = [p.communicate(timeout=240) for p in ranks]
        if all(p.returncode == 0 for p in ranks):
            break
        assert attempt == 0, [o[1][-2000:] for o in outs]
    want = [
        [b"xxx", b"x" * 43], [b"", b""],
        [bytes(range(256)), bytes(range(256)) * 2],
    ]
    for out, _ in outs:
        assert [eval(line) for line in out.splitlines()] == want


CHOICE = """
import sys
from ntlink_tpu_torch.parallel import distributed as d
print(d.maybe_init_distributed(), type(d.get_transport()).__name__,
      "torch.distributed" in sys.modules)
"""


@pytest.mark.parametrize("env,want", [
    ({}, "(0, 1) LocalTransport False"),
    ({"NTLINK_NUM_PROCESSES": "1", "NTLINK_COORDINATOR": "127.0.0.1:9"},
     "(0, 1) LocalTransport False"),
    # JAX_COORDINATOR is not read
    ({"NTLINK_NUM_PROCESSES": "2", "JAX_COORDINATOR": "127.0.0.1:9"},
     "(0, 1) LocalTransport False"),
])
def test_transport_choice_without_a_group(env, want):
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("NTLINK_", "JAX_COORD"))}
    res = subprocess.run(
        [sys.executable, "-c", CHOICE], capture_output=True, text=True,
        env={**base, "PYTHONPATH": REPO, **env}, timeout=240,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == want
