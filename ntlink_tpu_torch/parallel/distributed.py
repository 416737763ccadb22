"""Multi-process orchestration.

Counterpart of ``ntlink_tpu/parallel/distributed.py``; the host parts are
the same code under the same names, and ``JaxTransport`` is
`TorchTransport` over ``torch.distributed``.

- every process runs the same pipeline; `maybe_init_distributed()`
  connects them into one process group when NTLINK_COORDINATOR
  (``host:port``), NTLINK_NUM_PROCESSES and NTLINK_PROCESS_ID are set
  (JAX_COORDINATOR is not read). Setting NTLINK_GROUP_DIR instead selects
  a shared-directory transport (NFS-style deployments / tests) that needs
  no coordinator service and never imports ``torch.distributed``,
- the contig index is built once per host (the build is deterministic, so
  every host builds the same replicated table from the same target FASTA),
- read files are partitioned across hosts round-robin (`shard_read_files`);
  within a host, batches split across its local devices
  (`device_map.TorchMapper(devices=...)`),
- each host's pair tally is all-gathered and merged after mapping
  (`all_gather_tallies`): the tally is a per-pair list of gap estimates +
  anchor counts, which merges associatively; medians are taken after the
  merge, exactly as the reference computes them over the global dict,
- per-host verbose/PAF artifact parts (one per read file) are exchanged and
  concatenated in global read-file order (`merge_file_parts`), so every
  host ends up with the reference's canonical single files
  (ntlink_pair.py:382-388) and gap_fill / rounds / checkpoints work
  unchanged at n_processes > 1.

The result is bit-identical to a single-host run: per-file artifact parts
re-interleave into exactly the single-host byte order, and the tally merge
follows the same global order.
"""
from __future__ import annotations

import atexit
import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

from ..pairs import PairEvidence, PairKey, PairTally


class Transport:
    """Collective byte exchange over the process group."""

    process_id = 0
    n_processes = 1

    def allgather(self, blob: bytes) -> List[bytes]:
        raise NotImplementedError


class LocalTransport(Transport):
    def allgather(self, blob: bytes) -> List[bytes]:
        return [blob]


class TorchTransport(Transport):
    """Rides a ``torch.distributed`` process group on the gloo backend:
    the blobs are pickled host data, and two ranks that share one card
    cannot form an NCCL group. The group is destroyed at exit so that no
    rank hangs in its teardown."""

    def __init__(self, coordinator: str, process_id: int, n_processes: int,
                 timeout: float = 300.0):
        import datetime

        import torch.distributed as dist

        self.process_id = process_id
        self.n_processes = n_processes
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=n_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=timeout),
        )
        atexit.register(self.close)

    def allgather(self, blob: bytes) -> List[bytes]:
        import numpy as np
        import torch
        import torch.distributed as dist

        # lengths first, then the blobs padded to the longest
        n = self.n_processes
        lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
        dist.all_gather(lengths, torch.tensor([len(blob)], dtype=torch.int64))
        max_len = max(max(int(t) for t in lengths), 1)
        padded = torch.from_numpy(
            np.frombuffer(blob.ljust(max_len, b"\0"), dtype=np.uint8).copy()
        )
        gathered = [torch.zeros(max_len, dtype=torch.uint8) for _ in range(n)]
        dist.all_gather(gathered, padded)
        return [
            gathered[i][: int(lengths[i])].numpy().tobytes() for i in range(n)
        ]

    def close(self) -> None:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _read_pointer(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read().strip() or None
    except FileNotFoundError:
        return None


def _glob_joins(run_dir: str, rank: int) -> List[str]:
    """Join files for `rank`, excluding in-flight `.tmp.<pid>` writes."""
    import glob

    return [
        p
        for p in glob.glob(os.path.join(run_dir, f"join.{rank}.*"))
        if len(os.path.basename(p).split(".")) == 3
    ]


class DirTransport(Transport):
    """Shared-directory collective (NFS deployments, multi-process tests).

    Each call writes `<attempt-dir>/<seq>.<rank>` atomically (tmp + rename)
    and waits for all ranks' files; a per-instance sequence number keeps
    successive collectives from colliding (all ranks issue collectives in
    the same program order).

    Collectives live in a per-attempt namespace, established by an explicit
    join handshake (never by file mtimes, which race on quick reruns):

    - rank 0 mints a fresh `attempt-<nonce>` directory and publishes the
      nonce via an atomically-replaced CURRENT pointer, then waits for a
      `join.<rank>.<token>` file from every peer inside that directory and
      acknowledges each with `ack.<rank>.<token>`,
    - every other rank polls CURRENT, writes its join (with a fresh random
      token) into whichever attempt is currently published, and only adopts
      an attempt once it sees the ack matching its own token. A stale
      CURRENT from an earlier run can never be adopted: its dead rank 0
      will never ack the fresh token, and the rank keeps following CURRENT
      until the live rank 0 publishes and acks.

    Because every attempt handshakes a brand-new namespace, back-to-back
    reruns over the same group directory (with or without NTLINK_RUN_ID,
    which merely scopes the namespace under `run-<id>`) can never consume a
    previous attempt's blobs. Old attempt directories are inert litter;
    callers may delete the group dir between runs. Consumed blobs are
    garbage-collected one collective later (when this rank completes
    collective `seq`, every rank has completed `seq-1` — see allgather)."""

    def __init__(self, path: str, process_id: int, n_processes: int,
                 timeout: float = 300.0):
        import uuid

        self.process_id = process_id
        self.n_processes = n_processes
        self.timeout = timeout
        self._seq = 0
        run_id = os.environ.get("NTLINK_RUN_ID")
        base = os.path.join(path, f"run-{run_id}") if run_id else path
        os.makedirs(base, exist_ok=True)
        current = os.path.join(base, "CURRENT")
        deadline = time.time() + timeout
        if process_id == 0:
            nonce = uuid.uuid4().hex[:12]
            self.dir = os.path.join(base, f"attempt-{nonce}")
            os.makedirs(self.dir)
            self._publish(current, nonce)
            pending = set(range(1, n_processes))
            while pending:
                for rank in sorted(pending):
                    for join in _glob_joins(self.dir, rank):
                        token = join.rsplit(".", 1)[1]
                        self._publish(
                            os.path.join(self.dir, f"ack.{rank}.{token}"),
                            "",
                        )
                        pending.discard(rank)
                if not pending:
                    break
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank 0: ranks {sorted(pending)} never joined "
                        f"attempt {nonce} in {base} (all ranks must be "
                        f"launched for every attempt; each attempt "
                        f"handshakes a fresh namespace, so reuse of the "
                        f"group dir is safe)"
                    )
                time.sleep(0.02)
        else:
            token = uuid.uuid4().hex[:12]
            joined: set = set()
            while True:
                nonce = _read_pointer(current)
                if nonce:
                    d = os.path.join(base, f"attempt-{nonce}")
                    if os.path.isdir(d):
                        if nonce not in joined:
                            self._publish(
                                os.path.join(
                                    d, f"join.{process_id}.{token}"
                                ),
                                "",
                            )
                            joined.add(nonce)
                        if os.path.exists(
                            os.path.join(d, f"ack.{process_id}.{token}")
                        ):
                            self.dir = d
                            break
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {process_id}: rank 0 never acknowledged the "
                        f"join in {base} (is rank 0 up and launched for "
                        f"this attempt?)"
                    )
                time.sleep(0.02)

    @staticmethod
    def _publish(path: str, content: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(content)
        os.replace(tmp, path)

    def allgather(self, blob: bytes) -> List[bytes]:
        seq = self._seq
        self._seq += 1
        mine = os.path.join(self.dir, f"{seq}.{self.process_id}")
        tmp = mine + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, mine)
        parts = []
        deadline = time.time() + self.timeout
        for rank in range(self.n_processes):
            path = os.path.join(self.dir, f"{seq}.{rank}")
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {rank} never produced {path} (every attempt "
                        f"over a group dir handshakes its own namespace; a "
                        f"missing blob means that rank died or was never "
                        f"launched — relaunch all ranks together)"
                    )
                time.sleep(0.02)
            with open(path, "rb") as fh:
                parts.append(fh.read())
        # GC: completing collective `seq` proves every rank finished
        # `seq-1` (each read all ranks' seq files, which are written only
        # after their writers finished seq-1), so this rank's seq-1 blob can
        # no longer be read by anyone.
        if seq > 0:
            try:
                os.unlink(os.path.join(self.dir, f"{seq - 1}.{self.process_id}"))
            except FileNotFoundError:
                pass
        return parts


_TRANSPORT: Optional[Transport] = None


def get_transport() -> Transport:
    global _TRANSPORT
    if _TRANSPORT is None:
        maybe_init_distributed()
    return _TRANSPORT


def maybe_init_distributed() -> Tuple[int, int]:
    """Initialize the process group from env; returns (pid, n_processes).

    No-op single-process when unconfigured. NTLINK_GROUP_DIR selects the
    shared-directory transport; otherwise NTLINK_COORDINATOR selects
    the ``torch.distributed`` transport (imported only then).
    """
    global _TRANSPORT
    if _TRANSPORT is not None:
        return _TRANSPORT.process_id, _TRANSPORT.n_processes
    n = int(os.environ.get("NTLINK_NUM_PROCESSES", "0") or 0)
    pid = int(os.environ.get("NTLINK_PROCESS_ID", "0") or 0)
    group_dir = os.environ.get("NTLINK_GROUP_DIR")
    coord = os.environ.get("NTLINK_COORDINATOR")
    if group_dir and n > 1:
        _TRANSPORT = DirTransport(group_dir, pid, n)
        return pid, n
    if coord and n > 1:
        _TRANSPORT = TorchTransport(coord, pid, n)
        return pid, n
    _TRANSPORT = LocalTransport()
    return 0, 1


def shard_read_files(files: List[str], process_id: int, n_processes: int) -> List[str]:
    """Round-robin partition of read files across hosts."""
    return [f for i, f in enumerate(files) if i % n_processes == process_id]


def serialize_tally(tally: PairTally) -> bytes:
    payload = [
        (
            (p.source, p.source_ori, p.target, p.target_ori),
            ev.gap_estimates,
            ev.anchor,
        )
        for p, ev in tally.pairs.items()
    ]
    return pickle.dumps(payload)


def merge_tallies(
    base: PairTally, serialized_parts: List[bytes]
) -> PairTally:
    """Merge per-host tallies into `base` (order: parts in the given order).

    Gap-estimate lists concatenate; anchors add. The merged per-pair
    insertion order is the first sighting across parts in order, which keeps
    pairs.tsv deterministic for a fixed file partition.
    """
    for blob in serialized_parts:
        for (s, so, t, to), gaps, anchor in pickle.loads(blob):
            key = PairKey(s, so, t, to)
            ev = base.pairs.get(key)
            if ev is None:
                ev = base.pairs[key] = PairEvidence()
            ev.gap_estimates.extend(gaps)
            ev.anchor += anchor
    return base


def all_gather_tallies(tally: PairTally) -> PairTally:
    """All-gather the per-host tallies over the process group."""
    transport = get_transport()
    if transport.n_processes == 1:
        return tally
    parts = transport.allgather(serialize_tally(tally))
    merged = PairTally(tally.contig_lengths, tally.k, tally.f_cap)
    return merge_tallies(merged, parts)


def all_gather_file_tallies(
    per_file: Dict[int, PairTally], template: PairTally
) -> PairTally:
    """All-gather per-read-file tallies and merge them in global file order.

    Merging file-by-file (not host-by-host) reproduces the single-host
    insertion and gap-list order exactly, so pairs.tsv / DOT / medians are
    byte-identical to an unsharded run.
    """
    transport = get_transport()
    payload = {fi: serialize_tally(t) for fi, t in per_file.items()}
    if transport.n_processes > 1:
        merged_blobs: Dict[int, bytes] = {}
        for blob in transport.allgather(pickle.dumps(payload)):
            merged_blobs.update(pickle.loads(blob))
    else:
        merged_blobs = payload
    merged = PairTally(template.contig_lengths, template.k, template.f_cap)
    return merge_tallies(
        merged, [merged_blobs[fi] for fi in sorted(merged_blobs)]
    )


def merge_file_parts(final_path: str, my_parts: Dict[int, str]) -> None:
    """Exchange per-read-file artifact parts and write the canonical file.

    `my_parts` maps global read-file index -> local part path for the files
    this host mapped. All hosts receive every part and concatenate them in
    file-index order, reproducing the single-host byte order exactly
    (reference contract: one verbose file, ntlink_pair.py:382-388). Each
    host writes the result atomically to its local filesystem (identical
    content everywhere, so shared-FS double writes are benign); local part
    files are removed.

    Production note: parts travel over the group transport — for huge
    verbose checkpoints prefer a shared filesystem (NTLINK_GROUP_DIR).
    """
    transport = get_transport()
    payload = {}
    for idx, path in my_parts.items():
        with open(path, "rb") as fh:
            payload[idx] = fh.read()
    if transport.n_processes > 1:
        gathered = transport.allgather(pickle.dumps(payload))
        merged: Dict[int, bytes] = {}
        for blob in gathered:
            merged.update(pickle.loads(blob))
    else:
        merged = payload
    tmp = final_path + ".tmp"
    with open(tmp, "wb") as fh:
        for idx in sorted(merged):
            fh.write(merged[idx])
    os.replace(tmp, final_path)
    for path in my_parts.values():
        if os.path.exists(path):
            os.unlink(path)
