"""Seconds per rebuild in the table's build and upload
(`TorchMapper.build_seconds + upload_seconds`)."""


def read(run):
    b = run.counters.get("rebuilds") or []
    return sum(r["table_s"] for r in b) / len(b) if b else None
