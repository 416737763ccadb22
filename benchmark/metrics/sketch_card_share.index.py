"""Share of the contig bases that the card sketched in the hybrid contig
sketch (`TorchHybridSketcher.device_bases` over device plus host bases),
over the window's rebuilds."""


def read(run):
    b = run.counters.get("rebuilds") or []
    dev = sum(r["device_bases"] for r in b)
    host = sum(r["host_bases"] for r in b)
    return 100.0 * dev / (dev + host) if dev + host else None
