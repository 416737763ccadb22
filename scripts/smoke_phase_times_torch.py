"""Seconds by phase of a run of a `chip_smoke.py`, read off its output.

    python3 scripts/smoke_phase_times_torch.py <checkout> <log> [<json>]
    python3 scripts/smoke_phase_times_torch.py --read <log>

Runs ``python3 chip_smoke.py`` in `<checkout>` (this repository, or an
unpacked `git archive` of an earlier commit), stamps every line of its
output (standard error too) with the seconds since the start, writes the
stamped lines to `<log>`, and prints (and writes to `<json>`) one JSON
object: the exit code, the total wall seconds, and the seconds of each
phase. With --read it reads a log written so and prints the same object
without the exit code. A phase is named by the token after "phase " at
the start of a line ("2a", "3", "14b", ...); the time from one such line
to the next belongs to the phase of the later line, so the lines without
a prefix that a phase prints while it runs (the CLI's, the bench's, the
JSON lines of phases 6 and 11) count for the phase whose line follows
them. Works on any version of the smoke, also one that does not time its
phases itself; where the output holds the smoke's own `phase seconds`
line, that line's seconds are reported instead (`phase_s_from` says
which).
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time

PHASE = re.compile(r"^(?:FAIL: )?phase (\d+[a-z]?)\b")
#: the smoke's own seconds of every phase, the line before its two JSON lines
OWN = re.compile(r"^phase seconds \([^)]*\): (\{.*\})$")


def phase_seconds(stamped) -> tuple:
    """({phase: seconds}, where they came from) of [(seconds since the
    start, line)]: the smoke's own line if there is one, else the stamps."""
    for _, line in stamped:
        m = OWN.match(line)
        if m:
            return json.loads(m.group(1)), "smoke"
    out = {}
    last = 0.0
    for t, line in stamped:
        m = PHASE.match(line)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0.0) + t - last
            last = t
    return {k: round(v, 1) for k, v in out.items()}, "stamps"


def read_log(path: str) -> list:
    """[(seconds, line)] of a log that `main` wrote."""
    stamped = []
    with open(path, errors="replace") as fh:
        for row in fh:
            t, _, line = row.rstrip("\n").lstrip().partition(" ")
            stamped.append((float(t), line))
    return stamped


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2 and argv[0] == "--read":
        stamped = read_log(argv[1])
        phase_s, source = phase_seconds(stamped)
        print(json.dumps({"log": argv[1], "total_s": stamped[-1][0],
                          "phase_s": phase_s, "phase_s_from": source}))
        return 0
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    checkout, log_path = argv[:2]
    t0 = time.perf_counter()
    stamped = []
    with open(log_path, "w") as log, subprocess.Popen(
        [sys.executable, "chip_smoke.py"], cwd=checkout,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        errors="replace",
    ) as proc:
        for line in proc.stdout:
            t = time.perf_counter() - t0
            line = line.rstrip("\n")
            stamped.append((t, line))
            log.write(f"{t:9.1f} {line}\n")
            log.flush()
    phase_s, source = phase_seconds(stamped)
    out = {"checkout": checkout, "rc": proc.returncode,
           "total_s": round(time.perf_counter() - t0, 1),
           "phase_s": phase_s, "phase_s_from": source,
           "last_lines": [line for _, line in stamped[-3:]]}
    text = json.dumps(out)
    print(text, flush=True)
    if len(argv) == 3:
        with open(argv[2], "w") as fh:
            fh.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
