"""`scripts/smoke_phase_times_torch.py`: seconds by phase read off a smoke
run's output, here of a stand-in `chip_smoke.py` that prints as the real
one does."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
SCRIPT = os.path.join(REPO, "scripts", "smoke_phase_times_torch.py")

STAND_IN = '''
import sys, time
def say(line, wait=0.0):
    time.sleep(wait)
    print(line, flush=True)
say("phase 0: nvidia-smi: card")
say("phase 1: k=32 w=100", 0.3)
say("phase 2: dataset written", 0.2)
say("phase 2a: port pair on the card", 0.4)
say('{"json": "of phase 2a"}', 0.2)
say("seconds of phase 2-4: 1.1")
say("phase 13: contig sketch", 0.1)
print("stderr line", file=sys.stderr, flush=True)
if OWN:
    say('phase seconds (card, 700.00 W): {"0": 0.0, "1": 0.3, "13": 0.3}')
say("FAIL: phase 13: the TSVs differ", 0.2)
sys.exit(1)
'''


@pytest.mark.parametrize("own", [False, True],
                         ids=["stamps", "the smoke's own line"])
def test_phase_seconds_of_a_stand_in_smoke(tmp_path, own):
    (tmp_path / "chip_smoke.py").write_text(f"OWN = {own}\n" + STAND_IN)
    log, out_json = tmp_path / "smoke.log", tmp_path / "phases.json"
    res = subprocess.run(
        [sys.executable, SCRIPT, str(tmp_path), str(log), str(out_json)],
        capture_output=True, text=True, timeout=60, check=True)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out == json.loads(out_json.read_text())
    assert out["rc"] == 1
    s = out["phase_s"]
    read = subprocess.run([sys.executable, SCRIPT, "--read", str(log)],
                          capture_output=True, text=True, timeout=60,
                          check=True)
    again = json.loads(read.stdout)
    assert out["last_lines"][-1] == "FAIL: phase 13: the TSVs differ"
    stamped = log.read_text().splitlines()
    assert len(stamped) == 9 + own and stamped[-2 - own].split(None, 1)[1] \
        == "stderr line"
    if own:
        # the smoke's own seconds, as it printed them
        assert out["phase_s_from"] == again["phase_s_from"] == "smoke"
        assert s == again["phase_s"] == {"0": 0.0, "1": 0.3, "13": 0.3}
        return
    assert out["phase_s_from"] == again["phase_s_from"] == "stamps"
    # the "seconds of phase" line heads no phase
    assert list(s) == ["0", "1", "2", "2a", "13"]
    # the time up to a phase's line is that phase's, the unprefixed JSON
    # line's 0.2 s and the stderr line included in phase 13's
    assert s["1"] >= 0.25 and s["2"] >= 0.15
    assert s["2a"] >= 0.35 and s["13"] >= 0.45
    assert out["total_s"] >= sum(s.values())
    # the log keeps tenths of a second
    assert again["phase_s"].keys() == s.keys()
    assert all(abs(again["phase_s"][k] - s[k]) <= 0.2 for k in s)


def test_usage_without_arguments():
    res = subprocess.run([sys.executable, SCRIPT], capture_output=True,
                         text=True, timeout=60)
    assert res.returncode == 2 and "phase" in res.stderr
