"""The port refuses tracing (v=1) until it is ported, instead of running
without it: ``ntlink_tpu.cli`` lets no knob silently do nothing
(cli.py:131-134)."""
import os
import subprocess
import sys

import pytest

from ntlink_tpu.config import ScaffoldConfig
from ntlink_tpu_torch import pipeline

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
MESSAGE = "not yet ported: v (tracing)"


def test_check_supported_refuses_tracing():
    cfg = ScaffoldConfig(target="t.fa", reads=["r.fa"], v=1)
    with pytest.raises(pipeline.NotPorted, match=r"v \(tracing\)"):
        pipeline.check_supported(cfg)
    pipeline.check_supported(ScaffoldConfig(target="t.fa", reads=["r.fa"]))


def test_cli_prints_tracing_refusal(tmp_path):
    """The refusal comes before the card is looked for: without a card the
    command exits 2 either way, so the message is what shows it."""
    res = subprocess.run(
        [sys.executable, "-m", "ntlink_tpu_torch", "pair",
         "target=target.fa", "reads=reads.fa", "v=1"],
        cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": REPO}, timeout=300,
    )
    assert res.returncode == 2
    assert MESSAGE in res.stderr
