"""`chip_smoke.py`'s own plumbing, on the CPU (no card is opened).

- Its clock keeps each phase's seconds under the name it was started
  with, and names the running one when an exception escapes `main`.
- A phase that raises prints one `chip_smoke_failed:` line naming itself
  (with the error and its seconds) and the script exits non-zero with no
  result line: CUDA faked as available, the phase before it stubbed.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def test_the_clock_books_each_phase_under_its_name(capsys):
    clock = chip_smoke._PhaseClock()
    assert clock.current is None
    clock.start("build")
    clock.start("kernel_checks")
    assert clock.current == "kernel_checks" and list(clock.secs) == ["build"]
    clock.fail(ValueError("bad"))
    failed = json.loads(capsys.readouterr().out.split("chip_smoke_failed: ", 1)[1])
    assert failed["phase"] == "kernel_checks" and failed["error"] == "ValueError: bad" and failed["secs"] >= 0
    line = json.loads(clock.line())
    assert set(line) == {"build", "total"} and line["total"] >= line["build"] >= 0


_DRIVER = """
import sys
sys.path.insert(0, %(repo)r)
import torch
torch.cuda.is_available = lambda: True
import chip_smoke
from adanet_tpu_torch.ops import _build

def boom(*args, **kwargs):
    raise RuntimeError("stub phase failed")

chip_smoke.card_line = lambda: "stub card, 700.00 W"
_build.self_test = lambda: None
chip_smoke.build_kernels = %(build)s
chip_smoke.served_ensemble = boom
sys.exit(chip_smoke.main([]))
"""


@pytest.mark.parametrize("raising,phase", [("build_kernels", "build"), ("served_ensemble", "kernel_checks")])
def test_a_failing_phase_names_itself(tmp_path, raising, phase):
    code = _DRIVER % dict(repo=REPO, build="boom" if raising == "build_kernels" else "lambda: None")
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    lines = [line for line in out.stdout.splitlines() if line.startswith("chip_smoke_failed: ")]
    assert len(lines) == 1, out.stdout + out.stderr
    failed = json.loads(lines[0][len("chip_smoke_failed: "):])
    assert failed["phase"] == phase
    assert failed["error"] == "RuntimeError: stub phase failed"
    assert failed["secs"] >= 0
    assert '"ok"' not in out.stdout
    assert "RuntimeError: stub phase failed" in out.stderr
