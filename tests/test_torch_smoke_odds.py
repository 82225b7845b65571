"""`smoke_odds.py` (beside `chip_smoke.py`): the chances it gives for
`chip_smoke.py`'s chance- and time-dependent checks, on a synthetic log.

- the first passage at a single look against the binomial tail summed
  directly, the Wilson bound against its rate;
- a run's chances: the shadow's (a rate far under its bound gives a
  chance under 1e-3, one near the bound likely; two runs pooled), the
  heartbeat's, a wait's and the script's (shrinking as the margin
  grows), the exit status at 1 in 1,000;
- its usage, run as a script.
"""

import json
import math
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import smoke_odds  # noqa: E402


def test_binomial_tail_and_wilson_bound():
    n, p, bound = 40, 0.2, 0.3
    direct = sum(math.comb(n, i) * p ** i * (1 - p) ** (n - i) for i in range(13, n + 1))
    assert smoke_odds.first_passage(p, bound, horizon=n, first=n) == pytest.approx(direct, rel=1e-9)
    # More looks, more chances to pass.
    assert smoke_odds.first_passage(p, bound, horizon=2 * n, first=n) > direct
    assert 0.1 < smoke_odds.upper_rate(100, 1000) < 0.14
    assert smoke_odds.normal_sf(0.0) == pytest.approx(0.5)


def _log(divergence=0.09, max_age=0.3, wait_secs=50.0, total=820.0):
    rows = {
        "serving_fleet": {
            "cascade": {"shadow_divergence_bound": 0.278},
            "shadow": {"r0": {"shadow_divergence": divergence, "shadow_rows": 3600},
                       "r1": {"shadow_divergence": divergence, "shadow_rows": 300},
                       "r2": {"shadow_divergence": None, "shadow_rows": 0}},
            "max_heartbeat_age_secs": {"r0": max_age, "r1": 0.2},
        },
        "waits": {"serving_example": [wait_secs, 300]},
        "phase_secs": {"total": total},
        "multihost_peer_death": {"max_agreement_secs": 0.5, "deadline_secs": 5},
    }
    return "\n".join("%s: %s" % (name, json.dumps(row)) for name, row in rows.items())


def test_chances_of_a_run(tmp_path):
    secs = [883.7, 948.1, 1369.6, 968.4, 908.3, 840.1]
    calm = smoke_odds.odds([_log()], secs)
    assert 1e-6 < calm["shadow"]["chance"] < 1e-3
    assert calm["heartbeat"]["chance"] < 1e-6
    assert calm["wait serving_example"]["chance"] < 1e-6
    assert calm["chaos_deadline"]["chance"] < 1e-6
    assert 1e-3 < calm["script"]["chance"] < 0.2
    near = smoke_odds.odds([_log(divergence=0.27, max_age=1.9, wait_secs=290.0, total=1190.0)], secs)
    # Two runs pool the shadow's rows (a tighter rate) and keep the worst
    # of every other reading.
    pooled = smoke_odds.odds([_log(), _log(wait_secs=290.0)], secs)
    assert pooled["shadow"]["rows"] == 2 * calm["shadow"]["rows"]
    assert pooled["shadow"]["chance"] < calm["shadow"]["chance"]
    assert pooled["wait serving_example"]["chance"] == near["wait serving_example"]["chance"]
    assert near["shadow"]["chance"] > 0.3
    assert near["heartbeat"]["chance"] > 0.4
    assert near["wait serving_example"]["chance"] > 0.4
    assert near["script"]["chance"] > 0.4
    log = tmp_path / "smoke.log"
    log.write_text(_log())
    assert smoke_odds.main([str(log), "--script-secs", *map(str, secs)]) == 1  # the script's chance
    (tmp_path / "fast.log").write_text(_log(total=400.0))
    assert smoke_odds.main([str(tmp_path / "fast.log"), "--script-secs", *map(str, secs)]) == 0
    (tmp_path / "empty.log").write_text("")
    assert smoke_odds.main([str(tmp_path / "empty.log"), "--script-secs", "1", "2"]) == 2


def test_usage_as_a_script():
    out = subprocess.run([sys.executable, os.path.join(REPO, "smoke_odds.py"), "--help"], capture_output=True,
                         text=True, timeout=60)
    assert out.returncode == 0 and "--script-secs" in out.stdout
