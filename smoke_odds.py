"""The chance that each chance- or time-dependent check of `chip_smoke.py`
fails a run, from the script's own output.

    python3 smoke_odds.py LOG [LOG ...] --script-secs S S [S ...]

Each LOG is the standard output of one whole `python3 chip_smoke.py`
run; several are pooled into one larger sample (the shadow's counts
summed; each other reading its worst over the logs that carry it). The
chances, one a line:

- `shadow`: a `serving_fleet` replica's shadow rolling its distilled level
  0 back by chance. The rule (`serving/batcher.py`): after at least 64
  shadowed rows, a running disagreement past the published bound rolls
  back. The rows' true disagreement is taken at the upper 99.9% bound of
  the run's pooled shadow counts, and the chance is that of the running
  rate passing the bound at any row count from 64 to the shadow's window
  of 4,096 rows (`first_passage`, exact for a look after every row),
  times the replicas.
- `wait <name>`, `heartbeat`, `chaos_deadline` and `script`: a reading
  against its limit on another host. The readings: a bounded wait (the
  `waits:` line: the longest seconds each took and its limit), the
  oldest heartbeat `serving_fleet` saw (`max_heartbeat_age_secs`) against
  the balancer's staleness bound (2 s), the multi-host peer-death run's
  longest agreement that returned in time (`max_agreement_secs`) against
  its deadline, and the whole script (its `phase_secs` total) against
  its 1,200-s limit. Host speed is modelled as log-normal, its spread
  (sigma of log seconds) from `--script-secs`, the whole-script seconds
  of runs on different hosts; two hosts' ratio then has sigma x sqrt(2),
  and the chance is that of a ratio past the limit over the reading.

Exit status: 0 when every chance is below 1 in 1,000 (`BELOW`), 1
otherwise, 2 when no log holds a line it needs.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Dict, List, Optional, Sequence

#: The balancer's staleness bound and the script's time limit, seconds.
HEARTBEAT_STALE_SECS = 2.0
SCRIPT_LIMIT_SECS = 1200.0
#: The shadow's rule: its first look, and the window it halves at.
SHADOW_MIN_ROWS, SHADOW_WINDOW = 64, 4096
#: The chance a run every check must stay below.
BELOW = 1e-3


def normal_sf(z: float) -> float:
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def upper_rate(successes: float, n: float, z: float = 3.090232) -> float:
    """The one-sided upper Wilson bound of a binomial rate (99.9% at the
    default z)."""
    if n <= 0:
        return 1.0
    p = successes / n
    center = p + z * z / (2 * n)
    spread = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return min(1.0, (center + spread) / (1 + z * z / n))


def first_passage(p: float, bound: float, horizon: int = SHADOW_WINDOW, first: int = SHADOW_MIN_ROWS) -> float:
    """The chance that a running rate of Bernoulli(p) rows passes `bound`
    at some row count from `first` to `horizon`, looking after every row
    (more often than the shadow, which looks after a batch, so an upper
    bound of its chance): the rows' disagreement count carried exactly,
    the paths past the bound absorbed."""
    import numpy as np

    mass = np.zeros(horizon + 2)
    mass[0] = 1.0
    passed = 0.0
    for n in range(1, horizon + 1):
        mass[1:n + 1] = mass[1:n + 1] * (1 - p) + mass[0:n] * p
        mass[0] *= 1 - p
        if n >= first:
            over = int(math.floor(bound * n)) + 1
            if over <= n:
                passed += float(mass[over:n + 1].sum())
                mass[over:n + 1] = 0.0
    return min(1.0, passed)


def host_sigma(script_secs: Sequence[float]) -> float:
    """The sample standard deviation of log whole-script seconds."""
    logs = [math.log(s) for s in script_secs]
    mean = sum(logs) / len(logs)
    return math.sqrt(sum((x - mean) ** 2 for x in logs) / (len(logs) - 1))


def margin_chance(secs: float, limit: float, sigma: float) -> float:
    """The chance another host takes longer than `limit` where this one
    took `secs` (module docstring)."""
    if secs <= 0:
        return 0.0
    return normal_sf(math.log(limit / secs) / (sigma * math.sqrt(2.0)))


def _rows(log_text: str) -> Dict[str, dict]:
    rows = {}
    for line in log_text.splitlines():
        name, sep, rest = line.partition(": ")
        if sep and name.isidentifier() and rest.startswith("{"):
            try:
                rows[name] = json.loads(rest)
            except ValueError:
                continue
    return rows


def odds(log_texts: Sequence[str], script_secs: Sequence[float]) -> Dict[str, dict]:
    """Every check's chance a run, by name, from the pooled output of one
    or more runs."""
    runs = [_rows(text) for text in log_texts]
    fleets = [r["serving_fleet"] for r in runs if "serving_fleet" in r]
    with_waits = [r["waits"] for r in runs if "waits" in r]
    totals = [float(r["phase_secs"]["total"]) for r in runs if "phase_secs" in r]
    deaths = [r["multihost_peer_death"] for r in runs if "max_agreement_secs" in r.get("multihost_peer_death", {})]
    missing = [name for name, found in (("serving_fleet", fleets), ("waits", with_waits), ("phase_secs", totals),
                                        ("max_agreement_secs", deaths)) if not found]
    if missing:
        raise KeyError("no log holds %s" % ", ".join(missing))
    sigma = host_sigma(script_secs)
    rows: Dict[str, float] = {}
    divergence: Dict[str, float] = {}
    for run, fleet in enumerate(fleets):
        for replica, v in fleet["shadow"].items():
            key = "%d/%s" % (run, replica)
            rows[key] = float(v["shadow_rows"])
            # A replica that shadowed no row reports no divergence.
            divergence[key] = float(v["shadow_divergence"] or 0.0)
    bound = min(float(f["cascade"]["shadow_divergence_bound"]) for f in fleets)
    replicas = max(len(f["shadow"]) for f in fleets)
    p = upper_rate(sum(rows[r] * divergence[r] for r in rows), sum(rows.values()))
    out = {"shadow": dict(chance=min(1.0, first_passage(p, bound) * replicas), rate=p, bound=bound,
                          rows=sum(rows.values()))}
    waits: Dict[str, list] = {}
    for run_waits in with_waits:
        for name, (secs, limit) in run_waits.items():
            if name not in waits or secs > waits[name][0]:
                waits[name] = [secs, limit]
    for name, (secs, limit) in sorted(waits.items()):
        out["wait %s" % name] = dict(chance=margin_chance(secs, limit, sigma), secs=secs, limit=limit)
    age = max(max(f["max_heartbeat_age_secs"].values()) for f in fleets)
    out["heartbeat"] = dict(chance=margin_chance(age, HEARTBEAT_STALE_SECS, sigma), secs=age,
                            limit=HEARTBEAT_STALE_SECS)
    death = max(deaths, key=lambda d: float(d["max_agreement_secs"]) / float(d["deadline_secs"]))
    out["chaos_deadline"] = dict(chance=margin_chance(float(death["max_agreement_secs"]),
                                                      float(death["deadline_secs"]), sigma),
                                 secs=death["max_agreement_secs"], limit=death["deadline_secs"])
    out["script"] = dict(chance=margin_chance(max(totals), SCRIPT_LIMIT_SECS, sigma), secs=max(totals),
                         limit=SCRIPT_LIMIT_SECS, sigma=sigma)
    return out


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="smoke_odds.py", description=__doc__.split("\n")[0])
    parser.add_argument("logs", nargs="+", metavar="log", help="the standard output of a whole chip_smoke.py run")
    parser.add_argument("--script-secs", type=float, nargs="+", required=True,
                        help="whole-script seconds of two or more runs on different hosts (the host model's "
                        "spread)")
    args = parser.parse_args(argv)
    if len(args.script_secs) < 2:
        parser.error("--script-secs needs at least two runs")
    texts = []
    for path in args.logs:
        with open(path, errors="replace") as f:
            texts.append(f.read())
    try:
        result = odds(texts, args.script_secs)
    except KeyError as exc:
        print("smoke_odds: %s" % exc, file=sys.stderr)
        return 2
    for name, entry in result.items():
        detail = {k: v for k, v in entry.items() if k in ("secs", "limit", "rate", "bound", "rows")}
        print("%-48s %.3g  %s" % (name, entry["chance"], json.dumps(detail)))
    return 0 if all(entry["chance"] < BELOW for entry in result.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
