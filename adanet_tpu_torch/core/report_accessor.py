"""Durable JSON store of per-iteration materialized reports.

Analogue of the reference `_ReportAccessor`
(reference: adanet/core/report_accessor.py:87-159): an append-only JSON file
(`<report_dir>/iteration_reports.json`) feeding the Generator's search-space
adaptation on later iterations and after restarts.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Sequence

from adanet_tpu_torch.subnetwork.report import MaterializedReport

_FILENAME = "iteration_reports.json"


class ReportAccessor:
    """Reads and writes `MaterializedReport`s per iteration."""

    def __init__(self, report_dir: str):
        self._report_dir = report_dir
        os.makedirs(report_dir, exist_ok=True)
        self._path = os.path.join(report_dir, _FILENAME)

    @property
    def report_dir(self) -> str:
        return self._report_dir

    def _read_all(self) -> Dict[str, List[dict]]:
        if not os.path.exists(self._path):
            return {}
        with open(self._path) as f:
            return json.load(f)

    def write_iteration_report(
        self,
        iteration_number: int,
        materialized_reports: Sequence[MaterializedReport],
    ) -> None:
        """Writes (or overwrites) one iteration's reports atomically."""
        reports = self._read_all()
        reports[str(iteration_number)] = [
            r.to_json() for r in materialized_reports
        ]
        fd, tmp = tempfile.mkstemp(dir=self._report_dir)
        with os.fdopen(fd, "w") as f:
            json.dump(reports, f, sort_keys=True)
        os.replace(tmp, self._path)

    def read_iteration_reports(self) -> List[List[MaterializedReport]]:
        """All reports, ordered by iteration (reference: report_accessor.py:131-159)."""
        reports = self._read_all()
        out = []
        for key in sorted(reports, key=int):
            out.append(
                [MaterializedReport.from_json(obj) for obj in reports[key]]
            )
        return out
