"""Serializable ensemble architecture records.

Analogue of the reference `_Architecture`
(reference: adanet/core/architecture.py:24-173): a durable JSON blueprint of
a winning ensemble — the (iteration, builder_name) pairs of its members, the
ensembler that combined them, and the replay indices of the choices made so
far. Written to `<model_dir>/architecture-<t>.json` after each iteration's
selection phase and used to rebuild frozen iterations deterministically.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple


class Architecture:
    """The architecture of a winning ensemble at some iteration."""

    def __init__(
        self,
        ensemble_candidate_name: str,
        ensembler_name: str,
        global_step: int = 0,
        replay_indices: Optional[Sequence[int]] = None,
        iteration_number: int = 0,
    ):
        self._ensemble_candidate_name = ensemble_candidate_name
        self._ensembler_name = ensembler_name
        self._global_step = int(global_step)
        self._subnets: List[Tuple[int, str]] = []
        self._replay_indices: List[int] = list(replay_indices or [])
        self._iteration_number = int(iteration_number)

    @property
    def ensemble_candidate_name(self) -> str:
        return self._ensemble_candidate_name

    @property
    def ensembler_name(self) -> str:
        return self._ensembler_name

    @property
    def global_step(self) -> int:
        return self._global_step

    @property
    def iteration_number(self) -> int:
        return self._iteration_number

    @property
    def subnetworks(self) -> Sequence[Tuple[int, str]]:
        """(iteration_number, builder_name) pairs, in insertion order."""
        return tuple(self._subnets)

    @property
    def subnetworks_grouped_by_iteration(
        self,
    ) -> Sequence[Tuple[int, Tuple[str, ...]]]:
        """Members grouped by the iteration that introduced them.

        Mirrors reference architecture.py:66-84.
        """
        grouped: Dict[int, List[str]] = {}
        for iteration, name in self._subnets:
            grouped.setdefault(iteration, []).append(name)
        return tuple(
            (iteration, tuple(names))
            for iteration, names in sorted(grouped.items())
        )

    @property
    def replay_indices(self) -> List[int]:
        return list(self._replay_indices)

    def add_subnetwork(self, iteration_number: int, builder_name: str):
        self._subnets.append((int(iteration_number), builder_name))

    def add_replay_index(self, index: int):
        self._replay_indices.append(int(index))

    def set_global_step(self, global_step: int):
        self._global_step = int(global_step)

    # ------------------------------------------------------------- serialize

    def serialize(self, global_step: Optional[int] = None) -> str:
        """JSON string (reference: architecture.py:132-151)."""
        if global_step is not None:
            self._global_step = int(global_step)
        obj = {
            "ensemble_candidate_name": self._ensemble_candidate_name,
            "ensembler_name": self._ensembler_name,
            "global_step": self._global_step,
            # Top-level iteration_number for on-disk parity with the
            # reference's serialized architectures
            # (reference: adanet/core/architecture.py:132-151).
            "iteration_number": self._iteration_number,
            "subnetworks": [
                {"iteration_number": t, "builder_name": name}
                for t, name in self._subnets
            ],
            "replay_indices": self._replay_indices,
        }
        return json.dumps(obj, sort_keys=True)

    @classmethod
    def deserialize(cls, serialized: str) -> "Architecture":
        """Rebuilds from JSON (reference: architecture.py:153-173)."""
        obj = json.loads(serialized)
        arch = cls(
            ensemble_candidate_name=obj["ensemble_candidate_name"],
            ensembler_name=obj["ensembler_name"],
            global_step=obj.get("global_step", 0),
            replay_indices=obj.get("replay_indices", []),
            iteration_number=obj.get("iteration_number", 0),
        )
        for entry in obj.get("subnetworks", []):
            arch.add_subnetwork(
                entry["iteration_number"], entry["builder_name"]
            )
        return arch
