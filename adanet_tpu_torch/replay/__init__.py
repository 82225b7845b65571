"""Deterministic replay of a finished AdaNet search.

Copy of adanet_tpu/replay/__init__.py (its docstring excepted): a
`Config` records, per iteration of a previous run, the best-ensemble
index that was chosen and the structural hash of the resulting winner
architecture (`store.keys.architecture_hash`). An `Estimator` given a
`replay_config` re-runs the search on fresh data with those selection
decisions replayed and no Evaluator run. The JAX package also grafts a
recorded iteration straight from a shared artifact store; the port has
no store publication yet, so it retrains every replayed iteration.

`Estimator.train` writes `replay.json` (`REPLAY_FILENAME`) into the
model dir after every completed iteration (and once more at search
end), so every search, finished or interrupted, is replayable up to its
last completed iteration without hand-constructing a `Config`.
`load_partial` is the tolerant read side of that contract: it returns an
empty config for a missing or damaged model dir.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

#: Written into the model dir by `Estimator.train` at search end.
REPLAY_FILENAME = "replay.json"


class Config:
    """Holds the per-iteration choices of a previous run.

    `best_ensemble_indices[t]` is the winning candidate index of
    iteration t; `architecture_hashes[t]` (optional, may be shorter or
    empty for hand-constructed configs) is the structural hash of the
    frozen winner — the store ref key for warm starts.
    """

    def __init__(
        self,
        best_ensemble_indices: Optional[Sequence[int]] = None,
        architecture_hashes: Optional[Sequence[str]] = None,
    ):
        self._best_ensemble_indices = [
            int(i) for i in (best_ensemble_indices or [])
        ]
        self._architecture_hashes = [
            str(h) for h in (architecture_hashes or [])
        ]

    @property
    def best_ensemble_indices(self) -> List[int]:
        return list(self._best_ensemble_indices)

    @property
    def architecture_hashes(self) -> List[str]:
        return list(self._architecture_hashes)

    @property
    def num_iterations(self) -> int:
        return len(self._best_ensemble_indices)

    def get_best_ensemble_index(
        self, iteration_number: int
    ) -> Optional[int]:
        """The recorded winner for `iteration_number`, or None past the end."""
        if iteration_number < len(self._best_ensemble_indices):
            return self._best_ensemble_indices[iteration_number]
        return None

    def get_architecture_hash(
        self, iteration_number: int
    ) -> Optional[str]:
        """The recorded winner's structural hash, or None when unknown."""
        if iteration_number < len(self._architecture_hashes):
            return self._architecture_hashes[iteration_number] or None
        return None

    # ------------------------------------------------------- round trip

    def to_json(self) -> Dict[str, Any]:
        return {
            "best_ensemble_indices": list(self._best_ensemble_indices),
            "architecture_hashes": list(self._architecture_hashes),
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "Config":
        return cls(
            best_ensemble_indices=obj.get("best_ensemble_indices", []),
            architecture_hashes=obj.get("architecture_hashes", []),
        )

    def save(self, path: str) -> str:
        """Writes the config as strict JSON (atomic via the checkpoint
        writer when available; plain write in stripped environments)."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        try:
            from adanet_tpu_torch.core import checkpoint as ckpt

            ckpt.write_json(
                directory, os.path.basename(path), self.to_json()
            )
        except ImportError:  # core extras unavailable: best effort
            with open(path, "w") as f:
                json.dump(self.to_json(), f, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(json.load(f))

    @classmethod
    def from_model_dir(
        cls, model_dir: str, prefer_recorded: bool = True
    ) -> "Config":
        """Reconstructs a replay config from a finished model dir.

        Prefers the recorded `replay.json`; falls back to deriving the
        indices from the checkpoint manifest and the hashes from the
        `architecture-<t>.json` chain (pre-store model dirs).
        `prefer_recorded=False` forces the derivation — the emission
        path in `Estimator.train` uses it so a resumed search never
        re-writes a stale record.
        """
        recorded = os.path.join(model_dir, REPLAY_FILENAME)
        if prefer_recorded and os.path.exists(recorded):
            return cls.load(recorded)
        from adanet_tpu_torch.core import checkpoint as ckpt
        from adanet_tpu_torch.store import keys as store_keys

        info = ckpt.read_manifest(model_dir, quarantine=False)
        if info is None:
            return cls()
        hashes = []
        for t in range(info.iteration_number):
            path = os.path.join(
                model_dir, ckpt.architecture_filename(t)
            )
            try:
                hashes.append(
                    store_keys.architecture_hash_from_file(path)
                )
            except (OSError, ValueError):
                break
        return cls(
            best_ensemble_indices=info.replay_indices,
            architecture_hashes=hashes,
        )


def load_partial(model_dir: str) -> Config:
    """Best-effort replay config for a possibly-unfinished model dir.

    Reads the recorded `replay.json` when present (written incrementally
    per completed iteration), falls back to deriving from the checkpoint
    manifest, and returns an EMPTY config — never raises — when the dir
    is missing, empty, or too damaged to derive from. Donor selection in
    the fleet's transfer path runs over many sibling/culled dirs; one
    unreadable donor must not break grafting from the others.
    """
    try:
        return Config.from_model_dir(model_dir)
    except Exception:
        return Config()


__all__ = ["Config", "REPLAY_FILENAME", "load_partial"]
