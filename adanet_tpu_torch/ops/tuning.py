"""Store-persisted kernel autotuning for the port's CUDA kernels.

Port of adanet_tpu/ops/tuning.py, with the same API and the same ref
layout. Tile choices for the hand-written kernels (`sepconv_kernels`,
`cell_kernels`) come from each wrapper's own planner unless a
measured winner exists: `adanet_tpu_torch.tools.autotune` sweeps the
candidate tiles for a (kernel, shape) workload, and the winner lands as
a set-once `tune/` ref in the content-addressed artifact store
(`adanet_tpu_torch.store`). Every process that launches the same kernel
signature in the same environment then picks the tuned tile up without
searching again.

Key derivation follows `store/keys.py`:

    refs/tune/<kernel>-<spec_fingerprint>-<env_fingerprint>.json

- `kernel`: the kernel family ("sepconv", "cell").
- `spec_fingerprint`: the workload's shapes, dtype and static params, as
  the same dict the JAX package declares, so one workload has one spec
  fingerprint in both packages.
- `env_fingerprint`: (torch, CUDA, device name, device count) of the
  device the kernel runs on: a tile tuned on one card never applies on
  another, and a CPU proxy's never on a card.

The ref's meta carries the winner inline (`meta["winner"]`,
`{"tile_p": n, "device": ...}`), so the hot path reads one small JSON
document; the full sweep is content-addressed as a blob for audit.

Lookup layering (cheapest first):

1. an in-process memo (`_CACHE`), of hits and of misses;
2. the default store, when one was registered via
   `set_default_store(...)` or the `ADANET_TUNE_STORE` env var;
3. miss: the caller keeps its static heuristic.

A lookup reads the store at most once per (kernel, spec, environment,
store) per process, hit or miss, as the JAX package looks up once per
trace; K2's wrapper goes further and plans each launch signature once
(`sepconv_kernels._PLANS`, registered here with `register_memo`). The
memo and every registered one are dropped by `clear_cache()`,
`set_default_store()` and `record()`, so a process that tunes launches
its own winners; a ref that another process publishes mid-run is picked
up after the next drop (or by the next process). With no store
registered and an empty memo, `lookup` returns before it fingerprints
anything.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from adanet_tpu_torch.store import keys

TUNE_REF_KIND = "tune"

# (kernel, spec_fingerprint, env_fingerprint) -> winner config dict.
_CACHE: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
# (kernel, spec_fingerprint, env_fingerprint, store) of lookups that
# missed (stores hash by identity).
_MISSES: set = set()
# Callers' memos derived from lookups, dropped with this one.
_DEPENDENT_MEMOS: List[Dict] = []

_DEFAULT_STORE = None
# ADANET_TUNE_STORE root -> its ArtifactStore, opened once per process.
_ENV_STORES: Dict[str, Any] = {}


def set_default_store(store) -> None:
    """Registers the store consulted by `lookup` (None to clear); drops
    the lookup memo."""
    global _DEFAULT_STORE
    _DEFAULT_STORE = store
    _drop_memo()


def _resolve_store():
    if _DEFAULT_STORE is not None:
        return _DEFAULT_STORE
    root = os.environ.get("ADANET_TUNE_STORE")
    if not root:
        return None
    store = _ENV_STORES.get(root)
    if store is None:
        from adanet_tpu_torch.store import ArtifactStore

        try:
            store = ArtifactStore(root)
        except Exception:
            return None
        _ENV_STORES[root] = store
    return store


def clear_cache() -> None:
    """Drops the in-process lookup memo, hits and misses, and every memo
    registered with `register_memo`."""
    _CACHE.clear()
    _drop_memo()


def _drop_memo() -> None:
    _MISSES.clear()
    for memo in _DEPENDENT_MEMOS:
        memo.clear()


def register_memo(memo: Dict) -> None:
    """Has `clear_cache`, `set_default_store` and `record` clear `memo`
    too (a caller's plans built from lookups)."""
    _DEPENDENT_MEMOS.append(memo)


def tune_ref_name(kernel: str, spec: Dict[str, Any], device=None) -> str:
    """The set-once ref name for one (kernel, spec, environment)."""
    return keys.ref_name(
        kernel, keys.spec_fingerprint(spec), keys.env_fingerprint(device)
    )


def _cache_key(kernel: str, spec: Dict[str, Any], device) -> Tuple[str, str, str]:
    return (kernel, keys.spec_fingerprint(spec), keys.env_fingerprint(device))


def lookup(
    kernel: str, spec: Dict[str, Any], store=None, device=None
) -> Optional[Dict[str, Any]]:
    """The tuned winner config for `spec` on `device`, or None (keep the
    heuristic).

    Consults the in-process cache, then `store` (defaulting to the
    registered/env store). Malformed refs read as a miss: a corrupt
    tuning document never breaks a launch.
    """
    if store is None:
        store = _resolve_store()
        if store is None and not _CACHE:
            return None
    cache_key = _cache_key(kernel, spec, device)
    hit = _CACHE.get(cache_key)
    if hit is not None:
        return hit
    if store is None:
        return None
    miss_key = cache_key + (store,)
    if miss_key in _MISSES:
        return None
    doc = store.get_ref(TUNE_REF_KIND, tune_ref_name(kernel, spec, device))
    winner = (doc.get("meta") or {}).get("winner") if isinstance(doc, dict) else None
    if not isinstance(winner, dict):
        _MISSES.add(miss_key)
        return None
    _CACHE[cache_key] = winner
    return winner


def record(
    store,
    kernel: str,
    spec: Dict[str, Any],
    winner: Dict[str, Any],
    candidates: Sequence[Dict[str, Any]] = (),
    device=None,
) -> Dict[str, Any]:
    """Publishes a sweep's winner as a set-once `tune/` ref.

    The full sweep (spec + every candidate timing) is stored as a
    content-addressed blob; the ref meta carries the winner inline. A
    lost race adopts the first writer's winner, which this returns (and
    caches), so concurrent tuners converge on one config.
    """
    payload = keys.canonical_json(
        {
            "kernel": kernel,
            "spec": spec,
            "winner": winner,
            "candidates": list(candidates),
        }
    )
    digest = store.put(payload)
    doc = store.put_ref(
        TUNE_REF_KIND,
        tune_ref_name(kernel, spec, device),
        {"sweep": digest},
        meta={"kernel": kernel, "spec": spec, "winner": winner},
    )
    adopted = (doc.get("meta") or {}).get("winner", winner)
    _drop_memo()
    _CACHE[_cache_key(kernel, spec, device)] = adopted
    return doc


def candidate_tile_sizes(
    pixels: int,
    bytes_per_pixel: int,
    fixed_bytes: int,
    budget: int,
    smallest: int = 16,
) -> List[int]:
    """Pixel-tile candidates (pixels per block), largest first: the
    powers of two from the first one that covers `pixels` down to
    `smallest` whose block, `fixed_bytes + tile * bytes_per_pixel` of
    shared memory, fits `budget`. The smallest tile always stays, so a
    sweep is never empty (the Hopper counterpart of the JAX package's
    `candidate_block_sizes`, which divides the batch under a VMEM
    budget)."""
    if pixels < 1:
        return []
    tile = smallest
    while tile < pixels:
        tile *= 2
    fitting = []
    while tile >= smallest:
        if fixed_bytes + tile * bytes_per_pixel <= budget or tile == smallest:
            fitting.append(tile)
        tile //= 2
    return fitting


def sweep(
    run: Callable[[Dict[str, Any]], Any],
    candidates: Sequence[Dict[str, Any]],
    repeats: int = 2,
    clock: Callable[[], float] = time.perf_counter,
    synchronize: Optional[Callable[[], None]] = None,
    timer: Optional[Callable[[Callable[[], Any]], float]] = None,
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """Times `run(candidate)` for each candidate; returns (winner, all).

    With `synchronize` (`torch.cuda.synchronize` for kernels on the
    card) the clock starts after the queue drains and stops after the
    run's work finished. With `timer` (a function that runs its argument
    and returns the seconds it took, e.g. by CUDA events) that takes the
    clock's place. The first invocation per candidate is a discarded
    warmup (first-use build and launch); the reported time is the best
    of `repeats` timed runs. Candidates that raise are recorded as failed
    and never win; at least one candidate must survive.
    """
    if not candidates:
        raise ValueError("sweep needs at least one candidate")
    sync = synchronize if synchronize is not None else (lambda: None)
    results: List[Dict[str, Any]] = []
    for cand in candidates:
        entry = dict(cand)
        try:
            run(cand)
            sync()
            best = None
            for _ in range(max(1, repeats)):
                if timer is not None:
                    elapsed = timer(lambda: run(cand))
                else:
                    started = clock()
                    run(cand)
                    sync()
                    elapsed = clock() - started
                best = elapsed if best is None else min(best, elapsed)
            entry["secs"] = best
        except Exception as exc:
            entry["error"] = "%s: %s" % (type(exc).__name__, exc)
        results.append(entry)
    survivors = [r for r in results if "secs" in r]
    if not survivors:
        raise RuntimeError(
            "every tuning candidate failed: %s"
            % "; ".join(r.get("error", "?") for r in results)
        )
    winner = min(survivors, key=lambda r: r["secs"])
    return winner, results
