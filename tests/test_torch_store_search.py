"""The artifact store in the port's search, on the CPU.

Copies of tests/test_store.py's search-level tests, run on the port with
`device="cpu"` over `torch_chaos_ckpt_runner.build_estimator`'s search
(builders "a" and "b", 6 steps an iteration, 2 iterations):

- the serving publisher's ref closure (set-once) and the pool's lease;
- the warm start: a second search given the first's `replay.json` and
  the same store grafts both iterations with zero training steps, zero
  iterations built and zero batches, and predicts bitwise as the first
  (the JAX gate's "zero compiles": the port compiles nothing in a search,
  and on the card builds no kernel, `chip_smoke.py`'s `store_warm_start`);
- a re-selected winner (same structure as its previous iteration, other
  numbers) is not grafted in place of the other;
- `ckpt_fsck --json --store --gc --dry-run`'s store section;
- the chaos gate: two concurrent searches over one store
  (`torch_store_chaos_runner.py`), one SIGKILLed by a torn `store.put`
  mid-closure and resumed, the other's frozen payload rotted in the
  store, both ending on a store-less port oracle's architectures, and
  fsck's verdict at most 1 with the store clean after repair;
- a store written by a JAX search is never grafted by the port (the
  port's refs carry its payload format in their spec fingerprint), and
  neither package's refs block the other's.
"""

import io
import json
import os
import signal
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from adanet_tpu_torch import replay as replay_lib
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core.iteration import Iteration, IterationBuilder
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.store import ArtifactStore, collect, fsck_store, keys, leases
from torch_chaos_ckpt_runner import build_estimator, input_fn
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


def _arch(model_dir, t):
    with open(os.path.join(model_dir, ckpt_lib.architecture_filename(t))) as f:
        return json.load(f)


def _predictions(est):
    return [p for p in est.predict(lambda: iter([input_fn().__next__()]))]


class _Counting:
    """Counts `IterationBuilder.build_iteration` and the training steps
    (`Iteration.train_step`, `Iteration.train_steps`) while active."""

    def __init__(self, monkeypatch):
        self.built = self.steps = 0
        build, step, steps = IterationBuilder.build_iteration, Iteration.train_step, Iteration.train_steps

        def counted_build(builder, *args, **kwargs):
            self.built += 1
            return build(builder, *args, **kwargs)

        def counted_step(iteration, *args, **kwargs):
            self.steps += 1
            return step(iteration, *args, **kwargs)

        def counted_steps(iteration, state, batches, *args, **kwargs):
            self.steps += len(batches)
            return steps(iteration, state, batches, *args, **kwargs)

        monkeypatch.setattr(IterationBuilder, "build_iteration", counted_build)
        monkeypatch.setattr(Iteration, "train_step", counted_step)
        monkeypatch.setattr(Iteration, "train_steps", counted_steps)


# ---------------------------------------------- serving closure publication


def test_publisher_ref_closure_set_once_and_pool_lease(tmp_path):
    from adanet_tpu_torch.serving import publisher
    from adanet_tpu_torch.serving.model_pool import GenerationRecord, ModelPool

    store = ArtifactStore(str(tmp_path / "store"))
    model_dir = str(tmp_path / "model")
    gen_dir = publisher.generation_dir(model_dir, 0)
    os.makedirs(gen_dir)
    with open(os.path.join(gen_dir, "serving.pt2"), "wb") as f:
        f.write(b"fake program bytes")
    with open(os.path.join(gen_dir, "serving_signature.json"), "w") as f:
        json.dump({"inputs": []}, f)
    publisher.write_generation_manifest(gen_dir, 0)

    ref = publisher.publish_ref_closure(store, model_dir, 0)
    assert set(ref["blobs"]) == {"generation.json", "serving.pt2", "serving_signature.json"}
    for digest in ref["blobs"].values():
        assert store.has_blob(digest)
    # Set-once: a second publication adopts the landed closure.
    assert publisher.publish_ref_closure(store, model_dir, 0) is None

    # The pool pins the promoted generation's closure under a lease.
    pool = ModelPool(model_dir, store=store, device="cpu")
    record = GenerationRecord(iteration_number=0, path=gen_dir, program=lambda features: features, signature={})
    pool._pin_store_closure(record)
    live = leases.live_leases(store)
    assert len(live) == 1
    assert set(live[0].digests) == set(ref["blobs"].values())
    # GC with the lease live keeps every closure blob, however old.
    for digest in ref["blobs"].values():
        os.utime(store.blob_path(digest), (0.0, 0.0))
    report = collect(store, grace_secs=0.0)
    assert not report.removed
    pool.release_store_lease()
    assert not leases.live_leases(store)


def test_pool_pin_survives_a_failing_store(tmp_path):
    """A store that raises never stops serving: the pin is logged and
    skipped, and a lapsed lease is acquired anew."""
    from adanet_tpu_torch.serving.model_pool import GenerationRecord, ModelPool

    class _Broken:
        def get_ref(self, *args):
            raise OSError("store unreachable")

    pool = ModelPool(str(tmp_path), store=_Broken(), device="cpu")
    pool._pin_store_closure(GenerationRecord(0, str(tmp_path), lambda f: f, {}))
    assert pool._store_lease is None

    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put(b"blob")
    gen_dir = str(tmp_path / "gen")
    os.makedirs(gen_dir)
    with open(os.path.join(gen_dir, "generation.json"), "w") as f:
        json.dump({"digests": {"serving.pt2": digest}}, f)
    pool = ModelPool(str(tmp_path / "model"), store=store, store_lease_ttl_secs=0.01, device="cpu")
    record = GenerationRecord(0, gen_dir, lambda f: f, {})
    pool._pin_store_closure(record)
    first = pool._store_lease
    import time

    time.sleep(0.05)  # the lease lapses
    pool._pin_store_closure(record)
    assert pool._store_lease is not first and digest in pool._store_lease.digests


def test_publish_generation_with_store_publishes_the_closure(tmp_path):
    """`publish_generation(store=...)`: the closure on the fresh path and,
    when the directory exists but the ref does not, on the set-once path."""
    from adanet_tpu_torch.serving import publisher

    store = ArtifactStore(str(tmp_path / "store"))
    model_dir = str(tmp_path / "model")
    sample = {"x": np.zeros((2, 3), np.float32)}
    gen = publisher.publish_generation(model_dir, 0, lambda f: {"y": f["x"] * 2.0}, sample, store=store,
                                       device="cpu")
    ref = store.get_ref("serving", publisher.serving_ref_name(model_dir, 0))
    assert set(ref["blobs"]) == {"generation.json", "serving.pt2", "serving_signature.json"}
    with open(os.path.join(gen, "serving.pt2"), "rb") as f:
        assert store.get(ref["blobs"]["serving.pt2"]) == f.read()
    # A directory published without the store gets its closure on the
    # next (set-once) publication.
    assert publisher.publish_generation(model_dir, 1, lambda f: {"y": f["x"]}, sample, device="cpu")
    assert store.get_ref("serving", publisher.serving_ref_name(model_dir, 1)) is None
    assert publisher.publish_generation(model_dir, 1, lambda f: {"y": f["x"]}, sample, store=store,
                                        device="cpu") is None
    assert store.get_ref("serving", publisher.serving_ref_name(model_dir, 1)) is not None


# --------------------------------------------------------- warm-start gate


@pytest.fixture(scope="module")
def oracle_dir(tmp_path_factory):
    """An uninterrupted, store-less run of the shared chaos search."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = str(tmp_path_factory.mktemp("oracle") / "model")
        est = build_estimator(d)
        est.train(input_fn, max_steps=100)
        assert est.latest_iteration_number() == 2
    finally:
        torch.set_num_threads(before)
    return d


def test_warm_start_replay_zero_compiles_zero_retraining(oracle_dir, tmp_path, monkeypatch):
    """A second search sharing the store replays the first's
    architecture with zero training steps, zero iterations built, zero
    batches, and predicts bitwise as the first."""
    from adanet_tpu_torch.observability import metrics as metrics_lib

    store_root = str(tmp_path / "store")
    first_dir = str(tmp_path / "first")
    est1 = build_estimator(first_dir, artifact_store=store_root)
    est1.train(input_fn, max_steps=100)
    assert est1.latest_iteration_number() == 2
    # The store changes nothing about the search itself.
    assert _arch(first_dir, 1) == _arch(oracle_dir, 1)
    replay_path = os.path.join(first_dir, replay_lib.REPLAY_FILENAME)
    assert os.path.exists(replay_path)
    config = replay_lib.Config.load(replay_path)
    assert config.num_iterations == 2
    assert len(config.architecture_hashes) == 2

    streams_opened = [0]

    def counting_input_fn():
        streams_opened[0] += 1
        return input_fn()

    grafts = metrics_lib.registry().counter("estimator.replay.store_grafts").value
    counting = _Counting(monkeypatch)
    second_dir = str(tmp_path / "second")
    est2 = build_estimator(second_dir, artifact_store=store_root, replay_config=config)
    est2.train(counting_input_fn, max_steps=100)
    assert streams_opened[0] == 0
    assert (counting.built, counting.steps) == (0, 0)
    assert est2._store_graft_count == 2
    assert metrics_lib.registry().counter("estimator.replay.store_grafts").value == grafts + 2
    assert est2.latest_iteration_number() == 2
    assert est2.latest_global_step() == est1.latest_global_step()
    assert _arch(second_dir, 0) == _arch(oracle_dir, 0)
    assert _arch(second_dir, 1) == _arch(oracle_dir, 1)
    # The grafted payloads are byte for byte the first search's.
    info = ckpt_lib.read_manifest(second_dir)
    assert set(info.store_refs) == {"frozen-0.pt", "frozen-1.pt"}
    for t in (0, 1):
        for name in (ckpt_lib.frozen_filename(t), ckpt_lib.architecture_filename(t)):
            with open(os.path.join(first_dir, name), "rb") as a, open(os.path.join(second_dir, name), "rb") as b:
                assert a.read() == b.read(), name
    with open(os.path.join(second_dir, replay_lib.REPLAY_FILENAME)) as a, open(replay_path) as b:
        assert json.load(a) == json.load(b)
    # And the grafted search predicts bitwise as the trained one.
    for got, want in zip(_predictions(est2), _predictions(est1)):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])
    # The store survives a full audit.
    report = fsck_store(ArtifactStore(store_root), gc_dry_run=True)
    assert report["clean"] and report["would_gc"] == []


def test_warm_start_of_reselected_winner_is_not_aliased(tmp_path):
    """A re-selected (not grown) winner has its previous iteration's
    structural hash; the ref key still tells the two apart."""
    store_root = str(tmp_path / "store")
    first_dir = str(tmp_path / "first")
    # Index 0 at t=1 is the carried-over ensemble: iteration 0's
    # structure, other numbers.
    est1 = build_estimator(first_dir, artifact_store=store_root,
                           replay_config=replay_lib.Config(best_ensemble_indices=[1, 0]))
    est1.train(input_fn, max_steps=100)
    assert est1.latest_iteration_number() == 2
    a0, a1 = _arch(first_dir, 0), _arch(first_dir, 1)
    assert a0["subnetworks"] == a1["subnetworks"]  # re-selected
    store = ArtifactStore(store_root)
    assert len(list(store.iter_refs("frozen"))) == 2  # two refs, one structure

    config = replay_lib.Config.from_model_dir(first_dir)
    second_dir = str(tmp_path / "second")
    est2 = build_estimator(second_dir, artifact_store=store_root, replay_config=config)
    est2.train(input_fn, max_steps=100)
    assert est2._store_graft_count == 2
    assert est2.latest_global_step() == est1.latest_global_step()
    assert _arch(second_dir, 0) == a0
    assert _arch(second_dir, 1) == a1
    for t in (0, 1):  # t=1's own payload, not t=0's
        name = ckpt_lib.frozen_filename(t)
        with open(os.path.join(first_dir, name), "rb") as a, open(os.path.join(second_dir, name), "rb") as b:
            assert a.read() == b.read(), name


def test_store_outage_never_stops_the_search(tmp_path):
    """Every `store.put` fails: the search completes as without a store,
    and nothing is recorded as shared."""
    faults.arm("store.put", "error", count=10**6)
    d = str(tmp_path / "model")
    est = build_estimator(d, artifact_store=str(tmp_path / "store"))
    est.train(input_fn, max_steps=100)
    faults.disarm()
    assert est.latest_iteration_number() == 2
    assert ckpt_lib.read_manifest(d).store_refs == {}
    assert not list(ArtifactStore(str(tmp_path / "store")).iter_refs("frozen"))


def test_store_spec_extra_is_checked_at_construction(tmp_path):
    with pytest.raises(ValueError, match="shadows"):
        build_estimator(str(tmp_path / "a"), store_spec_extra={"random_seed": 1})
    with pytest.raises(ValueError, match="payload_format"):
        build_estimator(str(tmp_path / "b"), store_spec_extra={"payload_format": "x"})
    a = build_estimator(str(tmp_path / "c"), store_spec_extra={"lambda": 0.1})
    b = build_estimator(str(tmp_path / "d"), store_spec_extra={"lambda": 0.2})
    assert a._store_spec_fingerprint() != b._store_spec_fingerprint()


def test_ckpt_fsck_cli_store_section(tmp_path, capsys):
    """`ckpt_fsck --json --store ... --gc --dry-run` carries the store
    section without changing the checkpoint chain's exit code."""
    from adanet_tpu_torch.tools import ckpt_fsck

    store = ArtifactStore(str(tmp_path / "store"))
    digest = store.put(b"blob")
    store.put_ref("frozen", keys.ref_name("c" * 64), {"payload": digest})
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    rc = ckpt_fsck.main([model_dir, "--json", "--store", str(tmp_path / "store"), "--gc", "--dry-run"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    section = report["store"]
    assert section["clean"] is True
    assert section["blob_count"] == 1 and section["ref_count"] == 1
    assert section["would_gc"] == []  # fresh blobs sit in the grace window
    # The text form names the same census.
    assert ckpt_fsck.main([model_dir, "--store", str(tmp_path / "store")]) == 0
    assert "1 blobs" in capsys.readouterr().out


# -------------------------------------------------------------- chaos gate


def _subprocess_env(faults_spec):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS_DIR), TESTS_DIR, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env["ADANET_FAULTS"] = faults_spec
    return env


def test_store_chaos_two_searches_torn_rot_sigkill(oracle_dir, tmp_path):
    """Two concurrent searches over one store with armed `store.put`
    torn and rot faults and a SIGKILL mid-publish both reach the
    store-less oracle's architectures, and `ckpt_fsck --json` reports
    the store clean (healed quarantine allowed, verdict <= 1)."""
    from adanet_tpu_torch.tools import ckpt_fsck

    store_root = str(tmp_path / "store")
    dir_a, dir_b = str(tmp_path / "search_a"), str(tmp_path / "search_b")
    runner = os.path.join(TESTS_DIR, "torch_store_chaos_runner.py")

    def spawn(model_dir, faults_spec):
        return subprocess.Popen([sys.executable, runner, model_dir, store_root], env=_subprocess_env(faults_spec),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)

    # A: the fourth blob publication (serving gen-0's program, mid
    # closure) is torn at its final path, then SIGKILL. B: the seventh
    # (iteration 1's frozen payload) silently rots; B runs on.
    proc_a = spawn(dir_a, "store.put:torn:after=3")
    proc_b = spawn(dir_b, "store.put:rot:after=6")
    out_a, _ = proc_a.communicate(timeout=300)
    out_b, _ = proc_b.communicate(timeout=300)
    assert proc_a.returncode == -signal.SIGKILL, out_a.decode()[-2000:]
    assert b"DONE" not in out_a
    assert proc_b.returncode == 0, out_b.decode()[-2000:]
    assert b"DONE" in out_b

    # Resume A without faults, in this process: the startup reconcile
    # heals the torn blob from A's intact generation and the search ends.
    est = build_estimator(dir_a, artifact_store=store_root, export_serving=True)
    est.train(input_fn, max_steps=100)
    assert est.latest_iteration_number() == 2

    for t in (0, 1):
        assert _arch(dir_a, t) == _arch(oracle_dir, t)
        assert _arch(dir_b, t) == _arch(oracle_dir, t)

    for model_dir in (dir_a, dir_b):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = ckpt_fsck.main([model_dir, "--json", "--repair", "--store", store_root, "--gc", "--dry-run"])
        assert rc <= 1, buf.getvalue()
        report = json.loads(buf.getvalue())
        section = report["store"]
        assert section["clean"] is True, section
        assert section["dangling_refs"] == [], section
        assert section["would_gc"] == [], section
        assert report["serving"]["selected_generation"] == 1, report["serving"]
    # The chaos left quarantined copies behind: the heals were real.
    assert ArtifactStore(store_root).quarantined_blobs()


# ----------------------------------------------- JAX and port stay apart


def _jax_chaos_search(model_dir, **kwargs):
    """tests/chaos_common.py's search (RegressionHead, DNNBuilder "a" and
    "b", 6 steps, 2 iterations)."""
    from chaos_common import build_estimator as jax_build_estimator

    return jax_build_estimator(model_dir, **kwargs)


def _port_chaos_search(model_dir, **kwargs):
    """The same search in the port: the same builder names, candidates,
    ensembler, seed and step budget, hence the same architecture hashes."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import RegressionHead
    from adanet_tpu_torch.ensemble import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
    from torch_port_common import dnn_builder

    return Estimator(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        save_checkpoint_steps=2,
        device="cpu",
        **kwargs,
    )


def test_jax_written_store_is_never_grafted_by_the_port(tmp_path):
    """A store shared with a JAX search holds the same architecture hashes
    under the same seed and step budget, but msgpack payloads: the port
    keys its refs apart, so it trains instead of grafting them, and each
    package's refs stand beside the other's."""
    from adanet_tpu import replay as jax_replay
    from chaos_common import input_fn as jax_input_fn
    from multihost_rr_runner import full_batches

    store_root = str(tmp_path / "store")
    jax_dir = str(tmp_path / "jax")
    jax_est = _jax_chaos_search(jax_dir, artifact_store=store_root)
    jax_est.train(jax_input_fn, max_steps=100)
    assert jax_est.latest_iteration_number() == 2
    store = ArtifactStore(store_root)
    jax_refs = {name for _, name, _ in store.iter_refs("frozen")}
    assert len(jax_refs) == 2

    # The JAX search's own record, which names its store refs.
    config = replay_lib.Config.load(os.path.join(jax_dir, jax_replay.REPLAY_FILENAME))
    pulls = [0]

    def port_input_fn():
        pulls[0] += 1
        return ((dict(x), np.asarray(y)) for x, y in full_batches())

    port_dir = str(tmp_path / "port")
    port_est = _port_chaos_search(port_dir, artifact_store=store_root, replay_config=config)
    # The hazard is real: the port's winners hash as the JAX search's.
    port_est.train(port_input_fn, max_steps=100)
    assert [keys.architecture_hash_from_file(os.path.join(port_dir, ckpt_lib.architecture_filename(t)))
            for t in (0, 1)] == config.architecture_hashes
    assert port_est._store_graft_count == 0 and pulls[0] > 0
    assert port_est.latest_iteration_number() == 2
    # Both packages' refs stand, under names apart.
    port_refs = {name for _, name, _ in store.iter_refs("frozen")} - jax_refs
    assert len(port_refs) == 2
    assert {jax_est._frozen_ref_name(h, t) for t, h in enumerate(config.architecture_hashes)} == jax_refs
    assert {port_est._frozen_ref_name(h, t) for t, h in enumerate(config.architecture_hashes)} == port_refs
    for name in port_refs:
        blobs = store.get_ref("frozen", name)["blobs"]
        assert set(blobs) == {"architecture.json", "frozen.pt"}
    # A second port search over the same record grafts the port's own.
    second = _port_chaos_search(str(tmp_path / "port2"), artifact_store=store_root,
                                replay_config=replay_lib.Config.from_model_dir(port_dir))
    second.train(port_input_fn, max_steps=100)
    assert second._store_graft_count == 2
