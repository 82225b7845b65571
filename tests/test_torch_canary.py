"""The port's canary window, quarantine and fsck's serving section on the CPU.

Copies of tests/test_serving.py's canary, verify-on-load and fsck tests,
run on the port with `device="cpu"`: where the JAX tests write fake
generations served by a stub loader, these publish real hermetic programs
(`y = x * (t + 1)`, `serving.publisher.publish_generation`), which the
port's pool loads as it loads any generation. Beside them:

- a parity test driving the JAX `ModelPool` (stub loader, as
  tests/test_serving.py's `_stub_pool`) and the port's through the same
  sequences of `report_canary(ok, divergence)`: equal `stats()` after
  every report, and equal event kinds, generations and gates;
- the batcher's canary mirror (`Batcher._mirror_canary`): mirrored
  batches promote a staged candidate, its divergence lands on the gauge,
  a raising candidate is unhealthy and never reaches the request, and
  level-0 cascade answers skip the divergence;
- a copy of `test_serve_while_search_chaos_flips_and_bit_identity`: a
  searcher process (`torch_serving_search_runner.py`) SIGKILLed by a torn
  checkpoint write and restarted, one flip rotted at `serving.flip`,
  `canary_requests=2`, and zero dropped requests, at least two gated
  flips, one rollback and final answers bitwise the offline
  `load_serving_program`.
"""

import glob
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from adanet_tpu_torch.robustness import faults, integrity
from adanet_tpu_torch.serving import (
    Batcher,
    BatcherConfig,
    FrontendConfig,
    ModelPool,
    ServingFrontend,
    batcher as batcher_lib,
    publisher,
)
from adanet_tpu_torch.serving.model_pool import PoolConfig
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PROGRAM = "serving.pt2"


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


class FakeClock:
    def __init__(self, start: float = 1000.0):
        self.now = start

    def __call__(self) -> float:
        return self.now


def _write_generation(model_dir, t, scale=None):
    """Publishes generation t: the program `y = x * (t + 1)` (or
    `x * scale`) over 3 features."""
    k = float(t + 1 if scale is None else scale)
    return publisher.publish_generation(
        model_dir, t, lambda features: {"y": features["x"] * k}, {"x": np.zeros((2, 3), np.float32)},
        device="cpu",
    )


def _pool(model_dir, generations=(0,), **config_kwargs):
    for t in generations:
        _write_generation(model_dir, t)
    return ModelPool(model_dir, PoolConfig(canary_requests=3, **config_kwargs), device="cpu")


def _rot(gen, name=PROGRAM):
    with open(os.path.join(gen, name), "r+b") as f:
        f.seek(64)
        byte = f.read(1)
        f.seek(64)
        f.write(bytes([byte[0] ^ 0xFF]))


# ------------------------------------------------------- canary decisions


def test_canary_window_promotes_after_healthy_batches(tmp_path):
    clock = FakeClock()
    pool = _pool(str(tmp_path), generations=(0,))
    pool._clock = clock
    assert pool.poll()  # bootstrap flip: verify + load + smoke
    assert pool.stats()["active_generation"] == 0

    _write_generation(str(tmp_path), 1)
    assert pool.poll()
    assert pool.stats()["canary_generation"] == 1
    for _ in range(2):
        pool.report_canary(ok=True)
        assert pool.stats()["active_generation"] == 0  # window open
    pool.report_canary(ok=True)  # third healthy batch: promote
    stats = pool.stats()
    assert stats["active_generation"] == 1
    assert stats["canary_generation"] is None
    assert stats["flips"] == 2 and stats["rollbacks"] == 0
    assert [(e["event"], e.get("how"), e["at"]) for e in pool.events] == [
        ("flip", "bootstrap", 1000.0), ("flip", "canary", 1000.0)]


def test_canary_rollback_on_unhealthy_batches(tmp_path):
    pool = _pool(str(tmp_path), generations=(0, 1))
    assert pool.poll()  # newest first: bootstraps straight onto gen 1
    assert pool.stats()["active_generation"] == 1
    _write_generation(str(tmp_path), 2)
    assert pool.poll()
    pool.report_canary(ok=True)
    pool.report_canary(ok=False)  # max_canary_failures=0: one strike
    stats = pool.stats()
    assert stats["active_generation"] == 1  # rollback to the incumbent
    assert stats["canary_generation"] is None
    assert stats["rollbacks"] == 1
    assert glob.glob(os.path.join(str(tmp_path), "serving", "gen-2.corrupt*"))
    # The quarantined directory is never retried...
    assert not pool.poll()
    # ...but a fresh publish of the same iteration is.
    _write_generation(str(tmp_path), 2)
    assert pool.poll()
    for _ in range(3):
        pool.report_canary(ok=True)
    assert pool.stats()["active_generation"] == 2


def test_canary_divergence_watermark(tmp_path):
    pool = _pool(str(tmp_path), generations=(0,), max_divergence=0.5)
    pool.poll()
    _write_generation(str(tmp_path), 1)
    pool.poll()
    pool.report_canary(ok=True, divergence=0.9)  # finite but divergent
    assert pool.stats()["active_generation"] == 0
    assert pool.stats()["rollbacks"] == 1


def test_quarantine_names_do_not_clash(tmp_path):
    """A second rejection of iteration t lands beside the first as
    `gen-<t>.corrupt.1` (the JAX pool's suffix rule)."""
    pool = _pool(str(tmp_path), generations=(0,))
    pool.poll()
    for _ in range(2):
        _rot(_write_generation(str(tmp_path), 1))
        assert pool.poll()
    names = sorted(os.listdir(os.path.join(str(tmp_path), "serving")))
    assert names == ["gen-0", "gen-1.corrupt", "gen-1.corrupt.1"]
    assert pool.stats()["rollbacks"] == 2 and not pool.poll()


def test_follow_false_waits_for_the_fleet(tmp_path):
    """An externally driven pool never flips by itself: `poll()` ignores
    the chain, and `adopt` installs a generation the fleet gated."""
    from adanet_tpu_torch.serving.model_pool import gate_generation

    gen = _write_generation(str(tmp_path), 0)
    pool = ModelPool(str(tmp_path), PoolConfig(follow=False), device="cpu")
    assert not pool.poll() and pool.active is None
    pool.adopt(gate_generation(gen, pool.device), how="bootstrap")
    assert pool.stats()["active_generation"] == 0
    assert pool.events[-1]["how"] == "bootstrap"
    _write_generation(str(tmp_path), 1)
    assert not pool.poll() and pool.stats()["active_generation"] == 0


# ------------------------------------------------------ verify-on-load


def test_bit_rot_rejected_before_load(tmp_path):
    pool = _pool(str(tmp_path), generations=(0,))
    pool.poll()
    gen = _write_generation(str(tmp_path), 1)
    # Bit rot in the program AFTER publication.
    with open(os.path.join(gen, PROGRAM), "r+b") as f:
        f.write(b"\xff")
    assert pool.poll()
    stats = pool.stats()
    assert stats["active_generation"] == 0 and stats["rollbacks"] == 1
    assert "digest mismatch or missing file: serving.pt2" in pool.events[-1]["reason"]


def test_serving_flip_rot_fault_site(tmp_path):
    """The `serving.flip` chaos seam: armed `rot` corrupts the program
    mid-flip and the verify-on-load gate must roll back."""
    pool = _pool(str(tmp_path), generations=(0,))
    pool.poll()
    _write_generation(str(tmp_path), 1)
    faults.arm("serving.flip", "rot")
    try:
        pool.poll()
    finally:
        faults.disarm()
    assert pool.stats()["active_generation"] == 0
    assert pool.stats()["rollbacks"] == 1
    assert any(e["event"] == "rollback" for e in pool.events)


def test_serving_flip_raising_fault_rejects_not_escapes(tmp_path):
    """A raising fault at `serving.flip` resolves as a rollback, not an
    exception out of `poll` (which would leave the generation attempted
    but never quarantined)."""
    pool = _pool(str(tmp_path), generations=(0,))
    pool.poll()
    _write_generation(str(tmp_path), 1)
    faults.arm("serving.flip", "transient")
    try:
        pool.poll()
    finally:
        faults.disarm()
    stats = pool.stats()
    assert stats["active_generation"] == 0 and stats["rollbacks"] == 1
    assert any(e["event"] == "rollback" for e in pool.events)


def test_generation_manifest_checksum_required(tmp_path):
    """A manifest with the checksum stripped (and digests possibly
    rewritten) is ineligible, not quietly trusted."""
    gen = _write_generation(str(tmp_path), 0)
    manifest = os.path.join(gen, integrity.GENERATION_MANIFEST)
    with open(manifest) as f:
        obj = json.load(f)
    del obj["checksum"]
    with open(manifest, "w") as f:
        json.dump(obj, f)
    assert integrity.verify_serving_generation(gen) == ["generation manifest missing checksum"]


def test_fsck_json_reports_serving_eligibility(tmp_path, capsys):
    """`ckpt_fsck --json` flags which generation the pool would select."""
    from adanet_tpu_torch.tools import ckpt_fsck

    model_dir = str(tmp_path)
    _write_generation(model_dir, 0)
    gen1 = _write_generation(model_dir, 1)
    with open(os.path.join(gen1, PROGRAM), "r+b") as f:
        f.write(b"\xff")  # the newest generation is rotten
    rc = ckpt_fsck.main([model_dir, "--json"])
    assert rc == integrity.EXIT_CLEAN
    report = json.loads(capsys.readouterr().out)
    serving = report["serving"]
    by_iter = {g["iteration_number"]: g for g in serving["generations"]}
    assert by_iter[0]["serving_eligible"] is True
    assert by_iter[1]["serving_eligible"] is False
    assert by_iter[1]["issues"]
    # The pool would skip the rotten newest generation.
    assert serving["selected_generation"] == 0
    # And the pool does: it rejects gen-1 and serves gen-0.
    pool = ModelPool(model_dir, device="cpu")
    while pool.poll():
        pass
    assert pool.stats()["active_generation"] == serving["selected_generation"]


# --------------------------------------------- decisions: JAX against port


SEQUENCES = {
    "promote": (dict(), [(True, None)] * 3),
    "one_strike": (dict(), [(True, None), (False, None)]),
    "divergent": (dict(max_divergence=0.5), [(True, 0.9)]),
    "within_bound": (dict(max_divergence=0.5), [(True, 0.4), (True, None), (True, 0.5)]),
    "tolerated_failure": (dict(max_canary_failures=1), [(False, None), (True, None), (True, None), (True, None)]),
    "second_failure": (dict(max_canary_failures=1), [(False, None), (True, None), (False, 0.1)]),
    "raising_counts_as_unhealthy": (dict(canary_requests=2), [(True, 0.0), (False, None)]),
}


def _jax_pool(model_dir, config_kwargs):
    """tests/test_serving.py's `_stub_pool` over gen-0 and gen-1."""
    from adanet_tpu.serving import ModelPool as JaxPool
    from adanet_tpu.serving import PoolConfig as JaxConfig
    from adanet_tpu.serving import publisher as jax_publisher

    def write(t):
        gen = jax_publisher.generation_dir(model_dir, t)
        os.makedirs(gen)
        with open(os.path.join(gen, "serving.stablehlo"), "wb") as f:
            f.write(b"program-%d" % t)
        with open(os.path.join(gen, "serving_signature.json"), "w") as f:
            json.dump({"inputs": {"x": {"shape": ["batch", "3"], "dtype": "float32"}}}, f)
        jax_publisher.write_generation_manifest(gen, t)

    def loader(gen_dir):
        with open(os.path.join(gen_dir, "generation.json")) as f:
            t = int(json.load(f)["iteration_number"])
        with open(os.path.join(gen_dir, "serving_signature.json")) as f:
            signature = json.load(f)
        return (lambda features: {"y": np.asarray(features["x"], np.float32) * (t + 1)}), signature

    config = dict(canary_requests=3)
    config.update(config_kwargs)
    return JaxPool(model_dir, JaxConfig(**config), loader=loader), write


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_pool_decisions_match_jax(tmp_path, name):
    config_kwargs, reports = SEQUENCES[name]
    jax_pool, jax_write = _jax_pool(str(tmp_path / "jax"), config_kwargs)
    config = dict(canary_requests=3)
    config.update(config_kwargs)
    port_dir = str(tmp_path / "port")
    port_pool = ModelPool(port_dir, PoolConfig(**config), device="cpu")
    writers = ((jax_pool, jax_write), (port_pool, lambda t: _write_generation(port_dir, t)))

    def step(action):
        for pool, write in writers:
            action(pool, write)
        assert jax_pool.stats() == port_pool.stats()

    step(lambda pool, write: write(0))
    step(lambda pool, write: pool.poll())
    step(lambda pool, write: write(1))
    step(lambda pool, write: pool.poll())
    for ok, divergence in reports:
        step(lambda pool, write: pool.report_canary(ok, divergence))
    # The next generation goes through a healthy window on both.
    step(lambda pool, write: write(2))
    step(lambda pool, write: pool.poll())
    for _ in range(config["canary_requests"]):
        step(lambda pool, write: pool.report_canary(True, None))

    def kinds(pool):
        return [(e["event"], e["iteration_number"], e.get("how")) for e in pool.events]

    assert kinds(jax_pool) == kinds(port_pool)
    assert port_pool.stats()["active_generation"] == 2


# ----------------------------------------------------- the batcher mirror


def test_mirrored_batches_promote_and_measure_divergence(tmp_path):
    from adanet_tpu_torch.observability import metrics as metrics_lib

    model_dir = str(tmp_path)
    pool = _pool(model_dir, generations=(0,))
    pool.poll()
    _write_generation(model_dir, 1)
    pool.poll()
    batcher = Batcher(pool, BatcherConfig(bucket_sizes=(2, 4)))
    x = np.arange(9, dtype=np.float32).reshape(3, 3)
    for batch in range(3):
        record, (out,) = batcher.execute([{"x": x}])
        # The incumbent answers every request of the window.
        assert record.iteration_number == 0
        np.testing.assert_array_equal(out["y"], x)
    # gen-1 computes 2x: the divergence over the padded bucket is max|x|.
    assert metrics_lib.registry().gauge("serving.batcher.canary_divergence").value == 8.0
    assert pool.stats()["active_generation"] == 1
    record, (out,) = batcher.execute([{"x": x}])
    assert record.iteration_number == 1
    np.testing.assert_array_equal(out["y"], 2 * x)


def test_raising_candidate_is_unhealthy_and_never_escapes(tmp_path):
    model_dir = str(tmp_path)
    pool = _pool(model_dir, generations=(0,))
    pool.poll()
    _write_generation(model_dir, 1)
    pool.poll()

    def broken(features):
        raise RuntimeError("candidate exploded")

    pool.canary_record().program = broken
    frontend = ServingFrontend(Batcher(pool, BatcherConfig(bucket_sizes=(2, 4)))).start()
    try:
        result = frontend.submit({"x": np.ones((2, 3), np.float32)}, timeout=30.0)
    finally:
        frontend.drain(timeout=10.0)
    assert result.ok and result.generation == 0
    np.testing.assert_array_equal(result.outputs["y"], np.ones((2, 3), np.float32))
    stats = pool.stats()
    assert stats["active_generation"] == 0 and stats["rollbacks"] == 1
    assert "canary failed" in pool.events[-1]["reason"]


def test_non_finite_candidate_rolls_back(tmp_path):
    model_dir = str(tmp_path)
    pool = _pool(model_dir, generations=(0,))
    pool.poll()
    _write_generation(model_dir, 1, scale=float("inf"))
    # The zeros smoke sample gives 0 * inf = nan: the gate rejects it.
    assert pool.poll()
    assert pool.stats()["rollbacks"] == 1
    assert "smoke execution failed" in pool.events[-1]["reason"]
    _write_generation(model_dir, 2, scale=1e38)
    pool.poll()
    batcher = Batcher(pool, BatcherConfig(bucket_sizes=(2,)))
    batcher.execute([{"x": np.full((2, 3), 1e3, np.float32)}])  # 1e41 overflows f32 to inf
    stats = pool.stats()
    assert stats["active_generation"] == 0 and stats["rollbacks"] == 2


def test_cascade_answers_skip_the_divergence(tmp_path):
    """As the JAX batcher: with any row answered at level 0, the mirror
    reports finiteness only (divergence None)."""

    class _Pool:
        def __init__(self):
            self.reports = []

        def canary_record(self):
            return type("R", (), {"iteration_number": 1, "program": staticmethod(
                lambda f: {"y": torch.as_tensor(f["x"]) * 3})})()

        def report_canary(self, ok, divergence=None):
            self.reports.append((ok, divergence))

    pool = _Pool()
    batcher = Batcher(pool)
    padded = {"x": np.ones((2, 3), np.float32)}
    batcher.last_cascade_level, batcher.last_row_fallthrough = 1, np.array([True, False])
    batcher._mirror_canary(padded, {"y": np.ones((2, 3), np.float32)})
    batcher.last_cascade_level, batcher.last_row_fallthrough = 1, np.array([True, True])
    batcher._mirror_canary(padded, {"y": np.ones((2, 3), np.float32)})
    assert pool.reports == [(True, None), (True, 2.0)]


# ----------------------------------- serve-while-search chaos (the gate)


def _spawn(script, *args, env_extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS_DIR), TESTS_DIR, env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("ADANET_FAULTS", None)
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, os.path.join(TESTS_DIR, script)] + list(args), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_serve_while_search_chaos_flips_and_bit_identity(tmp_path):
    """A live 3-iteration search publishes generations under steady
    traffic while (a) the searcher is SIGKILLed mid-checkpoint-write by
    an armed torn fault and restarted, and (b) one flip is bit-rotted at
    the `serving.flip` seam. Every request is answered by the incumbent
    (zero drops, zero errors), a rollback is logged, at least two gated
    flips complete, and the final answers are bitwise the offline
    `load_serving_program` on the same padded bucket."""
    from adanet_tpu_torch.core.export import load_serving_program
    from adanet_tpu_torch.observability import flightrec

    model_dir = str(tmp_path / "model")
    # The pool's install_default must own this test's flight dir.
    flightrec.uninstall()
    pool = ModelPool(model_dir, PoolConfig(canary_requests=2), device="cpu")
    frontend = ServingFrontend(
        Batcher(pool, BatcherConfig(bucket_sizes=(4, 8))),
        FrontendConfig(default_deadline_secs=30.0, poll_interval_secs=0.05, batch_wait_secs=0.0),
    ).start()
    features = {"x": np.ones((2, 2), np.float32)}
    results = []

    def send():
        results.append(frontend.submit(features, timeout=60.0))

    # Iteration 1's frozen payload (the second checkpoint.write) is torn
    # and the searcher SIGKILLed; gen-1's flip (the second serving.flip,
    # after gen-0's bootstrap) is bit-rotted.
    faults.arm("serving.flip", "rot", after=1)
    proc = _spawn("torch_serving_search_runner.py", model_dir, "3",
                  env_extra={"ADANET_FAULTS": "checkpoint.write:torn:after=1"})
    try:
        deadline = time.time() + 240
        while pool.active is None and time.time() < deadline:
            time.sleep(0.05)
        assert pool.active is not None, "gen-0 never became servable"
        # Steady traffic until the armed fault kills the searcher.
        while proc.poll() is None and time.time() < deadline:
            send()
            time.sleep(0.02)
        out1 = proc.stdout.read()
        assert proc.returncode == -signal.SIGKILL, out1[-2000:]
        # The searcher is dead; the serving plane keeps answering.
        for _ in range(10):
            send()
        assert results and all(r.ok for r in results[-10:])
        # A clean restart heals the torn write, retrains iteration 1 and
        # finishes the search.
        proc = _spawn("torch_serving_search_runner.py", model_dir, "3")
        while proc.poll() is None and time.time() < deadline:
            send()
            time.sleep(0.02)
        out2 = proc.stdout.read()
        assert proc.returncode == 0, out2[-2000:]
        assert "SEARCH DONE 3" in out2
        # Traffic until the last generation's canary window promotes it,
        # then a few requests it must answer.
        while pool.stats()["active_generation"] != 2 and time.time() < deadline:
            send()
            time.sleep(0.02)
        for _ in range(5):
            send()
    finally:
        faults.disarm()
        if proc.poll() is None:
            proc.kill()
        frontend.drain(timeout=10.0)

    assert results
    assert all(r.ok for r in results), {r.status for r in results if not r.ok}
    assert frontend.stats().get("error", 0) == 0
    stats = pool.stats()
    assert stats["active_generation"] == 2
    assert stats["flips"] >= 2, pool.events
    assert stats["rollbacks"] >= 1, pool.events
    assert [e["how"] for e in pool.events if e["event"] == "flip"][-1] == "canary"
    # The rotted generation was quarantined, then published afresh.
    assert glob.glob(os.path.join(model_dir, "serving", "gen-1.corrupt*"))

    # The rot-rejected flip left a flight-recorder dump in this process.
    dump_path = os.path.join(model_dir, "flightrec", "flight-%d.json" % os.getpid())
    assert os.path.exists(dump_path), os.listdir(os.path.join(model_dir, "flightrec"))
    dump = flightrec.load_dump(dump_path)
    assert any(r.startswith("fault:serving.flip:rot") for r in dump["reasons"]), dump["reasons"]
    assert any(r.startswith("serving_rollback") for r in dump["reasons"]), dump["reasons"]
    rollbacks = [e for e in dump["events"] if e["name"] == "serving.rollback"]
    assert rollbacks and rollbacks[-1]["attrs"]["generation"] == 1

    # Every response came from a generation that passed the gate.
    flipped = {e["iteration_number"] for e in pool.events if e["event"] == "flip"}
    assert {r.generation for r in results} <= flipped

    # Bitwise the offline program on the same padded bucket.
    offline = load_serving_program(publisher.generation_dir(model_dir, 2), device="cpu")
    padded, _ = batcher_lib.pad_batch([features], 4)
    expected = batcher_lib.split_rows(offline(padded), [2])[0]
    served = [r for r in results if r.generation == 2][-1]
    np.testing.assert_array_equal(np.asarray(served.outputs["predictions"]), expected["predictions"])
