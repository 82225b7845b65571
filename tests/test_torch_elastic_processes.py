"""The port's elastic searches across processes: gloo on the CPU.

- Copies of tests/test_distributed.py's `test_elastic_wq_grow_back_oracle_parity`
  (the lease-based queue: 2 processes stopped at step 8, off the window
  grid; 1 process on to 28, across the iteration boundary; 2 processes to
  the end; the selection and every frozen parameter bitwise the
  never-shrunk one-process run's, since units run the same operations
  on the same snapshots whatever the world), `test_elastic_shrunk_world_resume`
  and `test_elastic_grow_back_resume` (data-parallel, 16-row global
  batches sharded by the world; the selection sequence equal to the
  never-shrunk oracle's), through `torch_elastic_wq_runner.py` and
  `torch_elastic_runner.py`.
- A copy of tests/test_robustness.py::test_elastic_wq_worker_sigkill_mid_unit:
  the worker SIGKILLed at its second unit, whose lease (TTL 2 s) expires
  and re-issues to the chief, which finishes the search alone on the
  lockstep RoundRobin oracle's selection (and, bitwise, its frozen
  parameters: windows of 4 on both sides, builders that draw nothing).
  The chief sleeps 0.3 s before each of its units: under a loaded host
  the worker can reach the queue after the chief has drained it alone,
  and would then never reach the unit its fault kills.
- A copy of tests/test_distributed.py::test_spmd_autoensemble_bagging
  (`torch_spmd_runner.py bagging`): each process feeds its half of the
  shared and the bagged streams; both processes' trained candidates
  bitwise equal, and within rtol 2e-4, atol 1e-5 (the JAX test's) of one
  process on the whole streams (a reordered f32 sum).

Every subprocess has its own timeout; each rendezvous binds port 0.
"""

import json
import os
import signal
import tempfile

import numpy as np
import pytest

from test_torch_multihost import TIMEOUT, _finish, _free_port, _run_world, _spawn
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _phase(script, model_dir, tag, world, max_steps, **extra):
    """One phase of a search, `world` processes; rank 0's record."""
    outs = _run_world(script, lambda r, p: [model_dir, tag, r, p, world, max_steps], world, **extra)
    for rank, (_, out) in enumerate(outs):
        assert "ROLE %d DONE" % rank in out, out[-2000:]
    with open(os.path.join(model_dir, "%s.json" % tag)) as f:
        return json.load(f)


def _wq(model_dir, tag, world, max_steps, **extra):
    return _phase("torch_elastic_wq_runner.py", model_dir, tag, world, max_steps, ADANET_TEST_EXIT_BARRIER="1",
                  **extra)


def _spmd(model_dir, tag, world, max_steps):
    return _phase("torch_elastic_runner.py", model_dir, tag, world, max_steps)


def _fresh(tmp_path, name):
    d = str(tmp_path / name)
    os.makedirs(d)
    return d


def test_elastic_wq_grow_back_oracle_parity(tmp_path):
    d = _fresh(tmp_path, "elastic_wq_model")
    phase_a = _wq(d, "phase_a", 2, 8)
    assert (phase_a["final_step"], phase_a["final_iteration"]) == (8, 0)
    phase_b = _wq(d, "phase_b", 1, 28)
    assert phase_b["resume_start_step"] == 8
    assert (phase_b["final_step"], phase_b["final_iteration"]) == (28, 1)
    phase_c = _wq(d, "phase_c", 2, -1)
    assert phase_c["resume_start_step"] == 28
    assert (phase_c["final_step"], phase_c["final_iteration"]) == (40, 2)
    assert np.isfinite(phase_c["loss"])
    oracle = _wq(_fresh(tmp_path, "oracle_model"), "oracle", 1, -1)
    assert phase_c["selection"] and phase_c["selection"] == oracle["selection"]
    # The two-process search straight through is the one-process one,
    # bitwise.
    straight = _wq(_fresh(tmp_path, "two_model"), "two", 2, -1)
    assert straight["frozen_digest"] == oracle["frozen_digest"]
    assert straight["selection"] == oracle["selection"]


def test_elastic_shrunk_world_resume(tmp_path):
    d = _fresh(tmp_path, "elastic_model")
    phase_a = _spmd(d, "phase_a", 2, 8)
    assert phase_a["final_step"] == 8
    phase_b = _spmd(d, "phase_b", 1, -1)
    assert phase_b["resume_start_step"] == 8
    assert (phase_b["final_step"], phase_b["final_iteration"]) == (40, 2)
    assert np.isfinite(phase_b["loss"])


def test_elastic_grow_back_resume(tmp_path):
    d = _fresh(tmp_path, "elastic_model")
    phase_a = _spmd(d, "phase_a", 2, 8)
    assert (phase_a["final_step"], phase_a["final_iteration"]) == (8, 0)
    phase_b = _spmd(d, "phase_b", 1, 28)
    assert phase_b["resume_start_step"] == 8
    assert (phase_b["final_step"], phase_b["final_iteration"]) == (28, 1)
    phase_c = _spmd(d, "phase_c", 2, -1)
    assert phase_c["resume_start_step"] == 28
    assert (phase_c["final_step"], phase_c["final_iteration"]) == (40, 2)
    assert np.isfinite(phase_c["loss"])
    oracle = _spmd(_fresh(tmp_path, "oracle_model"), "oracle", 1, -1)
    assert phase_c["selection"] and phase_c["selection"] == oracle["selection"]


def test_elastic_wq_worker_sigkill_mid_unit(tmp_path):
    d = _fresh(tmp_path, "m")
    port = _free_port()
    chief = _spawn("torch_elastic_wq_runner.py", [d, "chaos", 0, port, 2, -1], TEST_LEASE_TTL="2",
                   TEST_CHIEF_UNIT_DELAY="0.3")
    worker = _spawn("torch_elastic_wq_runner.py", [d, "chaos", 1, port, 2, -1], TEST_LEASE_TTL="2",
                    ADANET_FAULTS="workunit.execute:kill:after=1")
    (chief_rc, chief_out), (worker_rc, _) = _finish([chief, worker])
    assert chief_rc == 0, chief_out[-3000:]
    assert worker_rc == -signal.SIGKILL
    with open(os.path.join(d, "chaos.json")) as f:
        record = json.load(f)
    assert (record["final_step"], record["final_iteration"]) == (40, 2)
    assert np.isfinite(record["loss"])
    oracle_dir = _fresh(tmp_path, "oracle")
    (rc, out), = _finish([_spawn("torch_elastic_wq_runner.py", [oracle_dir, "oracle", 0, 0, 1, -1],
                                 TEST_PLACEMENT="rr")], timeout=TIMEOUT)
    assert rc == 0, out[-3000:]
    with open(os.path.join(oracle_dir, "oracle.json")) as f:
        oracle = json.load(f)
    assert record["selection"] == oracle["selection"]
    assert record["frozen_digest"] == oracle["frozen_digest"]


def test_spmd_autoensemble_bagging(tmp_path):
    from torch_spmd_runner import bagged_batches, bagging_probes, shared_batches

    d = _fresh(tmp_path, "bagging_model")
    outs = _run_world("torch_spmd_runner.py", lambda r, p: ["bagging", d, r, p, 2], 2)
    for rank, (_, out) in enumerate(outs):
        assert "BAGGING ROLE %d DONE" % rank in out
    p0, p1 = (np.load(os.path.join(d, "bagging_%d.npz" % r)) for r in range(2))
    assert sorted(p0.files) == sorted(p1.files) and any(k.startswith("bagged/") for k in p0.files)
    for key in p0.files:
        np.testing.assert_array_equal(p0[key], p1[key])
    oracle = bagging_probes(tempfile.mkdtemp(dir=str(tmp_path)), lambda: iter(shared_batches()),
                            lambda: iter(bagged_batches()), "cpu")
    assert sorted(oracle) == sorted(p0.files)
    for key, value in oracle.items():
        np.testing.assert_allclose(p0[key], value, rtol=2e-4, atol=1e-5, err_msg=key)
