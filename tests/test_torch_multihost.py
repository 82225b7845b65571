"""The port's processes under RoundRobin and at a restore: gloo on the CPU.

- The restore agreement (F5): two processes resume a data-parallel
  search from a mid-iteration state file whose read fails on rank 1
  only (`torch_elastic_runner.py`, `TEST_RESTORE_FAULT=1`). Both must
  roll back to the same global step, the iteration's start, and only
  the chief may quarantine the file and write the manifest.
- Copies of tests/test_distributed.py's multi-host RoundRobin tests
  (`torch_multihost_rr_runner.py`): 2 processes own groups [[0], [1],
  [0]] (the ensemble group and "b" on the chief, "a" on process 1); 4
  and 8 processes (slow, as in the JAX package) own whole-process
  blocks, so the ensemble group (and, with 8, a subnetwork group) trains
  data-parallel across processes. Every process feeds the same batches,
  so the chief's frozen winners must match a fused one-process oracle
  within rtol 2e-4, atol 1e-5 (the JAX test's; bitwise on the CPU while
  every subnetwork group has one process).
- A copy of tests/test_robustness.py::test_chaos_multihost_peer_death
  without its compile-cache fault site (`torch_chaos_multihost_runner.py`):
  a model dir torn mid-checkpoint, then a peer that stops answering at
  a member sync. The chief must declare it lost within the deadline,
  finish the iteration with the survivor, persist it, and exit 0.

Every subprocess has its own timeout; each rendezvous binds port 0.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from adanet_tpu_torch.core import checkpoint as ckpt_lib

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 180


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _env(**extra):
    env = dict(os.environ)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env.pop("ADANET_FAULTS", None)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS), TESTS, env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def _spawn(script, args, **extra):
    return subprocess.Popen([sys.executable, os.path.join(TESTS, script)] + [str(a) for a in args],
                            env=_env(**extra), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(procs, timeout=TIMEOUT):
    """Each process's (return code, output); a process still running at
    its timeout is killed, and every other one too."""
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=timeout)
            outs.append((proc.returncode, out.decode()))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def _run_world(script, args_of, world, **extra):
    port = _free_port()
    outs = _finish([_spawn(script, args_of(rank, port), **extra) for rank in range(world)])
    for rank, (rc, out) in enumerate(outs):
        assert rc == 0, (rank, out[-3000:])
    return outs


# ------------------------------------------------------ restore agreement


def test_restore_agreement_two_processes(tmp_path):
    """F5: a state file that only rank 1 fails to read rolls BOTH ranks
    back to the iteration's start; only the chief writes."""
    d = str(tmp_path / "model")
    os.makedirs(d)
    _run_world("torch_elastic_runner.py", lambda r, p: [d, "a", r, p, 2, 8], 2)
    info = ckpt_lib.read_manifest(d)
    assert (info.iteration_state_file, info.global_step) == ("ckpt-8.pt", 8)
    _run_world("torch_elastic_runner.py", lambda r, p: [d, "f", r, p, 2, -1], 2, TEST_RESTORE_FAULT="1")
    records = [json.load(open(os.path.join(d, "restore_%d.json" % r))) for r in range(2)]
    for record in records:
        assert record["state_file"] == "ckpt-8.pt"
        assert (record["global_step"], record["iteration_step"]) == (0, 0), records
    assert records[0]["writes"] == ["quarantine", "manifest"]
    assert records[1]["writes"] == []
    assert os.path.exists(os.path.join(d, "ckpt-8.pt.corrupt"))
    info = ckpt_lib.read_manifest(d)
    assert (info.iteration_state_file, info.global_step) == (None, 0)


# ------------------------------------------------------- multi-host RR


def _run_multihost_rr(tmp_path, world):
    d = str(tmp_path / "mhrr_model")
    os.makedirs(d)
    outs = _run_world("torch_multihost_rr_runner.py", lambda r, p: ["search", d, r, world, p], world)
    for rank, (_, out) in enumerate(outs):
        assert "MHRR ROLE %d DONE" % rank in out
    return d, [json.load(open(os.path.join(d, "topology_%d.json" % r))) for r in range(world)]


def _assert_matches_fused_oracle(model_dir, bitwise=True):
    """The chief's frozen winners against the same search fused in one
    process on the same batches; bitwise when every subnetwork group has
    one process (a group across processes all-reduces its gradients, a
    reordered f32 sum)."""
    from torch_multihost_rr_runner import full_batches, probing, search

    got = np.load(os.path.join(model_dir, "probe_0.npz"))
    want = {}
    oracle = search(tempfile.mkdtemp(dir=os.path.dirname(model_dir)), "cpu", probing(want), placement=False)
    oracle.train(lambda: iter(full_batches()), max_steps=100)
    assert sorted(got.files) == sorted(want) and want
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=2e-4, atol=1e-5, err_msg=key)
        assert not bitwise or np.array_equal(got[key], value), key


def test_multi_host_round_robin_two_processes(tmp_path):
    """2 processes and 3 groups: the worker-modulo rule puts the ensemble
    group and "b" on process 0 and "a" on process 1; members sync
    through the store, and the frozen winners match the fused oracle."""
    d, topologies = _run_multihost_rr(tmp_path, 2)
    assert topologies[0]["owners"] == [[0], [1], [0]]
    assert [t["owners"] for t in topologies] == [[[0], [1], [0]]] * 2
    assert [t["owned"] for t in topologies] == [[0, 2], [1]]
    _assert_matches_fused_oracle(d)


@pytest.mark.slow
def test_multi_host_round_robin_four_processes(tmp_path):
    """4 processes and 3 groups: whole-process blocks, the ensemble group
    spanning processes 0 and 1 (its updates all-reduce over their
    process group)."""
    d, topologies = _run_multihost_rr(tmp_path, 4)
    assert all(t["owners"] == [[0, 1], [2], [3]] for t in topologies)
    _assert_matches_fused_oracle(d)


@pytest.mark.slow
def test_multi_host_round_robin_eight_processes(tmp_path):
    """8 processes over 3 groups: UNEVEN whole-process blocks (3/3/2), so
    the ensemble group AND a subnetwork group train across processes."""
    d, topologies = _run_multihost_rr(tmp_path, 8)
    assert all(t["owners"] == [[0, 1, 2], [3, 4, 5], [6, 7]] for t in topologies)
    _assert_matches_fused_oracle(d, bitwise=False)


# ---------------------------------------------------------- peer death


def test_chaos_multihost_peer_death(tmp_path):
    """A model dir torn mid-checkpoint, then 2 processes resume under
    multi-host RoundRobin and process 1 (owner of "a") stops answering at
    its third broadcast. The chief quarantines the torn file, declares
    the peer lost within the deadline (no hang), finishes the iteration
    with "b", persists it, and exits 0; "a" is dead in the metrics file."""
    d = str(tmp_path / "m")
    proc = subprocess.run([sys.executable, os.path.join(TESTS, "torch_chaos_ckpt_runner.py"), d],
                          env=_env(ADANET_FAULTS="checkpoint.write:torn:after=2"), capture_output=True,
                          timeout=TIMEOUT)
    assert proc.returncode == -signal.SIGKILL, proc.stdout.decode()[-2000:] + proc.stderr.decode()[-2000:]
    assert os.path.exists(os.path.join(d, "ckpt-6.pt"))

    port = _free_port()
    timeouts = dict(ADANET_COLLECTIVE_TIMEOUT_SECS="3", ADANET_HEARTBEAT_INTERVAL_SECS="1")
    chief = _spawn("torch_chaos_multihost_runner.py", [d, 0, 2, port], **timeouts)
    peer = _spawn("torch_chaos_multihost_runner.py", [d, 1, 2, port],
                  ADANET_FAULTS="collective.entry:hang:after=2:delay=600", **timeouts)
    try:
        out, _ = chief.communicate(timeout=TIMEOUT)
    finally:
        peer.kill()
        peer.communicate(timeout=60)
        if chief.poll() is None:
            chief.kill()
            chief.communicate()
    text = out.decode()
    assert chief.returncode == 0, text[-3000:]
    line = [entry for entry in text.splitlines() if entry.startswith("CHAOS CHIEF DONE")]
    assert line, text[-3000:]
    record = json.loads(line[0].split("CHAOS CHIEF DONE ", 1)[1])
    assert record["peer_lost"] is True
    assert record["wall_secs"] < 120.0
    assert record["iteration_number"] == 1
    with open(os.path.join(d, "architecture-0.json")) as f:
        members = [e["builder_name"] for e in json.load(f)["subnetworks"]]
    assert members == ["2_layer_dnn"]
    assert os.path.exists(os.path.join(d, "ckpt-6.pt.corrupt"))
    assert not os.path.exists(os.path.join(d, "ckpt-6.pt"))
    metrics = json.load(open(os.path.join(d, ckpt_lib.candidate_metrics_filename(0))))
    assert [name for name, entry in metrics.items() if entry["dead"]] == ["t0_1_layer_dnn_grow_complexity_regularized"]
