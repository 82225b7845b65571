"""The port's processes: roles, the chief/worker handshake and data
parallelism over `torch.distributed` (gloo on the CPU).

Copies of tests/test_distributed.py's multi-process tests, with runners
`torch_distributed_runner.py` (chief and worker, each its own process)
and `torch_spmd_runner.py` (one process group):

- the manifest handshake (`wait_for_iteration`), chief and worker
  sharing a model dir, and a lone worker's `WorkerWaitTimeout` inside
  `train()`;
- `world` processes training one search data-parallel, each feeding its
  slice of every global batch: every process's final winner bitwise
  equal to the others' (one all-reduce gives every rank the same sums),
  and within rtol 2e-4, atol 1e-5 (the JAX test's) of the port's own
  one-process oracle on the whole batches (the slices' weighted means
  and gradients against the whole batch's, a reordered f32 sum);
- the collective bookkeeping's lockstep guard (streams that agree pass,
  a longer or a reshaped stream raises on both processes);
- a SIGTERM to one of two processes stopping both at the same step, the
  chief's checkpoint at that step.

Every subprocess gets its own timeout, so that a hang fails its test.
"""

import os
import signal
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.distributed import coordination

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS = os.path.dirname(os.path.abspath(__file__))
SPMD_RUNNER = os.path.join(TESTS, "torch_spmd_runner.py")
ROLE_RUNNER = os.path.join(TESTS, "torch_distributed_runner.py")
TIMEOUT = 180


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _env():
    env = dict(os.environ)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _spawn(args):
    return subprocess.Popen([sys.executable] + args, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _finish(procs):
    """Each process's output; a process still running at its timeout is
    killed, and every other one too."""
    outs = []
    try:
        for proc in procs:
            out, _ = proc.communicate(timeout=TIMEOUT)
            outs.append(out.decode())
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def test_backend_rule():
    assert coordination.backend_for("cuda") == "nccl"
    assert coordination.backend_for(torch.device("cuda", 0)) == "nccl"
    assert coordination.backend_for("cpu") == "gloo"
    assert coordination.backend_for("cuda", "gloo") == "gloo"
    # One process: no process group, the device resolved.
    assert coordination.initialize(num_processes=1, device="cpu") == torch.device("cpu")
    assert coordination.process_count() == 1 and coordination.is_chief()


def test_worker_wait_for_iteration(tmp_path):
    model_dir = str(tmp_path)
    ckpt_lib.write_manifest(model_dir, ckpt_lib.CheckpointInfo(iteration_number=0))

    def chief():
        import time

        time.sleep(0.3)
        ckpt_lib.write_manifest(model_dir, ckpt_lib.CheckpointInfo(iteration_number=1, global_step=8))

    thread = threading.Thread(target=chief)
    thread.start()
    info = coordination.wait_for_iteration(model_dir, 1, timeout_secs=10.0, poll_interval_secs=0.05)
    thread.join(timeout=10.0)
    assert not thread.is_alive()
    assert info.iteration_number == 1
    assert info.global_step == 8
    with pytest.raises(coordination.WorkerWaitTimeout):
        coordination.wait_for_iteration(model_dir, 2, timeout_secs=0.2, poll_interval_secs=0.05)


def test_worker_wait_ignores_unfinished_bookkeeping(tmp_path):
    """The chief's bookkeeping writes `architecture-0.json`, then
    `frozen-0.pt`, then the manifest. A worker that polls between the
    first two must keep waiting: a manifest reconstructed from the
    architecture chain would send it to read a payload not yet written."""
    model_dir = str(tmp_path)
    ckpt_lib.write_text(model_dir, ckpt_lib.architecture_filename(0), '{"global_step": 6}')
    assert ckpt_lib.read_manifest(model_dir).iteration_number == 1
    with pytest.raises(coordination.WorkerWaitTimeout):
        coordination.wait_for_iteration(model_dir, 1, timeout_secs=0.2, poll_interval_secs=0.05)
    ckpt_lib.write_manifest(model_dir, ckpt_lib.CheckpointInfo(iteration_number=1, global_step=6))
    info = coordination.wait_for_iteration(model_dir, 1, timeout_secs=1.0, poll_interval_secs=0.05)
    assert (info.iteration_number, info.global_step) == (1, 6)


def test_multi_process_chief_worker(tmp_path):
    """Chief and worker processes share a model dir: the worker waits for
    the chief's bookkeeping each iteration and both end at iteration 2."""
    model_dir = str(tmp_path / "shared_model")
    chief_out, worker_out = _finish([_spawn([ROLE_RUNNER, model_dir, "0"]), _spawn([ROLE_RUNNER, model_dir, "1"])])
    assert "ROLE 0 DONE" in chief_out, chief_out[-2000:]
    assert "ROLE 1 DONE" in worker_out, worker_out[-2000:]
    assert ckpt_lib.read_manifest(model_dir).iteration_number == 2


def test_worker_timeout_inside_train(tmp_path):
    (out,) = _finish([_spawn([ROLE_RUNNER, str(tmp_path / "abandoned"), "1", "timeout"])])
    assert "ROLE 1 TIMED OUT CLEANLY" in out, out[-2000:]
    # The worker wrote no bookkeeping.
    assert ckpt_lib.read_manifest(str(tmp_path / "abandoned")) is None


@pytest.mark.parametrize("world", [2, pytest.param(4, marks=pytest.mark.slow)])
def test_multi_host_spmd_data_path(tmp_path, world):
    sys.path.insert(0, TESTS)
    from torch_spmd_runner import oracle_probes

    model_dir = str(tmp_path / "spmd_model")
    os.makedirs(model_dir)
    port = str(_free_port())
    outs = _finish([_spawn([SPMD_RUNNER, "spmd", model_dir, str(i), port, str(world)]) for i in range(world)])
    for i, out in enumerate(outs):
        assert "SPMD ROLE %d DONE" % i in out, out[-3000:]
    probes = [np.load(os.path.join(model_dir, "probe_%d.npz" % i)) for i in range(world)]
    p0 = probes[0]
    assert p0.files
    for other in probes[1:]:
        assert sorted(other.files) == sorted(p0.files)
        for key in p0.files:
            np.testing.assert_array_equal(p0[key], other[key])
    # Only the chief wrote: one manifest, iteration 2, and the reports.
    assert ckpt_lib.read_manifest(model_dir).iteration_number == 2
    oracle = oracle_probes(str(tmp_path / "oracle_model"))
    assert sorted(oracle) == sorted(p0.files)
    assert any(key.startswith("t1/") for key in oracle)
    for key, value in oracle.items():
        np.testing.assert_allclose(p0[key], value, rtol=2e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["ok", "count", "shape"])
def test_collective_lockstep_guard(tmp_path, mode):
    port = str(_free_port())
    outs = _finish([_spawn([SPMD_RUNNER, "lockstep-" + mode, str(tmp_path), str(i), port, "2"]) for i in range(2)])
    expected = "OK" if mode == "ok" else "RAISED"
    for i, out in enumerate(outs):
        assert "LOCKSTEP %s ROLE %d %s" % (mode, i, expected) in out, out[-3000:]


def test_sigterm_to_one_process_stops_both_at_the_same_step(tmp_path):
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    port = str(_free_port())
    procs = [_spawn([SPMD_RUNNER, "sigterm", model_dir, str(i), port, "2"]) for i in range(2)]
    # Reading the worker's output blocks; a hang before its marker ends
    # at the timeout, with both processes killed.
    killer = threading.Timer(TIMEOUT, lambda: [proc.kill() for proc in procs])
    killer.start()
    try:
        seen = []
        for line in procs[1].stdout:
            seen.append(line.decode())
            if line.startswith(b"TRAINING"):
                procs[1].send_signal(signal.SIGTERM)
                break
        else:
            raise AssertionError("worker never trained: %s" % "".join(seen)[-3000:])
        rest = _finish(procs)
    finally:
        killer.cancel()
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    outs = [rest[0], "".join(seen) + rest[1]]
    stops = []
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("STOPPED AT ")]
        assert lines, out[-3000:]
        stops.append(int(lines[-1].split()[-1]))
    assert stops[0] == stops[1] >= 20, stops
    # The stop check runs every 8 steps (no logging period).
    assert stops[0] % 8 == 0, stops
    info = ckpt_lib.read_manifest(model_dir)
    assert info.global_step == stops[0] and info.iteration_state_file, info
