"""Checkpoint and resume of the port's search, on the CPU.

- Against the JAX package (simple_dnn, `utils.convert` weights, 2
  iterations x 25 steps, fused combine): stop at global step 1, 24 and
  32, evaluate from the mid-iteration checkpoint, resume in a fresh
  Estimator. Both pull the same batches; the manifest at the stop and at
  the end hold the same fields (digests aside, the state file's suffix
  mapped); the architecture files are equal; the frozen EMAs and both
  evaluations agree within atol 1e-4 x max(1, |value|).
- Exactness: with one fixed batch, stop (twice) and resume equals the
  uninterrupted run bitwise (every number of both frozen payloads, the
  architecture bytes), for simple_dnn with the fused combine off and on
  and for a 2-cell f32 NASNet with drop-path, the aux head, batch norm,
  ADAPTIVE distillation and `Chain` (momentum, cosine).
- A restore copies into the live buffers, and the next step moves the
  restored batch-norm statistics and `Chain`'s count.
- Faults of the port before resume: a fresh Estimator over a trained dir
  starts where the manifest says and overwrites nothing; every payload
  is written with a digest, recorded in the manifest.
- Pruning of superseded state files; SIGTERM (a subprocess runner)
  checkpoints, exits 0, and resumes; a torn write (a subprocess SIGKILLed
  by the armed fault) is quarantined and the resume reaches the
  uninterrupted run's architectures; evaluate and predict from a
  mid-iteration checkpoint in a fresh Estimator; a renamed builder and a
  state that does not fit its iteration fail; training cannot resume on
  another device type.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.core import checkpoint as jax_ckpt
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.examples import simple_dnn as jax_simple_dnn

from adanet_tpu_torch.core import checkpoint as ckpt
from adanet_tpu_torch.core import iteration as iteration_lib
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.research.improve_nas import fake_data, improve_nas, optimizer
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.utils.convert import WithInitialVariables

from torch_port_common import one_torch_thread

import torch_chaos_ckpt_runner
import torch_sigterm_runner

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
STEPS = 25

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def _adam(params):
    return torch.optim.Adam(params, lr=1e-3, eps=1e-8)


def _torch_estimator(model_dir, fused=True, steps=STEPS, layer_size=16, **kwargs):
    generator = WithInitialVariables(
        simple_dnn.Generator(optimizer_fn=_adam, layer_size=layer_size, initial_num_layers=1, seed=0), 256, 10)
    defaults = dict(
        head=MultiClassHead(10), subnetwork_generator=generator, max_iteration_steps=steps, max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=_adam, use_fused_combine=fused)],
        model_dir=str(model_dir), log_every_steps=0, device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


def _jax_estimator(model_dir):
    return adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.adam(1e-3), layer_size=16, initial_num_layers=1,
                                     seed=0),
            256, 10, convert=lambda v: v,
        ),
        max_iteration_steps=STEPS, max_iterations=2,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True)],
        model_dir=str(model_dir), log_every_steps=0,
    )


def _logged_input_fn(x, y, log, batch_size=32):
    def fn():
        for i, start in enumerate(range(0, len(x), batch_size)):
            log.append(i)
            yield {"x": x[start:start + batch_size]}, y[start:start + batch_size]

    return fn


def _manifest(package, model_dir, suffix):
    info = json.load(open(os.path.join(str(model_dir), "checkpoint.json")))
    for key in ("digests", "checksum"):
        info.pop(key)
    if info["iteration_state_file"]:
        info["iteration_state_file"] = info["iteration_state_file"].replace(suffix, ".pt")
    return info


def _close(got, want, what):
    for key in ("accuracy", "average_loss", "loss", "top_5_accuracy"):
        assert abs(got[key] - want[key]) <= 1e-4 * max(1.0, abs(want[key])), (what, key, got[key], want[key])
    assert got["best_ensemble"] == want["best_ensemble"], what
    assert got["global_step"] == want["global_step"], what


@pytest.mark.parametrize("stop", [1, STEPS - 1, STEPS + 7])
def test_stop_and_resume_matches_jax(tmp_path, stop):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    xte, yte = make_dataset(256, seed=8)
    runs = {}
    for key, make, package, suffix in (("jax", _jax_estimator, jax_ckpt, ".msgpack"),
                                       ("torch", _torch_estimator, ckpt, ".pt")):
        d, log = tmp_path / key, []
        make(d).train(_logged_input_fn(xtr, ytr, log), max_steps=stop)
        at_stop = _manifest(package, d, suffix)
        mid_eval = make(d).evaluate(input_fn(xte, yte, 32))
        est = make(d)
        est.train(_logged_input_fn(xtr, ytr, log), max_steps=10**6)
        runs[key] = dict(
            log=log, at_stop=at_stop, mid_eval=mid_eval, final=_manifest(package, d, suffix),
            eval=est.evaluate(input_fn(xte, yte, 32)),
            arch=[open(os.path.join(str(d), "architecture-%d.json" % t)).read() for t in range(2)],
            emas=[package.restore_payload(str(d), "frozen-%d%s" % (t, suffix))["final_ema"]["value"]
                  for t in range(2)],
        )
    got, want = runs["torch"], runs["jax"]
    # The resumed process pulls from input_fn's start (its first batch
    # sizes the iteration and is its first step).
    assert got["log"] == want["log"] == [i % 8 for i in range(stop)] + [i % 8 for i in range(2 * STEPS - stop)]
    assert got["at_stop"] == want["at_stop"]
    assert got["at_stop"]["iteration_state_file"] == "ckpt-%d.pt" % stop
    assert (got["at_stop"]["global_step"], got["at_stop"]["iteration_number"]) == (stop, stop // STEPS)
    assert got["final"] == want["final"]
    assert (got["final"]["global_step"], got["final"]["iteration_number"]) == (2 * STEPS, 2)
    assert got["arch"] == want["arch"]
    for g, w in zip(got["emas"], want["emas"]):
        assert abs(g - w) <= 1e-4 * max(1.0, abs(w)), (got["emas"], want["emas"])
    _close(got["mid_eval"], want["mid_eval"], "at the stop")
    assert got["mid_eval"]["global_step"] == stop
    _close(got["eval"], want["eval"], "at the end")


# ------------------------------------------------------------------ exactness


def _fixed_input_fn(batch):
    def fn():
        while True:
            yield batch

    return fn


def _nasnet_estimator(model_dir, steps=3, **kwargs):
    hparams = improve_nas.Hparams(
        num_cells=2, num_conv_filters=4, compute_dtype=torch.float32,
        knowledge_distillation=improve_nas.KnowledgeDistillation.ADAPTIVE, total_training_steps=2 * steps,
    )
    builder = improve_nas.Builder(optimizer.fn_with_name("momentum", "cosine", cosine_decay_steps=steps),
                                  hparams, seed=0, num_classes=3)
    assert hparams.use_aux_head and hparams.drop_path_keep_prob < 1.0

    def sgd(params):
        return torch.optim.SGD(params, lr=0.01)

    return Estimator(
        head=MultiClassHead(3), subnetwork_generator=SimpleGenerator([builder]), max_iteration_steps=steps,
        max_iterations=2, ensemblers=[ComplexityRegularizedEnsembler(optimizer=sgd, use_fused_combine=True)],
        force_grow=True, model_dir=str(model_dir), log_every_steps=0, device="cpu", **kwargs,
    )


def _nasnet_batch():
    provider = fake_data.FakeImageProvider(num_examples=8, image_size=16, num_classes=3, batch_size=8, seed=1)
    return next(iter(provider.get_input_fn("train")()))


def _equal_trees(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for key in want:
            _equal_trees(got[key], want[key], "%s/%s" % (path, key))
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _equal_trees(g, w, "%s/%d" % (path, i))
    elif torch.is_tensor(want):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    else:
        assert got == want, (path, got, want)


CASES = {
    "simple_dnn": (lambda d: _torch_estimator(d, fused=False, steps=6), lambda: next(input_fn(*make_dataset(32), 32)())),
    "simple_dnn_fused": (lambda d: _torch_estimator(d, fused=True, steps=6), lambda: next(input_fn(*make_dataset(32), 32)())),
    "nasnet": (_nasnet_estimator, _nasnet_batch),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_resume_is_exact(tmp_path, case):
    make, batch = CASES[case]
    data = _fixed_input_fn(batch())
    steps = make(tmp_path / "probe")._max_iteration_steps
    make(tmp_path / "whole").train(data, max_steps=10**6)
    for stop in (steps - 2, steps + 1, None):  # inside iteration 0, inside 1, to the end
        make(tmp_path / "parts").train(data, max_steps=stop or 10**6)
    for t in range(2):
        for name in ("architecture-%d.json" % t,):
            assert (tmp_path / "parts" / name).read_bytes() == (tmp_path / "whole" / name).read_bytes()
        _equal_trees(ckpt.restore_payload(str(tmp_path / "parts"), "frozen-%d.pt" % t),
                     ckpt.restore_payload(str(tmp_path / "whole"), "frozen-%d.pt" % t))
    assert ckpt.read_manifest(str(tmp_path / "parts")).global_step == 2 * steps


def test_restore_loads_into_live_buffers_and_the_next_step_moves_them(tmp_path):
    batch = _nasnet_batch()
    data = _fixed_input_fn(batch)
    _nasnet_estimator(tmp_path).train(data, max_steps=2)
    saved = ckpt.restore_payload(str(tmp_path), "ckpt-2.pt")
    est = _nasnet_estimator(tmp_path)
    info = ckpt.read_manifest(str(tmp_path))
    iteration = est._build_iteration(0, batch)
    state = iteration.init_state(est._iteration_generator(0), batch)
    (name, st), = state.subnetworks.items()
    assert hasattr(st.module.nasnet, "aux_head")
    buffers = dict(st.module.named_buffers())
    pointers = {key: b.data_ptr() for key, b in buffers.items()}
    iteration_lib.restore_state(state, ckpt.restore_payload(str(tmp_path), info.iteration_state_file))
    assert {key: b.data_ptr() for key, b in st.module.named_buffers()} == pointers
    _equal_trees(iteration_lib.state_payload(state), saved)
    counts = [key for key in buffers if key.endswith(".count")]
    assert counts and all(float(buffers[key]) == 2.0 for key in counts)
    assert st.optimizer.param_groups[0]["count"] == 2 and state.iteration_step == 2
    means = {key: buffers[key].clone() for key in buffers if key.endswith(".mean")}
    iteration.train_step(state, batch)
    assert all(float(buffers[key]) == 3.0 for key in counts)
    assert all(not torch.equal(buffers[key], means[key]) for key in means)
    assert float(buffers["nasnet.step"]) == 3.0 and st.optimizer.param_groups[0]["count"] == 3


# ---------------------------------------------- the faults before resume


def test_fresh_estimator_resumes_from_model_dir(tmp_path):
    """A second Estimator over a trained dir reports the manifest's step
    and iteration and goes on from there, leaving the finished
    iteration's files as they were."""
    xtr, ytr = make_dataset(8 * 32, seed=7)
    _torch_estimator(tmp_path, steps=6).train(input_fn(xtr, ytr, 32), max_steps=6)
    before = {name: (tmp_path / name).read_bytes() for name in ("architecture-0.json", "frozen-0.pt")}
    est = _torch_estimator(tmp_path, steps=6)
    assert (est.latest_global_step(), est.latest_iteration_number()) == (6, 1)
    est.train(input_fn(xtr, ytr, 32), max_steps=10**6)
    assert (est.latest_global_step(), est.latest_iteration_number()) == (12, 2)
    assert {name: (tmp_path / name).read_bytes() for name in before} == before
    arch = json.loads((tmp_path / "architecture-1.json").read_text())
    assert arch["global_step"] == 12 and len(arch["replay_indices"]) == 2


def test_every_payload_is_written_with_its_digest(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    _torch_estimator(tmp_path, steps=6).train(input_fn(xtr, ytr, 32), max_steps=9)
    info = ckpt.read_manifest(str(tmp_path))
    payloads = sorted(name for name in os.listdir(tmp_path) if name.endswith(".pt"))
    assert payloads == ["ckpt-9.pt", "frozen-0.pt"]
    assert sorted(info.digests) == payloads
    for name in payloads:
        assert ckpt.verify_file(str(tmp_path), name) is True
        assert ckpt.read_digest(str(tmp_path), name) == info.digests[name]
    assert not [name for name in os.listdir(tmp_path) if name.startswith("tmp")]


# ------------------------------------------------------------ the resume paths


def test_stale_mid_iteration_checkpoints_are_pruned(tmp_path):
    xtr, ytr = make_dataset(8 * 32, seed=7)
    est = _torch_estimator(tmp_path, steps=8, save_checkpoint_steps=2)
    est.train(input_fn(xtr, ytr, 32), max_steps=5)
    files = sorted(name for name in os.listdir(tmp_path) if name.startswith("ckpt-"))
    assert files == ["ckpt-5.pt", "ckpt-5.pt.sha256"]
    assert ckpt.read_manifest(str(tmp_path)).iteration_state_file == "ckpt-5.pt"
    _torch_estimator(tmp_path, steps=8, save_checkpoint_steps=2).train(input_fn(xtr, ytr, 32), max_steps=100)
    assert not [name for name in os.listdir(tmp_path) if name.startswith("ckpt-")]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS_DIR), TESTS_DIR, env.get("PYTHONPATH", "")])
    return env


def test_sigterm_checkpoints_and_resumes(tmp_path):
    model_dir = str(tmp_path / "model")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(TESTS_DIR, "torch_sigterm_runner.py"), model_dir],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    deadline = time.time() + 120
    while time.time() < deadline:
        line = proc.stdout.readline()
        if "READY" in line:
            break
        if not line and proc.poll() is not None:
            raise AssertionError(proc.communicate()[0][-2000:])
    else:  # pragma: no cover
        proc.kill()
        raise AssertionError("runner never started training")
    time.sleep(0.5)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0, out[-2000:]
    assert "STOPPED AT" in out, out[-2000:]
    info = ckpt.read_manifest(model_dir)
    assert info is not None and info.global_step > 0
    assert info.iteration_state_file == "ckpt-%d.pt" % info.global_step
    assert "STOPPED AT %d" % info.global_step in out
    stopped = info.global_step

    est = torch_sigterm_runner.build_estimator(model_dir, stopped + 4, max_iterations=1)
    est.train(torch_sigterm_runner.make_input_fn(), max_steps=stopped + 4)
    assert (est.latest_global_step(), est.latest_iteration_number()) == (stopped + 4, 1)


def test_torn_write_is_quarantined_and_resume_reaches_the_uninterrupted_run(tmp_path):
    oracle = str(tmp_path / "oracle")
    torch_chaos_ckpt_runner.build_estimator(oracle).train(torch_chaos_ckpt_runner.input_fn, max_steps=100)
    d = str(tmp_path / "model")
    env = _env()
    env["ADANET_FAULTS"] = "checkpoint.write:torn:after=2"
    proc = subprocess.run([sys.executable, os.path.join(TESTS_DIR, "torch_chaos_ckpt_runner.py"), d],
                          env=env, capture_output=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stdout.decode()[-2000:] + proc.stderr.decode()[-2000:]
    assert b"UNEXPECTED COMPLETION" not in proc.stdout
    assert os.path.exists(os.path.join(d, "ckpt-6.pt"))
    assert ckpt.read_digest(d, "ckpt-6.pt") is None
    info = ckpt.read_manifest(d)
    assert (info.iteration_state_file, info.global_step) == ("ckpt-4.pt", 4)

    est = torch_chaos_ckpt_runner.build_estimator(d)
    est.train(torch_chaos_ckpt_runner.input_fn, max_steps=100)
    assert (est.latest_iteration_number(), est.latest_global_step()) == (2, 12)
    assert os.path.exists(os.path.join(d, "ckpt-6.pt.corrupt"))
    assert not os.path.exists(os.path.join(d, "ckpt-6.pt"))
    for t in range(2):
        name = "architecture-%d.json" % t
        assert open(os.path.join(d, name)).read() == open(os.path.join(oracle, name)).read()


def test_evaluate_and_predict_from_mid_iteration_checkpoint(tmp_path):
    xtr, ytr = make_dataset(4 * 32, seed=7)
    est = _torch_estimator(tmp_path, steps=8)
    est.train(input_fn(xtr, ytr, 32), max_steps=5)
    assert est.latest_iteration_number() == 0
    metrics = est.evaluate(input_fn(xtr, ytr, 32))
    assert np.isfinite(metrics["average_loss"]) and metrics["best_ensemble"].startswith("t0_")
    assert metrics["global_step"] == 5
    preds = list(est.predict(input_fn(xtr, ytr, 32)))
    assert len(preds) == 4 and preds[0]["logits"].shape == (32, 10)
    again = _torch_estimator(tmp_path, steps=8).evaluate(input_fn(xtr, ytr, 32))
    assert again == metrics
    features_only = list(_torch_estimator(tmp_path, steps=8).predict(
        lambda: ({"x": b[0]["x"]} for b in input_fn(xtr, ytr, 32)())))
    for got, want in zip(features_only, preds):
        assert torch.equal(got["logits"], want["logits"])


def test_renamed_builder_breaks_the_rebuild(tmp_path):
    xtr, ytr = make_dataset(4 * 32, seed=7)
    data = input_fn(xtr, ytr, 32)
    _torch_estimator(tmp_path, steps=4, max_iterations=1).train(data, max_steps=100)

    class Renamed(simple_dnn._DNNBuilder):
        @property
        def name(self):
            return "renamed_" + super().name

    builders = [Renamed(_adam, 16, n, False, 0.0, 0) for n in (1, 2)]
    renamed = _torch_estimator(tmp_path, steps=4, subnetwork_generator=SimpleGenerator(builders))
    with pytest.raises(ValueError, match="deterministic"):
        renamed.train(data, max_steps=100)
    with pytest.raises(ValueError, match="deterministic"):
        renamed.evaluate(data)


def test_a_state_that_does_not_fit_its_iteration_raises(tmp_path):
    xtr, ytr = make_dataset(4 * 32, seed=7)
    data = input_fn(xtr, ytr, 32)
    _torch_estimator(tmp_path, steps=8).train(data, max_steps=3)
    payload = ckpt.restore_payload(str(tmp_path), "ckpt-3.pt")
    (name, sub), *_ = payload["subnetworks"].items()
    sub["parameter_names"] = list(reversed(sub["parameter_names"]))
    ckpt.save_payload(str(tmp_path), "ckpt-3.pt", payload)
    info = ckpt.read_manifest(str(tmp_path))
    info.digests["ckpt-3.pt"] = ckpt.read_digest(str(tmp_path), "ckpt-3.pt")
    ckpt.write_manifest(str(tmp_path), info)
    with pytest.raises(ValueError, match="parameters of %r do not match" % name):
        _torch_estimator(tmp_path, steps=8).train(data, max_steps=10)


def test_training_cannot_resume_on_another_device_type(tmp_path):
    """A CUDA generator's state is Philox (seed, offset), a CPU one's is
    a Mersenne Twister: a state saved on the card does not resume
    training on the CPU (evaluation from it does)."""
    xtr, ytr = make_dataset(4 * 32, seed=7)
    data = input_fn(xtr, ytr, 32)
    _torch_estimator(tmp_path, steps=8).train(data, max_steps=3)
    payload = ckpt.restore_payload(str(tmp_path), "ckpt-3.pt")
    payload["generator"] = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    info = ckpt.read_manifest(str(tmp_path))
    info.digests["ckpt-3.pt"] = ckpt.save_payload(str(tmp_path), "ckpt-3.pt", payload)
    ckpt.write_manifest(str(tmp_path), info)
    assert np.isfinite(_torch_estimator(tmp_path, steps=8).evaluate(data)["loss"])
    with pytest.raises(ValueError, match="cuda generator; training cannot resume on cpu"):
        _torch_estimator(tmp_path, steps=8).train(data, max_steps=10)
    assert ckpt.read_manifest(str(tmp_path)).global_step == 3


def test_trainer_checkpoints_on_sigterm_and_resumes(tmp_path, monkeypatch, capsys):
    """The improve_nas trainer CLI: a SIGTERM inside iteration 1 (sent by
    the input pipeline at its sixth pull) checkpoints that step,
    evaluates the current best and returns 0; run again over the same
    --model_dir, it restores the state and finishes."""
    import threading

    from adanet_tpu_torch.research.improve_nas import trainer

    assert threading.current_thread() is threading.main_thread()
    argv = ["--dataset=fake", "--num_cells=3", "--num_conv_filters=4", "--batch_size=16", "--boosting_iterations=2",
            "--train_steps=8", "--device=cpu", "--model_dir=%s" % tmp_path]
    get_input_fn = fake_data.FakeImageProvider.get_input_fn
    pulls = []

    def signalling(self, partition="train"):
        fn = get_input_fn(self, partition)

        def input_fn():
            for batch in fn():
                pulls.append(partition)
                if pulls.count("train") == 6 and partition == "train":
                    os.kill(os.getpid(), signal.SIGTERM)
                yield batch

        return input_fn

    monkeypatch.setattr(fake_data.FakeImageProvider, "get_input_fn", signalling)
    before = signal.getsignal(signal.SIGTERM)
    assert trainer.main(argv) == 0
    assert signal.getsignal(signal.SIGTERM) == before
    info = ckpt.read_manifest(str(tmp_path))
    assert (info.iteration_number, info.global_step, info.iteration_state_file) == (1, 6, "ckpt-6.pt")
    stopped = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stopped["global_step"] == 6 and stopped["best_ensemble"].startswith("t1_")
    monkeypatch.undo()
    assert trainer.main(argv) == 0
    info = ckpt.read_manifest(str(tmp_path))
    assert (info.iteration_number, info.global_step, info.iteration_state_file) == (2, 8, None)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["global_step"] == 8
