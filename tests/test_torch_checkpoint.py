"""The port's checkpoint layer against the JAX package's, on the CPU.

- The manifest: the same `CheckpointInfo` writes a byte-identical
  `checkpoint.json` (and `.prev`) through both packages; the `.prev` and
  the reconstruct fallbacks recover the same `CheckpointInfo`; a checksum
  mismatch raises in both.
- Payloads: digest sidecars, verify and quarantine; a `checkpoint.write`
  torn fault (the kill stubbed) leaves an undecodable prefix without a
  sidecar; payloads load with `weights_only=True` and anything that
  would not is refused at save time.
- `fsck` over each package's own simple_dnn model dir (two iterations
  done, a mid-iteration state in the third), in six states: clean,
  `frozen-1` corrupt, the mid-iteration state corrupt, a torn orphan
  `ckpt-*`, both manifests gone, `frozen-0` corrupt. Both give the same
  verdict, exit code, rollback iteration and step, and the same
  quarantined and retired names and issues once `.msgpack` reads `.pt`;
  then the same manifest after repair. With `keep_candidate_states`, the
  retained `iteration-final-<t>` states in three more: one corrupt
  (quarantined, no rollback), one missing (clean), and `frozen-1`
  corrupt (the rollback retires `iteration-final-1`).
- The port's `ckpt_fsck` CLI: exit codes 0, 1, 2 and 64 and its `--json`
  fields; `tools/payload_versions.py` runs on the CPU at a small size
  and both payload forms round-trip the same numbers.
"""

import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import optax
import pytest
import torch

import adanet_tpu
from adanet_tpu.core import checkpoint as jax_ckpt
from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
from adanet_tpu.examples import simple_dnn as jax_simple_dnn
from adanet_tpu.robustness import integrity as jax_integrity

from adanet_tpu_torch.core import checkpoint as ckpt
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import MultiClassHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.examples import simple_dnn
from adanet_tpu_torch.examples.synthetic_digits import input_fn, make_dataset
from adanet_tpu_torch.robustness import faults, integrity
from adanet_tpu_torch.tools import ckpt_fsck
from adanet_tpu_torch.utils.convert import WithInitialVariables

from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

STEPS = 4  # steps per iteration of the fsck dirs
STOP = 2 * STEPS + 2  # inside iteration 2: two iterations done, a state file


def _fields(info):
    return dataclasses.asdict(info)


INFOS = [
    dict(),
    dict(iteration_number=2, global_step=57, iteration_state_file="ckpt-57.pt", replay_indices=[0, 1],
         digests={"frozen-0.pt": "ab" * 32, "frozen-1.pt": "cd" * 32},
         history=[{"iteration_number": 0, "global_step": 25, "generation": 3},
                  {"iteration_number": 1, "global_step": 50, "generation": 7}]),
]


@pytest.mark.parametrize("fields", INFOS, ids=["empty", "full"])
def test_manifest_bytes_match_jax(tmp_path, fields):
    for package, d in ((jax_ckpt, tmp_path / "jax"), (ckpt, tmp_path / "torch")):
        os.makedirs(d)
        for name in fields.get("digests", {}):  # write_manifest keeps digests of files that exist
            (d / name).write_bytes(b"x")
        info = package.CheckpointInfo(**json.loads(json.dumps(fields)))
        package.write_manifest(str(d), info)
        info.global_step += 1
        package.write_manifest(str(d), info)
    for name in ("checkpoint.json", "checkpoint.json.prev"):
        want = (tmp_path / "jax" / name).read_bytes()
        assert (tmp_path / "torch" / name).read_bytes() == want, name
    assert _fields(ckpt.read_manifest(str(tmp_path / "torch"))) == _fields(
        jax_ckpt.read_manifest(str(tmp_path / "jax")))


def _corrupt_main_manifest(d):
    path = os.path.join(d, "checkpoint.json")
    with open(path) as f:
        raw = f.read()
    with open(path, "w") as f:
        f.write(raw.replace('"global_step": 12', '"global_step": 99'))


@pytest.mark.parametrize("fallback", ["prev", "reconstruct"])
def test_manifest_fallbacks_match_jax(tmp_path, fallback):
    got = {}
    for key, package, suffix in (("jax", jax_ckpt, ".msgpack"), ("torch", ckpt, ".pt")):
        d = str(tmp_path / key)
        os.makedirs(d)
        if fallback == "prev":
            info = package.CheckpointInfo(iteration_number=1, global_step=6, replay_indices=[1])
            package.write_manifest(d, info)
            info.global_step = 12
            package.write_manifest(d, info)
            _corrupt_main_manifest(d)
        else:
            for t, step in ((0, 6), (1, 12)):
                with open(os.path.join(d, "architecture-%d.json" % t), "w") as f:
                    json.dump({"global_step": step, "replay_indices": [0, 1][:t + 1]}, f)
            # A verified state beyond the chain's end, and one that fails.
            package.save_payload(d, "ckpt-15" + suffix, {"w": np.arange(4.0)})
            with open(os.path.join(d, "ckpt-16" + suffix), "wb") as f:
                f.write(b"torn")
            with open(os.path.join(d, "ckpt-16" + suffix + ".sha256"), "w") as f:
                f.write("0" * 64)
        info = _fields(package.read_manifest(d))
        if info["iteration_state_file"]:
            info["iteration_state_file"] = info["iteration_state_file"].replace(suffix, ".pt")
        got[key] = info
    assert got["torch"] == got["jax"]
    if fallback == "prev":
        assert got["torch"]["global_step"] == 6
        assert os.path.exists(tmp_path / "torch" / "checkpoint.json.corrupt")
    else:
        assert (got["torch"]["iteration_number"], got["torch"]["global_step"]) == (2, 15)
        assert got["torch"]["iteration_state_file"] == "ckpt-15.pt"


def test_manifest_checksum_mismatch_raises(tmp_path):
    for package in (jax_ckpt, ckpt):
        d = str(tmp_path / package.__name__)
        info = package.CheckpointInfo(iteration_number=0, global_step=12)
        package.write_manifest(d, info)
        _corrupt_main_manifest(d)
        path = os.path.join(d, "checkpoint.json")
        with pytest.raises(package.CheckpointCorruptionError, match="checksum mismatch"):
            package._parse_manifest(open(path, "rb").read(), path)
        assert not package.manifest_intact(d)


def test_payload_digest_verify_and_quarantine(tmp_path):
    d = str(tmp_path)
    digest = ckpt.save_payload(d, "frozen-0.pt", {"w": torch.arange(8.0), "name": "t0", "shared": {"n": 2}})
    assert ckpt.read_digest(d, "frozen-0.pt") == digest
    assert ckpt.verify_file(d, "frozen-0.pt") is True
    got = ckpt.restore_payload(d, "frozen-0.pt")
    assert torch.equal(got["w"], torch.arange(8.0)) and got["name"] == "t0" and got["shared"] == {"n": 2}

    with open(os.path.join(d, "frozen-0.pt"), "r+b") as f:
        f.seek(3)
        f.write(b"\xff")
    assert ckpt.verify_file(d, "frozen-0.pt") is False
    with pytest.raises(ckpt.CheckpointCorruptionError, match="SHA-256 mismatch"):
        ckpt.restore_payload(d, "frozen-0.pt")
    assert ckpt.quarantine_file(d, "frozen-0.pt") == "frozen-0.pt.corrupt"
    assert not os.path.exists(os.path.join(d, "frozen-0.pt"))
    assert os.path.exists(os.path.join(d, "frozen-0.pt.corrupt.sha256"))


def test_payloads_are_plain_data(tmp_path):
    """Numpy leaves become tensors and numpy scalars numbers, so that
    `weights_only=True` reads every payload; an object is refused at
    save time, not at restore."""
    payload = ckpt.plain({"a": np.arange(3, dtype=np.float32), "b": np.int64(4), "c": (1.5, None, "s")})
    assert torch.equal(payload["a"], torch.arange(3.0)) and payload["b"] == 4 and payload["c"] == (1.5, None, "s")
    ckpt.save_payload(str(tmp_path), "p.pt", payload)
    assert ckpt.restore_payload(str(tmp_path), "p.pt")["c"] == (1.5, None, "s")
    with pytest.raises(TypeError, match="cannot be stored"):
        ckpt.plain({"f": object()})


def test_checkpoint_write_torn_fault(tmp_path, monkeypatch):
    """`torn` leaves a truncated payload at the final path and kills the
    process; the kill is stubbed here to observe the bytes."""
    d = str(tmp_path)
    killed = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: killed.append(sig))
    try:
        faults.arm("checkpoint.write", "torn", frac=0.25)
        with pytest.raises(faults.InjectedFault):
            ckpt.save_payload(d, "ckpt-2.pt", {"w": torch.arange(32.0)})
    finally:
        faults.disarm()
    assert killed == [signal.SIGKILL]
    assert os.path.exists(os.path.join(d, "ckpt-2.pt"))
    assert ckpt.read_digest(d, "ckpt-2.pt") is None
    assert ckpt.verify_file(d, "ckpt-2.pt") is None
    with pytest.raises(ckpt.CheckpointCorruptionError, match="undecodable"):
        ckpt.restore_payload(d, "ckpt-2.pt")


# --------------------------------------------------------------------- fsck


def _jax_estimator(model_dir, **kwargs):
    return adanet_tpu.Estimator(
        head=adanet_tpu.MultiClassHead(n_classes=10),
        subnetwork_generator=WithInitialVariables(
            jax_simple_dnn.Generator(optimizer_fn=lambda: optax.adam(1e-3), layer_size=16, initial_num_layers=1,
                                     seed=0),
            256, 10, convert=lambda v: v,
        ),
        max_iteration_steps=STEPS, max_iterations=3,
        ensemblers=[JaxEnsembler(optimizer=optax.adam(1e-3), use_fused_combine=True)],
        model_dir=model_dir, log_every_steps=0, save_checkpoint_steps=2, **kwargs,
    )


def torch_estimator(model_dir, **kwargs):
    def adam(params):
        return torch.optim.Adam(params, lr=1e-3, eps=1e-8)

    defaults = dict(
        head=MultiClassHead(10),
        subnetwork_generator=WithInitialVariables(
            simple_dnn.Generator(optimizer_fn=adam, layer_size=16, initial_num_layers=1, seed=0), 256, 10),
        max_iteration_steps=STEPS, max_iterations=3,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=adam, use_fused_combine=True)],
        model_dir=model_dir, log_every_steps=0, save_checkpoint_steps=2, device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


@pytest.fixture(scope="module")
def model_dirs(tmp_path_factory):
    """Each package's simple_dnn model dir: iterations 0 and 1 done, the
    state of iteration 2's step 2 checkpointed."""
    xtr, ytr = make_dataset(4 * 32, seed=7)
    root = tmp_path_factory.mktemp("fsck")
    dirs = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    _jax_estimator(dirs["jax"]).train(input_fn(xtr, ytr, 32), max_steps=STOP)
    torch_estimator(dirs["torch"]).train(input_fn(xtr, ytr, 32), max_steps=STOP)
    for d in dirs.values():
        names = sorted(os.listdir(d))
        assert {"frozen-0", "frozen-1", "ckpt-%d" % STOP} <= {n.rsplit(".", 1)[0] for n in names}, names
    return dirs


def _flip(path, offset=40):
    with open(path, "r+b") as f:
        f.seek(offset)
        byte = f.read(1)
        f.seek(offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def _damage(d, state, suffix):
    if state == "frozen-1":
        _flip(os.path.join(d, "frozen-1" + suffix))
    elif state == "frozen-0":
        _flip(os.path.join(d, "frozen-0" + suffix))
    elif state == "mid_state":
        _flip(os.path.join(d, "ckpt-%d%s" % (STOP, suffix)))
    elif state == "torn_orphan":
        data = open(os.path.join(d, "ckpt-%d%s" % (STOP, suffix)), "rb").read()
        with open(os.path.join(d, "ckpt-%d%s" % (STOP + 1, suffix)), "wb") as f:
            f.write(data[: len(data) // 3])
    elif state == "manifests_gone":
        os.remove(os.path.join(d, "checkpoint.json"))
        os.remove(os.path.join(d, "checkpoint.json.prev"))


def _as_pt(value):
    if isinstance(value, str):
        return value.replace(".msgpack", ".pt")
    if isinstance(value, list):
        return [_as_pt(v) for v in value]
    return value


FSCK_STATES = {
    # state: (verdict, rolled back to iteration, its step)
    "clean": ("clean", None, None),
    "frozen-1": ("healed", 1, STEPS),
    "mid_state": ("healed", 2, 2 * STEPS),
    "torn_orphan": ("healed", None, None),
    "manifests_gone": ("healed", None, None),
    "frozen-0": ("unrecoverable", 0, 0),
}


@pytest.mark.parametrize("state", sorted(FSCK_STATES))
def test_fsck_matches_jax(model_dirs, tmp_path, state):
    reports, manifests = {}, {}
    for key, engine, suffix in (("jax", jax_integrity, ".msgpack"), ("torch", integrity, ".pt")):
        d = str(tmp_path / key)
        shutil.copytree(model_dirs[key], d)
        _damage(d, state, suffix)
        dry = engine.fsck(d).to_json()
        report = engine.fsck(d, repair=True).to_json()
        assert {k: dry[k] for k in ("verdict", "exit_code", "rolled_back_to_iteration",
                                    "rolled_back_global_step")} == {
            k: report[k] for k in ("verdict", "exit_code", "rolled_back_to_iteration", "rolled_back_global_step")}
        reports[key] = {k: _as_pt(v) for k, v in report.items()}
        manifests[key] = _fields(engine.ckpt.read_manifest(d))
        manifests[key]["digests"] = sorted(_as_pt(list(manifests[key]["digests"])))
        manifests[key]["iteration_state_file"] = _as_pt(manifests[key]["iteration_state_file"])
        assert engine.fsck(d).verdict == "clean"  # repair converged
    verdict, iteration, step = FSCK_STATES[state]
    got, want = reports["torch"], reports["jax"]
    assert (got["verdict"], got["rolled_back_to_iteration"], got["rolled_back_global_step"]) == (
        verdict, iteration, step)
    assert got["exit_code"] == {"clean": 0, "healed": 1, "unrecoverable": 2}[verdict]
    for key in ("verdict", "exit_code", "rolled_back_to_iteration", "rolled_back_global_step", "quarantined",
                "retired", "issues", "ok", "fresh", "manifest_rewritten", "iteration_number", "global_step",
                "generation"):
        assert got[key] == want[key], (key, got[key], want[key])
    assert manifests["torch"] == manifests["jax"]


@pytest.fixture(scope="module")
def kept_dirs(tmp_path_factory):
    """`model_dirs` trained with `keep_candidate_states=True`: the
    `iteration-final-<t>` states of iterations 0 and 1 are on disk."""
    xtr, ytr = make_dataset(4 * 32, seed=7)
    root = tmp_path_factory.mktemp("fsck_kept")
    dirs = {"jax": str(root / "jax"), "torch": str(root / "torch")}
    _jax_estimator(dirs["jax"], keep_candidate_states=True).train(input_fn(xtr, ytr, 32), max_steps=STOP)
    torch_estimator(dirs["torch"], keep_candidate_states=True).train(input_fn(xtr, ytr, 32), max_steps=STOP)
    for d, suffix in ((dirs["jax"], ".msgpack"), (dirs["torch"], ".pt")):
        for t in range(2):
            assert os.path.exists(os.path.join(d, "iteration-final-%d%s" % (t, suffix)))
    return dirs


RETAINED_STATES = {
    # state: (verdict, rolled back to iteration, quarantined, retired)
    "final_corrupt": ("healed", None, ["iteration-final-1.pt.corrupt"], []),
    "final_missing": ("clean", None, [], []),
    "frozen_corrupt": ("healed", 1, ["frozen-1.pt.corrupt"],
                       ["architecture-1.json.stale", "iteration-final-1.pt.stale", "ckpt-%d.pt.stale" % STOP]),
}


@pytest.mark.parametrize("state", sorted(RETAINED_STATES))
def test_fsck_of_retained_states_matches_jax(kept_dirs, tmp_path, state):
    """A corrupt `iteration-final-<t>` is quarantined and never blocks
    resume; a missing one is no fault; a rollback past it retires it."""
    reports = {}
    for key, engine, suffix in (("jax", jax_integrity, ".msgpack"), ("torch", integrity, ".pt")):
        d = str(tmp_path / key)
        shutil.copytree(kept_dirs[key], d)
        if state == "final_corrupt":
            _flip(os.path.join(d, "iteration-final-1" + suffix))
        elif state == "final_missing":
            os.remove(os.path.join(d, "iteration-final-0" + suffix))
        else:
            _flip(os.path.join(d, "frozen-1" + suffix))
        report = engine.fsck(d, repair=True).to_json()
        reports[key] = {k: _as_pt(v) for k, v in report.items()}
        assert engine.fsck(d).verdict == "clean"
    verdict, iteration, quarantined, retired = RETAINED_STATES[state]
    got, want = reports["torch"], reports["jax"]
    assert (got["verdict"], got["rolled_back_to_iteration"]) == (verdict, iteration)
    assert got["quarantined"] == quarantined and sorted(got["retired"]) == sorted(retired)
    for key in ("verdict", "exit_code", "rolled_back_to_iteration", "rolled_back_global_step", "quarantined",
                "retired", "issues", "ok", "manifest_rewritten", "iteration_number", "global_step", "generation"):
        assert got[key] == want[key], (key, got[key], want[key])


def test_fsck_of_a_fresh_dir_is_clean(tmp_path):
    report = integrity.fsck(str(tmp_path / "none"))
    assert report.fresh and report.verdict == "clean" and report.exit_code == 0


def test_ckpt_fsck_cli(model_dirs, tmp_path, capsys):
    d = str(tmp_path / "clean")
    shutil.copytree(model_dirs["torch"], d)
    assert ckpt_fsck.main([d, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert (report["verdict"], report["exit_code"], report["ok"]) == ("clean", 0, True)
    assert (report["iteration_number"], report["global_step"]) == (2, STOP)

    _flip(os.path.join(d, "frozen-1.pt"))
    assert ckpt_fsck.main([d]) == 1
    assert "verdict: healed" in capsys.readouterr().out
    assert ckpt_fsck.main([d, "--repair", "--json"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["verdict"] == "healed" and report["manifest_rewritten"]
    assert report["quarantined"] == ["frozen-1.pt.corrupt"]
    assert ckpt_fsck.main([d]) == 0
    assert "clean: iteration 1, global step %d" % STEPS in capsys.readouterr().out

    lost = str(tmp_path / "lost")
    shutil.copytree(model_dirs["torch"], lost)
    _flip(os.path.join(lost, "frozen-0.pt"))
    assert ckpt_fsck.main([lost, "--json"]) == 2
    report = json.loads(capsys.readouterr().out)
    assert (report["verdict"], report["exit_code"], report["rolled_back_to_iteration"]) == ("unrecoverable", 2, 0)

    with pytest.raises(SystemExit) as exc:
        ckpt_fsck.main(["--no-such-flag"])
    assert exc.value.code == 64


def test_payload_versions_tool(capsys):
    from adanet_tpu_torch.tools import payload_versions

    assert payload_versions.main(["--pairs", "1", "--num_cells", "3", "--num_conv_filters", "4", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.split("payload_versions: ", 1)[1])
    assert set(out["medians"]) == {"packed", "per_tensor"} and out["pairs"] == 1
    module, opt = payload_versions.trained_state(3, 4, torch.device("cpu"))
    state = {"module": module.state_dict(), "optimizer": opt.state_dict()}
    packed, per_tensor = ckpt.plain(state), payload_versions.per_tensor(state)
    assert packed["optimizer"]["param_groups"] == per_tensor["optimizer"]["param_groups"]
    for key, value in per_tensor["module"].items():
        assert torch.equal(packed["module"][key], value), key
    for index, slots in per_tensor["optimizer"]["state"].items():
        assert torch.equal(packed["optimizer"]["state"][index]["trace"], slots["trace"])
