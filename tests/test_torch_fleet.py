"""The port's fleet search on the CPU, and its parity with the JAX package.

Copies of tests/test_fleet.py's tier-1 tests on the port (`device="cpu"`
throughout): trial fingerprints, comparator ranking, transfer planning,
the controller state machine (mocked clock, no sleeps), the tiny 2-trial
fleet gate (`torch_fleet_common.py`), `fleetctl`, and the
promotion-SIGKILL chaos gate; the bench-scale gate is the port's slow
test. Then the parity tests against the JAX package:

- F(w) of a JAX search's frozen ensemble, converted with
  `utils.convert`, by both comparators in both modes (1e-5 relative);
- both controllers on the same fake objectives make the same runs,
  culls, winner and `fleet.json` states (paths, the fleet id and the
  spec fingerprints, which carry the port's payload format, left out);
- the tiny fleet, whole, in both packages: the same winner, culled
  trial and champion member names at t = 0 and 1;
- the fingerprints differ exactly by the port's payload format.
"""

import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from adanet_tpu_torch import replay as replay_lib
from adanet_tpu_torch.core import checkpoint as ckpt_lib
from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.fleet import (
    Comparator,
    FleetController,
    Score,
    TrialSpec,
    load_status,
    plan_graft,
    rank,
)
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.store import keys as store_keys

import torch_fleet_common
from torch_port_common import one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.disarm()
    yield
    faults.disarm()


def _spec(trial_id="t0", cls=TrialSpec, **kwargs):
    defaults = dict(
        trial_id=trial_id,
        make_head=lambda: None,
        make_generator=lambda: None,
        generator_id="g0",
        max_iteration_steps=4,
    )
    defaults.update(kwargs)
    return cls(**defaults)


def _arch(model_dir, t):
    with open(
        os.path.join(model_dir, ckpt_lib.architecture_filename(t))
    ) as f:
        return json.load(f)


def _members(model_dir, t):
    """The champion's (iteration, builder) member names at iteration t."""
    return [
        (s["iteration_number"], s["builder_name"])
        for s in _arch(model_dir, t)["subnetworks"]
    ]


# ------------------------------------------------------------ trial specs


def test_trial_spec_fingerprint_covers_numeric_ingredients():
    base = _spec()
    assert base.spec_fingerprint() == _spec().spec_fingerprint()
    for variant in (
        _spec(adanet_lambda=0.1),
        _spec(adanet_beta=0.01),
        _spec(random_seed=7),
        _spec(max_iteration_steps=8),
        _spec(generator_id="g1"),
        _spec(extra_spec={"lr": 0.5}),
    ):
        assert variant.spec_fingerprint() != base.spec_fingerprint()
    # estimator_kwargs are declared non-numeric: same fingerprint.
    assert (
        _spec(estimator_kwargs={"save_checkpoint_steps": 2}).spec_fingerprint()
        == base.spec_fingerprint()
    )


def test_trial_spec_fingerprint_matches_estimator_ref_keys(tmp_path):
    """The graft-safety contract: TrialSpec and the Estimator it builds
    derive the SAME spec fingerprint, so 'fingerprints agree' means
    'store refs collide exactly when payloads are bit-identical'."""
    spec = torch_fleet_common.make_trials()[0]
    est = spec.build_estimator(
        str(tmp_path / "m"), None, max_iterations=1, device="cpu"
    )
    assert est._store_spec_fingerprint() == spec.spec_fingerprint()
    # The Estimator fails FAST on a base-key-shadowing extra (not at
    # the first publication, hours into a search), and on one naming
    # the payload format, which is its own.
    from adanet_tpu_torch.core.heads import RegressionHead

    for extra in ({"random_seed": 7}, {"payload_format": "x"}):
        with pytest.raises(ValueError, match="shadows|payload_format"):
            Estimator(
                head=RegressionHead(),
                subnetwork_generator=torch_fleet_common._make_generator(),
                max_iteration_steps=4,
                model_dir=str(tmp_path / "bad"),
                store_spec_extra=extra,
                device="cpu",
            )


def test_trial_spec_validation():
    with pytest.raises(ValueError):
        _spec(trial_id="bad/slash")
    with pytest.raises(ValueError):
        _spec(trial_id="")
    with pytest.raises(ValueError):
        _spec(adanet_lambda=-1.0)
    with pytest.raises(ValueError):
        _spec(max_iteration_steps=0)
    with pytest.raises(TypeError):
        _spec(extra_spec={"fn": lambda: None})
    # extra_spec shadowing a derived fingerprint ingredient would alias
    # two numerically-different trials under one fingerprint.
    with pytest.raises(ValueError, match="shadow"):
        _spec(adanet_lambda=0.5, extra_spec={"adanet_lambda": 0.0})
    with pytest.raises(ValueError, match="shadow"):
        _spec(extra_spec={"random_seed": 7})
    with pytest.raises(ValueError, match="shadow"):
        _spec(extra_spec={"payload_format": "adanet_tpu/frozen.msgpack"})
    # estimator_kwargs overriding a spec-managed argument would key
    # store refs the declared fingerprint never matches; the device is
    # the controller's.
    with pytest.raises(ValueError, match="spec-managed"):
        _spec(estimator_kwargs={"random_seed": 7})
    with pytest.raises(ValueError, match="spec-managed"):
        _spec(estimator_kwargs={"ensemblers": []})
    with pytest.raises(ValueError, match="spec-managed"):
        _spec(estimator_kwargs={"device": "cpu"})


def test_fingerprints_differ_from_the_jax_package_by_payload_format():
    """A port fleet never grafts a JAX-written payload: its fingerprint
    is the JAX one's derivation plus the port's payload format, and
    nothing else."""
    from adanet_tpu.fleet import TrialSpec as JaxTrialSpec

    for kwargs in ({}, dict(adanet_lambda=0.1, adanet_beta=0.01, random_seed=7,
                            extra_spec={"lr": 0.5})):
        jax_spec = _spec(cls=JaxTrialSpec, **kwargs)
        port_spec = _spec(**kwargs)
        assert port_spec.store_spec_extra() == jax_spec.store_spec_extra()
        assert port_spec.summary()["spec_fingerprint"] != jax_spec.summary()["spec_fingerprint"]
        extra = dict(jax_spec.store_spec_extra(), payload_format=Estimator.STORE_PAYLOAD_FORMAT)
        assert port_spec.spec_fingerprint() == store_keys.search_spec_fingerprint(
            jax_spec.random_seed, jax_spec.max_iteration_steps, extra)


# ------------------------------------------------------------- comparator


def _score(trial_id, objective, members=1, cls=Score):
    return cls(
        trial_id=trial_id,
        objective=objective,
        loss=objective,
        complexity_regularization=0.0,
        num_members=members,
        iterations=1,
        global_step=4,
    )


def test_rank_orders_by_objective_then_complexity_then_id():
    scores = [
        _score("big", 1.0, members=3),
        _score("tie_b", 1.0, members=2),
        _score("tie_a", 1.0, members=2),
        _score("best", 0.5, members=5),
        _score("nan", float("nan")),
    ]
    ordered = [s.trial_id for s in rank(scores)]
    # Lower objective first; equal objectives prefer FEWER members,
    # then lexicographic id; non-finite always last.
    assert ordered == ["best", "tie_a", "tie_b", "big", "nan"]


def test_comparator_mode_validation():
    with pytest.raises(ValueError):
        Comparator(lambda: iter(()), adanet_lambda=0.1)  # beta missing
    with pytest.raises(ValueError):
        Comparator(lambda: iter(()), eval_steps=0)


def _jax_search(model_dir):
    """A tiny JAX simple_dnn search (2 iterations, lambda 0.1, beta
    0.01) on linear regression data; its estimator and input_fn."""
    import optax

    import adanet_tpu
    from adanet_tpu.ensemble import ComplexityRegularizedEnsembler as JaxEnsembler
    from adanet_tpu.examples import simple_dnn as jax_simple_dnn

    rng = np.random.RandomState(5)
    x = rng.randn(64, 4).astype(np.float32)
    y = x @ rng.randn(4, 1).astype(np.float32)

    def input_fn():
        for lo in range(0, 64, 16):
            yield {"x": x[lo:lo + 16]}, y[lo:lo + 16]

    est = adanet_tpu.Estimator(
        head=adanet_tpu.RegressionHead(),
        subnetwork_generator=jax_simple_dnn.Generator(optimizer_fn=lambda: optax.sgd(0.05), layer_size=8),
        max_iteration_steps=4,
        ensemblers=[JaxEnsembler(optimizer=optax.sgd(0.05), adanet_lambda=0.1, adanet_beta=0.01)],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
    )
    est.train(input_fn)
    return est, input_fn


class _ConvertedEstimator:
    """What the port's `Comparator.score` reads of an estimator, over a
    JAX search's frozen winner converted with `utils.convert`."""

    def __init__(self, jax_est, input_fn, model_dir):
        from adanet_tpu_torch.core.architecture import Architecture
        from adanet_tpu_torch.core.frozen import FrozenEnsemble, FrozenSubnetwork, FrozenWeightedSubnetwork
        from adanet_tpu_torch.core.heads import RegressionHead
        from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
        from adanet_tpu_torch.examples import simple_dnn
        from adanet_tpu_torch.utils import convert

        first = next(iter(input_fn()))
        forward, params, name = jax_est._final_forward_fn(first)
        jax_ensemble = forward(params, first[0])
        members = []
        for variables, ws in zip(params["members"], jax_ensemble.weighted_subnetworks):
            variables = {"params": {k: {n: np.asarray(v) for n, v in layer.items()}
                                    for k, layer in variables["params"].items()}}
            layers = sum(1 for key in variables["params"] if key.startswith("dense_"))
            module = simple_dnn._DNNBuilder(None, 8, layers, False, 0.0, 0).build_subnetwork(1, input_shape=(4,))
            module.load_state_dict(convert.convert_simple_dnn(variables), strict=True)
            members.append(FrozenWeightedSubnetwork(FrozenSubnetwork(
                0, "dnn", module.eval(), float(np.asarray(ws.subnetwork.complexity)))))
        ensembler_params = convert.convert_ensembler_params(
            {k: v for k, v in params["ensembler"].items() if v is not None})
        self.frozen = FrozenEnsemble(name, 1, members, "complexity_regularized", ensembler_params,
                                     Architecture(name, "complexity_regularized"))
        self.ensembler = ComplexityRegularizedEnsembler(adanet_lambda=0.1, adanet_beta=0.01, use_fused_combine=True)
        self._head = RegressionHead()
        self._weight_key = None
        self._device = torch.device("cpu")
        self.model_dir = model_dir

    def _final_forward_fn(self, sample_batch):
        def forward(features):
            return self.ensembler.build_ensemble(self.frozen.ensembler_params, self.frozen.member_outputs(features))

        return forward, self.frozen.name


@pytest.mark.parametrize("mode", ["uniform", "own_objective"])
def test_comparator_matches_jax_on_a_converted_ensemble(tmp_path, mode):
    """F(w)'s loss and penalty agree with the JAX comparator's within
    1e-5 relative, on a JAX search's 2-member winner converted."""
    from adanet_tpu.fleet import Comparator as JaxComparator

    jax_est, input_fn = _jax_search(str(tmp_path / "jax"))
    strengths = dict(adanet_lambda=0.01, adanet_beta=0.001) if mode == "uniform" else {}
    want = JaxComparator(input_fn, eval_steps=4, **strengths).score(jax_est, "t")
    converted = _ConvertedEstimator(jax_est, input_fn, str(tmp_path / "empty"))
    assert len(converted.frozen.weighted_subnetworks) == 2
    got = Comparator(input_fn, eval_steps=4, **strengths).score(converted, "t")
    assert want.complexity_regularization > 0
    np.testing.assert_allclose(got.loss, want.loss, rtol=1e-5)
    np.testing.assert_allclose(got.complexity_regularization, want.complexity_regularization, rtol=1e-5)
    np.testing.assert_allclose(got.objective, want.objective, rtol=1e-5)


# --------------------------------------------------------------- transfer


def _write_replay(model_dir, indices, hashes):
    os.makedirs(model_dir, exist_ok=True)
    replay_lib.Config(
        best_ensemble_indices=indices, architecture_hashes=hashes
    ).save(os.path.join(model_dir, replay_lib.REPLAY_FILENAME))


def test_plan_graft_longest_compatible_prefix(tmp_path):
    recipient = _spec("r")
    twin = _spec("twin")  # same fingerprint as the recipient
    other = _spec("other", adanet_lambda=0.5)  # different fingerprint
    short_dir = str(tmp_path / "short")
    long_dir = str(tmp_path / "long")
    alien_dir = str(tmp_path / "alien")
    _write_replay(short_dir, [0], ["h0"])
    _write_replay(long_dir, [0, 1], ["h0", "h1"])
    _write_replay(alien_dir, [0, 1, 1], ["x0", "x1", "x2"])
    plan = plan_graft(
        recipient,
        [(twin, short_dir), (twin, long_dir), (other, alien_dir)],
    )
    # Longest FINGERPRINT-COMPATIBLE donor wins; the alien's longer
    # record is ignored — there is no "close enough" tier.
    assert plan is not None
    assert plan.donor_dir == long_dir and plan.iterations == 2
    assert plan.config.architecture_hashes == ["h0", "h1"]


def test_plan_graft_truncates_to_hashed_prefix_and_excludes_self(tmp_path):
    recipient = _spec("r")
    twin = _spec("twin")
    donor_dir = str(tmp_path / "donor")
    # 3 recorded selections but only 1 architecture hash: only 1
    # iteration is graftable through the store.
    _write_replay(donor_dir, [0, 1, 0], ["h0"])
    plan = plan_graft(recipient, [(twin, donor_dir)])
    assert plan is not None and plan.iterations == 1
    assert plan.config.best_ensemble_indices == [0]
    # The recipient's own dir is not a donor.
    assert (
        plan_graft(recipient, [(twin, donor_dir)], exclude_dir=donor_dir)
        is None
    )
    # No compatible donors at all -> no plan, no attempt.
    assert plan_graft(recipient, []) is None


def test_plan_graft_fault_site_degrades(tmp_path):
    """`fleet.graft` armed with error fails planning (the controller
    degrades to plain training — graft loss costs compute, never
    correctness)."""
    twin = _spec("twin")
    donor_dir = str(tmp_path / "donor")
    _write_replay(donor_dir, [0], ["h0"])
    faults.arm("fleet.graft", "error")
    with pytest.raises(faults.InjectedFault):
        plan_graft(_spec("r"), [(twin, donor_dir)])
    faults.disarm()
    assert plan_graft(_spec("r"), [(twin, donor_dir)]) is not None


# ----------------------------------------- controller (mocked clock, fake
# trial runner: the rung/promotion state machine without any training)


class _FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 1.0
        return self.now


def _fake_fleet(tmp_path, objectives, rungs=(1, 2), jax=False, **kwargs):
    """A controller whose trial runs and scoring are pure bookkeeping:
    `objectives` maps trial_id -> comparator objective. `jax=True`
    builds the JAX package's controller over the same fakes."""
    if jax:
        from adanet_tpu.fleet import FleetController as Controller
        from adanet_tpu.fleet import Score as ScoreCls
        from adanet_tpu.fleet import TrialSpec as SpecCls

        work_dir = str(tmp_path / "jax_fleet")
    else:
        Controller, ScoreCls, SpecCls = FleetController, Score, TrialSpec
        kwargs.setdefault("device", "cpu")
        work_dir = str(tmp_path / "fleet")
    trials = [_spec(trial_id, cls=SpecCls) for trial_id in sorted(objectives)]
    controller = Controller(
        trials,
        input_fn=lambda: iter(()),
        work_dir=work_dir,
        rung_iterations=rungs,
        clock=_FakeClock(),
        build_champion=False,
        **kwargs,
    )
    runs = []

    def fake_run_trial(record, rung, target):
        started = controller._clock()
        runs.append((record.spec.trial_id, rung, target))
        record.steps_trained += (
            target - record.iterations
        ) * record.spec.max_iteration_steps
        record.iterations = target
        record.rung = rung
        record.train_secs += controller._clock() - started

    def fake_score_trial(record):
        return _score(
            record.spec.trial_id, objectives[record.spec.trial_id], cls=ScoreCls
        )

    controller._run_trial = fake_run_trial
    controller._score_trial = fake_score_trial
    return controller, runs


def test_successive_halving_culls_promotes_and_picks_winner(tmp_path):
    objectives = {"a": 0.9, "b": 0.2, "c": 0.5, "d": 0.7}
    controller, runs = _fake_fleet(
        tmp_path, objectives, rungs=(1, 2, 3)
    )
    report = controller.run()
    assert report.complete and report.winner_id == "b"
    states = {t: e["state"] for t, e in report.trials.items()}
    # Rung 0 culls the worst half (a, d); rung 1 culls c; b survives.
    assert states == {
        "a": "culled",
        "b": "live",
        "c": "culled",
        "d": "culled",
    }
    # Rung work: all 4 at rung 0, survivors only afterwards — culled
    # capacity re-packed, never re-trained.
    assert sorted(r[0] for r in runs if r[1] == 0) == [
        "a", "b", "c", "d"
    ]
    assert sorted(r[0] for r in runs if r[1] == 1) == ["b", "c"]
    assert [r[0] for r in runs if r[1] == 2] == ["b"]
    # Equal-budget accounting: steps = trained iterations * step budget.
    assert report.total_steps_trained == (4 * 1 + 2 * 1 + 1 * 1) * 4
    # Mocked-clock bookkeeping: every run booked a positive duration
    # from the injected clock — no wall clock, no sleeps.
    assert all(
        e["train_secs"] > 0 for e in report.trials.values()
    )
    # The port has no compile cache: the field reads 0.
    assert report.compile_store_hits == 0


def test_rung_boundary_is_cumulative_not_incremental(tmp_path):
    controller, runs = _fake_fleet(
        tmp_path, {"a": 0.1, "b": 0.2}, rungs=(2, 5)
    )
    controller.run()
    # Rung targets are CUMULATIVE iteration budgets.
    assert ("a", 0, 2) in runs and ("a", 1, 5) in runs


def test_resume_skips_completed_work(tmp_path):
    objectives = {"a": 0.3, "b": 0.6}
    controller, runs = _fake_fleet(tmp_path, objectives)
    first = controller.run()
    assert first.winner_id == "a"
    # A fresh controller over the same work dir adopts the durable
    # state: nothing re-runs, the winner stands.
    controller2, runs2 = _fake_fleet(tmp_path, objectives)
    report2 = controller2.run()
    assert runs2 == []
    assert report2.winner_id == "a" and report2.complete
    # Changing the rung schedule on resume is refused loudly.
    controller3, _ = _fake_fleet(tmp_path, objectives, rungs=(1, 3))
    with pytest.raises(ValueError):
        controller3.run()


def _flaky(controller, fails):
    real_run = controller._run_trial

    def flaky_run(record, rung, target):
        if fails.get(record.spec.trial_id, 0) > 0:
            fails[record.spec.trial_id] -= 1
            raise RuntimeError("injected trial death")
        real_run(record, rung, target)

    controller._run_trial = flaky_run


def test_trial_failure_is_isolated_then_respawned(tmp_path):
    objectives = {"a": 0.3, "b": 0.6}
    controller, _ = _fake_fleet(
        tmp_path, objectives, max_trial_attempts=2
    )
    _flaky(controller, {"b": 1})
    report = controller.run()
    # b died at rung 0, was isolated (a's rung completed), respawned
    # into a FRESH dir at rung 1, and caught up.
    assert report.complete and report.winner_id == "a"
    entry = report.trials["b"]
    assert entry["attempt"] == 1
    assert entry["model_dir"].endswith("b.a1")
    assert entry["state"] == "live"
    assert entry["iterations"] == 2


def test_exhausted_attempts_stay_failed(tmp_path):
    objectives = {"a": 0.3, "b": 0.6}
    controller, _ = _fake_fleet(
        tmp_path, objectives, max_trial_attempts=1
    )

    def dead_run(record, rung, target):
        if record.spec.trial_id == "b":
            raise RuntimeError("unrecoverable")
        record.iterations = target
        record.rung = rung

    controller._run_trial = dead_run
    report = controller.run()
    assert report.winner_id == "a"
    assert report.trials["b"]["state"] == "failed"
    assert "unrecoverable" in report.trials["b"]["error"]


def test_controller_validation(tmp_path):
    with pytest.raises(ValueError):
        FleetController([], lambda: iter(()), str(tmp_path / "f"), device="cpu")
    with pytest.raises(ValueError):
        FleetController(
            [_spec("a"), _spec("a")], lambda: iter(()),
            str(tmp_path / "f"), device="cpu",
        )
    with pytest.raises(ValueError):
        FleetController(
            [_spec("a")], lambda: iter(()), str(tmp_path / "f"),
            rung_iterations=(2, 2), device="cpu",
        )
    with pytest.raises(ValueError):
        FleetController(
            [_spec("a")], lambda: iter(()), str(tmp_path / "f"),
            survivor_fraction=0.0, device="cpu",
        )


def _comparable_state(work_dir):
    """fleet.json without what names the run's place (paths, the fleet
    id) or its package (the spec fingerprint, which carries the port's
    payload format)."""
    state = load_status(work_dir)
    state.pop("fleet_id")
    for entry in state["trials"].values():
        entry.pop("model_dir")
        entry["spec"].pop("spec_fingerprint")
    return state


@pytest.mark.parametrize("scenario", ["halving", "respawn"])
def test_controller_decisions_match_jax(tmp_path, scenario):
    """Both packages' controllers over the same fake objectives: the
    same runs, culls, winner and durable states."""
    if scenario == "halving":
        objectives, kwargs, fails = {"a": 0.9, "b": 0.2, "c": 0.5, "d": 0.7}, dict(rungs=(1, 2, 3)), {}
    else:
        objectives, kwargs, fails = {"a": 0.3, "b": 0.6, "c": 0.4}, dict(max_trial_attempts=2), {"b": 1}
    reports, runs, states = [], [], []
    for jax in (True, False):
        controller, ran = _fake_fleet(tmp_path, objectives, jax=jax, **kwargs)
        _flaky(controller, dict(fails))
        report = controller.run()
        reports.append(report)
        runs.append(ran)
        states.append(_comparable_state(controller.work_dir))
    assert runs[0] == runs[1]
    assert reports[0].winner_id == reports[1].winner_id
    assert {t: e["state"] for t, e in reports[0].trials.items()} == {
        t: e["state"] for t, e in reports[1].trials.items()}
    assert states[0] == states[1]
    assert reports[0].total_steps_trained == reports[1].total_steps_trained


# -------------------------------------------------- tiny fleet gate (CPU)


@pytest.fixture(scope="module")
def tiny_fleet(tmp_path_factory):
    """The 2-trial fleet run shared by the gate assertions and the
    chaos test's oracle comparison."""
    work_dir = str(tmp_path_factory.mktemp("fleet") / "work")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        report = torch_fleet_common.build_fleet(work_dir).run()
    finally:
        torch.set_num_threads(before)
    return work_dir, report


def test_tiny_fleet_gate(tiny_fleet, tmp_path):
    """The gate at tier-1 scale: the fleet completes, culls the
    over-regularized trial, grafts the champion from the store with
    zero retraining, and beats the a-priori single search on F(w) at
    equal total step budget."""
    work_dir, report = tiny_fleet
    assert report.complete
    assert report.winner_id == "reg_lo"
    trials = report.trials
    assert trials["reg_hi"]["state"] == "culled"
    assert trials["reg_lo"]["state"] == "live"
    # Equal-budget accounting: reg_hi trained 1 iteration, reg_lo 2.
    steps = torch_fleet_common.MAX_ITERATION_STEPS
    assert report.total_steps_trained == 3 * steps

    # The CULLED trial never reached search end yet its replay.json
    # records its one completed iteration — the incremental persistence
    # the transfer path depends on.
    culled_replay = replay_lib.load_partial(trials["reg_hi"]["model_dir"])
    assert culled_replay.num_iterations == 1
    assert len(culled_replay.architecture_hashes) == 1

    # Champion: rebuilt purely from store grafts — zero retraining —
    # and architecture-identical to the winner.
    champion = report.champion_dir
    assert champion and os.path.isdir(champion)
    assert report.graft_attempts >= 1
    assert report.graft_hits >= 2  # both winner iterations grafted
    winner_dir = trials["reg_lo"]["model_dir"]
    for t in (0, 1):
        assert _arch(champion, t) == _arch(winner_dir, t)

    # The acceptance comparison: a single search of the a-priori config
    # at the fleet's TOTAL trained budget, scored by the same
    # comparator, must not beat the fleet.
    single = torch_fleet_common.build_single_search(
        str(tmp_path / "single"), max_iterations=3
    )
    single.train(torch_fleet_common.input_fn)
    assert single.latest_global_step() == report.total_steps_trained
    single_score = torch_fleet_common.make_comparator().score(
        single, "single"
    )
    assert report.winner_score.objective <= single_score.objective

    # Durable state round-trips for fleetctl.
    state = load_status(work_dir)
    assert state["complete"] is True and state["winner"] == "reg_lo"

    # The shared store survives a full audit.
    from adanet_tpu_torch.store import ArtifactStore, fsck_store

    audit = fsck_store(
        ArtifactStore(os.path.join(work_dir, "store")), gc_dry_run=True
    )
    assert audit["clean"] and audit["would_gc"] == []


def test_scoring_rebuilds_without_training_or_publishing(tiny_fleet, monkeypatch):
    """The controller's scoring Estimator (`_score_trial`'s fresh build
    over a trial's dir) restores the frozen winner onto its device and
    scores it: no training step, no store write, the manifest as it was,
    the same F(w) as the fleet recorded."""
    from adanet_tpu_torch.core.iteration import Iteration
    from adanet_tpu_torch.store import ArtifactStore

    work_dir, report = tiny_fleet
    store = ArtifactStore(os.path.join(work_dir, "store"))
    refs = sorted((kind, name) for kind, name, _ in store.iter_refs())
    assert refs
    model_dir = report.trials["reg_lo"]["model_dir"]
    manifest = ckpt_lib.read_manifest(model_dir)
    steps = []
    monkeypatch.setattr(Iteration, "train_step", lambda *a, **k: steps.append(1))
    monkeypatch.setattr(Iteration, "train_steps", lambda *a, **k: steps.append(1))
    spec = {s.trial_id: s for s in torch_fleet_common.make_trials()}["reg_lo"]
    estimator = spec.build_estimator(model_dir, store, max_iterations=2, device="cpu")
    score = torch_fleet_common.make_comparator().score(estimator, "reg_lo")
    assert score.objective == pytest.approx(report.winner_score.objective, rel=1e-6)
    assert steps == []
    assert sorted((kind, name) for kind, name, _ in store.iter_refs()) == refs
    after = ckpt_lib.read_manifest(model_dir)
    assert (after.iteration_number, after.global_step) == (manifest.iteration_number, manifest.global_step)


def test_two_workers_share_the_device(tiny_fleet, tmp_path):
    """Two trial slots on one device (threads of this process): the same
    winner, culls and champion architecture as the one-slot oracle."""
    oracle_dir, oracle = tiny_fleet
    report = torch_fleet_common.build_fleet(str(tmp_path / "w2"), workers=2).run()
    assert report.winner_id == oracle.winner_id
    assert {t: e["state"] for t, e in report.trials.items()} == {
        t: e["state"] for t, e in oracle.trials.items()}
    assert report.total_steps_trained == oracle.total_steps_trained
    for t in (0, 1):
        assert _arch(report.champion_dir, t) == _arch(oracle.champion_dir, t)


class _SameInit:
    """Wraps either package's tiny-fleet generator: each builder ("a",
    one layer; "b", two) starts iteration t from the same numpy draw
    (`utils.convert.simple_dnn_variables`, passed through `convert` into
    the package's layout) as its `initial_variables`, so that the two
    packages' searches differ by rounding only."""

    LAYERS = {"a": 1, "b": 2}

    def __init__(self, generator, convert):
        self._generator, self._convert = generator, convert

    def generate_candidates(self, previous_ensemble, iteration_number, *args, **kwargs):
        from adanet_tpu_torch.utils.convert import simple_dnn_variables

        builders = self._generator.generate_candidates(previous_ensemble, iteration_number, *args, **kwargs)
        for builder in builders:
            layers = self.LAYERS[builder.name]
            builder.initial_variables = self._convert(
                simple_dnn_variables(layers, 8, 4, 1, 10 * iteration_number + layers))
        return builders


def _jax_store_without_compile_tier(root):
    """The JAX package's store with its persistent compile tier off: an
    executable it deserializes there expects its inputs on all eight
    CPU devices and fails on one (the reference-side failure of
    test_store.py's `test_compile_cache_persistent_tier_across_instances`),
    which the fleet meets whenever two trials score the same structure.
    The tier is a pure cache, so the fleet's decisions do not depend on
    it."""
    from adanet_tpu.core.compile_cache import AOT_REF_KIND
    from adanet_tpu.store import ArtifactStore

    class Store(ArtifactStore):
        def get_ref(self, kind, name):
            return None if kind == AOT_REF_KIND else super().get_ref(kind, name)

        def put_ref(self, kind, name, *args, **kwargs):
            if kind != AOT_REF_KIND:
                return super().put_ref(kind, name, *args, **kwargs)

    return Store(root)


def _same_init_fleet(common, work_dir, convert, **kwargs):
    """fleet_common's (or torch_fleet_common's) tiny fleet over
    `_SameInit` generators."""
    import dataclasses

    trials = [
        dataclasses.replace(spec, make_generator=lambda make=spec.make_generator: _SameInit(make(), convert))
        for spec in common.make_trials()
    ]
    cls = type(common.build_fleet(work_dir, **kwargs))
    return cls(trials, common.input_fn, work_dir=work_dir, rung_iterations=common.RUNGS, survivor_fraction=0.5,
               comparator=common.make_comparator(), workers=1, **kwargs)


def test_tiny_fleet_matches_jax(tmp_path):
    """The tiny fleet, whole, in both packages (fleet_common's and
    torch_fleet_common's configuration, every candidate started from
    the same numbers): the same winner, culled trial, steps and
    champion member names at t = 0 and 1."""
    import fleet_common

    from adanet_tpu_torch.utils.convert import convert_simple_dnn

    jax_dir = str(tmp_path / "jax")
    jax = _same_init_fleet(fleet_common, jax_dir, lambda v: v,
                           artifact_store=_jax_store_without_compile_tier(os.path.join(jax_dir, "store"))).run()
    port = _same_init_fleet(torch_fleet_common, str(tmp_path / "port"), convert_simple_dnn, device="cpu").run()
    assert jax.winner_id == port.winner_id == "reg_lo"
    culled = [
        sorted(t for t, e in report.trials.items() if e["state"] == "culled")
        for report in (jax, port)
    ]
    assert culled[0] == culled[1] == ["reg_hi"]
    assert jax.total_steps_trained == port.total_steps_trained
    assert jax.graft_hits == port.graft_hits >= 2
    for t in (0, 1):
        assert _members(jax.champion_dir, t) == _members(port.champion_dir, t)
    np.testing.assert_allclose(port.winner_score.objective, jax.winner_score.objective, rtol=1e-4)


# ---------------------------------------------------------------- fleetctl


def test_fleetctl_spec_builders():
    """`fleetctl launch`'s spec -> TrialSpec / dataset wiring (the
    launch path runs a real fleet, on the card in `chip_smoke.py`'s
    `fleet_search` and on the CPU in the slow gate below)."""
    from adanet_tpu_torch.tools import fleetctl

    spec = {
        "max_iteration_steps": 4,
        "trials": [
            {
                "id": "t1",
                "adanet_lambda": 0.1,
                "adanet_beta": 0.01,
                "random_seed": 7,
                "layer_size": 8,
                "learning_rate": 0.05,
            },
            {"id": "t2"},
        ],
    }
    trials = fleetctl._build_trials(spec)
    assert [t.trial_id for t in trials] == ["t1", "t2"]
    assert trials[0].adanet_lambda == 0.1
    assert trials[0].random_seed == 7
    assert "layer_size=8" in trials[0].generator_id
    assert "lr=0.05" in trials[0].generator_id
    # Different generator configs -> different fingerprints.
    assert trials[0].spec_fingerprint() != trials[1].spec_fingerprint()
    trials[0].make_generator()  # the factory builds without error
    input_fn = fleetctl._dataset_input_fn(
        {"dataset": {"n": 8, "dim": 2, "batch_size": 4, "seed": 1}}
    )
    features, labels = next(input_fn())
    assert features.shape == (4, 2) and labels.shape == (4, 1)
    # The JAX tool's spec maps to the same trials and data.
    sys.path.insert(0, REPO)
    from tools import fleetctl as jax_fleetctl

    jax_trials = jax_fleetctl._build_trials(spec)
    assert [t.store_spec_extra() for t in trials] == [t.store_spec_extra() for t in jax_trials]
    jax_features, jax_labels = next(jax_fleetctl._dataset_input_fn(
        {"dataset": {"n": 8, "dim": 2, "batch_size": 4, "seed": 1}})())
    np.testing.assert_array_equal(features, jax_features)
    np.testing.assert_array_equal(labels, jax_labels)


def test_fleetctl_status_and_report(tiny_fleet, capsys):
    from adanet_tpu_torch.tools import fleetctl

    work_dir, _report = tiny_fleet
    assert fleetctl.main(["status", work_dir]) == 0
    out = capsys.readouterr().out
    assert "reg_lo" in out and "culled" in out
    assert fleetctl.main(["report", work_dir, "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["winner"] == "reg_lo"
    assert report["store"]["clean"] is True
    assert report["exit_code"] == 0
    # Unreadable state is the exit-2 contract.
    assert fleetctl.main(["status", work_dir + ".missing"]) == 2
    with pytest.raises(SystemExit) as exc:
        fleetctl.main(["bogus-subcommand"])
    assert exc.value.code == 64


# ------------------------------------------------------------- chaos gate


def test_fleet_sigkill_at_promotion_resumes_to_oracle(
    tiny_fleet, tmp_path
):
    """A fleet SIGKILLed at the promotion seam (armed
    `fleet.promote:kill` in a subprocess) resumes in-process to the
    oracle fleet's winner with an oracle-identical champion
    architecture and a clean `ckpt_fsck --store` audit."""
    oracle_dir, oracle_report = tiny_fleet
    work_dir = str(tmp_path / "chaos_fleet")
    runner = os.path.join(TESTS_DIR, "torch_fleet_chaos_runner.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS_DIR, env.get("PYTHONPATH", "")]
    )
    env["ADANET_FAULTS"] = "fleet.promote:kill"
    proc = subprocess.run(
        [sys.executable, runner, work_dir, "cpu"],
        env=env,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        timeout=300,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stdout.decode()[-2000:]
    assert b"DONE" not in proc.stdout
    # Rung 0 trained and persisted; the promotion decision did not.
    state = load_status(work_dir)
    assert state is not None and state["next_rung"] == 0
    assert not state["complete"]

    # Resume the SAME work dir in-process, no faults armed.
    report = torch_fleet_common.build_fleet(work_dir).run()
    assert report.complete
    assert report.winner_id == oracle_report.winner_id
    for t in (0, 1):
        assert _arch(report.champion_dir, t) == _arch(
            oracle_report.champion_dir, t
        )

    # Full CLI audit over the champion + shared store.
    import io
    from contextlib import redirect_stdout

    from adanet_tpu_torch.tools import ckpt_fsck

    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = ckpt_fsck.main(
            [
                report.champion_dir,
                "--json",
                "--store",
                os.path.join(work_dir, "store"),
            ]
        )
    assert rc <= 1, buf.getvalue()
    fsck_report = json.loads(buf.getvalue())
    assert fsck_report["store"]["clean"] is True, fsck_report["store"]


# --------------------------------------------------- full gate (RUN_SLOW)

@pytest.mark.slow
def test_full_fleet_beats_best_single_search(tmp_path, capsys):
    """The bench-scale gate on the CPU (`chip_smoke.py`'s
    `FLEET_SEARCH_SPEC`, the JAX package's `_measure_fleet_search` as a
    fleetctl spec): a 4-trial fleet launched by `fleetctl` at equal total
    step budget reaches F(w) <= the a-priori
    single search's (`lam_hi`), with >= 1 cross-trial store hit and a
    clean store."""
    from adanet_tpu_torch.tools import fleetctl

    sys.path.insert(0, REPO)
    from chip_smoke import FLEET_SEARCH_SPEC

    spec_path = tmp_path / "spec.json"
    spec_path.write_text(json.dumps(FLEET_SEARCH_SPEC))
    work_dir = str(tmp_path / "fleet")
    assert fleetctl.main(["launch", work_dir, "--spec", str(spec_path), "--json", "--device", "cpu"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert fleetctl.main(["report", work_dir, "--json"]) == 0
    audit = json.loads(capsys.readouterr().out)
    assert audit["store"]["clean"] is True
    assert report["graft_hits"] >= 1
    steps = FLEET_SEARCH_SPEC["max_iteration_steps"]
    trial = fleetctl._build_trials(FLEET_SEARCH_SPEC)[0]
    input_fn = fleetctl._dataset_input_fn(FLEET_SEARCH_SPEC)
    single = trial.build_estimator(str(tmp_path / "single"), None,
                                   max_iterations=report["total_steps_trained"] // steps, device="cpu")
    single.train(input_fn)
    assert single.latest_global_step() == report["total_steps_trained"]
    single_score = Comparator(input_fn, eval_steps=8, adanet_lambda=0.01, adanet_beta=0.001).score(single, "single")
    assert report["winner_score"]["objective"] <= single_score.objective
