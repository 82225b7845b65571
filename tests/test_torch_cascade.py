"""The cascade (`serving/fleet/cascade.py`, a copy) through the port's
publisher, pool and batcher, on the CPU.

Copies of tests/test_serving_fleet.py's cascade tests that need no
fleet (temperature fitting, threshold picking, padding rows, the
published cascade through the gate, per-row fallthrough bit-identical to
a cascade-free oracle, the residual's re-bucketing, the shadow's
rollback, the Estimator's auto-published cascade), the JAX fixture's
functions written in torch and exported on the CPU.
"""

import json
import os

import numpy as np
import pytest
import torch

from adanet_tpu_torch.serving import (
    Batcher,
    BatcherConfig,
    FrontendConfig,
    GenerationRecord,
    ModelPool,
    ServingFrontend,
    publisher,
)
from adanet_tpu_torch.serving.fleet import CascadeSpec
from adanet_tpu_torch.serving.fleet import cascade as cascade_lib
from torch_port_common import dnn_builder, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)


def test_fit_temperature_improves_calibration():
    rng = np.random.RandomState(0)
    logits = rng.randn(512, 6) * 5.0  # overconfident
    labels = (logits + rng.randn(512, 6) * 2.0).argmax(-1)
    temperature = cascade_lib.fit_temperature(logits, labels)
    assert temperature > 1.0  # overconfident logits must be softened
    assert cascade_lib.nll(logits, labels, temperature) < cascade_lib.nll(
        logits, labels, 1.0
    )


def test_pick_threshold_meets_target_or_degrades_to_fallthrough():
    conf = np.array([0.3, 0.5, 0.7, 0.9, 0.95])
    agree = np.array([False, True, True, True, True])
    record = cascade_lib.pick_threshold(conf, agree, 0.99)
    assert record["threshold"] == 0.5
    assert record["holdout_agreement"] == 1.0
    assert record["holdout_fallthrough_rate"] == pytest.approx(0.2)
    # Unachievable target: the threshold must be unreachable even by a
    # serve-time row MORE confident than anything in the holdout (a
    # saturated softmax maxes at 1.0) — always-fall-through, and the
    # record stays strict-JSON (no Infinity).
    hopeless = cascade_lib.pick_threshold(
        conf, np.zeros(5, bool), 0.5
    )
    assert hopeless["threshold"] == 2.0
    assert hopeless["holdout_fallthrough_rate"] == 1.0
    saturated = {"y": np.array([[1000.0, -1000.0]])}
    assert not cascade_lib.clears(
        dict(hopeless, temperature=1.0, logits_key="y"),
        saturated,
        real_rows=1,
    )


def test_cascade_clears_ignores_padding_rows():
    record = {"temperature": 1.0, "threshold": 0.9, "logits_key": "y"}
    confident = np.array([[10.0, -10.0]])
    unsure = np.array([[0.1, 0.0]])
    outputs = {"y": np.concatenate([confident, unsure])}
    # Row 1 is padding: only the real row's confidence counts.
    assert cascade_lib.clears(record, outputs, real_rows=1)
    assert not cascade_lib.clears(record, outputs, real_rows=2)


@pytest.fixture(scope="module")
def cascade_model_dir(tmp_path_factory):
    """One real cascade publication shared by the serve-time tests (the
    JAX fixture's functions in torch, exported on the CPU)."""
    model_dir = str(tmp_path_factory.mktemp("cascade-model"))
    rng = np.random.RandomState(0)
    hidden = torch.from_numpy(rng.randn(16, 32).astype(np.float32))
    head = torch.from_numpy(rng.randn(32, 4).astype(np.float32))
    keep = 28  # the cheap member: most of the ensemble, much cheaper

    def full_fn(features):
        return {"predictions": torch.tanh(features["x"] @ hidden) @ head}

    def cheap_fn(features):
        return {"predictions": torch.tanh(features["x"] @ hidden[:, :keep]) @ head[:keep]}

    publisher.publish_generation(
        model_dir,
        0,
        full_fn,
        {"x": np.zeros((4, 16), np.float32)},
        cascade=CascadeSpec(
            cheap_fn,
            {"x": rng.randn(512, 16).astype(np.float32)},
            target_agreement=0.98,
        ),
        device="cpu",
    )
    return model_dir


def test_cascade_publication_signature_and_gate(cascade_model_dir):
    from adanet_tpu_torch.core import export as export_lib

    gen = publisher.generation_dir(cascade_model_dir, 0)
    assert os.path.exists(os.path.join(gen, export_lib.CASCADE_FILE))
    signature = export_lib.serving_signature(gen)
    cascade = signature["cascade"]
    assert cascade["program"] == export_lib.CASCADE_FILE
    assert cascade["temperature"] > 0
    assert 0.0 < cascade["threshold"] <= 1.0
    assert cascade["holdout_agreement"] >= 0.98
    pool = ModelPool(cascade_model_dir, device="cpu")
    assert pool.poll()
    record = pool.active_record()
    assert record.cascade_program is not None
    assert record.cascade["threshold"] == cascade["threshold"]


def test_cascade_fallthrough_bit_identical_to_full_oracle(
    cascade_model_dir,
):
    """The acceptance property, per ROW: every row the per-row cascade
    sends to the ensemble is bit-identical to a cascade-free server's
    answer for that row, every clear row really comes from the
    published level-0 program, and `last_row_fallthrough` tags which
    is which."""
    pool = ModelPool(cascade_model_dir, device="cpu")
    pool.poll()
    rng = np.random.RandomState(7)
    on = Batcher(pool, BatcherConfig(bucket_sizes=(4, 8)))
    off = Batcher(pool, BatcherConfig(bucket_sizes=(4, 8), cascade=False))
    record = pool.active_record()
    saw_cheap = saw_fall = saw_mixed = False
    for _ in range(40):
        x = {"x": rng.randn(2, 16).astype(np.float32)}
        _, answered = on.execute([x])
        _, oracle = off.execute([x])
        assert off.last_cascade_level is None
        assert off.last_row_fallthrough is None
        mask = on.last_row_fallthrough
        assert mask is not None and mask.shape == (2,)
        assert on.last_cascade_level == (1 if mask.any() else 0)
        cheap_oracle = record.cascade_program(
            {"x": np.concatenate([x["x"], np.zeros((2, 16), np.float32)])}
        )
        ans = np.asarray(answered[0]["predictions"])
        for row in range(2):
            if mask[row]:
                saw_fall = True
                np.testing.assert_array_equal(
                    ans[row],
                    np.asarray(oracle[0]["predictions"])[row],
                )
            else:
                saw_cheap = True
                np.testing.assert_array_equal(
                    ans[row],
                    np.asarray(cheap_oracle["predictions"])[row],
                )
        if mask.any() and not mask.all():
            saw_mixed = True
    assert saw_fall, "threshold never fell through in 40 batches"
    assert saw_cheap, "threshold never cleared in 40 batches"
    assert saw_mixed, "no batch ever split between the tiers"


def test_cascade_level_reaches_serve_result(cascade_model_dir):
    pool = ModelPool(cascade_model_dir, device="cpu")
    pool.poll()
    frontend = ServingFrontend(
        Batcher(pool, BatcherConfig(bucket_sizes=(4, 8))),
        FrontendConfig(default_deadline_secs=30.0),
    ).start()
    try:
        result = frontend.submit(
            {"x": np.zeros((2, 16), np.float32)}, timeout=60.0
        )
        assert result.ok
        assert result.cascade_level in (0, 1)
    finally:
        frontend.drain(timeout=10.0)


class _CascadeStubPool:
    """Minimal pool contract: one duck-typed record, host-side stub
    programs."""

    def __init__(self, record):
        self.record = record

    def active_record(self):
        return self.record

    def canary_record(self):
        return None

    @property
    def active(self):
        return self.record

    def poll(self):
        return False


def _counting(fn):
    """Wraps a program to count calls + record dispatched batch rows."""

    def wrapped(features):
        wrapped.calls += 1
        wrapped.batch_rows.append(
            int(np.asarray(next(iter(features.values()))).shape[0])
        )
        return fn(features)

    wrapped.calls = 0
    wrapped.batch_rows = []
    return wrapped


def _stub_cascade_record(cheap_fn, full_fn, t=0, threshold=0.9, **extra):
    cascade = {
        "temperature": 1.0,
        "threshold": threshold,
        "logits_key": "y",
    }
    cascade.update(extra)
    return GenerationRecord(
        t,
        "/nonexistent-gen-%d" % t,
        full_fn,
        {},
        cascade_program=cheap_fn,
        cascade=cascade,
    )


def _margin_programs():
    """Cheap logits [x0, 0]: row clears iff x0 >= ln(9) (~2.2) at
    threshold 0.9; padding rows (x0 == 0) sit at confidence 0.5. The
    full program shifts by +100 so provenance is unambiguous."""

    def cheap_fn(features):
        x0 = np.asarray(features["x"])[:, 0]
        return {"y": np.stack([x0, np.zeros_like(x0)], axis=-1)}

    def full_fn(features):
        x0 = np.asarray(features["x"])[:, 0]
        return {"y": np.stack([x0 + 100.0, np.zeros_like(x0)], axis=-1)}

    return _counting(cheap_fn), _counting(full_fn)


def _row(x0):
    return {"x": np.array([[x0, 0.0]], np.float32)}


def test_cascade_residual_rebucketing_edges():
    """The re-bucketing edge cases of per-row splitting: an all-clear
    batch never touches the ensemble, a zero-clear batch runs it once
    on the original bucket, and a small residual re-buckets to the
    SMALLEST holding bucket with clear/fallthrough rows scattered
    bit-exactly."""
    cheap_fn, full_fn = _margin_programs()
    batcher = Batcher(
        _CascadeStubPool(_stub_cascade_record(cheap_fn, full_fn)),
        BatcherConfig(bucket_sizes=(4, 8), shadow_every=0),
    )
    # All rows clear: answered at level 0, the ensemble NEVER runs.
    _, out = batcher.execute([_row(5.0), _row(6.0)])
    assert batcher.last_cascade_level == 0
    assert not batcher.last_row_fallthrough.any()
    assert full_fn.calls == 0
    np.testing.assert_array_equal(
        np.asarray(out[0]["y"]), [[5.0, 0.0]]
    )
    # Zero rows clear: one full run on the ORIGINAL bucket (4), no
    # residual dispatch.
    _, out = batcher.execute([_row(0.5), _row(1.0)])
    assert batcher.last_cascade_level == 1
    assert batcher.last_row_fallthrough.all()
    assert full_fn.calls == 1 and full_fn.batch_rows == [4]
    np.testing.assert_array_equal(
        np.asarray(out[1]["y"]), [[101.0, 0.0]]
    )
    # 6 real rows (bucket 8), ONE unclear: the residual re-buckets to
    # the smallest bucket (4), and every row's provenance is exact.
    full_fn.calls, full_fn.batch_rows = 0, []
    xs = [5.0, 6.0, 0.5, 7.0, 8.0, 9.0]
    _, out = batcher.execute([_row(x) for x in xs])
    mask = batcher.last_row_fallthrough
    np.testing.assert_array_equal(
        mask, [False, False, True, False, False, False]
    )
    assert batcher.last_cascade_level == 1
    assert full_fn.calls == 1 and full_fn.batch_rows == [4]
    for i, x in enumerate(xs):
        expected = x + 100.0 if mask[i] else x
        np.testing.assert_array_equal(
            np.asarray(out[i]["y"]), [[expected, 0.0]]
        )


def test_cascade_padding_rows_never_force_fallthrough():
    """Padding rows sit below the margin (x0=0 -> confidence 0.5) but
    only REAL rows are scored: an all-clear 2-row batch in a 4-bucket
    stays at level 0."""
    cheap_fn, full_fn = _margin_programs()
    batcher = Batcher(
        _CascadeStubPool(_stub_cascade_record(cheap_fn, full_fn)),
        BatcherConfig(bucket_sizes=(4,), shadow_every=0),
    )
    _, _ = batcher.execute([_row(5.0), _row(6.0)])
    assert batcher.last_cascade_level == 0
    assert full_fn.calls == 0


def test_cascade_padding_rows_never_mask_fallthrough():
    """The inverse: a cheap program whose logits are [4 - x0, 0] makes
    PADDING (x0=0) maximally confident while a real x0=4 row is not —
    confident padding must not hide the real row's fallthrough."""

    def cheap_fn(features):
        x0 = np.asarray(features["x"])[:, 0]
        return {"y": np.stack([4.0 - x0, np.zeros_like(x0)], axis=-1)}

    def full_fn(features):
        x0 = np.asarray(features["x"])[:, 0]
        return {"y": np.stack([x0 + 100.0, np.zeros_like(x0)], axis=-1)}

    full_fn = _counting(full_fn)
    batcher = Batcher(
        _CascadeStubPool(_stub_cascade_record(cheap_fn, full_fn)),
        BatcherConfig(bucket_sizes=(4,), shadow_every=0),
    )
    _, out = batcher.execute([_row(0.0), _row(4.0)])
    np.testing.assert_array_equal(
        batcher.last_row_fallthrough, [False, True]
    )
    assert full_fn.calls == 1
    np.testing.assert_array_equal(
        np.asarray(out[1]["y"]), [[104.0, 0.0]]
    )


def test_cascade_shadow_divergence_rolls_back_to_ensemble(tmp_path):
    """The auto-rollback acceptance: a divergent level-0 program trips
    the shadow canary past the published bound — the tripping batch is
    re-answered by the full ensemble (no condemned answer is served),
    the batcher serves ensemble-only for that generation with the
    reason on the flight recorder, and a new generation flip resets the
    rollback."""
    from adanet_tpu_torch.observability import flightrec

    # Divergent level 0: confidently argmax-0 where the ensemble says
    # argmax-1, on every row.
    def cheap_fn(features):
        n = np.asarray(features["x"]).shape[0]
        return {"y": np.tile([10.0, 0.0], (n, 1))}

    def full_fn(features):
        n = np.asarray(features["x"]).shape[0]
        return {"y": np.tile([0.0, 10.0], (n, 1))}

    pool = _CascadeStubPool(
        _stub_cascade_record(
            cheap_fn, full_fn, shadow_divergence_bound=0.05
        )
    )
    batcher = Batcher(
        pool,
        BatcherConfig(
            bucket_sizes=(4,),
            shadow_every=1,
            shadow_min_rows=2,
        ),
    )
    recorder = flightrec.install(
        flightrec.FlightRecorder(str(tmp_path / "flightrec"))
    )
    try:
        before = batcher._m_cascade_rollbacks.value
        _, out = batcher.execute(
            [{"x": np.zeros((4, 2), np.float32)}]
        )
        # The shadow tripped ON this batch: every row re-answered by
        # the ensemble, not the condemned level 0.
        np.testing.assert_array_equal(
            np.asarray(out[0]["y"]), np.tile([0.0, 10.0], (4, 1))
        )
        assert batcher.last_row_fallthrough.all()
        rollback = batcher.cascade_rollback
        assert rollback is not None and rollback["generation"] == 0
        assert "shadow divergence" in rollback["reason"]
        assert rollback["shadow_divergence"] > rollback["bound"]
        assert batcher._m_cascade_rollbacks.value == before + 1
        # Forensics: the rollback dumped the flight recorder.
        dump = json.load(open(recorder.dump_path))
        assert any(
            "cascade_shadow_rollback:gen-0" in r
            for r in dump["reasons"]
        )
        # Ensemble-only from here for THIS generation; the stats
        # surface carries the rollback fleet-wide.
        _, out = batcher.execute(
            [{"x": np.zeros((2, 2), np.float32)}]
        )
        assert batcher.last_cascade_level is None
        np.testing.assert_array_equal(
            np.asarray(out[0]["y"]), np.tile([0.0, 10.0], (2, 1))
        )
        stats = batcher.cascade_stats()
        assert stats["active"] is False
        assert stats["rollback"]["generation"] == 0
        # In-flight requests keep being answered through the frontend.
        frontend = ServingFrontend(
            batcher, FrontendConfig(default_deadline_secs=30.0)
        ).start()
        try:
            result = frontend.submit(
                {"x": np.zeros((2, 2), np.float32)}, timeout=60.0
            )
            assert result.ok
        finally:
            frontend.drain(timeout=10.0)
        # A NEW generation (healthy level 0) resets the rollback.
        pool.record = _stub_cascade_record(full_fn, full_fn, t=1)
        _, _ = batcher.execute([{"x": np.zeros((2, 2), np.float32)}])
        assert batcher.cascade_rollback is None
        assert batcher.last_cascade_level in (0, 1)
        assert batcher.cascade_stats()["active"] is True
    finally:
        flightrec.uninstall()


def test_estimator_auto_publishes_calibrated_cascade(tmp_path):
    """`export_serving=True` + the default `serving_cascade=True`: a
    multi-class search publishes, with ZERO operator action, a
    generation whose signature carries a calibrated cascade derived
    from the ensemble's own cheapest member — and a pool + batcher
    serve it with the cascade active."""
    from adanet_tpu_torch.core import export as export_lib
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead
    from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    rng = np.random.RandomState(3)
    x = rng.randn(64, 2).astype(np.float32)
    labels = (x[:, 0] > 0).astype(np.int32) + (x[:, 1] > 0).astype(np.int32)

    def input_fn():
        for start in range(0, 64, 16):
            yield {"x": x[start : start + 16]}, labels[start : start + 16]

    model_dir = str(tmp_path / "model")
    est = Estimator(
        head=MultiClassHead(3),
        subnetwork_generator=SimpleGenerator([dnn_builder("dnn", 1), dnn_builder("deep", 2)]),
        max_iteration_steps=8,
        max_iterations=2,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        model_dir=model_dir,
        log_every_steps=0,
        export_serving=True,
        # A toy 8-step member won't reach the 0.995 default agreement
        # (calibration would degrade to the safe full-fallthrough
        # threshold 2.0); a modest target keeps the cascade live.
        cascade_target_agreement=0.6,
        device="cpu",
    )
    est.train(input_fn, max_steps=100)
    # Iteration 0's ensemble has ONE member: level 0 would BE the full
    # program, so that generation publishes without a cascade.
    gen0 = publisher.generation_dir(model_dir, 0)
    assert "cascade" not in export_lib.serving_signature(gen0)
    # Iteration 1 has two members: the auto-derived cascade ships,
    # calibrated, sourced from the member prefix.
    gen1 = publisher.generation_dir(model_dir, 1)
    signature = export_lib.serving_signature(gen1)
    cascade = signature["cascade"]
    assert cascade["source"] == "member"
    assert cascade["temperature"] > 0
    assert 0.0 < cascade["threshold"] <= 1.0
    assert cascade["holdout_agreement"] >= 0.6
    assert "shadow_divergence_bound" in cascade
    # The standard serve chain picks it up with the cascade active.
    pool = ModelPool(model_dir, device="cpu")
    assert pool.poll()
    record = pool.active_record()
    assert record.iteration_number == 1
    assert record.cascade_program is not None
    batcher = Batcher(pool)
    _, out = batcher.execute([{"x": x[:5]}])
    assert batcher.last_cascade_level in (0, 1)
    assert batcher.cascade_stats()["active"] is True
    assert out[0]["logits"].shape == (5, 3)


def test_cascade_spec_is_none_where_a_cascade_cannot_help(tmp_path):
    """As the JAX Estimator's `_auto_cascade_spec`: no cascade for one
    member, for per-member outputs, or for dict logits (multi-head)."""
    from adanet_tpu_torch.core.estimator import Estimator
    from adanet_tpu_torch.core.heads import MultiClassHead, MultiHead, RegressionHead
    from adanet_tpu_torch.subnetwork.generator import SimpleGenerator

    frozen = type("F", (), {"weighted_subnetworks": [object(), object()]})()
    one = type("F", (), {"weighted_subnetworks": [object()]})()
    sample = {"x": np.zeros((2, 2), np.float32)}

    def estimator(head, **kwargs):
        return Estimator(head, SimpleGenerator([dnn_builder("dnn")]), 4, model_dir=str(tmp_path), device="cpu",
                         export_serving=True, **kwargs)

    assert estimator(MultiClassHead(3))._auto_cascade_spec(one, sample) is None
    assert estimator(MultiClassHead(3), export_subnetwork_logits=True)._auto_cascade_spec(frozen, sample) is None
    multi = MultiHead([RegressionHead(name="r"), MultiClassHead(3, name="c")])
    assert estimator(multi)._auto_cascade_spec(frozen, sample) is None
    assert estimator(RegressionHead())._auto_cascade_spec(frozen, sample) is None
