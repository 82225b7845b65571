"""The port's observability plane on the CPU: the Estimator's spans and
flight recorder, `adanet_tpu_torch.tools.trace_view` and the Chrome-trace
export.

Copies of tests/test_observability.py's flight-recorder tests (round
trip, a fault trip dumping through the installed recorder, per-directory
install, the sweep of stage strays, a SIGKILL mid-write through
`tests/torch_flightrec_chaos_runner.py`), its overhead gate (tracing off:
zero tracer clock reads on the search path), its trace_view acceptance (a
real 2-iteration port search -> flight dump -> `trace_view --export` ->
a Chrome trace with `search`, `train_window` and `iteration.complete` for
iterations 0 and 1 under one `search_id`), its usage-error and export
tests. The search is the JAX tests' (`chaos_common.build_estimator`: a
regression head, DNNs of 1 and 2 layers, SGD 0.05, 2 x 6 steps) on the
port's `dnn_builder`.
"""

import glob
import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from adanet_tpu_torch.core.estimator import Estimator
from adanet_tpu_torch.core.heads import RegressionHead
from adanet_tpu_torch.ensemble.weighted import ComplexityRegularizedEnsembler
from adanet_tpu_torch.observability import FlightRecorder, install, install_default, installed
from adanet_tpu_torch.observability import spans as spans_lib
from adanet_tpu_torch.observability.export import chrome_trace
from adanet_tpu_torch.observability.flightrec import load_dump
from adanet_tpu_torch.observability.spans import Tracer
from adanet_tpu_torch.robustness import faults
from adanet_tpu_torch.subnetwork.generator import SimpleGenerator
from adanet_tpu_torch.tools import trace_view
from torch_port_common import dnn_builder, linear_dataset, one_torch_thread

_one_torch_thread = pytest.fixture(autouse=True)(one_torch_thread)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))


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

    def advance(self, secs: float) -> None:
        self.now += secs


def build_estimator(model_dir, **kwargs):
    defaults = dict(
        head=RegressionHead(),
        subnetwork_generator=SimpleGenerator([dnn_builder("a", 1), dnn_builder("b", 2)]),
        max_iteration_steps=6,
        ensemblers=[ComplexityRegularizedEnsembler(optimizer=lambda p: torch.optim.SGD(p, lr=0.05))],
        max_iterations=2,
        model_dir=model_dir,
        log_every_steps=0,
        save_checkpoint_steps=2,
        device="cpu",
    )
    defaults.update(kwargs)
    return Estimator(**defaults)


input_fn = linear_dataset()


# ----------------------------------------------------------- flight dumps


def test_flight_dump_roundtrip_and_reason_history(tmp_path):
    recorder = FlightRecorder(str(tmp_path / "fr"), clock=FakeClock())
    with recorder.tracer.span("search", correlation={"search_id": "s"}):
        pass
    first = recorder.dump("first")
    second = recorder.dump("second", extra={"note": 7})
    assert first == second
    doc = load_dump(second)
    assert doc["reason"] == "second"
    assert doc["reasons"] == ["first", "second"]
    assert doc["extra"] == {"note": 7}
    assert any(e["name"] == "search" for e in doc["events"])
    assert "counters" in doc["metrics"]


def test_fault_trip_dumps_through_installed_recorder(tmp_path):
    recorder = install(FlightRecorder(str(tmp_path / "fr")))
    faults.arm("store.get", "transient")
    with pytest.raises(OSError):
        faults.trip("store.get")
    doc = load_dump(recorder.dump_path)
    assert doc["reason"] == "fault:store.get:transient"
    trips = [e for e in doc["events"] if e["name"] == "fault.trip"]
    assert trips and trips[-1]["attrs"]["site"] == "store.get"
    assert doc["armed_faults"]["store.get"]["mode"] == "transient"


def test_install_default_shares_per_dir_and_rebinds_on_new_dir(tmp_path):
    a = install_default(str(tmp_path / "a"))
    same = install_default(str(tmp_path / "a"))
    assert same is a
    b = install_default(str(tmp_path / "b"))
    assert b is not a and installed() is b
    assert b.directory.endswith("b")


def test_sweep_spares_live_writers_stages(tmp_path):
    directory = str(tmp_path / "fr")
    recorder = FlightRecorder(directory)
    live = os.path.join(directory, ".stage-%d-live" % os.getpid())
    open(live, "w").write("x")
    dead = os.path.join(directory, ".stage-999999999-dead")
    open(dead, "w").write("x")
    other = os.path.join(directory, ".stage-%d-inflight" % 1)
    open(other, "w").write("x")
    recorder.dump("sweep_test")
    assert not os.path.exists(live)
    assert not os.path.exists(dead)
    assert os.path.exists(other)


def test_flight_dump_survives_sigkill_mid_write(tmp_path):
    directory = str(tmp_path / "fr")
    env = dict(os.environ, ADANET_FAULTS="flightrec.dump:kill:after=1")
    env["PYTHONPATH"] = os.pathsep.join([os.path.dirname(TESTS_DIR), TESTS_DIR, env.get("PYTHONPATH", "")])
    proc = subprocess.run([sys.executable, os.path.join(TESTS_DIR, "torch_flightrec_chaos_runner.py"), directory],
                          env=env, capture_output=True, timeout=120)
    out = proc.stdout.decode()
    assert proc.returncode == -signal.SIGKILL, out[-2000:]
    assert "FIRST DUMP OK" in out
    assert "UNEXPECTED SECOND DUMP COMPLETION" not in out
    dumps = glob.glob(os.path.join(directory, "flight-*.json"))
    assert len(dumps) == 1
    doc = load_dump(dumps[0])
    assert doc["reason"] == "first"
    assert not any(e["name"] == "second.marker" for e in doc["events"])
    assert [name for name in os.listdir(directory) if name.startswith(".stage-")]
    FlightRecorder(directory).dump("post")
    assert not [name for name in os.listdir(directory) if name.startswith(".stage-")]


def test_estimator_sigterm_stop_dumps(tmp_path):
    """The port's Estimator dumps `sigterm_stop` under
    `<model_dir>/flightrec` when a SIGTERM stopped the search."""
    model_dir = str(tmp_path / "model")
    est = build_estimator(model_dir, max_iterations=1)

    def stopping_input():
        for i, batch in enumerate(input_fn()):
            if i == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch

    est.train(stopping_input, max_steps=6)
    assert est.latest_global_step() < 6
    [dump] = glob.glob(os.path.join(model_dir, "flightrec", "flight-*.json"))
    doc = load_dump(dump)
    assert doc["reason"] == "sigterm_stop"
    assert any(e["name"] == "search" for e in doc["events"])


# ----------------------------------------------------------- overhead gate


def test_overhead_gate_disabled_tracing_reads_no_clock(tmp_path):
    """With tracing disabled, the instrumented search path costs zero
    tracer clock reads and appends nothing to the ring; the same path
    with tracing enabled reads the clock and records the spans."""
    tracer = spans_lib.tracer()
    was_enabled = tracer.enabled
    try:
        tracer.disable()
        # The ring is bounded and shared by every test in the process:
        # start it empty, so that the spans this test records are the
        # ring's whole content however full earlier tests left it.
        tracer.clear()
        reads_before = tracer.clock_reads
        build_estimator(str(tmp_path / "off"), max_iterations=1).train(input_fn, max_steps=6)
        assert tracer.clock_reads == reads_before
        assert tracer.events() == []
        tracer.enable()
        build_estimator(str(tmp_path / "on"), max_iterations=1).train(input_fn, max_steps=6)
        assert tracer.clock_reads > reads_before
        new = [e.name for e in tracer.events()]
        assert "train_window" in new and "search" in new
    finally:
        if was_enabled:
            tracer.enable()
        else:
            tracer.disable()


# ------------------------------------------------- trace_view / acceptance


def test_trace_view_renders_perfetto_trace_from_real_search(tmp_path, capsys):
    tracer = spans_lib.tracer()
    was_enabled = tracer.enabled
    tracer.enable()
    tracer.clear()
    try:
        model_dir = str(tmp_path / "model")
        est = build_estimator(model_dir)
        est.train(input_fn, max_steps=100)
        assert est.latest_iteration_number() == 2
        from adanet_tpu_torch.observability import dump_installed

        dump = dump_installed("post_search")
        assert dump and os.path.dirname(dump).startswith(model_dir)
    finally:
        if not was_enabled:
            tracer.disable()
    export = str(tmp_path / "trace.json")
    assert trace_view.main([model_dir, "--json", "--export", export]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert {"search", "train_window", "iteration.complete", "checkpoint.save"} <= set(summary["spans"])
    assert summary["exported"] == export
    doc = json.load(open(export))
    trace_events = doc["traceEvents"]
    complete = [e for e in trace_events if e.get("ph") == "X"]
    metadata = [e for e in trace_events if e.get("ph") == "M"]
    assert complete and metadata
    for event in complete:
        assert set(event) >= {"name", "pid", "tid", "ts", "dur", "args"}
        assert event["ts"] >= 0
        assert event["pid"] == os.getpid()
    names = {e["name"] for e in complete}
    assert {"search", "train_window", "iteration.complete"} <= names
    iterations = {e["args"].get("iteration") for e in complete if "iteration" in e["args"]}
    assert {0, 1} <= iterations
    search_ids = {e["args"].get("search_id") for e in complete if "search_id" in e["args"]}
    assert len(search_ids) == 1
    # The text summary renders the same dump.
    assert trace_view.main([model_dir]) == 0
    assert "train_window" in capsys.readouterr().out


def test_trace_view_usage_errors(tmp_path):
    assert trace_view.main([str(tmp_path / "nope")]) == 64
    assert trace_view.main([]) == 64


def test_trace_view_export_keeps_each_process(tmp_path):
    """Dumps of two processes under one directory export under their own
    pids, on one time axis."""
    clock = FakeClock(start=100.0)
    first = FlightRecorder(str(tmp_path / "fr"), tracer=Tracer(capacity=8, clock=clock))
    with first.tracer.span("search"):
        clock.advance(0.5)
    first.dump("searcher")
    doc = load_dump(first.dump_path)
    doc["pid"] = 4242
    for event in doc["events"]:
        event["start"] += 2.0
        event["end"] += 2.0
    with open(os.path.join(str(tmp_path / "fr"), "flight-4242.json"), "w") as f:
        json.dump(doc, f)
    export = str(tmp_path / "trace.json")
    assert trace_view.main([str(tmp_path / "fr"), "--json", "--export", export]) == 0
    spans = [e for e in json.load(open(export))["traceEvents"] if e.get("ph") == "X"]
    by_pid = {e["pid"]: e["ts"] for e in spans}
    assert by_pid == {os.getpid(): 0.0, 4242: pytest.approx(2e6)}


def test_chrome_trace_rebases_timestamps_and_names_threads():
    clock = FakeClock(start=5000.0)
    tracer = Tracer(capacity=8, clock=clock)
    with tracer.span("a"):
        clock.advance(0.002)
    doc = chrome_trace(tracer.events(), pid=7, process_name="p")
    [span] = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert span["ts"] == 0.0
    assert span["dur"] == pytest.approx(2000.0)
    thread_names = [e for e in doc["traceEvents"] if e["ph"] == "M" and e["name"] == "thread_name"]
    assert thread_names and thread_names[0]["pid"] == 7
