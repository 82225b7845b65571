"""The port's prefetching input pipeline (`utils/prefetch.py`): copies of
tests/test_prefetch.py for the port, one by one, but
`test_bagging_prefetchers_closed_per_iteration` (bagging is not ported).

The device tests mock the worker's copy at the `_prepare` seam with fake
staged batches that record their release, as the JAX tests mock
`jax.device_put`; the stream handshake of a staged batch runs against a
fake stream and event on the CPU (the consumer's stream waits on the
event recorded after the copy before any use, and every tensor of the
batch is `record_stream`ed on it); the real worker copy runs to the CPU
here and to the card in `chip_smoke.py` (`windows_vs_steps`,
`nasnet_gate_bf16`, `train_nasnet_mobile`). Prefetched training equals
unprefetched training bitwise.
"""

import threading
import time

import numpy as np
import pytest
import torch

from adanet_tpu_torch.utils.prefetch import DevicePrefetchIterator, PrefetchIterator, StagedBatch


def test_order_preserved():
    items = list(range(100))
    assert list(PrefetchIterator(iter(items), buffer_size=4)) == items


def test_exhaustion_is_sticky():
    it = PrefetchIterator(iter([1]), buffer_size=2)
    assert next(it) == 1
    with pytest.raises(StopIteration):
        next(it)
    with pytest.raises(StopIteration):
        next(it)


def test_exception_propagates_at_position():
    def source():
        yield 1
        yield 2
        raise RuntimeError("input pipeline failed")

    it = PrefetchIterator(source(), buffer_size=2)
    assert next(it) == 1
    assert next(it) == 2
    with pytest.raises(RuntimeError, match="input pipeline failed"):
        next(it)
    with pytest.raises(StopIteration):  # sticky after the error
        next(it)


def test_worker_actually_runs_ahead():
    produced = []

    def source():
        for i in range(10):
            produced.append(i)
            yield i

    it = PrefetchIterator(source(), buffer_size=4)
    deadline = time.time() + 5.0
    while len(produced) < 4 and time.time() < deadline:
        time.sleep(0.01)
    assert len(produced) >= 4
    assert list(it) == list(range(10))


def test_close_unblocks_parked_worker():
    def source():
        while True:
            yield 0

    it = PrefetchIterator(source(), buffer_size=1)
    next(it)
    it.close()
    deadline = time.time() + 5.0
    while time.time() < deadline and it._thread.is_alive():
        time.sleep(0.01)
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)


def test_close_from_other_thread_wakes_blocked_consumer():
    release_worker = threading.Event()

    def source():
        yield 0
        release_worker.wait(timeout=10)  # keeps the queue empty meanwhile
        yield 1

    it = PrefetchIterator(source(), buffer_size=1)
    assert next(it) == 0
    result = {}

    def consume():
        try:
            result["value"] = next(it)
        except StopIteration:
            result["value"] = "stop"

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    time.sleep(0.2)  # lets the consumer park in queue.get()
    it.close()
    consumer.join(timeout=5.0)
    release_worker.set()
    assert not consumer.is_alive(), "consumer stayed blocked after close()"
    assert result["value"] in ("stop", 1)


def test_buffer_size_validation():
    with pytest.raises(ValueError):
        PrefetchIterator(iter([]), buffer_size=0)


class _FakeStaged:
    """A staged batch at the `_prepare` seam: records its release so that
    the shutdown audit can count the batches left on the device."""

    def __init__(self, value, log):
        self.value = value
        self.released = False
        self._log = log

    def take(self, stream):
        return self

    def release(self):
        if self.released:
            raise RuntimeError("batch already released")
        self.released = True
        self._log.append(self.value)


def _mock_copy(monkeypatch, log, fail_on=None):
    def prepare(self, item):
        if fail_on is not None and item == fail_on:
            raise RuntimeError("copy to the device failed (simulated out of memory)")
        return _FakeStaged(item, log)

    monkeypatch.setattr(DevicePrefetchIterator, "_prepare", prepare)


def test_device_prefetch_order_and_values(monkeypatch):
    released = []
    _mock_copy(monkeypatch, released)
    it = DevicePrefetchIterator(iter(range(10)), buffer_size=3, device="cpu")
    assert [a.value for a in it] == list(range(10))
    assert released == []  # consumed batches belong to the consumer


def test_device_prefetch_real_device_put():
    """Unmocked: numpy batches arrive as tensors on the device asked for
    (the CPU here), values and dtypes unchanged."""
    batches = [({"x": np.full((2, 2), i, np.float32)}, np.array([i], np.int32)) for i in range(4)]
    out = list(DevicePrefetchIterator(iter(batches), buffer_size=2, device="cpu"))
    assert len(out) == 4
    for i, (features, labels) in enumerate(out):
        assert isinstance(features["x"], torch.Tensor) and features["x"].device.type == "cpu"
        np.testing.assert_array_equal(features["x"].numpy(), i)
        assert labels.dtype == torch.int32 and labels.tolist() == [i]


def test_device_prefetch_close_releases_pinned_buffers(monkeypatch):
    released = []
    _mock_copy(monkeypatch, released)
    prepared = []

    def source():
        for i in range(100):
            prepared.append(i)
            yield i

    it = DevicePrefetchIterator(source(), buffer_size=2, device="cpu")
    first = next(it)
    assert first.value == 0
    deadline = time.time() + 5.0
    while len(prepared) < 3 and time.time() < deadline:
        time.sleep(0.01)
    it.close()
    deadline = time.time() + 5.0
    while it._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not it._thread.is_alive(), "feeder thread leaked"
    assert not first.released
    assert sorted(released) == sorted(set(prepared) - {0}), (prepared, released)
    with pytest.raises(StopIteration):
        next(it)


def test_device_prefetch_double_delete_tolerated(monkeypatch):
    released = []
    _mock_copy(monkeypatch, released)
    it = DevicePrefetchIterator(iter([1, 2, 3]), buffer_size=3, device="cpu")
    time.sleep(0.1)  # lets the worker stage everything
    for kind, payload in list(it._queue.queue):
        if kind == "item" and payload.value == 2:
            payload.release()
    it.close()  # must not raise
    assert 2 in released


def test_device_prefetch_put_failure_propagates(monkeypatch):
    released = []
    _mock_copy(monkeypatch, released, fail_on=2)
    it = DevicePrefetchIterator(iter(range(5)), buffer_size=2, device="cpu")
    assert next(it).value == 0
    assert next(it).value == 1
    with pytest.raises(RuntimeError, match="simulated out of memory"):
        next(it)
    with pytest.raises(StopIteration):  # sticky after the error
        next(it)
    deadline = time.time() + 5.0
    while it._thread.is_alive() and time.time() < deadline:
        time.sleep(0.01)
    assert not it._thread.is_alive()


class _FakeEvent:
    def __init__(self, log):
        self.log = log

    def synchronize(self):
        self.log.append(("synchronize", self))


class _FakeStream:
    def __init__(self, log):
        self.log = log

    def wait_event(self, event):
        self.log.append(("wait_event", event))


def test_staged_batch_waits_for_its_copy_on_a_fake_stream(monkeypatch):
    """The consumer's stream waits on the copy's event before anything
    else, and every tensor of the batch is recorded on that stream (so
    the allocator keeps its memory until the stream is done with it);
    release waits for the copy, and twice raises."""
    log = []
    recorded = []
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, stream: recorded.append((self, stream)))
    batch = ({"x": torch.ones(2, 3), "n": 4}, torch.zeros(2, dtype=torch.int32))
    event, stream = _FakeEvent(log), _FakeStream(log)
    staged = StagedBatch(batch, event)
    got = staged.take(stream)
    assert got is batch and staged.batch is None
    assert log == [("wait_event", event)]
    assert [t for t, _ in recorded] == [batch[0]["x"], batch[1]] and all(s is stream for _, s in recorded)
    other = StagedBatch(batch, event)
    other.release()
    assert log[-1] == ("synchronize", event)
    with pytest.raises(RuntimeError, match="already released"):
        other.release()
    assert StagedBatch(batch).take(None) is batch  # the CPU: no stream


def test_device_prefetch_asks_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DevicePrefetchIterator(iter([]))


@pytest.mark.parametrize("to_device", [False, True])
def test_estimator_training_identical_with_prefetch(tmp_path, to_device):
    """Prefetch changes scheduling, never results: two searches on the
    same data, one prefetched, end with bitwise equal frozen winners and
    equal eval metrics, and no prefetcher left open."""
    from test_torch_tpu_estimator import _estimator, _frozen, _input_fn

    def run(name, **kwargs):
        est = _estimator(tmp_path / name, **kwargs)
        est.train(_input_fn(), max_steps=100)
        assert not est._open_prefetchers  # closed by train()'s finally
        return _frozen(est), est.evaluate(_input_fn())

    plain = run("plain")
    prefetched = run("prefetched", prefetch_buffer=3, prefetch_to_device=to_device)
    assert plain[1]["loss"] == prefetched[1]["loss"]
    assert plain[1]["accuracy"] == prefetched[1]["accuracy"]
    _frozen_equal(plain[0], prefetched[0])


def _frozen_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for key in a:
            _frozen_equal(a[key], b[key])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _frozen_equal(x, y)
    elif torch.is_tensor(a):
        assert torch.equal(a, b)
    else:
        assert a == b
