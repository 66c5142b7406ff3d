"""PyTorch/CUDA port, ``Trainer.prefetch`` and its stage
(``io.dataloader._DevicePrefetchIter``) on the CPU, against the JAX
package's iterator: the order of the staged batches, the bound on how far
the producer runs ahead, the end of the source, an error in the source,
and the observed trainer's ``prefetch_queue_depth`` gauge."""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.io.dataloader import _DevicePrefetchIter as JaxPrefetch
from paddle_tpu_torch.distributed import Trainer
from paddle_tpu_torch.io.dataloader import _DevicePrefetchIter

pytestmark = pytest.mark.torch_port


def _host(n, tuples=True):
    rng = np.random.RandomState(n)
    out = []
    for i in range(n):
        x = rng.randn(4, 3).astype(np.float32) + i
        out.append((x, np.full((4,), i, np.int64)) if tuples else x)
    return out


def _drain(it, limit=100):
    """The pulls of ``it`` as ("item", numpy values), ("err", message) and
    a final ("end",); the iteration is pulled once more after an error."""
    events = []
    for _ in range(limit):
        try:
            b = next(it)
        except StopIteration:
            events.append(("end",))
            return events
        except ValueError as e:
            events.append(("err", str(e)))
            continue
        vals = b if isinstance(b, tuple) else (b,)
        events.append(("item", [np.asarray(v) for v in vals]))
    raise AssertionError("the iteration did not end")


def _failing(batches, at):
    for i, b in enumerate(batches):
        if i == at:
            raise ValueError(f"poison batch {i}")
        yield b


def _same(a, b):
    assert [e[0] for e in a] == [e[0] for e in b]
    for x, y in zip(a, b):
        if x[0] == "item":
            assert len(x[1]) == len(y[1])
            for u, v in zip(x[1], y[1]):
                assert u.dtype == v.dtype and np.array_equal(u, v)
        elif x[0] == "err":
            assert x[1] == y[1]


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("case", ["tuples", "arrays", "error_first",
                                  "error_mid", "empty"])
def test_order_end_and_errors_match_the_jax_iterator(case, depth):
    """The same source through the port's stage and the JAX iterator (its
    stage the identity): the same batches in the same order and types,
    the error at the same turn, then the end; tensors on the CPU."""
    host = _host(0 if case == "empty" else 6, tuples=case != "arrays")
    at = {"error_first": 0, "error_mid": 3}.get(case)

    def src():
        return iter(host) if at is None else _failing(host, at)
    mine = _DevicePrefetchIter(src(), "cpu", depth=depth)
    want = _drain(JaxPrefetch(src(), lambda b: b, depth=depth))
    got = _drain(mine)
    _same(got, want)
    assert got[-1] == ("end",)
    assert ("err" in [e[0] for e in got]) == (at is not None)
    with pytest.raises(StopIteration):
        next(mine)                      # ended: no deadlock on a re-pull


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_producer_runs_at_most_depth_ahead(depth):
    """With the consumer stalled, the producer stages ``depth`` batches
    into the queue and holds one more: it never pulls further."""
    pulled = []

    def src():
        for i in range(20):
            pulled.append(i)
            yield np.full((2,), i)
    it = _DevicePrefetchIter(src(), "cpu", depth=depth)
    deadline = time.monotonic() + 10
    while len(pulled) < depth + 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.3)                     # time to run further, if it would
    assert len(pulled) == depth + 1
    assert it.q.qsize() == depth
    assert int(next(it)[0]) == 0
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()


def test_close_stops_the_producer_and_ends_the_iteration():
    it = _DevicePrefetchIter(iter(_host(50)), "cpu", depth=2)
    next(it)
    it.close()
    it._thread.join(timeout=5)
    assert not it._thread.is_alive()
    rest = _drain(it)
    assert rest[-1] == ("end",) and len(rest) <= 3


def _linear_trainer(**kw):
    def loss_fn(p, x, y):
        return ((x @ p["w"] - y) ** 2).mean()
    return Trainer(loss_fn, lr=1e-2, device="cpu", **kw)


def _linear_batches(n=4):
    rng = np.random.RandomState(3)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 4).astype(np.float32)) for _ in range(n)]


def test_trainer_prefetch_feeds_the_steps_it_would_take_directly():
    """Steps fed by ``prefetch`` give the losses of the same batches
    passed to ``step``, bit for bit; the staged batches are tensors on the
    trainer's device; the counters see every step."""
    host = _linear_batches(1) * 3 + _linear_batches(2)
    losses = {}
    for via in ("prefetch", "direct"):
        tr = _linear_trainer()
        state = tr.init_state({"w": torch.ones(4, 4)})
        src = tr.prefetch(iter(host)) if via == "prefetch" else iter(host)
        out = []
        for x, y in src:
            if via == "prefetch":
                assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
            state, m = tr.step(state, x, y)
            out.append(float(m["loss"]))
        assert tr.metrics()["steps"] == len(host)
        losses[via] = out
    assert losses["prefetch"] == losses["direct"]
    assert losses["direct"][2] < losses["direct"][0]   # one batch, thrice


def test_prefetch_queue_depth_gauge():
    """With observability on, each pull samples the staged-queue depth
    (the JAX trainer's gauge); disabled, no gauge exists."""
    tr = _linear_trainer(observability=True)
    state = tr.init_state({"w": torch.ones(4, 4)})
    seen = []
    for x, y in tr.prefetch(iter(_linear_batches(5)), depth=3):
        state, _ = tr.step(state, x, y)
        seen.append(1)
    g = tr.metrics()["gauges"]
    assert len(seen) == 5
    assert "prefetch_queue_depth" in g
    assert g["prefetch_queue_depth"]["last"] is not None
    assert 0 <= g["prefetch_queue_depth"]["max"] <= 3
    plain = _linear_trainer()
    list(plain.prefetch(iter(_linear_batches(2))))
    assert "gauges" not in plain.metrics()


def test_prefetch_relays_a_source_error_to_the_training_loop():
    tr = _linear_trainer()
    state = tr.init_state({"w": torch.ones(4, 4)})
    steps = 0
    with pytest.raises(ValueError, match="poison batch 2"):
        for x, y in tr.prefetch(_failing(_linear_batches(), 2)):
            state, _ = tr.step(state, x, y)
            steps += 1
    assert steps == 2 and tr.metrics()["steps"] == 2


def test_prefetch_pulls_the_source_in_its_own_thread():
    """The source is pulled, and its batches staged, in the producer
    thread, not in the consumer's: that is what overlaps them with the
    step."""
    threads = set()

    def src():
        for b in _linear_batches(3):
            threads.add(threading.current_thread().name)
            yield b
    list(_linear_trainer().prefetch(src()))
    assert threads == {"device-prefetch"}
