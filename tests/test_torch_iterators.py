"""The port's host iterators and its forked tensorize, on the CPU.

* ``BufferedIterator`` (``core/iterators.py``), the cases of
  ``tests/test_iterators.py``: the order, data that looks like a marker, a
  producer's error re-raised with its traceback, a SIGKILLed child; and the
  port's own: an element that does not pickle fails loudly, an abandoned
  stream's child is terminated and joined, a child that sends nothing
  raises after ``STALL_SECONDS``, and the child never finalizes the
  parent's garbage.
* ``tensorize_dataset``: forked, thread-pool and sequential streams equal,
  and equal to the JAX package's forked stream, on Graph2Class and PPI
  samples; an abandoned forked stream (``close()``, or an early break in
  ``minibatch_iterator``) leaves no live child.
* ``ModelTrainer.train`` for 2 epochs with ``use_multiprocessing`` on and
  off: the same losses and parameters, bitwise; the progress bar on; and
  ``DistributedModelTrainer`` at world 1 (gloo, in this process) passes
  both parameters on to its training pass.

Each test runs under its own deadline (``SIGALRM``), so a hang fails the
test instead of stalling the suite."""
import dataclasses
import itertools
import multiprocessing
import os
import signal
import time

import numpy as np
import pytest
import torch

from ptgnn_tpu_torch.core.iterators import BufferedIterator, _EndOfStream, _WorkerError
from ptgnn_tpu_torch.implementations.typilus.harness import build_graph2class, small_padding
from ptgnn_tpu_torch.utils.synthetic import synthetic_typilus_graphs

LIMIT_S = 120


@pytest.fixture(autouse=True)
def deadline():
    def expire(signum, frame):
        raise TimeoutError(f"the test ran past its {LIMIT_S} s deadline")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


def _live_children():
    return {p.pid for p in multiprocessing.active_children()}


def _wait_until(predicate, seconds: float = 10.0) -> bool:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if predicate():
            return True
        time.sleep(0.05)
    return predicate()


# ---------------------------------------------------------------------------
# BufferedIterator
# ---------------------------------------------------------------------------
def test_buffered_iterator_keeps_the_order():
    assert list(BufferedIterator(range(2000), max_queue_size=16)) == list(range(2000))


def test_buffered_iterator_data_that_looks_like_a_marker():
    data = ["x", "___end_of_iterator___", None, b"bytes", _EndOfStream(), _WorkerError("not an error"), "y"]
    got = list(BufferedIterator(iter(data)))
    assert got[:4] == data[:4] and got[-1] == "y" and len(got) == len(data)
    assert isinstance(got[4], _EndOfStream) and isinstance(got[5], _WorkerError) and got[5].message == "not an error"


def test_buffered_iterator_reraises_a_worker_error_with_its_traceback():
    def gen():
        yield 1
        raise ValueError("boom in child")

    it = BufferedIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="(?s)worker process failed.*Traceback.*ValueError: boom in child"):
        next(it)
    assert not it.process.is_alive()


def test_buffered_iterator_detects_a_killed_worker():
    def gen():
        yield 1
        os.kill(os.getpid(), signal.SIGKILL)  # dies without the marker
        yield 2  # pragma: no cover

    it = BufferedIterator(gen())
    # SIGKILL may race the queue's feeder thread, so the first element may
    # or may not arrive: either way the consumer gets the diagnostic.
    with pytest.raises(RuntimeError, match="died without an end-of-stream marker"):
        assert next(it) == 1
        next(it)
    assert it.process.exitcode == -signal.SIGKILL


def test_buffered_iterator_an_element_that_does_not_pickle_fails_loudly():
    def gen():
        yield 1
        yield lambda: 2  # a local object: no pickle

    it = BufferedIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="(?s)worker process failed.*pickle"):
        next(it)


def test_buffered_iterator_close_terminates_and_joins_the_child():
    it = BufferedIterator(itertools.count(), max_queue_size=4)
    assert next(it) == 0
    child = it.process
    assert child.is_alive()
    it.close()
    assert child.exitcode is not None and not child.is_alive()
    it.close()  # idempotent
    with pytest.raises(StopIteration):
        next(it)


def test_buffered_iterator_a_stalled_child_raises(monkeypatch):
    from ptgnn_tpu_torch.core import iterators

    monkeypatch.setattr(iterators, "STALL_SECONDS", 2.0)

    def gen():
        yield 1
        time.sleep(60)  # alive, sending nothing (a deadlocked child)
        yield 2  # pragma: no cover

    it = BufferedIterator(gen())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="sent nothing for"):
        next(it)
    assert not it.process.is_alive()


class _Finalized:
    """Writes the pid of the process that finalizes it."""

    def __init__(self, path):
        self.path = path
        self.cycle = self

    def __del__(self):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()}\n")


def test_the_child_never_finalizes_the_parents_garbage(tmp_path):
    """Garbage of the parent (a reference cycle not yet collected at the
    fork) stays uncollected in the child, whose collector runs: a CUDA
    object's destructor there would call CUDA in a forked child. The
    parent's collector finalizes it after."""
    import gc

    path = tmp_path / "finalized"
    gc.disable()
    try:
        _Finalized(path)  # unreachable at once, alive until a collection

        def collect_in_child():
            gc.collect()
            yield os.getpid()

        child_pid, = list(BufferedIterator(collect_in_child()))
        assert child_pid != os.getpid()
        assert not path.exists() or str(child_pid) not in path.read_text().split()
    finally:
        gc.enable()
    gc.collect()
    assert path.read_text().split() == [str(os.getpid())]


def test_buffered_iterator_disabled_iterates_in_this_process():
    pid = os.getpid()
    assert list(BufferedIterator((os.getpid() == pid for _ in range(3)), enabled=False)) == [True] * 3


# ---------------------------------------------------------------------------
# tensorize_dataset
# ---------------------------------------------------------------------------
def _canonical(obj):
    """A structure of plain values for comparing tensorized samples across
    classes of the two packages: arrays by dtype, shape and bytes."""
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.dtype.str, obj.shape, obj.tobytes())
    if isinstance(obj, (np.generic,)):
        return ("scalar", obj.dtype.str, obj.tobytes())
    if hasattr(obj, "_asdict"):
        return (type(obj).__name__, _canonical(dict(obj._asdict())))
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, _canonical({f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}))
    if isinstance(obj, dict):
        return {k: _canonical(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_canonical(v) for v in obj]
    slots = getattr(type(obj), "__slots__", None)
    if slots:
        return (type(obj).__name__, _canonical({k: getattr(obj, k) for k in slots}))
    if hasattr(obj, "__dict__") and not isinstance(obj, type):
        return (type(obj).__name__, _canonical(dict(vars(obj))))
    return obj


def _streams(model, samples, **kw):
    modes = {"forked": dict(parallelize=True, use_multiprocessing=True),
             "threads": dict(parallelize=True, use_multiprocessing=False),
             "sequential": dict(parallelize=False)}
    return {mode: [_canonical(s) for s in model.tensorize_dataset(iter(samples), **args, **kw)]
            for mode, args in modes.items()}


G2C = dict(hidden_state_size=16, num_minibatches=1, minibatch_size=8)


def _g2c_samples():
    return list(synthetic_typilus_graphs(40, seed=3, mean_nodes=60, max_nodes=300))


MAX_NODES_PER_GRAPH = 62  # larger graphs are dropped: tensorize returns None


def test_forked_stream_equals_the_thread_pool_the_sequential_and_jax_graph2class():
    from ptgnn_tpu.implementations.typilus.harness import build_graph2class as jax_build
    from ptgnn_tpu.implementations.typilus.harness import small_padding as jax_small_padding
    from ptgnn_tpu.utils.synthetic import synthetic_typilus_graphs as jax_graphs

    model, _, _ = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **G2C)
    jmodel, _, _, _ = jax_build(padding=jax_small_padding(max_nodes=256), **G2C)
    samples = _g2c_samples()
    assert samples == list(jax_graphs(40, seed=3, mean_nodes=60, max_nodes=300))
    model.gnn_model.max_nodes_per_graph = jmodel.gnn_model.max_nodes_per_graph = MAX_NODES_PER_GRAPH
    got = _streams(model, samples, return_input_data=True)
    want = [_canonical(s) for s in jmodel.tensorize_dataset(iter(samples), parallelize=True,
                                                             use_multiprocessing=True, return_input_data=True)]
    assert 0 < len(want) < len(samples)  # some samples were dropped
    assert got["forked"] == got["threads"] == got["sequential"] == want


def test_forked_stream_equals_the_thread_pool_the_sequential_and_jax_ppi():
    from ptgnn_tpu.graph.structs import BatchPadding as JaxBatchPadding
    from ptgnn_tpu.implementations.ppi.dataloader import PPIGraphSample as JaxSample
    from ptgnn_tpu.implementations.ppi.train import create_ppi_gnn_model as jax_create
    from ptgnn_tpu.utils.synthetic import synthetic_ppi_graphs as jax_synthetic
    from ptgnn_tpu_torch.graph.structs import BatchPadding
    from ptgnn_tpu_torch.implementations.ppi.harness import synthetic_ppi_samples
    from ptgnn_tpu_torch.implementations.ppi.train import create_ppi_gnn_model

    data = dict(mean_nodes=100, num_labels=16, edges_per_node=5)
    pad = dict(max_nodes=512, max_edge_slots=512 * 24, max_graphs=4, edge_tile=64)
    samples = synthetic_ppi_samples(8, 2, **data)
    jsamples = [JaxSample([np.asarray(g["edges"], np.int32)], g["features"], g["labels"].astype(bool))
                for g in jax_synthetic(8, seed=2, **data)]
    model = create_ppi_gnn_model(hidden_state_size=16, padding=BatchPadding(**pad))
    model.compute_metadata(iter(samples), parallelize=False)
    jmodel = jax_create(hidden_state_size=16, padding=JaxBatchPadding(**pad))
    jmodel.compute_metadata(iter(jsamples), parallelize=False)
    got = _streams(model, samples)
    want = [_canonical(s) for s in jmodel.tensorize_dataset(iter(jsamples), parallelize=True,
                                                             use_multiprocessing=True)]
    assert len(want) == 8
    assert got["forked"] == got["threads"] == got["sequential"] == want


def test_an_abandoned_forked_tensorize_leaves_no_live_child():
    model, _, _ = build_graph2class(padding=small_padding(max_nodes=256), device="cpu", **G2C)
    before = _live_children()
    endless = itertools.cycle(_g2c_samples())
    stream = model.tensorize_dataset(endless)  # the default: forked
    next(stream)
    started = _live_children() - before
    assert len(started) == 1
    stream.close()  # GeneratorExit at the yield: the child is terminated and joined
    assert not (_live_children() & started)

    # an early break out of minibatch_iterator, whose worker thread holds
    # the stream: the stream closes when the thread lets it go
    it = model.minibatch_iterator(model.tensorize_dataset(itertools.cycle(_g2c_samples())),
                                  max_minibatch_size=8, parallelize=True)
    for i, _ in enumerate(it):
        if i >= 2:
            break
    started = _live_children() - before
    assert len(started) == 1
    it.close()
    del it
    assert _wait_until(lambda: not (_live_children() & started)), "the forked tensorize child outlived its stream"


# ---------------------------------------------------------------------------
# The trainers
# ---------------------------------------------------------------------------
def _recording(cls):
    """``cls`` that records each training epoch's (loss sum, minibatches,
    samples)."""
    class Recording(cls):
        def _report_training_epoch(self, epoch, sum_epoch_loss, num_minibatches, num_samples, *rest):
            self.losses.append((sum_epoch_loss, num_minibatches, num_samples))
            return super()._report_training_epoch(epoch, sum_epoch_loss, num_minibatches, num_samples, *rest)

    return Recording


def _train_two_epochs(tmp_path, use_multiprocessing, cls=None, **kw):
    from ptgnn_tpu_torch.core.trainer import ModelTrainer
    from ptgnn_tpu_torch.implementations.typilus.train import create_graph2class_gnn_model

    model = create_graph2class_gnn_model(hidden_state_size=16, padding=small_padding(max_nodes=256))
    trainer = _recording(cls or ModelTrainer)(model, tmp_path / f"m-{use_multiprocessing}.pkl.gz", max_num_epochs=2,
                                              minibatch_size=8, clip_gradient_norm=1.0, device="cpu", seed=5, **kw)
    trainer.losses = []
    train = list(synthetic_typilus_graphs(24, seed=1, mean_nodes=60, max_nodes=200))
    valid = list(synthetic_typilus_graphs(8, seed=2, mean_nodes=60, max_nodes=200))
    trainer.train(train, valid, use_multiprocessing=use_multiprocessing, show_progress_bar=True, patience=5)
    return trainer.losses, {k: v.detach().clone() for k, v in trainer.neural_module.named_parameters()}


def test_two_epochs_forked_equal_the_thread_pool_bitwise(tmp_path):
    before = _live_children()
    forked_losses, forked = _train_two_epochs(tmp_path, True)
    assert not (_live_children() - before)  # every pass joined its child
    losses, params = _train_two_epochs(tmp_path, False)
    assert len(losses) == 2 and forked_losses == losses
    assert all(torch.equal(forked[k], params[k]) for k in params)


def test_distributed_trainer_at_world_one_takes_both_parameters(tmp_path):
    """``DistributedModelTrainer`` inherits ``train``: the forked tensorize
    and the progress bar reach its training pass (gloo, world 1, in this
    process), and the epochs equal those without the fork, bitwise."""
    import torch.distributed as dist

    from ptgnn_tpu_torch.parallel import DistributedModelTrainer, initialize_multi_host

    initialize_multi_host("gloo", f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        seen = []

        class Watching(DistributedModelTrainer):
            def _run_training(self, *args, **kwargs):
                seen.append(args[-1])  # show_progress_bar
                return super()._run_training(*args, **kwargs)

        forked_losses, forked = _train_two_epochs(tmp_path, True, cls=Watching, zero1=False)
        losses, params = _train_two_epochs(tmp_path, False, cls=Watching, zero1=False)
    finally:
        dist.destroy_process_group()
    assert seen == [True] * 4
    assert len(losses) == 2 and forked_losses == losses
    assert all(torch.equal(forked[k], params[k]) for k in params)
