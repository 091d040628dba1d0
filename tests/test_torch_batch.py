"""PyTorch port: trial batching, the prefetcher and the pipelined dataset path.

``io.batch`` against the JAX package's on the same NumPy trials:
``stack_trials`` and ``batch_iterator`` give the same padded data,
masks, lengths and names, and the same refusals.  ``device_prefetch``
with ``device="cpu"`` (the same producer thread and bounded queue as on
the card, without streams) keeps the order, runs at most
``buffer_size`` items ahead of the consumer, raises a producer's error
in the consumer and lets an early ``break`` release its producer.
``analyze_dataset_pipelined`` against the JAX package's on the same
loader table (``tests/test_dataset.py``'s pipelined cases), float64:
VAF within 1e-8, ``w``/``h`` within 1e-6, iteration counts equal (but
CD at rank 1, whose stop is rounding noise: ``tests/test_torch_dataset.py``),
and a staged ragged chunk reaching the batch preprocessing as the
tensors the prefetcher staged, never converted back to NumPy.
"""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_threads import one_torch_thread  # noqa: E402,F401
from torch_mesh_pool import no_leftover_group  # noqa: E402,F401

import muscle_synergies_tpu as mst  # noqa: E402
from muscle_synergies_tpu.io import batch as jbatch  # noqa: E402
from muscle_synergies_tpu.utils.config import PipelineConfig as JConfig  # noqa: E402
import muscle_synergies_tpu_torch as mt  # noqa: E402
from muscle_synergies_tpu_torch import dataset as tdataset  # noqa: E402
from muscle_synergies_tpu_torch.io import batch as tbatch  # noqa: E402
from muscle_synergies_tpu_torch.utils.config import PipelineConfig  # noqa: E402

CFG = dict(use_rms=True, rms_window_s=0.05, reduce_to=100)
CPU = dict(device="cpu")


def _trials(lengths=(40, 55, 40, 61, 48), l=3, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((n, l)) for n in lengths]


@pytest.mark.parametrize("pad_to", [None, 70])
def test_stack_trials_matches_jax(pad_to):
    trials = _trials()
    names = [f"t{i}" for i in range(len(trials))]
    want = jbatch.stack_trials(trials, pad_to=pad_to, names=names)
    got = tbatch.stack_trials(trials, pad_to=pad_to, names=names, **CPU)
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.names == want.names and got.batch_size == want.batch_size
    f32 = tbatch.stack_trials(trials, dtype=torch.float32, **CPU)
    assert f32.data.dtype == f32.mask.dtype == torch.float32


def test_batch_iterator_matches_jax():
    trials = _trials(lengths=(30, 41, 35, 50, 33, 44, 38))
    names = list("abcdefg")
    for drop in (False, True):
        want = list(jbatch.batch_iterator(trials, 3, drop_remainder=drop, names=names))
        got = list(tbatch.batch_iterator(trials, 3, drop_remainder=drop, names=names,
                                         **CPU))
        assert len(got) == len(want) == (2 if drop else 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
            np.testing.assert_array_equal(g.mask.numpy(), np.asarray(w.mask))
            np.testing.assert_array_equal(g.lengths, w.lengths)
            assert g.names == w.names


def test_names_for_trials_errors_match_jax():
    trials = _trials()
    for call in (lambda m, **kw: m.stack_trials(trials, names=["a"], **kw),
                 lambda m, **kw: list(m.batch_iterator(trials, 2, names=["a"], **kw))):
        with pytest.raises(ValueError) as want:
            call(jbatch)
        with pytest.raises(ValueError) as got:
            call(tbatch, **CPU)
        assert str(got.value) == str(want.value) == "got 1 names for 5 trials"


def test_sharding_is_not_ported():
    """``sharding=`` places the batch on a device mesh (here one gloo
    process; four in ``test_torch_parallel_dataset``)."""
    from muscle_synergies_tpu_torch.parallel import batch_sharding, make_mesh

    sharding = batch_sharding(make_mesh((1, 1), device="cpu"), time_sharded=True)
    plain = tbatch.stack_trials(_trials(), **CPU)
    placed = tbatch.stack_trials(_trials(), sharding=sharding, **CPU)
    assert torch.equal(placed.data.full_tensor(), plain.data)
    assert torch.equal(placed.mask.full_tensor(), plain.mask)
    staged = next(tbatch.device_prefetch(iter([plain.data.numpy()]), sharding=sharding,
                                         device="cpu"))
    assert torch.equal(staged.full_tensor(), plain.data)


def test_device_prefetch_keeps_order_and_stages_every_leaf():
    trials = _trials()
    batch = tbatch.stack_trials(trials, **CPU)
    items = [np.full(3, float(i)) for i in range(6)] + [
        {"x": [trials[0], (trials[1], "tag")], "b": batch}]
    got = list(tbatch.device_prefetch(iter(items), buffer_size=2, device="cpu"))
    for i in range(6):
        assert isinstance(got[i], torch.Tensor)
        np.testing.assert_array_equal(got[i].numpy(), items[i])
    last = got[-1]
    assert isinstance(last["x"][0], torch.Tensor) and last["x"][1][1] == "tag"
    np.testing.assert_array_equal(last["x"][1][0].numpy(), trials[1])
    assert last["b"].data is batch.data and last["b"].lengths is batch.lengths


class _Counting:
    """An iterable that records how many items have been pulled."""

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at, self.pulled = n, fail_at, 0

    def __iter__(self):
        for i in range(self.n):
            if i == self.fail_at:
                raise RuntimeError(f"producer failed at {i}")
            self.pulled += 1
            yield np.array([float(i)])


def _settle(source, seconds=0.3):
    time.sleep(seconds)
    return source.pulled


@pytest.mark.parametrize("buffer_size", [1, 2, 3])
def test_device_prefetch_runs_at_most_buffer_size_ahead(buffer_size):
    source = _Counting(20)
    gen = tbatch.device_prefetch(source, buffer_size=buffer_size, device="cpu")
    for consumed in range(1, 4):
        next(gen)
        # the queue holds buffer_size items and the producer one more
        assert _settle(source) == consumed + buffer_size + 1
    gen.close()


def test_device_prefetch_raises_the_producer_error():
    gen = tbatch.device_prefetch(_Counting(10, fail_at=3), buffer_size=2, device="cpu")
    assert [float(next(gen)[0]) for _ in range(3)] == [0.0, 1.0, 2.0]
    with pytest.raises(RuntimeError, match="producer failed at 3"):
        next(gen)
    gen.close()


def test_an_early_break_releases_the_producer():
    # the threads this call starts, not the process's count: producers of
    # earlier tests may end while this one waits
    before = set(threading.enumerate())
    source = _Counting(1000)
    for i, _ in enumerate(tbatch.device_prefetch(source, buffer_size=2, device="cpu")):
        if i == 2:
            break
    started = [t for t in threading.enumerate() if t not in before]
    deadline = time.time() + 5
    while any(t.is_alive() for t in started) and time.time() < deadline:
        time.sleep(0.05)
    assert not any(t.is_alive() for t in started), started
    assert source.pulled < 10


def _arrays(b=5, n=400, l=6):
    """``tests/test_dataset.py``'s pipelined trials."""
    rng = np.random.default_rng(7)
    return [np.maximum(np.abs(rng.standard_normal((n, 2))) @ rng.random((2, l))
                       + 0.02 * rng.random((n, l)), 0) for _ in range(b)]


def _same(got, want, rank1_cd=True):
    np.testing.assert_allclose(got.vaf_overall, want.vaf_overall, rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.vaf_per_channel, want.vaf_per_channel, rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got.w, want.w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.h, want.h, rtol=0, atol=1e-6)
    first = 1 if rank1_cd else 0  # CD at rank 1: see the module docstring
    np.testing.assert_array_equal(got.n_iter[first:], want.n_iter[first:])
    assert got.ranks == want.ranks and got.subjects == want.subjects
    assert got.sampling_frequency == want.sampling_frequency
    assert got.channel_names == want.channel_names


@pytest.mark.parametrize("chunk_files,prefetch", [(5, 2), (2, 2), (2, 1)])
def test_pipelined_matches_jax(chunk_files, prefetch):
    table = {f"t{i}": t for i, t in enumerate(_arrays())}
    kw = dict(ranks=(1, 2), max_iter=300, chunk_files=chunk_files, prefetch=prefetch,
              loader=table.__getitem__, subjects=["a", "a", "b", "b", "c"])
    want = mst.analyze_dataset_pipelined(list(table), 200, config=JConfig(**CFG), **kw)
    got = mt.analyze_dataset_pipelined(list(table), 200, config=PipelineConfig(**CFG),
                                       **kw, **CPU)
    _same(got, want)
    if chunk_files == len(table):  # one chunk: the one-shot result exactly
        one = mt.analyze_dataset(list(table.values()), 200, ranks=(1, 2), max_iter=300,
                                 config=PipelineConfig(**CFG), **CPU)
        np.testing.assert_array_equal(got.vaf_overall, one.vaf_overall)
        np.testing.assert_array_equal(got.w, one.w)


@pytest.mark.parametrize("rms", [True, False])
def test_pipelined_ragged_chunks_match_jax(rms):
    trials = _arrays()
    trials[1] = trials[1][:350]
    trials[4] = trials[4][:380]
    table = {f"t{i}": t for i, t in enumerate(trials)}
    cfg = CFG if rms else dict(reduce_to=100)
    kw = dict(ranks=(2,), solver="mu", max_iter=300, chunk_files=2,
              loader=table.__getitem__)
    want = mst.analyze_dataset_pipelined(list(table), 200, config=JConfig(**cfg), **kw)
    got = mt.analyze_dataset_pipelined(list(table), 200, config=PipelineConfig(**cfg),
                                       **kw, **CPU)
    _same(got, want, rank1_cd=False)


def test_real_captures_through_the_default_loader(tmp_path):
    from muscle_synergies_tpu.testing import write_synthetic_capture

    paths = [write_synthetic_capture(str(tmp_path / f"cap{i}.csv"), state_len=40,
                                     n_trechos=1, n_cycles=1, seed=50 + i)
             for i in range(3)]
    cfg = dict(use_rms=True, rms_window_s=0.02, reduce_to=50)
    kw = dict(ranks=(1, 2), max_iter=200, chunk_files=2, prefetch=1)
    want = mst.analyze_dataset_pipelined(paths, config=JConfig(**cfg), **kw)
    got = mt.analyze_dataset_pipelined(paths, config=PipelineConfig(**cfg), **kw, **CPU)
    _same(got, want)
    assert got.channel_names[0] == "VL" and got.sampling_frequency == 2000.0


def _raised(fn):
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


def test_pipelined_validation_matches_jax():
    table = {f"t{i}": t for i, t in enumerate(_arrays(b=2))}
    cases = [
        lambda m, **kw: m.analyze_dataset_pipelined([], 200, **kw),
        lambda m, **kw: m.analyze_dataset_pipelined(list(table), 200, chunk_files=0,
                                                    loader=table.__getitem__, **kw),
        lambda m, **kw: m.analyze_dataset_pipelined(list(table), 200, subjects=["a"],
                                                    loader=table.__getitem__, **kw),
    ]
    for case in cases:
        assert _raised(lambda: case(mt, **CPU)) == _raised(lambda: case(mst))
    # bare arrays carry no rate: sampling_frequency= is required
    assert _raised(lambda: mt.analyze_dataset_pipelined(
        list(table), config=PipelineConfig(**CFG), loader=table.__getitem__, **CPU)) == \
        _raised(lambda: mst.analyze_dataset_pipelined(
            list(table), config=JConfig(**CFG), loader=table.__getitem__))


def test_pipelined_sampling_rate_mismatch_matches_jax():
    class FakeCapture:
        def __init__(self, arr, fs):
            self.array, self.sampling_frequency = arr, fs

        @property
        def coords(self):
            return [f"M{j}" for j in range(self.array.shape[1])]

    trials = _arrays(b=2)
    table = {"a": FakeCapture(trials[0], 200.0), "b": FakeCapture(trials[1], 500.0)}
    kw = dict(ranks=(1,), max_iter=50, loader=table.__getitem__)
    got = _raised(lambda: mt.analyze_dataset_pipelined(
        list(table), config=PipelineConfig(**CFG), **kw, **CPU))
    assert got == _raised(lambda: mst.analyze_dataset_pipelined(
        list(table), config=JConfig(**CFG), **kw))
    assert "sampling rate" in got


def test_staged_ragged_chunk_enters_the_batch_preprocessing(monkeypatch):
    trials = _arrays(b=4)
    trials[1] = trials[1][:350]
    table = {f"t{i}": t for i, t in enumerate(trials)}
    staged, seen, to_host = [], [], []
    prefetch = tbatch.device_prefetch

    def spy_prefetch(*args, **kwargs):
        for item in prefetch(*args, **kwargs):
            staged.append(item)
            yield item

    def spy_preprocess(xs, mask, fs, config, *mesh):
        seen.append((xs, mask))
        return preprocess(xs, mask, fs, config, *mesh)

    def spy_to_numpy(x):
        to_host.append(tuple(getattr(x, "shape", ())))
        return to_numpy(x)

    preprocess, to_numpy = tdataset._preprocess_batch, tdataset.to_numpy
    monkeypatch.setattr(tbatch, "device_prefetch", spy_prefetch)
    monkeypatch.setattr(tdataset, "_preprocess_batch", spy_preprocess)
    monkeypatch.setattr(tdataset, "to_numpy", spy_to_numpy)
    mt.analyze_dataset_pipelined(list(table), 200, ranks=(2,), chunk_files=2,
                                 max_iter=50, config=PipelineConfig(**CFG),
                                 loader=table.__getitem__, **CPU)
    assert len(staged) == len(seen) == 2
    for (xs, mask), (sx, smask) in zip(seen, staged):
        assert xs is sx and mask is smask
    assert seen[0][1] is not None and seen[1][1] is None  # ragged, then equal
    assert seen[0][0].shape == (2, 400, 6)
    np.testing.assert_array_equal(seen[0][1].sum(1).numpy(), [400, 350])
    # the trials went through the loader's NumPy arrays only; nothing of
    # the staged batches' shape came back to the host
    assert not [s for s in to_host if len(s) == 3 and s[1] == 400]
