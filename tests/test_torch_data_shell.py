"""The port's training data shell vs the JAX package (CPU): the loader's
worker pool and multi-process shards, packed uploads and the device
prefetcher.

* The pooled loader (2 spawned workers) gives the thread path's batches
  and the JAX loader's byte for byte, in order, over two shuffled epochs
  with a padded last batch (tests/test_data.py:581-621 holds JAX); a
  worker's exception reaches the consumer; the workers compute a cold
  feature cache with the plain log-mel on the CPU.
* ``process_index``/``process_count`` shards and ``iter_with_indices``
  equal the JAX loader's over a grid that includes short tails
  (tests/test_data.py:641-699).
* ``device_put_packed`` round trips are bit-equal, the unpacked leaves
  equal JAX ``unpack_batch(pack_batch(...))``'s, and the dtypes JAX does
  not pack upload leaf by leaf (tests/test_pack.py).
* ``DevicePrefetcher`` keeps tests/test_prefetch.py's cases on the CPU.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os
import threading
import time

import numpy as np
import pytest

import jax  # kept on the CPU by conftest
import torch

from corpus_fixture import make_dummy_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("shell_corpus"))
    make_dummy_corpus(root, n_clips=11)
    return root


def _assert_batches_equal(a, b):
    flat_a, flat_b = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


def _port_data(corpus, cache, num_workers=0, **kwargs):
    from voice100_tpu_torch.data import AudioTextDataModule

    args = dict(vocoder="mel", dataset="dummy_en", data_dir=corpus, cache_dir=cache,
                batch_size=4, valid_ratio=0.25, num_workers=num_workers, device="cpu")
    data = AudioTextDataModule(**{**args, **kwargs})
    data.setup("fit")
    return data


# --- the worker pool ---------------------------------------------------------

def test_pooled_epochs_equal_the_thread_path_and_jax(corpus, tmp_path):
    """11 clips, a quarter held out: 9 train clips in batches of 4, the
    last batch one real row and three repeats."""
    from voice100_tpu.data import AudioTextDataModule as JaxData

    cache = str(tmp_path / "cache")
    threaded = _port_data(corpus, cache).train_dataloader()
    for _ in threaded:  # a warm cache: both paths read the same entries
        pass
    pooled = _port_data(corpus, cache, num_workers=2).train_dataloader()
    jax_data = JaxData(vocoder="mel", dataset="dummy_en", data_dir=corpus, cache_dir=cache,
                       batch_size=4, valid_ratio=0.25)
    jax_data.setup("fit")
    reference = jax_data.train_dataloader()
    try:
        assert len(pooled) == len(threaded) == len(reference) == 3
        for epoch in range(2):
            for loader in (threaded, pooled, reference):
                loader.set_epoch(epoch)
            got = list(pooled.iter_with_counts())
            want = list(reference.iter_with_counts())
            assert [n for _, n in got] == [n for _, n in want] == [4, 4, 1]
            for (a, _), (b, _), c in zip(got, want, threaded):
                _assert_batches_equal(a, b)
                _assert_batches_equal(a, c)
            for (ia, a), (ib, b) in zip(pooled.iter_with_indices(),
                                        reference.iter_with_indices()):
                np.testing.assert_array_equal(ia, ib)
                _assert_batches_equal(a, b)
        assert pooled._executor is not None  # one pool across the epochs
    finally:
        pooled.close()
    assert pooled._executor is None


def test_workers_compute_cold_features_on_the_host(corpus, tmp_path):
    """A cold cache read by the pool: the workers run the plain log-mel on
    the CPU (the transform is moved there), one thread each; the entries
    are the in-process plain log-mel's within float16 rounding."""
    cold = _port_data(corpus, str(tmp_path / "cold"), num_workers=2)
    pooled = cold.train_dataloader()
    try:
        batches = list(pooled)
    finally:
        pooled.close()
    plain = _port_data(corpus, str(tmp_path / "plain")).train_dataloader()
    for (a, _), (b, _) in zip(batches, plain):
        np.testing.assert_allclose(a[0].astype(np.float32), b[0].astype(np.float32),
                                   rtol=1e-3, atol=1e-2)
        np.testing.assert_array_equal(a[1], b[1])


def test_pooled_world_analysis_equals_the_thread_path(corpus, tmp_path):
    """The cold WORLD analysis in 2 workers: the cache files are the thread
    path's byte for byte, and so are the batches. The WORLD dataset pickles
    past a pipe's buffer (its mcep matrices), so it reaches the workers
    through the loader's queue."""
    import pickle

    from voice100_tpu_torch.data import AudioTextDataModule

    runs = {}
    for workers in (0, 2):
        cache = tmp_path / f"world{workers}"
        data = AudioTextDataModule(vocoder="world_mcep", dataset="dummy_en", data_dir=corpus,
                                   cache_dir=str(cache), batch_size=4, valid_ratio=0.0,
                                   num_workers=workers, device="cpu")
        data.setup("fit")
        assert len(pickle.dumps(data.train_ds)) > 65536
        loader = data.train_dataloader()
        try:
            batches = list(loader)
        finally:
            loader.close()
        runs[workers] = (batches, {p.name: p.read_bytes() for p in sorted(cache.iterdir())})
    assert len(runs[0][1]) == 11 and runs[0][1] == runs[2][1]
    for a, b in zip(runs[0][0], runs[2][0]):
        _assert_batches_equal(a, b)


def test_worker_transform_moves_to_the_host():
    """The workers' initializer: one torch thread, the transform's device
    the CPU; a pickled WORLD vocoder carries no device tensor."""
    import pickle
    import queue

    from voice100_tpu_torch.data import loader
    from voice100_tpu_torch.data.transforms import (MelSpectrogramAudioTransform,
                                                    WORLDAudioProcessor)

    class Holder:
        audio_transform = MelSpectrogramAudioTransform(device="cpu")

    threads = torch.get_num_threads()
    state = queue.Queue()
    state.put((Holder(), None, True, 4))
    try:
        loader._worker_init(state)
        assert torch.get_num_threads() == 1
        assert loader._WORKER_STATE[0].audio_transform.device.type == "cpu"
    finally:
        torch.set_num_threads(threads)
        loader._WORKER_STATE = None
    world = WORLDAudioProcessor(16000, use_mcep=True, device="cpu")
    world.vocoder.decode_batch(np.full((1, 4), 120.0, np.float32),
                               np.zeros((1, 4, 25), np.float32), np.zeros((1, 4, 1), np.float32),
                               [4])
    assert world.vocoder._mc2sp32 is not None
    assert pickle.loads(pickle.dumps(world)).vocoder._mc2sp32 is None
    world.to_host()
    assert world.vocoder.device.type == "cpu" and world.vocoder._mc2sp32 is None


def test_a_worker_exception_reaches_the_consumer(tmp_path):
    root = str(tmp_path / "broken")
    make_dummy_corpus(root, n_clips=8)
    os.remove(os.path.join(root, "dummy-speech-en", "wavs", "clip0003.wav"))
    data = _port_data(root, str(tmp_path / "cache"), num_workers=2, valid_ratio=0.0)
    loader = data.train_dataloader()
    loader.shuffle = False
    try:
        with pytest.raises(Exception, match="clip0003"):
            list(loader)
    finally:
        loader.close()


# --- multi-process shards -----------------------------------------------------

class _Ids:
    """Item i is the row [i]."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i], np.int32)


def _stack(items):
    return np.stack(items)


@pytest.mark.parametrize("n,bs,pc", [(64, 4, 2), (13, 4, 2), (13, 3, 3), (5, 4, 3), (10, 2, 4)])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("bucketed", [False, True])
def test_process_shards_equal_jax(n, bs, pc, drop_last, bucketed):
    """Each process's batches, with their counts and indices, over two
    shuffled epochs: the port's loader against the JAX loader."""
    from voice100_tpu.data.loader import DataLoader as JaxLoader
    from voice100_tpu_torch.data.loader import DataLoader

    lengths = np.random.default_rng(n * bs).integers(3, 300, size=n)
    hint = (lambda i: int(lengths[i])) if bucketed else None
    for p in range(pc):
        kwargs = dict(batch_size=bs, collate_fn=_stack, shuffle=True, seed=7, prefetch=0,
                      drop_last=drop_last, process_index=p, process_count=pc, length_hint=hint)
        port, ref = DataLoader(_Ids(n), **kwargs), JaxLoader(_Ids(n), **kwargs)
        assert len(port) == len(ref)
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port.iter_with_counts()), list(ref.iter_with_counts())
            assert len(got) == len(want) == len(port)
            for (a, na), (b, nb) in zip(got, want):
                assert na == nb
                np.testing.assert_array_equal(a, b)
            for (ia, a), (ib, b) in zip(port.iter_with_indices(), ref.iter_with_indices()):
                np.testing.assert_array_equal(ia, ib)
                np.testing.assert_array_equal(a[:, 0], ia)


def test_process_shards_are_disjoint_and_make_the_global_batches():
    """The concatenated process batches of a step are the single-process
    batch of ``batch_size * process_count`` rows (test_data.py:641)."""
    from voice100_tpu_torch.data.loader import DataLoader

    n, bs, pc = 64, 4, 2
    shards = []
    for p in range(pc):
        loader = DataLoader(_Ids(n), bs, _stack, shuffle=True, seed=7, prefetch=0,
                            process_index=p, process_count=pc)
        shards.append([b[:, 0] for b in loader])
    flat = [set(np.concatenate(s).tolist()) for s in shards]
    assert flat[0].isdisjoint(flat[1]) and flat[0] | flat[1] == set(range(n))
    single = [b[:, 0] for b in DataLoader(_Ids(n), bs * pc, _stack, shuffle=True, seed=7,
                                          prefetch=0)]
    for k, batch in enumerate(single):
        np.testing.assert_array_equal(np.concatenate([shards[0][k], shards[1][k]]), batch)
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(_Ids(n), bs, _stack, process_index=2, process_count=2)


# --- packed uploads -----------------------------------------------------------

def _nested_batch(seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((4, 16, 8)).astype(np.float32),
             np.array([3, 9, 16, 2], np.int32)),
            (rng.standard_normal((4, 7)).astype(np.float16),
             np.arange(8, dtype=np.uint32).reshape(4, 2)))


def _assert_leaves_bitequal(got, want):
    flat_g, flat_w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        g = g.view(torch.uint16).numpy() if g.dtype == torch.bfloat16 else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape and g.tobytes() == w.tobytes()


def test_pack_round_trip_is_bitequal_and_one_buffer():
    from voice100_tpu_torch.data.pack import ALIGN, device_put_packed, pack_batch

    batch = _nested_batch()
    out = device_put_packed(batch, "cpu")
    assert isinstance(out, tuple) and isinstance(out[0], tuple)
    _assert_leaves_bitequal(out, batch)
    assert [t.dtype for pair in out for t in pair] == [torch.float32, torch.int32,
                                                        torch.float16, torch.uint32]
    # every leaf is a view of the one packed buffer, at an aligned offset
    leaves = [t for pair in out for t in pair]
    assert len({t.untyped_storage().data_ptr() for t in leaves}) == 1
    assert all(t.storage_offset() * t.element_size() % ALIGN == 0 for t in leaves)
    packed, _ = pack_batch(batch)
    # 2048 + 16 bytes, 56 of float16 padded to 64, 32 of uint32
    assert packed.dtype == torch.uint8 and packed.numel() == 2048 + 16 + 64 + 32


@pytest.mark.parametrize("sizes", [(3, 5, 1), (1, 1, 1), (7, 0, 2)])
def test_pack_odd_offsets_and_empty_leaves(sizes):
    """Leaves of 2-, 4- and 1-row sizes that are no multiple of the
    alignment, and a leaf with no elements, round trip at aligned offsets."""
    from voice100_tpu_torch.data.pack import device_put_packed

    a, b, c = sizes
    rng = np.random.default_rng(sum(sizes))
    batch = [np.arange(a, dtype=np.float16), {"z": np.zeros((b, 3), np.float32),
                                              "n": rng.integers(0, 9, size=c).astype(np.int32)},
             np.zeros((0, 4), np.float32)]
    out = device_put_packed(batch, "cpu")
    assert isinstance(out, list) and set(out[1]) == {"z", "n"}
    _assert_leaves_bitequal(out, batch)
    assert out[2].shape == (0, 4)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["ml_dtypes", "torch"])
def test_pack_bf16_leaves_and_jax_unpack(as_tensor):
    """bf16 leaves (an ml_dtypes array or the trainer's CPU tensor) pack;
    the unpacked leaves equal JAX unpack_batch(pack_batch(...))'s."""
    import ml_dtypes

    from voice100_tpu.data.pack import pack_batch as jax_pack, unpack_batch as jax_unpack
    from voice100_tpu_torch.data.pack import device_put_packed, pack_batch

    x = np.linspace(-3, 3, 12, dtype=np.float32).reshape(3, 4).astype(ml_dtypes.bfloat16)
    batch = {"x": x, "n": np.array([3], np.int32)}
    packed, _ = pack_batch(batch)
    assert packed is not None and packed.numel() == 4 + 12 + 3 * 4 * 2
    jax_out = jax_unpack(jax.device_put(jax_pack(batch)[0]), jax_pack(batch)[1])
    if as_tensor:
        batch = {"x": torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16), "n": batch["n"]}
    out = device_put_packed(batch, "cpu")
    assert out["x"].dtype == torch.bfloat16
    _assert_leaves_bitequal(out, jax_out)
    _assert_leaves_bitequal(device_put_packed(_nested_batch(3), "cpu"),
                            jax_unpack(jax.device_put(jax_pack(_nested_batch(3))[0]),
                                       jax_pack(_nested_batch(3))[1]))


@pytest.mark.parametrize("leaf", [np.array([True, False, True]), np.arange(4, dtype=np.uint8),
                                  np.arange(4, dtype=np.int16), np.arange(4, dtype=np.int64)],
                         ids=["bool", "uint8", "int16", "int64"])
def test_pack_fallback_dtypes_upload_leaf_by_leaf(leaf):
    from voice100_tpu.data.pack import pack_batch as jax_pack
    from voice100_tpu_torch.data.pack import device_put_packed, pack_batch

    batch = (leaf, np.zeros(2, np.float32))
    assert pack_batch(batch) == (None, None) == jax_pack(batch)
    out = device_put_packed(batch, "cpu")
    np.testing.assert_array_equal(out[0].numpy(), leaf)
    assert out[0].untyped_storage().data_ptr() != out[1].untyped_storage().data_ptr()


# --- device prefetch ------------------------------------------------------------

def _prefetcher(source, **kwargs):
    from voice100_tpu_torch.data.prefetch import DevicePrefetcher

    return DevicePrefetcher(source, device="cpu", **kwargs)


def test_prefetch_yields_in_order_with_place():
    seen = []

    def place(x):
        seen.append(x)
        return x * 10

    assert list(_prefetcher(range(7), size=2, place=place)) == [i * 10 for i in range(7)]
    assert seen == list(range(7))


def test_prefetch_default_place_is_the_packed_upload():
    batches = [(np.full((2, 3), i, np.float32), np.arange(2, dtype=np.int32)) for i in range(3)]
    out = list(_prefetcher(batches, size=2))
    assert all(isinstance(t, torch.Tensor) for pair in out for t in pair)
    np.testing.assert_array_equal(out[1][0].numpy(), batches[1][0])


def test_prefetch_early_close_releases_the_thread_and_the_source():
    closed = threading.Event()

    def gen():
        try:
            for i in range(100):
                yield i
        finally:
            closed.set()

    pf = _prefetcher(gen(), size=2, place=lambda x: x)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive() and closed.is_set()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_worker_exception_propagates():
    def bad():
        yield 1
        raise ValueError("decode failed")

    pf = _prefetcher(bad(), size=2, place=lambda x: x)
    assert next(pf) == 1
    with pytest.raises(ValueError, match="decode failed"):
        while True:
            next(pf)


def test_prefetch_overlaps_producer_and_consumer():
    """With a window of 2 the wall time nears max(producer, consumer),
    not their sum (0.64 s serial, ~0.36 s overlapped)."""
    def gen():
        for i in range(8):
            time.sleep(0.04)
            yield i

    start = time.perf_counter()
    n = 0
    for _ in _prefetcher(gen(), size=2, place=lambda x: x):
        time.sleep(0.04)
        n += 1
    assert n == 8 and time.perf_counter() - start < 0.55


def test_prefetch_runs_on_cuda_unless_asked_for_the_cpu():
    from voice100_tpu_torch.data.prefetch import DevicePrefetcher

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePrefetcher(range(3))
    with pytest.raises(ValueError, match="size"):
        _prefetcher(range(3), size=0)
