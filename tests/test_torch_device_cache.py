"""The port's device feature cache and multi-step dispatch vs the JAX
package (CPU).

* ``DeviceFeatureCache`` keeps tests/test_device_cache.py:32-377's cases
  on the port's cache (``device="cpu"``): gathers equal host collation
  and the JAX cache's gathers on the same loader; bucketed growth and
  slicing; the ``drop_last`` self-heal; ``max_bytes`` and layout drift
  errors; ``epoch_plan`` gives JAX's groups, extents and index matrices.
* The trainer: ``device_cache=True, steps_per_dispatch=k`` over 3 epochs
  equals the port's own per-step run bit for bit, augmentation and
  dropout on (float32 and bf16 uploads); with both off, its losses equal
  the JAX trainer's at the same settings within tests/test_torch_train.py's
  rtol 1e-4; the CLI takes the settings and ``num_workers``.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json

import numpy as np
import pytest

import jax  # kept on the CPU by conftest
import jax.numpy as jnp
import torch

from corpus_fixture import make_dummy_corpus

SETTINGS = ((16, False, 3, 2, 1, False),)
HIDDEN = 16
LOSS_RTOL = 1e-4  # tests/test_torch_train.py's trajectory tolerance


class _Ids:
    """Item i is [i, 2 i]: rows name their dataset index."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.asarray([i, i * 2], np.int32)


def _stack(items):
    return np.stack(items)


def _loaders(ds, **kwargs):
    """The port's loader and the JAX loader, alike."""
    from voice100_tpu.data import DataLoader as JaxLoader
    from voice100_tpu_torch.data import DataLoader

    kwargs = dict(prefetch=0, **kwargs)
    return DataLoader(ds, **kwargs), JaxLoader(ds, **kwargs)


def _cache(n, **kwargs):
    from voice100_tpu_torch.data import DeviceFeatureCache

    return DeviceFeatureCache(n, device="cpu", **kwargs)


def _leaves_equal(got, want):
    got, want = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_iter_with_indices_matches_rows():
    port, ref = _loaders(_Ids(13), batch_size=4, collate_fn=_stack, shuffle=True, seed=5)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        seen = []
        for (idx, batch), (jidx, jbatch) in zip(port.iter_with_indices(), ref.iter_with_indices()):
            assert idx.shape[0] == batch.shape[0] == 4
            np.testing.assert_array_equal(batch[:, 0], idx)
            np.testing.assert_array_equal(idx, jidx)
            seen.extend(idx.tolist())
        assert set(seen) == set(range(13))


def test_gathers_equal_upload_host_collation_and_jax():
    """Epoch 0 uploads and scatters; epochs 1 and 2 gather; every batch
    equals the host's collation and the JAX cache's batch."""
    from voice100_tpu.data.device_cache import DeviceFeatureCache as JaxCache

    n = 16
    port, ref = _loaders(_Ids(n), batch_size=4, collate_fn=_stack, shuffle=True, seed=3)
    cache, jax_cache = _cache(n), JaxCache(n)
    port.set_epoch(0)
    ref.set_epoch(0)
    warm = [b.clone() for b in cache.epoch_batches(port)]
    list(jax_cache.epoch_batches(ref))
    assert cache.complete and cache.nbytes() == n * 2 * 4
    assert all(b.dtype == torch.int32 for b in warm)
    for epoch in (1, 2):
        for loader in (port, ref):
            loader.set_epoch(epoch)
        host = [b for _, b in port.iter_with_indices()]
        dev = list(cache.epoch_batches(port))
        want = list(jax_cache.epoch_batches(ref))
        assert len(host) == len(dev) == len(want) == 4
        for h, d, w in zip(host, dev, want):
            np.testing.assert_array_equal(d.numpy(), h)
            np.testing.assert_array_equal(d.numpy(), np.asarray(w))


def test_cache_self_heals_drop_last():
    n = 10
    port, _ = _loaders(_Ids(n), batch_size=4, collate_fn=_stack, shuffle=True, seed=1,
                       drop_last=True)
    cache = _cache(n)
    port.set_epoch(0)
    list(cache.epoch_batches(port))
    assert not cache.complete  # 2 batches of 4: at most 8 of 10 rows
    for epoch in range(1, 6):
        port.set_epoch(epoch)
        for got, (_, host) in zip(cache.epoch_batches(port), port.iter_with_indices()):
            np.testing.assert_array_equal(got.numpy(), host)
        if cache.complete:
            break
    assert cache.complete


def test_nested_batches():
    class Pairs(_Ids):
        def __getitem__(self, i):
            return np.full((3, 2), i, np.float32), np.asarray([i], np.int32)

    def collate(items):
        return np.stack([a for a, _ in items]), np.stack([b for _, b in items])

    port, _ = _loaders(Pairs(8), batch_size=4, collate_fn=collate, shuffle=True, seed=2)
    cache = _cache(8)
    port.set_epoch(0)
    list(cache.epoch_batches(port))
    port.set_epoch(1)
    host = [b for _, b in port.iter_with_indices()]
    for (hf, hi), got in zip(host, cache.epoch_batches(port)):
        assert isinstance(got, tuple)
        np.testing.assert_array_equal(got[0].numpy(), hf)
        np.testing.assert_array_equal(got[1].numpy(), hi)


class _VarLen:
    """Item i is (audio [T_i, 3] filled with i, text [L_i] filled with i + 1)."""

    def __init__(self, lengths):
        self.lengths = list(lengths)

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        t, n = self.lengths[i]
        return np.full((t, 3), i, np.float32), np.full((n,), i + 1, np.int64)


def test_bucketed_collate_grows_the_store_and_slices_gathers(monkeypatch):
    """Real bucketed collation (batches of several extents): the store
    grows to the largest bucket with the pad values (log 1e-6 for audio)
    and every gathered batch equals host collation at its own bucket."""
    from voice100_tpu_torch.data.collate import collate_audio_text

    monkeypatch.setenv("VOICE100_TPU_TIME_BUCKET", "4")
    monkeypatch.setenv("VOICE100_TPU_TEXT_BUCKET", "2")
    lengths = [(3, 1), (7, 3), (12, 6), (5, 2), (20, 10), (9, 4), (14, 7), (2, 1), (17, 8),
               (6, 3), (11, 5), (4, 2)]
    ds = _VarLen(lengths)
    port, _ = _loaders(ds, batch_size=4, collate_fn=collate_audio_text, shuffle=True, seed=7)
    cache = _cache(len(ds), pad_values=collate_audio_text.pad_values)
    port.set_epoch(0)
    list(cache.epoch_batches(port))
    assert cache.complete and cache.store[0][0].shape[1] == 20
    shapes = set()
    for epoch in (1, 2, 3):
        port.set_epoch(epoch)
        host = [b for _, b in port.iter_with_indices()]
        for h, d in zip(host, cache.epoch_batches(port)):
            shapes.add((h[0][0].shape[1], h[1][0].shape[1]))
            _leaves_equal(d, jax.tree_util.tree_map(torch.from_numpy, h))
    assert len(shapes) > 1, shapes


def test_max_bytes_raises_before_allocating():
    port, _ = _loaders(_Ids(1000), batch_size=4, collate_fn=_stack)
    cache = _cache(1000, max_bytes=100)
    with pytest.raises(ValueError, match="max_bytes"):
        next(iter(cache.epoch_batches(port)))
    assert cache.store is None


def test_layout_drift_raises():
    cache = _cache(8)
    cache.place(np.arange(4), np.zeros((4, 6), np.float32))
    with pytest.raises(ValueError, match="fixed collate bucket"):
        cache.place(np.arange(4), np.zeros((4, 7), np.float32))
    with pytest.raises(ValueError, match="drifted"):
        cache.place(np.arange(4), np.zeros((4, 6), np.int32))


def test_mesh_and_missing_cuda_raise():
    from voice100_tpu_torch.data import DeviceFeatureCache
    from voice100_tpu_torch.parallel import make_mesh

    assert DeviceFeatureCache(4, mesh=make_mesh(["cpu"])).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="one process a device \\(--distributed\\)"):
        DeviceFeatureCache(4, mesh=make_mesh(["cpu", "cpu"]))
    with pytest.raises(TypeError, match="mesh must be a voice100_tpu_torch.parallel.Mesh"):
        DeviceFeatureCache(4, mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            DeviceFeatureCache(4)


@pytest.mark.parametrize("seed", [0, 1])
def test_epoch_plan_equals_jax_and_gathers_equal_host_collation(monkeypatch, seed):
    """The plan's groups, extents and index matrices are JAX's; the
    flattened plan is the loader's epoch order; gathers at a group's
    extents equal host collation of the same items."""
    from voice100_tpu.data.collate import collate_audio_text as jax_collate
    from voice100_tpu.data.device_cache import DeviceFeatureCache as JaxCache
    from voice100_tpu_torch.data.collate import collate_audio_text

    monkeypatch.setenv("VOICE100_TPU_TIME_BUCKET", "8")
    monkeypatch.setenv("VOICE100_TPU_TEXT_BUCKET", "4")
    rng = np.random.RandomState(seed)
    lengths = [(int(rng.randint(3, 21)), int(rng.randint(2, 7))) for _ in range(24)]
    ds = _VarLen(lengths)
    kwargs = dict(batch_size=4, shuffle=True, seed=2, length_hint=lambda i: lengths[i][0])
    port, _ = _loaders(ds, collate_fn=collate_audio_text, **kwargs)
    _, ref = _loaders(ds, collate_fn=jax_collate, **kwargs)
    cache = _cache(len(ds), pad_values=collate_audio_text.pad_values,
                   var_specs=collate_audio_text.var_specs)
    jax_cache = JaxCache(len(ds), pad_values=jax_collate.pad_values,
                         var_specs=jax_collate.var_specs)
    port.set_epoch(0)
    ref.set_epoch(0)
    assert cache.epoch_plan(port) is None  # nothing cached yet
    list(cache.epoch_batches(port))
    list(jax_cache.epoch_batches(ref))
    for epoch in (1, 2):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        plan, want = cache.epoch_plan(port), jax_cache.epoch_plan(ref)
        assert len(plan) == len(want) and len({k[0][0] for k, _ in plan}) >= 2
        for (extents, mat), (jextents, jmat) in zip(plan, want):
            assert extents == tuple(tuple(e) for e in jextents)
            np.testing.assert_array_equal(mat, jmat)
        rows = [row for _, mat in plan for row in mat]
        chunks = [port._effective_indices(c) for c in port._epoch_index_chunks()]
        assert len(rows) == len(chunks)
        for row, chunk in zip(rows, chunks):
            np.testing.assert_array_equal(row, chunk)
        for extents, mat in plan:
            for row in mat:
                got = cache.gather_rows(cache.store, row, extents)
                host = collate_audio_text([ds[int(i)] for i in row])
                _leaves_equal(got, jax.tree_util.tree_map(torch.from_numpy, host))


def test_plan_needs_equal_rows():
    """Ragged batches (no pad_to_full, a short last batch) have no plan."""
    port, _ = _loaders(_Ids(10), batch_size=4, collate_fn=_stack, pad_to_full=False)
    cache = _cache(10)
    list(cache.epoch_batches(port))
    assert cache.complete and cache.epoch_index_matrix(port) is None
    assert cache.epoch_plan(port) is None


# --- the trainer ------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cache_corpus"))
    make_dummy_corpus(root, n_clips=12)
    return root


def _data(corpus, cache_dir, **kwargs):
    from voice100_tpu_torch.data import AudioTextDataModule

    args = dict(vocoder="mel", dataset="dummy_en", data_dir=corpus, cache_dir=cache_dir,
                batch_size=4, valid_ratio=0.0, device="cpu")
    return AudioTextDataModule(**{**args, **kwargs})


def _model(state_dict=None):
    from voice100_tpu_torch.models import AudioToAlignText

    model = AudioToAlignText(64, 29, SETTINGS, 1, HIDDEN, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _port_fit(corpus, tmp_path, tag, train=True, model=None, data_kwargs=None, **cfg):
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    log = str(tmp_path / f"{tag}.jsonl")
    trainer = Trainer(TrainerConfig(max_epochs=3, device_cache=True, log_path=log,
                                    log_every_n_steps=1, **cfg))
    if not train:  # augmentation and dropout off, as the JAX side runs
        step = trainer.train_step
        trainer.train_step = lambda task, state, batch, generator=None, train=True: step(
            task, state, batch, generator, False)
    model = model if model is not None else _model()
    state = trainer.fit(model, _data(corpus, str(tmp_path / "cache"), **(data_kwargs or {})))
    trainer.close()
    return state, _records(log), trainer


@pytest.mark.parametrize("upload_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [3, 2])
def test_chunked_fit_equals_the_per_step_fit_bit_for_bit(corpus, tmp_path, k, upload_dtype):
    """Epoch 0 warms the cache step by step; epochs 1 and 2 run chunks of
    k steps (k=2: a chunk of 2 and a tail of 1). The same batches in the
    same order and the same generator draws: equal weights and losses. The
    bf16 upload runs on a float32 feature cache (a float16 one is left as
    it is), so the store holds what the bf16 cast made."""
    bf16 = upload_dtype == "bfloat16"
    data_kwargs = {"cache_dtype": None} if bf16 else {}
    base, base_recs, _ = _port_fit(corpus, tmp_path, "step", upload_dtype=upload_dtype,
                                   data_kwargs=data_kwargs)
    chunked, recs, trainer = _port_fit(corpus, tmp_path, "chunk", steps_per_dispatch=k,
                                       upload_dtype=upload_dtype, data_kwargs=data_kwargs)
    dispatch = [r for r in recs if r.get("event") == "scan_dispatch"]
    assert dispatch == [{"event": "scan_dispatch", "steps_per_dispatch": k,
                         "batches_per_epoch": 3, "buckets": 1, "runs": 1}]
    assert not any(r.get("event") == "scan_dispatch" for r in base_recs)
    assert any(r.get("event") == "device_cache" for r in recs)
    store = jax.tree_util.tree_leaves(trainer.feature_cache.store)
    assert store[0].dtype == (torch.bfloat16 if bf16 else torch.float16)
    assert chunked.step == base.step == 9
    for (name, a), b in zip(base.model.state_dict().items(), chunked.model.state_dict().values()):
        assert torch.equal(a, b), name
    epoch_losses = [[r["train_loss"] for r in rs if "train_time_s" in r]
                    for rs in (base_recs, recs)]
    assert epoch_losses[0] == epoch_losses[1] and len(epoch_losses[0]) == 3
    step_losses = [r["train_loss"] for r in base_recs
                   if "train_loss" in r and "train_time_s" not in r]
    chunk_recs = [r for r in recs if "train_loss" in r and "train_time_s" not in r]
    # epoch 0 logs every step; a chunk logs its steps' mean at its last step
    chunks = [(step, step) for step in (1, 2, 3)]
    for first_step in (4, 7):
        chunks += [(first_step + b, first_step + min(b + k, 3) - 1) for b in range(0, 3, k)]
    assert [r["step"] for r in chunk_recs] == [last for _, last in chunks]
    for r, (first, last) in zip(chunk_recs, chunks):
        np.testing.assert_allclose(r["train_loss"], np.mean(step_losses[first - 1:last]),
                                   rtol=1e-6)


class _NoAugmentTask:
    """A JAX task whose loss runs with train=False: no augmentation or
    dropout in the JAX trainer's steps."""

    def __init__(self, task):
        self._task = task

    def __getattr__(self, name):
        return getattr(self._task, name)

    def loss(self, params, extra, batch, rng, train=True):
        return self._task.loss(params, extra, batch, rng, train=False)


def test_chunked_fit_losses_equal_the_jax_trainer(corpus, tmp_path, monkeypatch):
    """device_cache and steps_per_dispatch=3 on both sides, from the same
    weights, on the same cached features (the JAX package writes the
    cache, the port reads it), augmentation and dropout off."""
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.models import AudioToAlignText as JaxModel
    from voice100_tpu.parallel.mesh import make_mesh
    from voice100_tpu.training import Trainer as JaxTrainer, TrainerConfig as JaxConfig
    from voice100_tpu.training import trainer as jax_trainer_module
    from voice100_tpu_torch.tools.weights import from_jax_variables

    jax_model = JaxModel(audio_size=64, vocab_size=29, encoder_settings=SETTINGS,
                         decoder_num_layers=1, decoder_hidden_size=HIDDEN)
    variables = jax.tree_util.tree_map(np.asarray, jax_model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 21, 64)), jnp.asarray([21])))
    make_task = jax_trainer_module.make_task
    monkeypatch.setattr(jax_trainer_module, "make_task", lambda m: _NoAugmentTask(make_task(m)))
    log = str(tmp_path / "jax.jsonl")
    trainer = JaxTrainer(JaxConfig(max_epochs=3, device_cache=True, steps_per_dispatch=3,
                                   log_path=log, log_every_n_steps=1))
    trainer.mesh = make_mesh(jax.devices()[:1], data=1, model=1)
    trainer.fit(jax_model, JaxData(vocoder="mel", dataset="dummy_en", data_dir=corpus,
                                   cache_dir=str(tmp_path / "cache"), batch_size=4,
                                   valid_ratio=0.0), init_variables=variables)
    want = [r for r in _records(log) if "train_loss" in r]

    _, recs, _ = _port_fit(corpus, tmp_path, "port", train=False, steps_per_dispatch=3,
                           model=_model(from_jax_variables(variables)))
    got = [r for r in recs if "train_loss" in r]
    assert any(r.get("event") == "scan_dispatch" for r in recs)
    assert any(r.get("event") == "scan_dispatch" for r in _records(log))
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 3, 6, 6, 9, 9]
    np.testing.assert_allclose([r["train_loss"] for r in got], [r["train_loss"] for r in want],
                               rtol=LOSS_RTOL)


def test_device_cache_needs_a_loader():
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    batches = [((np.zeros((4, 8, 64), np.float32), np.full(4, 8, np.int32)),
                (np.ones((4, 2), np.int32), np.full(4, 2, np.int32)))]
    with pytest.raises(TypeError, match="device_cache needs a loader"):
        Trainer(TrainerConfig(device_cache=True)).fit(_model(), batches)


def test_cli_takes_the_cache_dispatch_and_worker_settings(corpus, tmp_path):
    """trainer: device_cache, device_cache_max_bytes, steps_per_dispatch and
    data: num_workers, prefetch reach the fit: the cache and the dispatch
    engage, with the batches read by two worker processes."""
    import yaml

    from test_torch_cli import tiny_config
    from voice100_tpu_torch.training.cli import build_trainer_config, cli_main, load_config

    cfg = tiny_config(tmp_path / "tiny.yaml", max_epochs=2, device_cache=True,
                      device_cache_max_bytes=10**9, steps_per_dispatch=2, log_every_n_steps=1)
    config = load_config(cfg)
    config["data"]["init_args"].update(num_workers=2, prefetch=1)
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    tc = build_trainer_config(config, {})
    assert (tc.device_cache, tc.device_cache_max_bytes, tc.steps_per_dispatch) == (True, 10**9, 2)
    log = tmp_path / "log.jsonl"
    cli_main(["fit", "--config", cfg, "--data_dir", corpus, "--cache_dir", str(tmp_path / "c"),
              "--checkpoint_dir", str(tmp_path / "ck"), "--log_path", str(log), "--device",
              "cpu"])
    records = _records(log)
    assert [r["items"] for r in records if r.get("event") == "device_cache"] == [9]
    assert [r["steps_per_dispatch"] for r in records if r.get("event") == "scan_dispatch"] == [2]
    epochs = [r for r in records if "train_time_s" in r]
    assert len(epochs) == 2 and all(np.isfinite(r["val_loss"]) for r in epochs)
    assert (tmp_path / "ck" / "last.pt").exists()
