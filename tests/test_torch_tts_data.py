"""Port TTS data path (WORLD features, the two data modules, calc_stat,
the TTS CLI drive) vs the JAX package (CPU).

The port's WORLD analysis is the JAX package's host analysis copied
(tests/test_torch_world_analysis.py), and its cache, collates and split
follow the JAX package's, so batches are held byte for byte: both
``AudioTextDataModule`` vocoders (``world_mcep``, and ``world`` with its
mcep round trip) with aligned text, and ``AlignTextDataModule``, on the
dummy corpus with its align file. ``calc_stat`` is held within rtol 1e-6
(float64 sums of float32 features; the JAX package reads the same batches
but may add in another order where numpy pairs differently, which it
does not here: measured equal). The port's drive of
``tests/test_tools.py:107`` (calc_stat -> fit align -> fit tts ->
validate -> predict, ``--device cpu``) writes predictions whose keys and
shapes equal the JAX ``_run_predict``'s on the same weights, their values
within 1e-4 (the models' float32 forward, as in test_torch_tts.py).
"""

import os

import numpy as np
import pytest
import yaml

import jax
import torch

from corpus_fixture import make_dummy_corpus

N_CLIPS = 11


def _assert_batches_equal(a, b):
    flat_a, flat_b = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tts_data") / "data")
    make_dummy_corpus(root, n_clips=N_CLIPS)
    return root


def _modules(corpus, cache_dir, vocoder="world_mcep", **extra):
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu_torch.data import AudioTextDataModule

    kwargs = dict(vocoder=vocoder, dataset="dummy_en", data_dir=corpus, use_align=True,
                  batch_size=3, **extra)
    return (AudioTextDataModule(**kwargs, cache_dir=os.path.join(cache_dir, "port"), device="cpu"),
            JaxData(**kwargs, cache_dir=os.path.join(cache_dir, "jax")))


@pytest.mark.parametrize("vocoder", ["world_mcep", "world"])
def test_world_datamodule_matches_jax_batches(corpus, tmp_path, vocoder):
    port, ref = _modules(corpus, str(tmp_path), vocoder)
    assert port.cache_salt == ref.cache_salt and port.cache_dtype is ref.cache_dtype is None
    assert (port.audio_size, port.vocab_size) == (ref.audio_size, ref.vocab_size)
    for stage in (None, "predict"):
        ref.setup(stage)
        port.setup(stage)
    assert len(port.train_ds) == len(ref.train_ds) == 10 and len(port.valid_ds) == 1
    for make in ("predict_dataloader", "train_dataloader", "val_dataloader"):
        want = list(getattr(ref, make)().iter_with_counts())
        got = list(getattr(port, make)().iter_with_counts())
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            _assert_batches_equal(a, b)
    (f0, f0_len, spc, codeap), (text, text_len) = got[0][0]
    assert f0.dtype == spc.dtype == codeap.dtype == np.float32
    assert spc.shape[2] == port.audio_size - 2 and f0.shape[1] % 64 == 0


def test_align_datamodule_matches_jax_batches(corpus):
    from voice100_tpu.data import AlignTextDataModule as JaxAlign
    from voice100_tpu_torch.data import AlignTextDataModule
    from voice100_tpu_torch.data.collate import collate_text_align

    kwargs = dict(data_dir=corpus, dataset="dummy_en", batch_size=4, valid_ratio=0.3)
    port, ref = AlignTextDataModule(**kwargs), JaxAlign(**kwargs)
    assert port.vocab_size == ref.vocab_size and port.collate_fn is collate_text_align
    for stage in ("fit", "predict"):
        ref.setup(stage)
        port.setup(stage)
    assert len(port.train_ds) == len(ref.train_ds) == 8 and len(port.valid_ds) == 3
    for make in ("train_dataloader", "val_dataloader", "predict_dataloader"):
        loaders = getattr(port, make)(), getattr(ref, make)()
        loaders[0].set_epoch(1)
        loaders[1].set_epoch(1)
        got, want = (list(loader.iter_with_counts()) for loader in loaders)
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            _assert_batches_equal(a, b)
    (text, _), (align, align_len) = got[0][0]
    assert align.shape[1] == 2 * text.shape[1]  # durations pad to twice the text bucket


def test_collates_and_buckets_match_jax(monkeypatch):
    from voice100_tpu.data import collate as jc
    from voice100_tpu_torch.data import collate as tc

    rng = np.random.default_rng(0)
    world = [((rng.standard_normal(n).astype(np.float32),
               rng.standard_normal((n, 25)).astype(np.float32),
               rng.standard_normal((n, 1)).astype(np.float32)),
              rng.integers(1, 29, m).astype(np.int32)) for n, m in ((70, 9), (3, 40), (128, 1))]
    aligns = [(rng.integers(1, 29, m).astype(np.int32), rng.integers(0, 9, 2 * m + 1)
               .astype(np.int32)) for m in (9, 40, 1)]
    for kwargs in ({}, {"time_bucket": 32, "text_bucket": 8}):
        _assert_batches_equal(tc.collate_world_text(world, **kwargs),
                              jc.collate_world_text(world, **kwargs))
        text_kwargs = {k: v for k, v in kwargs.items() if k == "text_bucket"}
        _assert_batches_equal(tc.collate_text_align(aligns, **text_kwargs),
                              jc.collate_text_align(aligns, **text_kwargs))
    for fn in ("collate_audio_text", "collate_world_text", "collate_text_align"):
        assert getattr(tc, fn).pad_values == getattr(jc, fn).pad_values
        assert getattr(tc, fn).var_specs == getattr(jc, fn).var_specs
    for n in (1, 31, 32, 33, 97):
        assert tc.bucket_extent("align", n) == jc.bucket_extent("align", n)
    assert tc.get_collate_fn("world") is tc.get_collate_fn("world_mcep") is tc.collate_world_text
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 9"):
        tc.get_collate_fn("world_mcep", use_target=True)


@pytest.mark.parametrize("sample_rate", [16000, 22050])
@pytest.mark.parametrize("vocoder", ["mel", "world", "world_mcep"])
def test_cache_salt_equals_jax(sample_rate, vocoder):
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu_torch.data import AudioTextDataModule

    kwargs = dict(vocoder=vocoder, sample_rate=sample_rate)
    port, ref = AudioTextDataModule(**kwargs, device="cpu"), JaxData(**kwargs)
    assert (port.cache_salt, port.cache_dtype) == (ref.cache_salt, ref.cache_dtype)
    if vocoder != "mel":
        assert b"@ap-harmonic1" in port.cache_salt and port.cache_salt.startswith(b"world")
        assert port.audio_size == ref.audio_size


def test_cold_and_warm_items_equal_and_the_mcep_round_trip(corpus, tmp_path):
    """A cold read (analysis, then the write) equals every warm read and the
    JAX package's warm read of the same files; ``world`` and
    ``world_mcep`` share the cache, the log spectrum rebuilt from the mcep
    entry on every read; frame counts come from the npz headers."""
    from voice100_tpu.dsp.mcep import create_mc2sp_matrix
    from voice100_tpu_torch.data import AudioTextDataModule

    cache = str(tmp_path / "cache")
    mods = {v: AudioTextDataModule(vocoder=v, dataset="dummy_en", data_dir=corpus,
                                   cache_dir=cache, use_align=True, device="cpu")
            for v in ("world", "world_mcep")}
    for mod in mods.values():
        mod.setup("predict")
    world, mcep = mods["world"].predict_ds, mods["world_mcep"].predict_ds
    assert world.audio_frames(0) is None  # not cached yet
    cold = [world[i][0] for i in range(N_CLIPS)]
    files = sorted(os.listdir(cache))
    assert len(files) == N_CLIPS and all(f.endswith(".npz") for f in files)
    warm = [world[i][0] for i in range(N_CLIPS)]
    shared = [mcep[i][0] for i in range(N_CLIPS)]
    assert sorted(os.listdir(cache)) == files  # world_mcep computed nothing
    mc2sp = create_mc2sp_matrix(512, 24, 0.410).astype(np.float32)
    _, ref = _modules(corpus, str(tmp_path), "world")
    ref.cache_dir = cache
    ref.setup("predict")
    for i in range(N_CLIPS):
        _assert_batches_equal(cold[i], warm[i])
        _assert_batches_equal(warm[i], ref.predict_ds[i][0])
        assert cold[i][1].shape[1] == 257 and shared[i][1].shape[1] == 25
        np.testing.assert_array_equal(cold[i][1], shared[i][1] @ mc2sp)
        np.testing.assert_array_equal(cold[i][0], shared[i][0])
        assert world.audio_frames(i) == mcep.audio_frames(i) == len(cold[i][0])
        assert world.audio_frames(i) == ref.predict_ds.audio_frames(i)
    # the loader's length buckets read those headers
    bucketed = AudioTextDataModule(vocoder="world_mcep", dataset="dummy_en", data_dir=corpus,
                                   cache_dir=cache, use_align=True, batch_size=3,
                                   bucket_by_length=True, device="cpu")
    bucketed.setup("fit")
    loader = bucketed.train_dataloader()
    assert loader.length_hint is not None
    assert loader._bucketed_chunks(np.arange(len(bucketed.train_ds)), None) is not None


def test_calc_stat_matches_jax(corpus, tmp_path):
    from voice100_tpu.tools.calc_stat import calc_stat as jax_calc_stat
    from voice100_tpu_torch.tools.calc_stat import calc_stat

    port, ref = _modules(corpus, str(tmp_path))
    port.setup("predict")
    ref.setup("predict")
    got = calc_stat(port, str(tmp_path / "port.npz"))
    want = jax_calc_stat(ref, str(tmp_path / "jax.npz"))
    assert list(got) == list(want)
    on_disk = dict(np.load(tmp_path / "port.npz"))
    for key in want:
        assert got[key].dtype == np.float32 and got[key].shape == want[key].shape
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6)
        np.testing.assert_array_equal(on_disk[key], got[key])
    assert (got["logspc_std"] > 0).all() and got["f0_mean"][0] > 30


def _tiny_configs(workdir, data_dir, cache_dir):
    callbacks = [{"class_path": "ModelCheckpoint", "init_args": {"monitor": "train_loss"}}]
    configs = {
        "align": {"model": {"class_path": "voice100_tpu.models.TextToAlignText",
                            "init_args": {"vocab_size": 29, "num_layers": 1, "hidden_size": 16,
                                          "num_outputs": 2}},
                  "data": {"class_path": "voice100_tpu.data.AlignTextDataModule",
                           "init_args": {"dataset": "dummy_en", "language": "en",
                                         "batch_size": 3, "data_dir": data_dir}}},
        "tts": {"model": {"class_path": "voice100_tpu.models.AlignTextToAudio",
                          "init_args": {"vocab_size": 29, "logspc_size": 25, "codeap_size": 1,
                                        "encoder_num_layers": 1, "encoder_hidden_size": 16,
                                        "decoder_settings": [[16, False, 3, 1, 1, False],
                                                             [16, True, 5, 2, 2, False]]}},
                "data": {"class_path": "voice100_tpu.data.AudioTextDataModule",
                         "init_args": {"vocoder": "world_mcep", "dataset": "dummy_en",
                                       "language": "en", "use_align": True, "batch_size": 3,
                                       "data_dir": data_dir, "cache_dir": cache_dir}}},
    }
    paths = {}
    for name, config in configs.items():
        config.update({"seed_everything": 1234, "trainer": {
            "max_epochs": 1, "gradient_clip_val": 1.0, "callbacks": callbacks}})
        paths[name] = str(workdir / f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(config, f)
    return paths


def test_world_pipeline_through_the_cli(corpus, tmp_path, capsys):
    """The port's drive of tests/test_tools.py:107 on the CPU: calc_stat,
    fit align, fit tts with --audio_stat (the statistics reach the model,
    no identity warning), validate (the last epoch's loss on last.pt,
    train_loss monitored), predict; the .npz predictions of both models
    against the JAX CLI's _run_predict on the same weights."""
    from voice100_tpu.data import AlignTextDataModule as JaxAlign
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.training.cli import _MODEL_CLASSES, _filter_kwargs
    from voice100_tpu.training.cli import _run_predict as jax_run_predict
    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main
    from voice100_tpu_torch.tools.weights import to_jax_variables
    from voice100_tpu_torch.training.cli import build_from_config, load_config, main
    from voice100_tpu_torch.training.checkpoint import load_model_weights

    cache_dir = str(tmp_path / "cache")
    stat_path = str(tmp_path / "stat.npz")
    stat_main(["--output", stat_path, "--dataset", "dummy_en", "--vocoder", "world_mcep",
               "--data_dir", corpus, "--cache_dir", cache_dir, "--batch_size", "3",
               "--device", "cpu"])
    stats = dict(np.load(stat_path))
    assert stats["logspc_mean"].shape == (25,) and (stats["logspc_std"] > 0).all()
    paths = _tiny_configs(tmp_path, corpus, cache_dir)
    results, runs = {}, {}
    for name, extra in (("align", []), ("tts", ["--audio_stat", stat_path])):
        ckpt = str(tmp_path / f"{name}_ckpt")
        log = str(tmp_path / f"{name}.jsonl")
        common = ["--config", paths[name], "--checkpoint_dir", ckpt, "--device", "cpu"]
        main(["fit", *common, "--log_path", log, *extra])
        records = [yaml.safe_load(line) for line in open(log)]
        assert not [r for r in records if r.get("event") == "warning"]
        epoch = [r for r in records if "train_time_s" in r][-1]
        last = os.path.join(ckpt, "last.pt")
        results[name] = main(["validate", *common, "--restore_from", last])
        np.testing.assert_allclose(results[name]["loss"], epoch["val_loss"], rtol=1e-5)
        out = str(tmp_path / f"{name}_pred")
        main(["predict", *common, "--restore_from", last, "--output", out])
        runs[name] = (last, out + ".npz")
    assert {"loss", "hasf0_loss", "f0_loss", "logspc_loss", "hascodeap_loss",
            "codeap_loss"} <= set(results["tts"])
    assert "Traceback" not in capsys.readouterr().err

    for name, key, n_items in (("align", "durations", N_CLIPS), ("tts", "f0", N_CLIPS)):
        last, npz = runs[name]
        config = load_config(paths[name])
        model, data = build_from_config(config, {}, device="cpu")
        load_model_weights(last, model)
        if name == "tts":
            np.testing.assert_array_equal(model.norm.f0_std.numpy(), stats["f0_std"])
        settings_ = model.decoder_settings if name == "tts" else None
        variables = to_jax_variables(model.state_dict(), settings_)
        jax_cls = _MODEL_CLASSES[config["model"]["class_path"].rsplit(".", 1)[-1]]
        jax_model = jax_cls(**_filter_kwargs(jax_cls, dict(config["model"]["init_args"])))
        jax_data = (JaxData if name == "tts" else JaxAlign)(**config["data"]["init_args"])
        jax_data.setup("predict")
        jax_out = str(tmp_path / f"{name}_jax")
        jax_run_predict(jax_model, variables, jax_data, jax_data.predict_dataloader(), jax_out)
        got, want = dict(np.load(npz, allow_pickle=True)), dict(np.load(jax_out + ".npz",
                                                                        allow_pickle=True))
        assert sorted(got) == sorted(want) and len(got[key]) == n_items
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype == object
            for g, w in zip(got[k], want[k]):
                assert g.shape == w.shape
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(1.0, np.abs(w).max()))
