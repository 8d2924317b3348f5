"""Port data path vs the JAX package (CPU).

The port's collate, loader, registry, WAV I/O and resampler are copies or
ports of the JAX package's host code, so they are held to it exactly:
byte-equal batches, the same order under a seed, the same ``n_real``, the
same length buckets, the same corpus items. The port's log-mel transform
is held to JAX's within the log-mel bound of tests/test_torch_melspec.py
(rtol and atol 1e-4; noise clips, so every bin carries energy), and the
feature cache is shared: an entry either package writes, the other reads
back byte for byte.
"""

import os

import numpy as np
import pytest

import jax  # kept on the CPU by conftest

from corpus_fixture import make_dummy_corpus


def _items(seed=0, n=11, dim=3):
    """In-memory (feature, tokens) items of ragged lengths."""
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((int(rng.integers(5, 300)), dim)).astype(np.float16),
             rng.integers(1, 29, size=int(rng.integers(1, 40))).astype(np.int32))
            for _ in range(n)]


def _assert_batches_equal(a, b):
    flat_a, flat_b = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert len(flat_a) == len(flat_b)
    for x, y in zip(flat_a, flat_b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("buckets", [None, (64, 16), (32, 8)])
def test_collate_matches_jax_byte_for_byte(buckets):
    from voice100_tpu.data.collate import collate_audio_text as jax_collate
    from voice100_tpu_torch.data.collate import collate_audio_text

    items = _items()
    kwargs = {} if buckets is None else dict(time_bucket=buckets[0], text_bucket=buckets[1])
    _assert_batches_equal(collate_audio_text(items, **kwargs), jax_collate(items, **kwargs))


def test_bucket_extent_and_env_overrides_match_jax(monkeypatch):
    from voice100_tpu.data import collate as jc
    from voice100_tpu_torch.data import collate as tc

    for env in ({}, {"VOICE100_TPU_TIME_BUCKET": "100", "VOICE100_TPU_TEXT_BUCKET": "7"}):
        for key, value in env.items():
            monkeypatch.setenv(key, value)
        for kind in ("time", "text"):
            for n in (1, 15, 16, 17, 63, 64, 65, 640, 1001):
                assert tc.bucket_extent(kind, n) == jc.bucket_extent(kind, n)
    monkeypatch.setenv("VOICE100_TPU_TIME_BUCKET", "0")
    with pytest.raises(ValueError):
        tc.bucket_extent("time", 5)
    assert (tc.TIME_BUCKET, tc.TEXT_BUCKET) == (jc.TIME_BUCKET, jc.TEXT_BUCKET)
    assert tc.get_collate_fn("mel") is tc.collate_audio_text
    # the WORLD collates are ported (test_torch_tts_data.py); the multi-task
    # batches wait for the v1 models
    with pytest.raises(NotImplementedError, match="item 9"):
        tc.get_collate_fn("world_mcep", use_target=True)


class _Lengths:
    """Items whose feature length is known up front (the loader's
    length_hint), as the feature cache's headers give it."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def frames(self, i):
        return len(self.items[i][0])


@pytest.mark.parametrize("shuffle, drop_last, pad_to_full, bucketed", [
    (False, False, True, False), (True, False, True, False), (True, True, True, False),
    (True, False, False, False), (True, False, True, True), (True, True, True, True),
])
def test_loader_matches_jax_order_content_and_counts(shuffle, drop_last, pad_to_full, bucketed):
    from voice100_tpu.data.collate import collate_audio_text as jax_collate
    from voice100_tpu.data.loader import DataLoader as JaxLoader
    from voice100_tpu_torch.data.collate import collate_audio_text
    from voice100_tpu_torch.data.loader import DataLoader

    ds = _Lengths(_items(seed=1, n=23))
    kwargs = dict(batch_size=4, shuffle=shuffle, seed=7, drop_last=drop_last,
                  pad_to_full=pad_to_full, length_hint=ds.frames if bucketed else None)
    port = DataLoader(ds, collate_fn=collate_audio_text, **kwargs)
    ref = JaxLoader(ds, collate_fn=jax_collate, **kwargs)
    assert len(port) == len(ref)
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(port.iter_with_counts()), list(ref.iter_with_counts())
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            _assert_batches_equal(a, b)
        assert len(got) == len(want) == len(port)
        for a, b in zip(port, ref):                  # the background-thread path
            _assert_batches_equal(a, b)
    if bucketed:                                     # batches stay within a time bucket
        for (audio, audio_len), _ in port:
            assert audio.shape[1] in (128, 256, 384) or len(audio_len) < 4


def test_loader_worker_pool_is_not_ported():
    from voice100_tpu_torch.data.collate import collate_audio_text
    from voice100_tpu_torch.data.loader import DataLoader

    with pytest.raises(NotImplementedError, match="item 8"):
        DataLoader(_items(), 4, collate_audio_text, num_workers=2)


def _fake_corpora(root):
    """Minimal trees of each registry corpus but dummy (made by
    make_dummy_corpus): LibriSpeech, LJSpeech, CommonVoice ja, Kokoro."""
    libri = os.path.join(root, "LibriSpeech", "train-clean-100", "19", "198")
    os.makedirs(libri)
    with open(os.path.join(libri, "19-198.trans.txt"), "w") as f:
        f.write("19-198-0000 NORTHANGER ABBEY\n19-198-0001 THIS LITTLE WORK\n")
    for name, meta, line in (("LJSpeech-1.1", "metadata.csv", "LJ001-0001|Printing|printing\n"),
                             ("kokoro-speech-v1_2-tiny", "metadata.csv", "meian_0000|a|b\n")):
        os.makedirs(os.path.join(root, name))
        with open(os.path.join(root, name, meta), "w") as f:
            f.write(line)
    cv = os.path.join(root, "cv-corpus-12.0-2022-12-07", "ja")
    os.makedirs(cv)
    with open(os.path.join(cv, "validated.tsv"), "w") as f:
        f.write("client_id\tpath\tsentence\nx\tcommon_voice_ja_1.mp3\tこんにちは\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpora"))
    make_dummy_corpus(root, n_clips=5)
    _fake_corpora(root)
    return root


@pytest.mark.parametrize("name, flags", [
    ("dummy_en", {}), ("dummy_en", {"use_phone": True}), ("dummy_en", {"use_align": True}),
    ("dummy_en", {"use_align": True, "use_phone": True}),
    ("dummy_en", {"use_align": True, "use_target": True}), ("dummy_en,dummy_en", {}),
])
def test_registry_matches_jax(corpus, name, flags):
    from voice100_tpu.data.registry import get_dataset as jax_get
    from voice100_tpu_torch.data.registry import get_dataset

    got, want = get_dataset(corpus, name, "train", **flags), jax_get(corpus, name, "train", **flags)
    assert len(got) == len(want) > 0
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]


@pytest.mark.parametrize("name", ["librispeech", "ljspeech", "cv_ja", "kokoro_tiny"])
def test_base_corpora_match_jax(corpus, name):
    from voice100_tpu.data.registry import get_base_dataset as jax_get
    from voice100_tpu_torch.data.registry import get_base_dataset

    got, want = get_base_dataset(corpus, name, "train"), jax_get(corpus, name, "train")
    assert [got[i] for i in range(len(got))] == [want[i] for i in range(len(want))]
    with pytest.raises(ValueError):
        get_base_dataset(corpus, "no_such_corpus", "train")


def _noise_corpus(root, seconds=(0.37, 1.0, 1.61)):
    """dummy_en layout with noise clips under a slow envelope."""
    from voice100_tpu_torch.dsp.wav import write_wav

    rng = np.random.default_rng(5)
    wavs = os.path.join(root, "dummy-speech-en", "wavs")
    os.makedirs(wavs)
    lines = []
    for i, sec in enumerate(seconds):
        n = int(sec * 16000)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.3 * np.arange(n) / 16000)
        write_wav(os.path.join(wavs, f"c{i}.wav"),
                  (rng.standard_normal(n) * 4000 * env).astype(np.int16), 16000)
        lines.append(f"c{i}|text {i}|text {i}")
    with open(os.path.join(root, "dummy-speech-en", "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "dummy_en-train.txt"), "w") as f:
        f.write("\n".join(line.rsplit("|", 1)[0] for line in lines) + "\n")
    return root


def _datasets(root, cache_dir, cache_dtype):
    from voice100_tpu.data.registry import get_dataset
    from voice100_tpu.data.transforms import EncodedCacheDataset as JaxCache
    from voice100_tpu.data.transforms import MelSpectrogramAudioTransform as JaxMel
    from voice100_tpu.text import get_tokenizer as jax_tokenizer
    from voice100_tpu_torch.data.transforms import EncodedCacheDataset, MelSpectrogramAudioTransform
    from voice100_tpu_torch.text import get_tokenizer

    ds = get_dataset(root, "dummy_en", "train")
    salt = b"mel" + (b"" if cache_dtype is None else f"@{cache_dtype}".encode())
    port = EncodedCacheDataset(ds, MelSpectrogramAudioTransform(device="cpu"),
                               get_tokenizer("en", False), cachedir=cache_dir, salt=salt,
                               cache_dtype=cache_dtype)
    ref = JaxCache(ds, JaxMel(), jax_tokenizer("en", False), cachedir=cache_dir, salt=salt,
                   cache_dtype=cache_dtype)
    return port, ref


def test_mel_transform_matches_jax(tmp_path):
    port, ref = _datasets(_noise_corpus(str(tmp_path)), None, None)
    for i in range(len(port)):
        (got, got_text), (want, want_text) = port[i], ref[i]
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.shape[0] == int([0.37, 1.0, 1.61][i] * 16000) // 160 + 1
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got_text, want_text)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_feature_cache_is_shared_with_jax(tmp_path, writer):
    """An entry one package writes (float16 .npy under sha1(salt + id)),
    the other reads back byte for byte without computing it again; the
    frame counts come from the file headers."""
    root = _noise_corpus(str(tmp_path / "data"))
    cache = str(tmp_path / "cache")
    os.makedirs(cache)
    port, ref = _datasets(root, cache, "float16")
    first, second = (ref, port) if writer == "jax" else (port, ref)
    written = [first[i][0] for i in range(len(first))]
    files = sorted(os.listdir(cache))
    assert len(files) == len(first) and all(f.endswith(".npy") for f in files)
    for i, feature in enumerate(written):
        read = np.asarray(second[i][0])
        assert read.dtype == np.float16 and read.tobytes() == np.asarray(feature).tobytes()
        assert port.audio_frames(i) == ref.audio_frames(i) == len(feature)
    assert sorted(os.listdir(cache)) == files


@pytest.mark.parametrize("ext", [".flac", ".mp3"])
def test_native_formats_raise_the_named_error(tmp_path, ext):
    from voice100_tpu_torch.dsp.audioio import NATIVE_DECODERS_ITEM, load_audio

    path = tmp_path / f"clip{ext}"
    path.write_bytes(b"\0" * 64)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        load_audio(str(path))
    assert NATIVE_DECODERS_ITEM in str(err.value)
    with pytest.raises(ValueError):
        load_audio(str(tmp_path / "clip.ogg"))


def test_wav_and_resample_match_jax(tmp_path):
    from voice100_tpu.dsp import wav as jax_wav
    from voice100_tpu.dsp.audioio import load_audio as jax_load_audio
    from voice100_tpu.dsp.resample import resample as jax_resample
    from voice100_tpu_torch.dsp import load_audio, resample, wav

    rng = np.random.default_rng(3)
    stereo = rng.uniform(-1, 1, size=(2, 3001)).astype(np.float32)
    data = wav.write_wav_bytes(stereo, 22050)
    assert data == jax_wav.write_wav_bytes(stereo, 22050)
    got, want = wav.parse_wav(data), jax_wav.parse_wav(data)
    assert got[1] == want[1] and got[0].tobytes() == want[0].tobytes()
    x = rng.standard_normal(5000).astype(np.float32)
    assert resample(x, 22050, 16000).tobytes() == jax_resample(x, 22050, 16000).tobytes()
    path = str(tmp_path / "stereo.wav")
    wav.write_wav(path, stereo, 22050)
    assert load_audio(path).tobytes() == jax_load_audio(path).tobytes()


def test_datamodule_matches_jax_split_salt_and_batches(tmp_path):
    """setup() splits 90/10 with the JAX seed; the train loader's batches
    (shuffled, from a shared warm cache; then bucketed by the cache
    headers' lengths) and the predict loader's equal the JAX data
    module's byte for byte."""
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu_torch.data import AudioTextDataModule

    root = str(tmp_path / "data")
    make_dummy_corpus(root, n_clips=11)
    kwargs = dict(vocoder="mel", dataset="dummy_en", data_dir=root,
                  cache_dir=str(tmp_path / "cache"), batch_size=3)
    ref, port = JaxData(**kwargs), AudioTextDataModule(**kwargs, device="cpu")
    assert port.cache_salt == ref.cache_salt and port.cache_dtype == ref.cache_dtype == "float16"
    assert (port.audio_size, port.vocab_size) == (ref.audio_size, ref.vocab_size)
    for stage in (None, "predict"):
        ref.setup(stage)
        port.setup(stage)
    assert len(port.train_ds) == len(ref.train_ds) == 10 and len(port.valid_ds) == 1
    assert [port.train_ds._dataset[i] for i in range(10)] == \
        [ref.train_ds._dataset[i] for i in range(10)]
    for make in ("predict_dataloader", "train_dataloader", "val_dataloader", "bucketed"):
        if make == "bucketed":
            ref.bucket_by_length = port.bucket_by_length = True
            make = "train_dataloader"
            assert port.train_dataloader().length_hint is not None
        want = list(getattr(ref, make)().iter_with_counts())
        got = list(getattr(port, make)().iter_with_counts())
        assert [n for _, n in got] == [n for _, n in want]
        for (a, _), (b, _) in zip(got, want):
            _assert_batches_equal(a, b)
    with pytest.raises(NotImplementedError, match="item 9"):
        AudioTextDataModule(vocoder="world", use_target=True, device="cpu")
