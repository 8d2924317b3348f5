"""The port's native audio library vs the JAX package's (CPU).

``voice100_tpu_torch/native/`` builds a copy of ``audioio.cpp`` into
``voice100_tpu_torch/_build/``. On the fixtures of ``tests/test_native.py``
and ``tests/test_mp3.py`` its ``read_flac``, ``read_mp3``, ``load_audio``
and ``load_audio_batch`` equal the JAX package's bit for bit (each path
against its own JAX counterpart: the native resampler of the batch path
is not the NumPy one of ``load_audio``); corrupt and truncated files give
the same error in both; the loader's batches with the native ``prefetch``
equal those without it, and the JAX loader's, on a FLAC corpus in the
LJSpeech and LibriSpeech layouts.

The JAX library builds in place (``voice100_tpu/native/_audioio.so``). So
each module that reaches it loads it first through ``load_jax_lib``, which
builds a missing or stale file under a temporary name and moves it into
place (no test process of the port's ever leaves it half written), and
loads again if another test process was rebuilding it in place.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from flac_fixture import encode_flac
from mp3_fixture import lame_available, write_mp3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BUILD = os.path.join(ROOT, "voice100_tpu_torch", "_build")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")

# LJSpeech-style English transcripts: digits, currency, abbreviations, heteronyms
EN_TEXTS = [
    "Dr. Smith read 12 books in 1998.",
    "They paid $3.50 for the lead pipe on St. James Street.",
    "I will read the record; it was a record year.",
    "The wind was too strong to wind the clock at 7:45.",
    "Mr. Brown lives at 221 Baker St. with 2 cats.",
    "We must object to the object, said the 3rd witness.",
]


def load_jax_lib():
    """The JAX package's native library. Where its file is missing or older
    than its sources (the test its ``get_lib`` makes), it is built under a
    temporary name and moved into place, so that no other test process
    loads it half written; the load is tried again once or twice if the
    first attempts met a file that another test process was rebuilding in
    place."""
    import voice100_tpu.native as jax_native

    here = os.path.dirname(os.path.abspath(jax_native.__file__))
    sources = [os.path.join(here, name) for name in ("audioio.cpp", "world.cpp")]
    out = os.path.join(here, "_audioio.so")
    if not os.path.exists(out) or any(os.path.getmtime(out) < os.path.getmtime(src)
                                      for src in sources):
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            jax_native._build(sources, tmp)
            os.replace(tmp, out)
        except jax_native.NativeUnavailable:
            pass  # get_lib reports it
    for _ in range(3):
        try:
            return jax_native.get_lib()
        except jax_native.NativeUnavailable:
            jax_native._ERROR = None
            time.sleep(2.0)
    return jax_native.get_lib()


@pytest.fixture(scope="module")
def libs():
    from voice100_tpu_torch.native import get_lib

    return load_jax_lib(), get_lib()


def mp3_codecs() -> bool:
    from voice100_tpu_torch.native.mp3 import mp3_available

    return lame_available() and mp3_available()


def _flac(tmp_path, name, channels, rate, **kwargs):
    path = tmp_path / name
    path.write_bytes(encode_flac(channels, rate, **kwargs))
    return str(path)


def _fixtures(tmp_path):
    """The FLAC fixtures of tests/test_native.py: verbatim stereo,
    constant, fixed orders 1 and 2, a 22.05 kHz tone, a 24 kHz tone."""
    rng = np.random.RandomState(0)
    left = (rng.randn(1000) * 8000).astype(np.int64)
    right = (rng.randn(1000) * 8000).astype(np.int64)
    t = np.arange(900)
    smooth = (3000 * np.sin(2 * np.pi * 220 * t / 16000)).astype(np.int64)
    tone = (6000 * np.sin(2 * np.pi * 440 * np.arange(2205) / 22050)).astype(np.int64)
    t24 = np.arange(24000) / 24000.0
    tone24 = (0.4 * np.sin(2 * np.pi * 330 * t24) * 32767).astype(np.int32)
    return {
        "verbatim_stereo": _flac(tmp_path, "v.flac", [left, right], 16000),
        "constant": _flac(tmp_path, "c.flac", [np.full(600, -123, np.int64)], 22050,
                          subframe_types="constant"),
        "fixed1": _flac(tmp_path, "f1.flac", [smooth], 16000, subframe_types="fixed1"),
        "fixed2": _flac(tmp_path, "f2.flac", [smooth], 16000, subframe_types="fixed2"),
        "tone_22050": _flac(tmp_path, "s.flac", [tone], 22050),
        "tone_24000": _flac(tmp_path, "tone.flac", [tone24], 24000),
    }


FLAC_CASES = ["verbatim_stereo", "constant", "fixed1", "fixed2", "tone_22050", "tone_24000"]


@pytest.mark.parametrize("case", FLAC_CASES)
def test_read_flac_and_load_audio_match_jax(libs, tmp_path, case):
    from voice100_tpu.dsp.audioio import load_audio as jax_load_audio
    from voice100_tpu.native.flac import read_flac as jax_read_flac
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.native.flac import read_flac

    path = _fixtures(tmp_path)[case]
    (got, rate), (want, want_rate) = read_flac(path), jax_read_flac(path)
    assert rate == want_rate and got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.tobytes() == want.tobytes()
    for target in (16000, 22050):
        a, b = load_audio(path, target), jax_load_audio(path, target)
        assert a.dtype == np.float32 and a.shape == b.shape and a.tobytes() == b.tobytes()


def _mp3_tone(tmp_path, rate=24000):
    t = np.arange(rate) / rate
    path = str(tmp_path / "tone.mp3")
    write_mp3(path, (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32), rate)
    return path


def test_read_mp3_and_load_audio_match_jax(libs, tmp_path):
    if not mp3_codecs():
        pytest.skip("system mp3 codec libraries unavailable")
    from voice100_tpu.dsp.audioio import load_audio as jax_load_audio
    from voice100_tpu.native.mp3 import read_mp3 as jax_read_mp3
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.native.mp3 import read_mp3

    path = _mp3_tone(tmp_path)
    (got, rate), (want, want_rate) = read_mp3(path), jax_read_mp3(path)
    assert rate == want_rate == 24000 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert load_audio(path).tobytes() == jax_load_audio(path).tobytes()


def test_load_audio_batch_matches_jax(libs, tmp_path):
    """wav, flac (16, 22.05 and 24 kHz, stereo) and mp3 in one batch,
    against the JAX package's batch decode; a missing file is None in
    both."""
    from corpus_fixture import make_dummy_corpus
    from voice100_tpu.native.batch import load_audio_batch as jax_batch
    from voice100_tpu_torch.native.batch import load_audio_batch

    root = make_dummy_corpus(str(tmp_path), n_clips=2)
    paths = [os.path.join(root, "wavs", f"clip{i:04d}.wav") for i in range(2)]
    paths += list(_fixtures(tmp_path).values())
    if mp3_codecs():
        paths.append(_mp3_tone(tmp_path))
    paths.append(str(tmp_path / "missing.flac"))
    for rate in (16000, 22050):
        got, want = load_audio_batch(paths, rate, n_threads=3), jax_batch(paths, rate)
        assert len(got) == len(want) == len(paths)
        assert got[-1] is None and want[-1] is None
        for path, a, b in zip(paths[:-1], got, want):
            assert a is not None and a.dtype == b.dtype and a.tobytes() == b.tobytes(), path


def _corrupt_files(tmp_path):
    from corpus_fixture import make_dummy_corpus

    root = make_dummy_corpus(str(tmp_path), n_clips=1)
    good = open(os.path.join(root, "wavs", "clip0000.wav"), "rb").read()
    flac = encode_flac([(np.random.RandomState(0).randn(3000) * 5000).astype(np.int64)], 16000)
    rng = np.random.RandomState(0)
    files = {}
    for ext in (".wav", ".flac", ".mp3"):
        files[f"garbage{ext}"] = rng.bytes(4096)
    for cut in (4, 12, 20, 45, len(good) // 2):
        files[f"trunc{cut}.wav"] = good[:cut]
    for cut in (3, 20, 42, 60, len(flac) // 2):
        files[f"trunc{cut}.flac"] = flac[:cut]
    files["empty.flac"] = b""
    files["empty.mp3"] = b""
    paths = []
    for name, data in files.items():
        (tmp_path / name).write_bytes(data)
        paths.append(str(tmp_path / name))
    return paths


def _outcome(fn, path):
    try:
        out = fn(path)
    except Exception as err:  # the error's type is what is compared
        return type(err).__name__
    samples = out[0] if isinstance(out, tuple) else out
    return np.asarray(samples).tobytes()


def test_corrupt_and_truncated_files_fail_alike(libs, tmp_path):
    """Garbage, truncated and empty files: the same error type (or the
    same bytes, where the decoder reads a truncated stream's head) from
    both packages' read_flac, read_mp3 and load_audio, and None in the
    same slots of the batch decode."""
    from voice100_tpu.dsp.audioio import load_audio as jax_load_audio
    from voice100_tpu.native.batch import load_audio_batch as jax_batch
    from voice100_tpu.native.flac import read_flac as jax_read_flac
    from voice100_tpu.native.mp3 import read_mp3 as jax_read_mp3
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.native.batch import load_audio_batch
    from voice100_tpu_torch.native.flac import read_flac
    from voice100_tpu_torch.native.mp3 import read_mp3

    paths = _corrupt_files(tmp_path)
    failures = 0
    for path in paths:
        pairs = [(load_audio, jax_load_audio)]
        if path.endswith(".flac"):
            pairs.append((read_flac, jax_read_flac))
        if path.endswith(".mp3"):
            pairs.append((read_mp3, jax_read_mp3))
        for port_fn, jax_fn in pairs:
            got = _outcome(port_fn, path)
            assert got == _outcome(jax_fn, path), path
            failures += isinstance(got, str)
    assert failures >= len(paths) // 2
    got, want = load_audio_batch(paths), jax_batch(paths)
    assert [g is None for g in got] == [w is None for w in want]
    for g, w in zip(got, want):
        assert g is None or g.tobytes() == w.tobytes()


def write_flac_corpora(data_dir, n_lj=6, n_libri=4, n_dev=2, seed=0):
    """An LJSpeech layout (``LJSpeech-1.1/metadata.csv``, 22.05 kHz
    ``wavs/*.flac``) and a LibriSpeech layout (16 kHz
    ``train-clean-100/<spk>/<chap>/*.flac`` with ``*.trans.txt``, and
    ``dev-clean``) of 0.6-1.4 s noise clips with English transcripts,
    encoded with tests/flac_fixture.py; returns the texts by corpus."""
    rng = np.random.RandomState(seed)

    def clip(rate):
        n = min(int(rng.uniform(0.6, 1.4) * rate), 127 * 256)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * np.arange(n) / rate)
        return (rng.randn(n) * 3000 * env).astype(np.int64)

    lj = os.path.join(data_dir, "LJSpeech-1.1")
    os.makedirs(os.path.join(lj, "wavs"))
    texts = {"ljspeech": [], "librispeech": [], "librispeech_dev": []}
    lines = []
    for i in range(n_lj):
        clipid = f"LJ001-{i + 1:04d}"
        text = EN_TEXTS[i % len(EN_TEXTS)]
        with open(os.path.join(lj, "wavs", clipid + ".flac"), "wb") as f:
            f.write(encode_flac([clip(22050)], 22050))
        lines.append(f"{clipid}|{text}|{text}")
        texts["ljspeech"].append(text)
    with open(os.path.join(lj, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for split, n, key in (("train-clean-100", n_libri, "librispeech"),
                          ("dev-clean", n_dev, "librispeech_dev")):
        chapter = os.path.join(data_dir, "LibriSpeech", split, "19", "198")
        os.makedirs(chapter)
        trans = []
        for i in range(n):
            clipid = f"19-198-{i:04d}"
            text = EN_TEXTS[(i + 3) % len(EN_TEXTS)].upper()
            with open(os.path.join(chapter, clipid + ".flac"), "wb") as f:
                f.write(encode_flac([clip(16000)], 16000))
            trans.append(f"{clipid} {text}")
            texts[key].append(text)
        with open(os.path.join(chapter, "19-198.trans.txt"), "w") as f:
            f.write("\n".join(trans) + "\n")
    return texts


def _prepare(data_dir, jax_side=False):
    if jax_side:
        from voice100_tpu.tools.prepare_dataset import cli_main
    else:
        from voice100_tpu_torch.tools.prepare_dataset import cli_main
    cli_main(["--data_dir", data_dir, "--dataset", "ljspeech,librispeech", "--split",
              "train,valid", "--language", "en", "--use_phone"])


def _data_module(data_dir, cache, port, stage, batch_size=3):
    if port:
        from voice100_tpu_torch.data import AudioTextDataModule

        data = AudioTextDataModule(vocoder="mel", dataset="ljspeech,librispeech",
                                   use_phone=True, data_dir=data_dir, cache_dir=cache,
                                   batch_size=batch_size, device="cpu")
    else:
        from voice100_tpu.data import AudioTextDataModule

        data = AudioTextDataModule(vocoder="mel", dataset="ljspeech,librispeech",
                                   use_phone=True, data_dir=data_dir, cache_dir=cache,
                                   batch_size=batch_size)
    data.setup(stage)
    return data


def _flat(batch):
    (audio, audio_len), (text, text_len) = batch
    return [np.asarray(a) for a in (audio, audio_len, text, text_len)]


def test_prefetch_decodes_what_the_jax_batch_decode_does(libs, tmp_path):
    """prefetch keeps, for each cache miss, the JAX batch decode's wave
    bit for bit; against the per-item decode (load_audio), the 16 kHz
    clips are equal and the 22.05 kHz ones within tests/test_native.py's
    2e-4 (the native resampler is not the NumPy one)."""
    from voice100_tpu.native.batch import load_audio_batch as jax_batch
    from voice100_tpu_torch.dsp.audioio import load_audio

    data_dir = str(tmp_path / "data")
    write_flac_corpora(data_dir)
    _prepare(data_dir)
    ds = _data_module(data_dir, str(tmp_path / "cache"), True, "predict").predict_ds
    ds.prefetch(range(len(ds)))
    items = [ds._dataset[i][:2] for i in range(len(ds))]
    assert len(ds._preloaded) == len(ds) == 10
    want = jax_batch([path for _, path in items], 16000)
    for (clipid, path), ref in zip(items, want):
        wave = ds._preloaded[clipid]
        assert wave.tobytes() == ref.tobytes(), path
        single = load_audio(path, 16000)
        if "LibriSpeech" in path:
            assert wave.tobytes() == single.tobytes(), path
        else:
            assert wave.shape == single.shape
            np.testing.assert_allclose(wave, single, atol=2e-4)
    ds[0]
    assert items[0][0] not in ds._preloaded  # taken by __getitem__
    ds.prefetch(range(len(ds)))  # cached items are not decoded again
    assert items[0][0] not in ds._preloaded and len(ds._preloaded) == len(ds) - 1


def test_loader_batches_with_prefetch_equal_without_and_jax(libs, tmp_path, monkeypatch):
    """The loader calls prefetch once a batch, before the batch's items;
    its batches equal those of the item-by-item decode (the 16 kHz rows
    bit for bit, every text and length), and, on one feature cache, the
    JAX loader's batches bit for bit."""
    from voice100_tpu_torch.data.transforms import EncodedCacheDataset

    data_dir = str(tmp_path / "data")
    write_flac_corpora(data_dir)
    _prepare(data_dir)
    calls = []
    real = EncodedCacheDataset.prefetch

    def counted(self, indices):
        calls.append([int(i) for i in indices])
        real(self, indices)

    monkeypatch.setattr(EncodedCacheDataset, "prefetch", counted)
    data = _data_module(data_dir, str(tmp_path / "a"), True, "predict")
    with_prefetch = [_flat(b) for b in data.predict_dataloader()]
    assert calls == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9]] and not data.predict_ds._preloaded
    monkeypatch.setattr(EncodedCacheDataset, "prefetch", None)
    data = _data_module(data_dir, str(tmp_path / "b"), True, "predict")
    without = [_flat(b) for b in data.predict_dataloader()]
    monkeypatch.setattr(EncodedCacheDataset, "prefetch", real)
    libri = [i for i in range(10) if "LibriSpeech" in data.predict_ds._dataset[i][1]]
    assert libri == [6, 7, 8, 9]
    for n, (a, b) in enumerate(zip(with_prefetch, without)):
        assert all(x.shape == y.shape for x, y in zip(a, b))
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2].tobytes() == b[2].tobytes() and a[3].tobytes() == b[3].tobytes()
        for row in range(3):
            if 3 * n + row in libri:
                assert a[0][row].tobytes() == b[0][row].tobytes()
    # one cache, written by the JAX loader (with its own native prefetch)
    shared = str(tmp_path / "shared")
    for stage in ("fit", "predict"):
        jax_data = _data_module(data_dir, shared, False, stage)
        port_data = _data_module(data_dir, shared, True, stage)
        loaders = ((jax_data.train_dataloader(), port_data.train_dataloader())
                   if stage == "fit" else
                   (jax_data.predict_dataloader(), port_data.predict_dataloader()))
        jax_batches, port_batches = (list(loader) for loader in loaders)
        assert len(jax_batches) == len(port_batches) > 1
        for a, b in zip(port_batches, jax_batches):
            for x, y in zip(_flat(a), _flat(b)):
                assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_prefetch_without_the_library_warns_once_and_decodes_item_by_item(tmp_path, monkeypatch,
                                                                          caplog):
    """With the native library unloadable, prefetch logs one warning and
    returns; a WAV corpus loads as before, and a FLAC item raises naming
    its file."""
    import logging

    import voice100_tpu_torch.native as native
    from corpus_fixture import make_dummy_corpus
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.dsp.audioio import load_audio

    make_dummy_corpus(str(tmp_path), n_clips=4)
    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=str(tmp_path),
                               cache_dir=str(tmp_path / "ref"), batch_size=2, valid_ratio=0.0,
                               device="cpu")
    data.setup("fit")
    data.train_ds.prefetch = None
    want = [_flat(b) for b in data.train_dataloader()]
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", native.NativeUnavailable("native build failed: g++"))
    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=str(tmp_path),
                               cache_dir=str(tmp_path / "cold"), batch_size=2, valid_ratio=0.0,
                               device="cpu")
    data.setup("fit")
    with caplog.at_level(logging.WARNING, logger="voice100_tpu_torch.data.transforms"):
        got = [_flat(b) for b in data.train_dataloader()]
    assert [r.getMessage() for r in caplog.records].count(
        "native batch decode unavailable, decoding clip by clip: native build failed: g++") == 1
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.tobytes() == y.tobytes()
    flac = tmp_path / "clip.flac"
    flac.write_bytes(encode_flac([np.zeros(100, np.int64)], 16000))
    with pytest.raises(RuntimeError, match=f"{flac}: FLAC decoding requires"):
        load_audio(str(flac))
    mp3 = tmp_path / "clip.mp3"
    mp3.write_bytes(b"\0" * 64)
    with pytest.raises(RuntimeError, match=f"{mp3}: MP3 decoding requires"):
        load_audio(str(mp3))


def test_library_is_built_in_the_port_and_loads_nothing_of_the_jax_package(tmp_path):
    """In a fresh process: the port's library is the one under
    voice100_tpu_torch/_build/ named by its source's hash, and decoding a
    FLAC file maps no library and imports no module of voice100_tpu."""
    from voice100_tpu_torch.native import BUILD_DIR, library_path

    path = _flac(tmp_path, "x.flac", [np.arange(500, dtype=np.int64)], 16000)
    lib = library_path()
    assert lib.parent == BUILD_DIR and str(BUILD_DIR) == PORT_BUILD
    assert lib.name.startswith("libaudioio-") and lib.suffix == ".so"
    code = (
        "import sys\n"
        "from voice100_tpu_torch.dsp.audioio import load_audio\n"
        "from voice100_tpu_torch.native.batch import load_audio_batch\n"
        f"wav = load_audio({path!r}, 22050)\n"
        f"assert load_audio_batch([{path!r}])[0] is not None\n"
        "maps = [line.split()[-1] for line in open('/proc/self/maps') if '.so' in line]\n"
        "print('\\n'.join(sorted(set(m for m in maps if 'voice100' in m))))\n"
        "print('MODULES', [m for m in sys.modules if m.split('.')[0] == 'voice100_tpu'])\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "MODULES []"
    assert lines[:-1] == [str(lib)]


def test_a_failed_build_raises_native_unavailable_with_the_compiler_output(tmp_path, monkeypatch):
    import voice100_tpu_torch.native as native

    bad = tmp_path / "audioio.cpp"
    bad.write_text("int broken = ;\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_ERROR", None)
    for _ in range(2):  # the error is kept: a second call raises it again
        with pytest.raises(native.NativeUnavailable, match="(?s)native build failed.*error"):
            native.get_lib()
    assert os.listdir(tmp_path / "build") == []  # no half-written library is left
