"""Port TTSPipeline and update_samples vs the JAX package (CPU).

The small models of ``tests/test_inference.py:100-140`` (align H=16,
audio H=16 with a transposed decoder block), initialised in JAX with
realistic WORLD statistics and carried across. Held to JAX's
``TTSPipeline``:

* durations to rtol 1e-5; aligned ids and lengths equal, except where a
  cursor value (from JAX's durations) lies within 1e-5 of an integer:
  ``floor`` may then land on either side, and the test names those
  tokens;
* features to 1e-4 abs; pulse positions equal and waveforms within
  1e-4 x peak (``test_torch_world.py``'s rules), JAX's noise fed in;
* ``_split_long`` pieces equal; int16 = ``round(clip(float) * 32767)`` +/- 1.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os
import wave

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.dsp.world import synthesis_shape, synthesize_batch
from voice100_tpu_torch.inference import TTSPipeline
from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER = ((16, False, 3, 1, 1, False), (16, True, 5, 2, 2, False))
STATS = {"f0_mean": [140.0], "f0_std": [25.0], "logspc_mean": np.r_[-5.0, np.zeros(24)],
         "logspc_std": np.full(25, 0.3), "codeap_mean": [-15.0], "codeap_std": [4.0]}
TEXTS = ["hello world", "ok", "the quick brown fox jumps over the lazy dog"]
BUCKETS = dict(text_buckets=(32, 64), frame_buckets=(128, 256))


@pytest.fixture(scope="module")
def pipes():
    from voice100_tpu.inference import TTSPipeline as JaxPipeline
    from voice100_tpu.models import AlignTextToAudio as JaxAudio, TextToAlignText as JaxAlign

    text = jnp.zeros((1, 8), jnp.int32)
    align = JaxAlign(vocab_size=29, num_layers=1, hidden_size=16)
    align_vars = jax.tree_util.tree_map(
        np.asarray, align.init(jax.random.PRNGKey(0), text, jnp.asarray([8])))
    # durations of a few frames a token: shift the log-duration bias
    align_vars["params"]["Dense_0"]["bias"] = np.asarray([0.4, 1.1], np.float32)
    audio = JaxAudio(vocab_size=29, logspc_size=25, codeap_size=1, encoder_num_layers=1,
                     encoder_hidden_size=16, decoder_settings=DECODER)
    audio_vars = jax.tree_util.tree_map(
        np.asarray, audio.init(jax.random.PRNGKey(0), text, jnp.asarray([8])))
    audio_vars["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in STATS.items()}
    jax_pipe = JaxPipeline(align, align_vars, audio, audio_vars, language="en",
                           use_phone=False, **BUCKETS)
    port_align = TextToAlignText(29, 1, 16, device="cpu")
    port_align.load_state_dict(from_jax_variables(align_vars))
    port_audio = AlignTextToAudio(29, 25, 1, 1, 16, DECODER, device="cpu")
    port_audio.load_state_dict(from_jax_variables(audio_vars, DECODER))
    pipe = TTSPipeline(port_align, port_audio, language="en", use_phone=False, device="cpu",
                       **BUCKETS)
    return jax_pipe, align_vars, audio_vars, pipe


def _jax_stages(jax_pipe, align_vars, audio_vars, texts):
    """JAX's ``_synthesize_batch`` up to the features, stage by stage."""
    encoded = [jax_pipe.tokenizer(jax_pipe.phonemizer(t)) for t in texts]
    bucket = 32 if max(len(e) for e in encoded) <= 32 else 64
    text = np.zeros((len(texts), bucket), np.int32)
    text_len = np.ones(len(texts), np.int32)
    for i, e in enumerate(encoded):
        text[i, :len(e)] = e
        text_len[i] = max(len(e), 1)
    durations = np.array(jax_pipe._durations(align_vars, jnp.asarray(text),
                                             jnp.asarray(text_len)))
    mask = np.arange(bucket)[None, :] < text_len[:, None]
    need = int(np.max((durations * mask[:, :, None]).sum((1, 2)))) + bucket + 16
    out_len = 128 if need <= 128 else 256
    aligntext, aligntext_len = jax_pipe._expand(align_vars, jnp.asarray(text),
                                                jnp.asarray(durations), jnp.asarray(text_len),
                                                out_len)
    feats = jax_pipe._acoustics(audio_vars, aligntext, aligntext_len)
    return (text, text_len, durations, np.array(aligntext), np.array(aligntext_len),
            [np.array(f) for f in feats])


def _near_integer_tokens(durations, text_len, head=5, tol=1e-5):
    """Tokens whose cursor values (float64 from JAX's durations) lie within
    ``tol`` of an integer, by row."""
    out = {}
    for b, n in enumerate(text_len):
        steps = durations[b, :n].astype(np.float64).reshape(-1).copy()
        steps[0] = 0.0
        cursor = head + np.cumsum(steps)
        near = np.nonzero(np.abs(cursor - np.round(cursor)) < tol)[0] // 2
        if len(near):
            out[b] = sorted(set(near.tolist()))
    return out


def test_stages_match_jax(pipes):
    jax_pipe, align_vars, audio_vars, pipe = pipes
    text, text_len, durations, aligntext, aligntext_len, feats = _jax_stages(
        jax_pipe, align_vars, audio_vars, TEXTS)
    got = pipe.align_model.predict(torch.from_numpy(text), torch.from_numpy(text_len)).numpy()
    np.testing.assert_allclose(got, durations, rtol=1e-5, atol=0)
    ids, lengths = pipe.align_model.align(torch.from_numpy(text), got,
                                          torch.from_numpy(text_len), aligntext.shape[1])
    ids, lengths = ids.numpy(), lengths.numpy()
    near = _near_integer_tokens(durations, text_len)
    for b in range(len(TEXTS)):
        differ = np.nonzero(ids[b] != aligntext[b])[0]
        assert not len(differ) or b in near, f"row {b}: ids differ at {differ}, no tie"
    np.testing.assert_array_equal(lengths, aligntext_len)
    assert (lengths > 2 * text_len).all()  # durations of a few frames a token
    port_feats = pipe.audio_model.predict(torch.from_numpy(aligntext),
                                          torch.from_numpy(aligntext_len))
    for g, w in zip(port_feats, feats):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)
    assert (feats[0] > 60).any()  # voiced frames at speech rates


def test_synthesize_matches_jax(pipes):
    from voice100_tpu.dsp.world.synthesis import synthesize_fn

    jax_pipe, align_vars, audio_vars, pipe = pipes
    want = jax_pipe.synthesize(TEXTS)
    *_, aligntext_len, feats = _jax_stages(jax_pipe, align_vars, audio_vars, TEXTS)
    n_frames = feats[0].shape[1]
    _, max_pulses = synthesis_shape(n_frames, 16000, 10.0, 512)
    keys = jax.random.split(jax.random.PRNGKey(0), len(TEXTS))
    noise = np.stack([np.asarray(jax.random.normal(k, (max_pulses, 512))) for k in keys])
    # synthesize_fn's own draws (PRNGKey(0)), for the flat-envelope runs
    flat_noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (max_pulses, 512)))
    got = pipe.synthesize(TEXTS, noise=torch.from_numpy(noise))
    f0_port = pipe.audio_model.predict(torch.from_numpy(np.asarray(_jax_stages(
        jax_pipe, align_vars, audio_vars, TEXTS)[3])), torch.from_numpy(aligntext_len))[0]
    assert len(got) == len(want)
    flat = np.ones((n_frames, 257), np.float32), np.full((n_frames, 257), 1e-6, np.float32)
    voiced_pulses = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == np.float32
        # the voiced pulses each side places for its own f0 (muted past the
        # length), read off a flat envelope: a voiced pulse is sqrt(period)
        # >= sqrt(16000 / 420) > 6 high, the unit noise of unvoiced spans
        # (the same draws on both sides) stays under 5.5
        n = min(2 * int(aligntext_len[i]), n_frames)
        f0_j = np.where(np.arange(n_frames) < n, feats[0][i], 0).astype(np.float32)
        f0_p = np.where(np.arange(n_frames) < n, f0_port[i].numpy(), 0).astype(np.float32)
        pw = np.nonzero(np.abs(np.asarray(synthesize_fn(f0_j, *flat))) > 5.5)[0]
        pg = np.nonzero(np.abs(synthesize_batch(
            torch.from_numpy(f0_p)[None], *(torch.from_numpy(x)[None] for x in flat),
            noise=torch.from_numpy(flat_noise.copy())[None])[0].numpy()) > 5.5)[0]
        np.testing.assert_array_equal(pg, pw)
        voiced_pulses += len(pw)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max())
    assert voiced_pulses > 20
    pcm = pipe.synthesize(TEXTS, output_dtype=np.int16, noise=torch.from_numpy(noise))
    for w16, w32 in zip(pcm, got):
        assert w16.dtype == np.int16 and w16.shape == w32.shape
        expect = np.round(np.clip(w32, -1.0, 1.0) * 32767.0)
        assert np.abs(w16.astype(np.float64) - expect).max() <= 1


def test_split_long_matches_jax(pipes):
    jax_pipe, _, _, pipe = pipes
    long_text = ("beginnings are apt to be determinative, and when reinforced by continuous "
                 "applications of similar influence. which had restored the courage of "
                 "noirtier for ever since he had conversed with the priest")
    for text in (long_text, "x" * 150, "short"):
        assert pipe._split_long(text) == jax_pipe._split_long(text)
    pieces = pipe._split_long(long_text)
    assert len(pieces) > 1 and all(pipe._encoded_len(p) <= 64 for p in pieces)
    wavs = pipe.synthesize([long_text, "ok"])
    parts = pipe._synthesize_batch(pieces)
    np.testing.assert_array_equal(wavs[0], np.concatenate(parts))


def _write_configs(tmp_path, align_model, audio_model):
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    paths = {}
    for name, cls, init, model in (
            ("align", "voice100_tpu.models.TextToAlignText",
             dict(vocab_size=29, num_layers=1, hidden_size=16), align_model),
            ("audio", "voice100_tpu.models.AlignTextToAudio",
             dict(vocab_size=29, logspc_size=25, codeap_size=1, encoder_num_layers=1,
                  encoder_hidden_size=16, decoder_settings=[list(s) for s in DECODER],
                  audio_stat="./data/none.npz"), audio_model)):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({
            "model": {"class_path": cls, "init_args": init},
            "data": {"class_path": "voice100_tpu.data.AlignTextDataModule",
                     "init_args": {"dataset": "ljspeech"}}}))
        ckpt = tmp_path / f"{name}.pt"
        save_checkpoint(str(ckpt), TrainState(model, torch.optim.Adam(model.parameters())))
        paths[name] = (str(cfg), str(ckpt))
    return paths


def test_update_samples_writes_wavs(tmp_path, pipes):
    from voice100_tpu_torch.tools.update_samples import cli_main
    from voice100_tpu_torch.training.cli import load_model

    _, _, _, pipe = pipes
    paths = _write_configs(tmp_path, pipe.align_model, pipe.audio_model)
    model = load_model(*paths["audio"], device="cpu")
    assert isinstance(model, AlignTextToAudio) and not model.training
    np.testing.assert_array_equal(model.norm.f0_mean.numpy(), [140.0])
    prefix = str(tmp_path / "out")
    cli_main(["--align_config", paths["align"][0], "--align_ckpt", paths["align"][1],
              "--audio_config", paths["audio"][0], "--audio_ckpt", paths["audio"][1],
              "--no_phone", "--device", "cpu", "--output_prefix", prefix,
              "--text", "hello world", "--text", "ok then"])
    for i in (1, 2):
        with wave.open(f"{prefix}-en-{i}.wav") as f:
            assert f.getframerate() == 16000 and f.getsampwidth() == 2
            pcm = np.frombuffer(f.readframes(f.getnframes()), np.int16)
        assert len(pcm) > 1600 and np.abs(pcm).max() <= 26212  # 0.8 * 32765
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(["--align_config", paths["align"][0], "--align_ckpt", paths["align"][1],
                      "--audio_config", paths["audio"][0], "--audio_ckpt", paths["audio"][1],
                      "--no_phone"])


@pytest.mark.parametrize("config", ["align_en_base.yaml", "tts_en_base.yaml"])
def test_tts_configs_build_at_full_width_and_fit_raises(config, tmp_path):
    from voice100_tpu_torch.training.cli import _MODEL_CLASSES, main

    init = yaml.safe_load(open(os.path.join(ROOT, "config", config)))["model"]["init_args"]
    cls = _MODEL_CLASSES["TextToAlignText" if "align" in config else "AlignTextToAudio"]
    init.pop("audio_stat", None)
    init.pop("learning_rate", None)
    model = cls(**{k: tuple(map(tuple, v)) if isinstance(v, list) else v
                   for k, v in init.items()}, device="cpu")
    assert sum(p.numel() for p in model.parameters()) > 1_000_000
    # fit builds it and raises where it reads a corpus that is not there
    with pytest.raises(FileNotFoundError, match="(?i)ljspeech"):
        main(["fit", "--config", os.path.join(ROOT, "config", config), "--device", "cpu",
              "--data_dir", str(tmp_path), "--cache_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "ckpt")])


def test_unported_paths_raise(pipes):
    """Meshes and unknown languages still raise; English phones (CMU
    G2P) and Japanese, which raised until the text front end was ported,
    now give the JAX package's phonemizers' outputs, also inside a
    TTSPipeline built for phones."""
    from voice100_tpu.text import get_phonemizer as jax_get_phonemizer
    from voice100_tpu_torch.text import get_phonemizer

    _, _, _, pipe = pipes
    for language, use_phone, text in (("en", True, "Dr. Smith read 12 books for $3.50."),
                                      ("ja", False, "東京で3時に会いましょう。"),
                                      ("ja", True, "東京で3時に会いましょう。")):
        port, ref = get_phonemizer(language, use_phone), jax_get_phonemizer(language, use_phone)
        assert type(port).__name__ == type(ref).__name__
        assert port(text) == ref(text) != ""
    with pytest.raises(ValueError):
        get_phonemizer("xx", use_phone=False)
    with pytest.raises(TypeError, match="mesh must be a voice100_tpu_torch.parallel.Mesh"):
        TTSPipeline(pipe.align_model, pipe.audio_model, use_phone=False, mesh=object(),
                    device="cpu")
    phone_pipe = TTSPipeline(pipe.align_model, pipe.audio_model, device="cpu")
    text = "Read the lead, Dr. Smith."
    assert phone_pipe.phonemizer(text) == jax_get_phonemizer("en", True)(text)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TTSPipeline(pipe.align_model, pipe.audio_model, use_phone=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            TextToAlignText(29, 1, 16)
        with pytest.raises(RuntimeError, match="CUDA"):
            AlignTextToAudio(29, 25, 1, 1, 16, DECODER)


def test_chip_smoke_drives_the_tts_configs_at_full_width():
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    for name, want in (("align_en_base.yaml", chip_smoke.ALIGN_EN_BASE),
                       ("tts_en_base.yaml", chip_smoke.TTS_EN_BASE)):
        init = yaml.safe_load(open(os.path.join(ROOT, "config", name)))["model"]["init_args"]
        got = {k: tuple(map(tuple, v)) if isinstance(v, list) else v for k, v in init.items()
               if k in want}
        assert got == want, name
    lengths = [len(t) for t in chip_smoke.TTS_TEXTS]
    assert len(lengths) == 16 and min(lengths) >= 20 and max(lengths) <= 240


def test_pipeline_over_a_mesh_equals_the_plain_call(pipes):
    """``mesh=`` runs the align and audio models on each device's shard
    of the texts (two CPU devices; three texts pad to four rows, cut off
    after the models): the waveforms of the plain call within 1e-6 of the
    peak, the noise drawn from one seed; a mesh of one device is the plain
    call."""
    from voice100_tpu_torch.parallel import make_mesh

    pipe = pipes[-1]
    want = pipe.synthesize(TEXTS, noise=torch.Generator().manual_seed(3))
    for devices in (["cpu", "cpu"], ["cpu"]):
        meshed = TTSPipeline(pipe.align_model, pipe.audio_model, use_phone=False,
                             mesh=make_mesh(devices), **BUCKETS)
        got = meshed.synthesize(TEXTS, noise=torch.Generator().manual_seed(3))
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            if len(devices) == 1:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.abs(w).max())
