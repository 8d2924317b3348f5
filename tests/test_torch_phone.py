"""The phone configs' path through the port vs the JAX package (CPU).

The slice as a whole, at small widths:

* ``TTSPipeline(use_phone=True)`` for English (CMU phones, vocab 71) and
  Japanese (phones, vocab 44): the JAX package's pipeline and the port's
  on the same weights (initialised in JAX and carried across), held by
  ``test_torch_tts_pipeline.py``'s rules: durations to rtol 1e-5, aligned
  ids equal except at a cursor tie, features to 1e-4, waveforms to 1e-4 x
  peak with JAX's noise fed in, on JAX's features and end to end, except
  over the response of a pulse that JAX's float32 phase places a sample
  from the port's (``test_torch_world.py``'s rule); ``_split_long`` gives
  JAX's pieces for a long Japanese text (no spaces) and a long English one.
* A narrow copy of ``config/asr_en_phone_base.yaml`` (vocab 71, the
  ``ljspeech,librispeech`` corpus list, use_phone) on a FLAC corpus in
  both layouts, phonemized by the port's ``prepare_dataset``: on one
  feature cache the port's train batches equal the JAX loader's bit for
  bit, two training steps from the same weights (augmentation and
  dropout off) give the JAX trainer's losses within rtol 1e-4
  (``test_torch_train.py``'s tolerance), and ``fit`` through the port's
  CLI trains on it from the config's seed.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json
import os

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.dsp.world import synthesis_shape
from voice100_tpu_torch.inference import TTSPipeline, _bucket
from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables

from test_torch_tts_pipeline import _near_integer_tokens

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER = ((16, False, 3, 1, 1, False), (16, True, 5, 2, 2, False))
STATS = {"f0_mean": [140.0], "f0_std": [25.0], "logspc_mean": np.r_[-5.0, np.zeros(24)],
         "logspc_std": np.full(25, 0.3), "codeap_mean": [-15.0], "codeap_std": [4.0]}
BUCKETS = dict(text_buckets=(64, 128), frame_buckets=(256, 512))
TEXTS = {
    "en": ["Dr. Smith read 12 books.", "Lead the way!", "I paid $3.50 to read it."],
    "ja": ["東京で3時に会いましょう。", "りんごを6個買った。", "カレーライスが好きです。"],
}
LONG = {
    "en": ("Dr. Smith read the record in 1998, and then he read it again; the lead pipe, "
           "which cost $3.50, was too heavy to lift. We must object to the object, said "
           "the 3rd witness, who lives at 221 Baker St."),
    "ja": ("また、東寺のように五大明王と呼ばれる主要な明王の中央に配されることも多い。"
           "ニューイングランド風は牛乳をベースとした白いクリームスープであり、"
           "ボストンクラムチャウダーとも呼ばれる。2026年8月18日の午後3時30分です。"),
}
VOCAB = {"en": 71, "ja": 44}


def build_pipes(language):
    """JAX's phone pipeline and the port's on the same small models."""
    from voice100_tpu.inference import TTSPipeline as JaxPipeline
    from voice100_tpu.models import AlignTextToAudio as JaxAudio, TextToAlignText as JaxAlign

    vocab = VOCAB[language]
    text = jnp.zeros((1, 8), jnp.int32)
    align = JaxAlign(vocab_size=vocab, num_layers=1, hidden_size=16)
    align_vars = jax.tree_util.tree_map(
        np.asarray, align.init(jax.random.PRNGKey(1), text, jnp.asarray([8])))
    align_vars["params"]["Dense_0"]["bias"] = np.asarray([0.4, 1.1], np.float32)
    audio = JaxAudio(vocab_size=vocab, logspc_size=25, codeap_size=1, encoder_num_layers=1,
                     encoder_hidden_size=16, decoder_settings=DECODER)
    audio_vars = jax.tree_util.tree_map(
        np.asarray, audio.init(jax.random.PRNGKey(1), text, jnp.asarray([8])))
    audio_vars["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in STATS.items()}
    jax_pipe = JaxPipeline(align, align_vars, audio, audio_vars, language=language,
                           use_phone=True, **BUCKETS)
    port_align = TextToAlignText(vocab, 1, 16, device="cpu")
    port_align.load_state_dict(from_jax_variables(align_vars))
    port_audio = AlignTextToAudio(vocab, 25, 1, 1, 16, DECODER, device="cpu")
    port_audio.load_state_dict(from_jax_variables(audio_vars, DECODER))
    pipe = TTSPipeline(port_align, port_audio, language=language, use_phone=True, device="cpu",
                       **BUCKETS)
    return language, jax_pipe, align_vars, audio_vars, pipe


@pytest.fixture(scope="module", params=["en", "ja"])
def phone_pipes(request):
    return build_pipes(request.param)


def _jax_stages(jax_pipe, align_vars, audio_vars, texts):
    """JAX's ``_synthesize_batch`` up to the features, stage by stage."""
    encoded = [jax_pipe.tokenizer(jax_pipe.phonemizer(t)) for t in texts]
    bucket = _bucket(max(len(e) for e in encoded), BUCKETS["text_buckets"])
    text = np.zeros((len(texts), bucket), np.int32)
    text_len = np.ones(len(texts), np.int32)
    for i, e in enumerate(encoded):
        text[i, :len(e)] = e
        text_len[i] = max(len(e), 1)
    durations = np.array(jax_pipe._durations(align_vars, jnp.asarray(text),
                                             jnp.asarray(text_len)))
    mask = np.arange(bucket)[None, :] < text_len[:, None]
    need = int(np.max((durations * mask[:, :, None]).sum((1, 2)))) + bucket + 16
    out_len = _bucket(need, BUCKETS["frame_buckets"])
    aligntext, aligntext_len = jax_pipe._expand(align_vars, jnp.asarray(text),
                                                jnp.asarray(durations), jnp.asarray(text_len),
                                                out_len)
    feats = jax_pipe._acoustics(audio_vars, aligntext, aligntext_len)
    return (text, text_len, durations, np.array(aligntext), np.array(aligntext_len),
            [np.array(f) for f in feats])


def test_phone_pipeline_tokens_and_stages_match_jax(phone_pipes):
    language, jax_pipe, align_vars, audio_vars, pipe = phone_pipes
    texts = TEXTS[language]
    for t in texts:
        assert pipe.phonemizer(t) == jax_pipe.phonemizer(t)
        ids = pipe.tokenizer(pipe.phonemizer(t))
        assert list(ids) == list(jax_pipe.tokenizer(jax_pipe.phonemizer(t)))
        assert len(ids) > len(t) // 2 and max(ids) < VOCAB[language]
    text, text_len, durations, aligntext, aligntext_len, feats = _jax_stages(
        jax_pipe, align_vars, audio_vars, texts)
    got = pipe.align_model.predict(torch.from_numpy(text), torch.from_numpy(text_len)).numpy()
    np.testing.assert_allclose(got, durations, rtol=1e-5, atol=0)
    ids, lengths = pipe.align_model.align(torch.from_numpy(text), got,
                                          torch.from_numpy(text_len), aligntext.shape[1])
    near = _near_integer_tokens(durations, text_len)
    for b in range(len(texts)):
        differ = np.nonzero(ids.numpy()[b] != aligntext[b])[0]
        assert not len(differ) or b in near, f"row {b}: ids differ at {differ}, no tie"
    np.testing.assert_array_equal(lengths.numpy(), aligntext_len)
    port_feats = pipe.audio_model.predict(torch.from_numpy(aligntext),
                                          torch.from_numpy(aligntext_len))
    for g, w in zip(port_feats, feats):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4)


def _pulses(f0, n, n_frames, max_pulses):
    """The pulse positions (voiced and unvoiced) the port's synthesis
    places for ``f0`` muted past ``n`` frames."""
    from voice100_tpu_torch.dsp.world import synthesis

    f0 = torch.from_numpy(np.where(np.arange(n_frames) < n, f0, 0).astype(np.float32))[None]
    out_len, _ = synthesis_shape(n_frames, 16000, 10.0, 512)
    f0_s = synthesis._per_sample_f0(f0, 16000 * 10.0 / 1000.0, out_len)
    rate = torch.where(f0_s > 0, f0_s, synthesis._DEFAULT_F0).clamp(synthesis._MIN_RATE,
                                                                    synthesis._MAX_RATE)
    pos = synthesis._pulse_positions(rate, 16000, max_pulses)[0].numpy()
    return pos[pos >= 0]


def _hold_waveform(got, want, pulses, n_fft=512):
    """test_torch_world.py's rule: the waveform within 1e-4 x peak, except
    where JAX's float32 phase lies within its rounding of a wrap and one
    pulse lands a sample from the port's: there the two differ over that
    pulse's response alone, a stretch of at most n_fft + 2 samples that
    starts at one of the port's pulses or a sample before it. Such
    stretches are at most 2% of the pulses; returns their samples."""
    assert got.shape == want.shape and got.dtype == np.float32 and len(got) > 1600
    bad = np.nonzero(np.abs(got - want) > 1e-4 * np.abs(want).max())[0]
    if not len(bad):
        return 0
    stretches = np.split(bad, np.nonzero(np.diff(bad) > n_fft + 1)[0] + 1)
    for stretch in stretches:
        first, last = int(stretch[0]), int(stretch[-1])
        assert last - first <= n_fft + 1, (first, last)
        assert np.isin([first, first + 1], pulses).any(), first
    assert len(stretches) <= 0.02 * len(pulses)
    return sum(int(st[-1] - st[0]) + 1 for st in stretches)


def test_phone_synthesize_matches_jax(phone_pipes):
    """The port's synthesize with JAX's noise against JAX's: on JAX's own
    features (the vocoder stage), and end to end (each package's own
    features, which differ by float32 rounding)."""
    language, jax_pipe, align_vars, audio_vars, pipe = phone_pipes
    texts = TEXTS[language]
    want = jax_pipe.synthesize(texts)
    *_, aligntext, aligntext_len, feats = _jax_stages(jax_pipe, align_vars, audio_vars, texts)
    n_frames = feats[0].shape[1]
    _, max_pulses = synthesis_shape(n_frames, 16000, 10.0, 512)
    keys = jax.random.split(jax.random.PRNGKey(0), len(texts))
    noise = np.stack([np.asarray(jax.random.normal(k, (max_pulses, 512))) for k in keys])
    audio_lens = np.minimum(aligntext_len * 2, n_frames)
    stage = pipe.vocoder.decode_batch(*(torch.from_numpy(f) for f in feats), audio_lens,
                                      noise=torch.from_numpy(noise))
    got = pipe.synthesize(texts, noise=torch.from_numpy(noise))
    port_f0 = pipe.audio_model.predict(torch.from_numpy(aligntext),
                                       torch.from_numpy(aligntext_len))[0].numpy()
    assert len(got) == len(want) == len(texts)
    pulses = masked = 0
    for i, w in enumerate(want):
        n = int(audio_lens[i])
        stage_pulses = _pulses(feats[0][i], n, n_frames, max_pulses)
        masked += _hold_waveform(np.clip(stage[i, :len(w)], -1.0, 1.0), w, stage_pulses)
        masked += _hold_waveform(got[i], w, _pulses(port_f0[i], n, n_frames, max_pulses))
        pulses += len(stage_pulses)
    assert pulses > 10 and masked <= 0.1 * sum(len(w) for w in want)


def test_phone_split_long_matches_jax(phone_pipes):
    language, jax_pipe, _, _, pipe = phone_pipes
    text = LONG[language]
    pieces = pipe._split_long(text)
    assert pieces == jax_pipe._split_long(text)
    assert len(pieces) > 1 and all(pipe._encoded_len(p) <= 128 for p in pieces)
    if language == "ja":
        assert " " not in text and "".join(pieces) == text


# --- asr_en_phone_base, narrow, on a FLAC corpus ----------------------------

SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
HIDDEN = 16


def _phone_config(path):
    with open(os.path.join(ROOT, "config", "asr_en_phone_base.yaml")) as f:
        config = yaml.safe_load(f)
    config["trainer"].update(max_epochs=1, log_every_n_steps=1)
    config["model"]["init_args"].update(encoder_settings=[list(s) for s in SETTINGS],
                                        decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    config["data"]["init_args"].update(batch_size=4)
    with open(path, "w") as f:
        yaml.safe_dump(config, f)
    return str(path), config


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    from test_torch_native import load_jax_lib, write_flac_corpora
    from voice100_tpu_torch.tools.prepare_dataset import cli_main as prepare

    load_jax_lib()  # the JAX loader decodes this corpus
    root = tmp_path_factory.mktemp("phone_corpus")
    data_dir = str(root / "data")
    write_flac_corpora(data_dir, n_lj=6, n_libri=4)
    prepare(["--data_dir", data_dir, "--dataset", "ljspeech,librispeech", "--split",
             "train,valid", "--language", "en", "--use_phone"])
    return root, data_dir


def test_asr_phone_fit_batches_and_losses_match_jax(phone_corpus):
    """Two steps of the narrow asr_en_phone_base copy on the port's
    phonemized FLAC corpus: the port's loader gives the JAX loader's mel
    batches bit for bit (one cache, the JAX loader writes it), and the
    port's train steps from the JAX initial weights give the JAX task's
    and optax's losses within rtol 1e-4."""
    import optax
    from voice100_tpu.data import AudioTextDataModule as JaxData
    from voice100_tpu.models import AudioToAlignText as JaxModel
    from voice100_tpu.training.tasks import make_task as jax_make_task
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training import TrainState, Trainer, TrainerConfig, make_task

    root, data_dir = phone_corpus
    cache = str(root / "shared_cache")
    kwargs = dict(vocoder="mel", dataset="ljspeech,librispeech", language="en", use_phone=True,
                  data_dir=data_dir, cache_dir=cache, batch_size=4)
    jax_data = JaxData(**kwargs)
    jax_data.setup("fit")
    jax_batches = list(jax_data.train_dataloader())
    port_data = AudioTextDataModule(**kwargs, device="cpu")
    port_data.setup("fit")
    port_batches = list(port_data.train_dataloader())
    assert port_data.vocab_size == 71 and len(port_batches) == len(jax_batches) == 3
    for a, b in zip(port_batches, jax_batches):
        for x, y in zip([*a[0], *a[1]], [*b[0], *b[1]]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
    batches = port_batches[:2]

    jax_model = JaxModel(audio_size=64, vocab_size=71, encoder_settings=SETTINGS,
                         decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    task = jax_make_task(jax_model)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(task.init(jax.random.PRNGKey(0), jax_batches[0])))
    params = variables["params"]
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    opt_state = optimizer.init(params)
    want = []
    for batch in batches:
        jbatch = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float32)
                                                              if a.dtype == np.float16 else a),
                                        batch)
        loss, grads = jax.value_and_grad(
            lambda p: task.loss(p, {}, jbatch, None, train=False)[0])(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        want.append(float(loss))

    model = AudioToAlignText(64, 71, SETTINGS, 2, HIDDEN, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    port_task = make_task(model)
    state = TrainState(model, port_task.make_optimizer())
    trainer = Trainer(TrainerConfig())
    got = [float(trainer.train_step(port_task, state, tuple(
        tuple(torch.from_numpy(np.asarray(a)) for a in pair) for pair in batch), None,
        False)["loss"]) for batch in batches]
    assert all(np.isfinite(got)) and got[0] > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_asr_phone_fit_through_the_cli(phone_corpus):
    from voice100_tpu_torch.training.cli import main

    root, data_dir = phone_corpus
    cfg, _ = _phone_config(root / "asr_en_phone_narrow.yaml")
    log = str(root / "fit.jsonl")
    main(["fit", "--config", cfg, "--data_dir", data_dir, "--cache_dir", str(root / "cache"),
          "--checkpoint_dir", str(root / "ckpt"), "--log_path", log, "--device", "cpu"])
    records = [json.loads(line) for line in open(log)]
    steps = [r for r in records if "train_loss" in r and "train_time_s" not in r]
    epoch = [r for r in records if "train_time_s" in r]
    assert len(steps) == 3 and all(np.isfinite(r["train_loss"]) for r in steps)
    assert len(epoch) == 1 and np.isfinite(epoch[0]["val_loss"])
    assert os.path.exists(root / "ckpt" / "last.pt")


# --- chip_smoke.py's phone phase: its configs, texts and FLAC writer --------

def _chip_smoke():
    import sys

    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def test_chip_smoke_drives_the_phone_configs_at_full_width():
    chip_smoke = _chip_smoke()
    for name, want in (("asr_en_phone_base.yaml", chip_smoke.ASR_EN_PHONE_BASE),
                       ("align_en_phone_base.yaml", chip_smoke.ALIGN_EN_PHONE_BASE),
                       ("tts_en_phone_base.yaml", chip_smoke.TTS_EN_PHONE_BASE),
                       ("align_ja_phone_base.yaml", chip_smoke.ALIGN_JA_PHONE_BASE),
                       ("tts_ja_phone_base.yaml", chip_smoke.TTS_JA_PHONE_BASE)):
        init = yaml.safe_load(open(os.path.join(ROOT, "config", name)))["model"]["init_args"]
        got = {k: tuple(map(tuple, v)) if isinstance(v, list) else v for k, v in init.items()
               if k in want}
        assert got == want, name
    from voice100_tpu_torch.text import get_phonemizer, get_tokenizer

    for language, texts, count in (("en", chip_smoke.PHONE_TTS_TEXTS_EN, 16),
                                   ("ja", chip_smoke.PHONE_TTS_TEXTS_JA, 8)):
        phonemizer, tokenizer = get_phonemizer(language, True), get_tokenizer(language, True)
        lengths = [len(tokenizer(phonemizer(t))) for t in texts]
        assert len(texts) == count and min(lengths) >= 10 and max(lengths) <= 256


def test_chip_smoke_flac_writer_decodes_to_its_samples(tmp_path):
    """encode_flac_long (tests/flac_fixture.py's verbatim subframes in
    4096-sample frames with 16-bit block sizes and UTF-8 frame numbers)
    decodes to its samples in both packages, up to 2,000 frames."""
    from voice100_tpu.native.flac import read_flac as jax_read_flac
    from voice100_tpu_torch.native.flac import read_flac

    from test_torch_native import load_jax_lib

    load_jax_lib()
    chip_smoke = _chip_smoke()
    rng = np.random.default_rng(0)
    for n, rate in ((1, 16000), (4096, 16000), (int(8.0 * 22050) + 17, 22050),
                    (2000 * 4096 - 5, 16000)):
        pcm = (rng.standard_normal(n) * 5000).clip(-32768, 32767).astype(np.int16)
        path = tmp_path / f"clip{n}.flac"
        path.write_bytes(chip_smoke.encode_flac_long(pcm, rate))
        (got, got_rate), (want, want_rate) = read_flac(str(path)), jax_read_flac(str(path))
        assert got_rate == want_rate == rate and got.shape == (1, n)
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(got[0], pcm / np.float32(32768.0))


def test_chip_smoke_phone_corpus_layouts_read_back(tmp_path):
    chip_smoke = _chip_smoke()
    from voice100_tpu_torch.data.registry import get_base_dataset

    old = chip_smoke.PHONE_LJ_CLIPS, chip_smoke.PHONE_LIBRI_TRAIN, chip_smoke.PHONE_LIBRI_DEV
    chip_smoke.PHONE_LJ_CLIPS, chip_smoke.PHONE_LIBRI_TRAIN, chip_smoke.PHONE_LIBRI_DEV = 3, 5, 2
    try:
        data_dir, corpora = chip_smoke.write_phone_corpus(str(tmp_path))
    finally:
        chip_smoke.PHONE_LJ_CLIPS, chip_smoke.PHONE_LIBRI_TRAIN, chip_smoke.PHONE_LIBRI_DEV = old
    for dataset, split, key in (("ljspeech", "train", "ljspeech"),
                                ("librispeech", "train", "train-clean-100"),
                                ("librispeech", "valid", "dev-clean")):
        ds = get_base_dataset(data_dir, dataset, split)
        seconds, texts = corpora[key]
        assert len(ds) == len(texts)
        got = sorted(ds[i][2].lower() for i in range(len(ds)))
        assert got == sorted(t.lower() for t in texts)
        assert all(os.path.exists(ds[i][1]) and ds[i][1].endswith(".flac") for i in range(len(ds)))
        assert all(2.0 <= s <= 8.0 for s in seconds)
    texts = sum((corpora[key][1] for key in corpora), [])
    assert any("$" in t for t in texts) and any(ch.isdigit() for t in texts for ch in t)
