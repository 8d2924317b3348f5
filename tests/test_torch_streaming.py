"""Port long-form streaming ASR vs the JAX package (CPU).

A 1-layer AudioToAlignText (one conv block of 16 channels, stride 2;
H=16) is initialised in JAX and carried across with
``from_jax_variables``; both pipelines take buckets of 0.5 and 1.0 s.

* A port ``StreamingASRSession`` and a JAX one over the same chunks
  (int16 and float32, uneven sizes) agree after every ``feed`` and after
  ``finish``: equal committed ids, committed frame, buffer base and
  transcript. Cases: the default contexts (the window slides past the
  1.0 s bucket), ``left_context_sec=None``, narrow contexts over a long
  stream, and an infinite right context (equal to offline
  ``transcribe`` too).
* ``transcribe`` of short and long clips in one call equals JAX's,
  greedy and with a beam (the long clip decodes greedily in both).
* The JAX tests of long-form serving (tests/test_inference.py:73, 228,
  256, 293) against the port; the last trains with the port's ``fit``.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.inference import ASRPipeline, StreamingASRSession
from voice100_tpu_torch.models import AudioToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables

SETTINGS = ((16, False, 3, 2, 1, False),)
BUCKETS = (0.5, 1.0)


@pytest.fixture(scope="module")
def models():
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model = JaxModel(audio_size=64, vocab_size=29, encoder_settings=SETTINGS,
                     decoder_num_layers=1, decoder_hidden_size=16)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 51, 64)), jnp.asarray([51]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = AudioToAlignText(64, 29, SETTINGS, 1, 16, device="cpu")
    port.load_state_dict(from_jax_variables(variables))
    return model, variables, port


def _pipes(models, batch_size=2, buckets=BUCKETS, **kwargs):
    from voice100_tpu.inference import ASRPipeline as JaxPipeline

    model, variables, port = models
    return (JaxPipeline(model, variables, batch_size=batch_size, buckets_sec=buckets, **kwargs),
            ASRPipeline(port, batch_size=batch_size, buckets_sec=buckets, device="cpu",
                        **kwargs))


def _chunks(seed, sizes):
    """Noise chunks of ``sizes`` samples, every other one int16 PCM."""
    rng = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(sizes):
        w = rng.randn(n) * 0.1
        out.append((w * 32768).clip(-32768, 32767).astype(np.int16) if i % 2 else
                   w.astype(np.float32))
    return out


def _state(session):
    return (list(session._committed_ids), session._committed_frame, session._base,
            session.transcript)


CONTEXTS = {
    "defaults": ({}, [777] * 40),
    "no_left_context": ({"left_context_sec": None}, [777, 1600, 333, 4000] * 4),
    "sliding_window": ({"chunk_sec": 0.2, "right_context_sec": 0.3, "left_context_sec": 0.5},
                       [1600, 777, 2500] * 12),
    "infinite_right_context": ({"chunk_sec": 0.1, "right_context_sec": 1e9,
                                "left_context_sec": None}, [777] * 15),
}


@pytest.mark.parametrize("name", list(CONTEXTS))
def test_session_matches_jax_after_every_feed(models, name):
    from voice100_tpu.inference import StreamingASRSession as JaxSession

    kwargs, sizes = CONTEXTS[name]
    jax_pipe, pipe = _pipes(models, batch_size=1)
    ref, got = JaxSession(jax_pipe, **kwargs), StreamingASRSession(pipe, **kwargs)
    chunks = _chunks(1, sizes)
    for chunk in chunks:
        assert got.feed(chunk) == ref.feed(chunk)
        assert _state(got) == _state(ref)
    assert got.finish() == ref.finish()
    assert _state(got) == _state(ref)
    total = sum(sizes)
    assert got._committed_frame >= total // 320
    if name == "sliding_window":  # the window slid: samples were dropped
        assert got._base > pipe.buckets[-1]
    if name == "infinite_right_context":
        assert got.windows == 1  # nothing commits before finish
        wav = np.concatenate([c.astype(np.float32) / 32768.0 if c.dtype == np.int16 else c
                              for c in chunks])
        assert got.transcript == pipe.transcribe([wav])[0] == jax_pipe.transcribe([wav])[0]


@pytest.mark.parametrize("beam", [0, 4], ids=["greedy", "beam"])
def test_transcribe_long_and_short_clips_matches_jax(models, beam):
    jax_pipe, pipe = _pipes(models, beam_size=beam)
    rng = np.random.RandomState(3)
    wavs = [(rng.randn(6000) * 0.1).astype(np.float32),
            (rng.randn(40000) * 0.1).astype(np.float32),  # > the 1.0 s bucket: streams
            (rng.randn(3000) * 3000).astype(np.int16),
            (rng.randn(23000) * 3000).astype(np.int16),  # streams
            (rng.randn(12000) * 0.1).astype(np.float32)]
    got = pipe.transcribe(wavs)
    assert got == jax_pipe.transcribe(wavs)
    assert [r["samples"] for r in pipe.streamed] == [40000, 23000]
    assert all(r["committed_frame"] >= r["samples"] // 320 for r in pipe.streamed)
    if beam:  # the long clips decode greedily, as the greedy pipeline does
        _, greedy = _pipes(models)
        want = greedy.transcribe([wavs[1], wavs[3]])
        assert [got[1], got[3]] == want


# --- tests/test_inference.py's long-form tests, against the port ------------

def test_streaming_feed_int16_matches_float():
    rng = np.random.RandomState(2)
    pcm = (rng.randn(3200) * 3000).astype(np.int16)
    buffers = []
    for chunk in (pcm, pcm.astype(np.float32) / 32768.0):
        s = StreamingASRSession.__new__(StreamingASRSession)
        s._buffer = np.zeros(0, np.float32)
        s._committed_ids = []
        s._since_decode = 0
        s.chunk = 10 ** 9  # never triggers a device decode

        class _Tok:
            def decode(self, ids):
                return ""

            def merge_repeated(self, s):
                return s

        class _Pipe:
            tokenizer = _Tok()

        s.pipeline = _Pipe()
        StreamingASRSession.feed(s, chunk)
        buffers.append(s._buffer)
    np.testing.assert_array_equal(buffers[0], buffers[1])


def test_streaming_asr_no_commit_path_is_offline_identical(models):
    """With an infinite right context nothing commits until finish(),
    which then equals offline transcription exactly."""
    _, pipe = _pipes(models, batch_size=1)
    rng = np.random.RandomState(7)
    wav = (rng.randn(12000) * 0.1).astype(np.float32)
    offline = pipe.transcribe([wav])[0]
    session = StreamingASRSession(pipe, chunk_sec=0.1, right_context_sec=1e9,
                                  left_context_sec=None)
    for start in range(0, len(wav), 777):
        session.feed(wav[start:start + 777])
    assert session.finish() == offline


def test_transcribe_long_form_routes_through_streaming(models):
    """Clips past the largest bucket stream instead of being cut; short
    clips in the same call still batch."""
    _, pipe = _pipes(models)
    rng = np.random.RandomState(3)
    short = (rng.randn(6000) * 0.1).astype(np.float32)
    long = (rng.randn(40000) * 0.1).astype(np.float32)  # > 1.0 s bucket
    out = pipe.transcribe([short, long, short])
    assert len(out) == 3 and all(isinstance(t, str) for t in out)
    session = StreamingASRSession(pipe, chunk_sec=0.5, right_context_sec=0.5,
                                  left_context_sec=1.0)
    for start in range(0, len(long), 8000):
        session.feed(long[start:start + 8000])
    session.finish()
    assert session._committed_frame >= len(long) // 320
    with pytest.raises(NotImplementedError, match="transcribe streams"):
        list(pipe.batches([long]))


def test_long_form_content_matches_wide_bucket_pipeline(tmp_path):
    """A long clip streamed through a small-bucket pipeline gives (nearly)
    the transcript of a pipeline whose buckets hold the whole clip: no
    interior audio is lost to the window bound."""
    from corpus_fixture import make_dummy_corpus
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.ops.metrics import levenshtein
    from voice100_tpu_torch.training import Trainer, TrainerConfig

    root = make_dummy_corpus(str(tmp_path), n_clips=4)
    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=str(tmp_path),
                               cache_dir=str(tmp_path / "cache"), batch_size=4, valid_ratio=0.0,
                               device="cpu")
    model = AudioToAlignText(64, 29, ((32, False, 3, 2, 1, False), (32, False, 3, 1, 1, False)),
                             1, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    trainer = Trainer(TrainerConfig(max_epochs=10, monitor="train_loss"))
    state = trainer.fit(model, data)
    trainer.close()

    wavs = [load_audio(f"{root}/wavs/clip{i:04d}.wav", 16000) for i in range(3)]
    long_clip = np.concatenate(wavs)  # ~3.3 s: three training clips back to back
    wide = ASRPipeline(state.model, batch_size=1, buckets_sec=(0.5, 1.0, 2.0, 4.0, 8.0),
                       device="cpu")
    offline = wide.transcribe([long_clip])[0]
    narrow = ASRPipeline(state.model, batch_size=1, buckets_sec=(0.5, 1.0, 2.0), device="cpu")
    streamed = narrow.transcribe([long_clip])[0]
    assert len(narrow.streamed) == 1
    dist = levenshtein(offline, streamed)
    assert dist <= max(3, len(offline) // 5), (offline, streamed)
