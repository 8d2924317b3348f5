"""Port ASR v2 serving slice vs the JAX package (CPU).

A narrow AudioToAlignText (two conv blocks of 32 channels, a 2-layer
biLSTM with H=32) is initialised in JAX, carried across with
``from_jax_variables`` and run by both packages. Logits agree to 1e-4:
both are float32, and the conv, LayerNorm and 2 x 2 directions of
recurrence sum in different orders (measured ~1e-7 here), well inside
that bound. Transcripts from the two pipelines must be equal.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.models import AudioToAlignText
from voice100_tpu_torch.models.layers import conv_stack_output_length
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables

SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
HIDDEN, VOCAB, MELS = 32, 29, 64


@pytest.fixture(scope="module")
def jax_model():
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model = JaxModel(audio_size=MELS, vocab_size=VOCAB, encoder_settings=SETTINGS,
                     decoder_num_layers=2, decoder_hidden_size=HIDDEN)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 21, MELS)), jnp.asarray([21]))
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port_model(variables):
    model = AudioToAlignText(MELS, VOCAB, SETTINGS, 2, HIDDEN, device="cpu").eval()
    model.load_state_dict(from_jax_variables(variables), strict=True)
    return model


def test_weights_round_trip_exactly(jax_model):
    _, variables = jax_model
    state = from_jax_variables(variables)
    back = to_jax_variables(state)
    flat_ref = jax.tree_util.tree_leaves_with_path(variables)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_back]
    for (_, a), (_, b) in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(a, b)
    again = from_jax_variables(back)
    assert again.keys() == state.keys()
    for k in state:
        torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)
    assert state.keys() == AudioToAlignText(MELS, VOCAB, SETTINGS, 2, HIDDEN,
                                            device="cpu").state_dict().keys()


@pytest.mark.parametrize("settings", [SETTINGS, ((8, False, 3, 2, 1, False),),
                                      ((8, False, 4, 3, 0, True), (8, False, 3, 1, 1, False))])
def test_conv_stack_output_length_matches_jax(settings):
    from voice100_tpu.models.layers import conv_stack_output_length as jax_length

    lengths = np.arange(1, 200, dtype=np.int32)
    want = np.asarray(jax_length(settings, jnp.asarray(lengths)))
    np.testing.assert_array_equal(conv_stack_output_length(settings, torch.from_numpy(lengths)).numpy(), want)
    assert conv_stack_output_length(settings, 1001) == int(jax_length(settings, 1001))


def test_logits_and_greedy_ids_match_jax(jax_model):
    from voice100_tpu.models import AudioToAlignText as JaxModel

    model, variables = jax_model
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((3, 41, MELS)).astype(np.float32)
    lengths = np.asarray([41, 30, 7], np.int32)
    ref, ref_len = model.apply(variables, jnp.asarray(audio), jnp.asarray(lengths))
    ref_ids, _ = model.apply(variables, jnp.asarray(audio), jnp.asarray(lengths),
                             method=JaxModel.greedy_decode)
    port = _port_model(variables)
    with torch.no_grad():
        got, got_len = port(torch.from_numpy(audio), torch.from_numpy(lengths))
        ids, _ = port.greedy_decode(torch.from_numpy(audio), torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)
    top2 = np.sort(np.asarray(ref), axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(ref_ids)[clear])


def test_pipeline_transcripts_match_jax(jax_model):
    """Same weights and clips (float32 and int16 batches, ragged, two
    buckets) through both pipelines give the same strings."""
    from voice100_tpu.inference import ASRPipeline as JaxPipeline
    from voice100_tpu_torch.inference import ASRPipeline

    model, variables = jax_model
    rng = np.random.default_rng(1)
    floats = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (4000, 9000, 2500)]
    pcm = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (7000, 16000, 1200)]
    kwargs = dict(batch_size=2, buckets_sec=(0.5, 1.0))
    jax_pipe = JaxPipeline(model, variables, **kwargs)
    pipe = ASRPipeline(_port_model(variables), device="cpu", **kwargs)
    for clips in (floats, pcm, floats[:1] + pcm[:2]):
        want = jax_pipe.transcribe(clips)
        assert pipe.transcribe(clips) == want
        assert any(want)


def test_training_mode_and_long_inputs_raise(jax_model):
    """Training mode runs (dropout between the biLSTM layers) since the
    train slice; serving puts the model in eval mode. A clip longer than
    the largest bucket still raises in ``batches``; ``transcribe`` streams
    it (tests/test_torch_streaming.py holds that to the JAX package)."""
    from voice100_tpu_torch.inference import ASRPipeline

    port = _port_model(jax_model[1]).train()
    audio, lengths = torch.randn(1, 21, MELS), torch.tensor([21])
    with torch.no_grad():
        dropped, _ = port(audio, lengths, torch.Generator().manual_seed(0))
        plain, _ = port.eval()(audio, lengths)
    assert (dropped - plain).abs().max() > 1e-4
    pipe = ASRPipeline(port.train(), device="cpu", batch_size=1, buckets_sec=(0.5,))
    assert not pipe.model.training
    with pytest.raises(NotImplementedError):
        list(pipe.batches([np.zeros(8001, np.float32)]))
    assert isinstance(pipe.transcribe([np.zeros(8001, np.float32)])[0], str)
    assert [r["samples"] for r in pipe.streamed] == [8001]


def test_pipeline_over_a_mesh_equals_the_plain_call(jax_model):
    """``mesh=`` runs each batch's rows on the devices of its data axis
    (two CPU devices here) and puts them back in order: ids equal, log
    probs within 1e-6, transcripts equal, for greedy and both beams; a
    mesh of one device is the plain call. A batch size the data axis does
    not divide raises the JAX pipeline's ``ValueError``."""
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.parallel import make_mesh

    variables = jax_model[1]
    rng = np.random.default_rng(5)
    clips = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (4000, 9000, 2500, 7000, 6100, 3000)]
    kwargs = dict(batch_size=4, buckets_sec=(0.5, 1.0))
    for beam in (dict(), dict(beam_size=4, beam_device=False), dict(beam_size=4)):
        plain = ASRPipeline(_port_model(variables), device="cpu", **kwargs, **beam)
        meshed = ASRPipeline(_port_model(variables), mesh=make_mesh(["cpu", "cpu"]), **kwargs,
                             **beam)
        one = ASRPipeline(_port_model(variables), mesh=make_mesh(["cpu"]), **kwargs, **beam)
        for (_, wav, lengths), _ in zip(plain.batches(clips), range(2)):
            want, want_len = plain._decode(wav, lengths)
            got, got_len = meshed._decode(wav, lengths)
            np.testing.assert_array_equal(got_len.numpy(), want_len.numpy())
            if want.dtype.is_floating_point:
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(got.numpy(), want.numpy())
            assert all(torch.equal(a, b) for a, b in zip(one._decode(wav, lengths),
                                                         (want, want_len)))
        assert meshed.transcribe(clips) == plain.transcribe(clips) == one.transcribe(clips)
    with pytest.raises(ValueError, match="batch_size 3 must be divisible by the mesh data axis 2"):
        ASRPipeline(_port_model(variables), mesh=make_mesh(["cpu", "cpu"]), batch_size=3)


REACH = 960  # the front end's reach for SETTINGS: 6 mel hops past the last valid frame


def _rule_width(longest, bucket):
    """A batch's width: its longest clip plus the reach, rounded up to
    1,600 samples, capped at its bucket."""
    return min(bucket, -(-(longest + REACH) // 1600) * 1600)


@pytest.mark.parametrize("longest,short_by", [(3839, 0), (3840, 0), (7500, 0), (3200, 160)],
                         ids=["just_under_a_step", "on_a_step", "capped", "a_hop_short"])
def test_a_batch_padded_to_its_reach_gives_the_bucket_logits(jax_model, longest, short_by):
    """A batch padded by the rule (longest + reach just under a 1,600
    boundary, on one, and past its bucket) gives the valid logit frames
    and greedy ids of the same rows padded to their bucket, and
    ``transcribe`` the strings of a bucket-padded run; so does the batch
    padded by hand to exactly longest + reach (within its bucket). One hop
    short of the
    reach, the longest row's last valid frame reads the conv's zero
    padding where the blank level stood, and differs: the reach is
    needed, not merely enough."""
    from voice100_tpu_torch.inference import ASRPipeline

    rng = np.random.default_rng(longest)
    clips = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (longest - 1000, longest, 300, longest - 161)]
    kwargs = dict(batch_size=4, buckets_sec=(0.5, 1.0))
    pipe = ASRPipeline(_port_model(jax_model[1]), device="cpu", **kwargs)
    assert pipe.reach == REACH
    bucket = 8000 if longest <= 8000 else 16000
    (chunk, wav, lengths), = pipe.batches(clips)
    width = wav.shape[1]
    assert width == _rule_width(longest, bucket) and width <= bucket
    assert width % 1600 == 0 or width == bucket
    assert (width == bucket) == (longest == 7500)
    rows = [clips[i] for i in chunk]
    want, want_len = pipe.logits(*map(torch.from_numpy, _numpy_pad(rows, 4, bucket, False)))
    got, got_len = pipe.logits(wav, lengths)
    hand, hand_len = pipe.logits(*map(torch.from_numpy, _numpy_pad(
        rows, 4, min(bucket, longest + REACH - short_by), False)))
    for n in (got_len, hand_len):
        torch.testing.assert_close(n, want_len, rtol=0, atol=0)
    for r, n in enumerate(want_len.tolist()):
        torch.testing.assert_close(got[r, :n], want[r, :n], rtol=0, atol=1e-6)
        assert torch.equal(got[r, :n].argmax(-1), want[r, :n].argmax(-1))
        gap = (hand[r, :n] - want[r, :n]).abs().max().item()
        if short_by and len(rows[r]) == longest:
            assert (hand[r, n - 1] - want[r, n - 1]).abs().max().item() > 1e-3
        else:
            assert gap <= 1e-6, (r, gap)
    bucketed = ASRPipeline(_port_model(jax_model[1]), device="cpu", **kwargs)
    bucketed.reach = None  # an encoder without a reach: every batch at its bucket
    assert next(bucketed.batches(clips))[1].shape[1] == bucket
    texts = pipe.transcribe(clips)
    assert texts == bucketed.transcribe(clips) and any(texts)


def _numpy_pad(clips, rows, width, pcm16):
    """A batch as the pipeline padded it before it staged batches: a fresh
    ``np.zeros`` buffer, each clip written at the start of its row."""
    batch = np.zeros((rows, width), np.int16 if pcm16 else np.float32)
    lengths = np.zeros(rows, np.int32)
    for row, w in enumerate(clips):
        if w.dtype == np.int16 and not pcm16:
            w = w.astype(np.float32) * (1.0 / 32768.0)
        batch[row, :len(w)] = w
        lengths[row] = len(w)
    return batch, lengths


class _RecycledHost:
    """``torch.empty`` for the pipeline's host buffers (the calls that
    name ``pin_memory``) as a caching allocator hands blocks back: every
    request of a rank is a view of one arena that keeps what the last
    batch wrote, and the arena's first bytes are garbage."""

    def __init__(self, empty):
        self.empty, self.arenas = empty, {}

    def __call__(self, size, dtype=None, pin_memory=None, **kwargs):
        if pin_memory is None:
            return self.empty(size, dtype=dtype, **kwargs)
        shape = (size,) if isinstance(size, int) else tuple(size)
        nbytes = int(np.prod(shape)) * dtype.itemsize
        arena = self.arenas.get(len(shape))
        if arena is None or arena.numel() < nbytes:
            grown = torch.full((nbytes,), 0x5A, dtype=torch.uint8)
            if arena is not None:
                grown[:arena.numel()] = arena
            arena = self.arenas[len(shape)] = grown
        return arena[:nbytes].view(dtype).view(shape)


@pytest.fixture
def recycled(monkeypatch):
    monkeypatch.setattr(torch, "empty", _RecycledHost(torch.empty))


def _mix(kind, rng):
    """Clips with a short last batch at batch size 2 and an empty clip."""
    sizes = (0, 1200, 7000, 16000, 300)
    pcm = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in sizes]
    floats = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in sizes]
    return {"int16": pcm, "float32": floats, "mixed": floats[:2] + pcm[2:]}[kind]


@pytest.mark.parametrize("kind", ["int16", "float32", "mixed"])
def test_batches_equal_a_fresh_numpy_pad(jax_model, recycled, kind):
    """Every element of a batch is written, none assumed zero: padded into
    recycled garbage, a batch equals the fresh ``np.zeros`` pad element for
    element (tails, rows past a short last batch, an empty clip's row),
    in the batch's dtype, shortest clips first, at its longest clip plus
    the reach, rounded up to 1,600 samples, or its bucket where narrower
    (1,600, 8,000 and the capped 16,000 here)."""
    from voice100_tpu_torch.inference import ASRPipeline

    clips = _mix(kind, np.random.default_rng(2))
    pipe = ASRPipeline(_port_model(jax_model[1]), device="cpu", batch_size=2,
                       buckets_sec=(0.5, 1.0))
    order = list(np.argsort([len(c) for c in clips]))
    seen = []
    for chunk, wav, lengths in pipe.batches(clips):
        longest = max(len(clips[i]) for i in chunk)
        width = _rule_width(longest, 8000 if longest <= 8000 else 16000)
        want, want_len = _numpy_pad([clips[i] for i in chunk], 2, width, kind == "int16")
        assert wav.dtype == torch.from_numpy(want).dtype and lengths.dtype == torch.int32
        np.testing.assert_array_equal(wav.numpy(), want)
        np.testing.assert_array_equal(lengths.numpy(), want_len)
        seen += chunk
    assert seen == order and len(chunk) == 1


def test_a_recycled_40s_buffer_leaves_no_samples_in_a_5s_batch(jax_model, recycled):
    """A 40 s batch and then a 5 s one, their buffers the same recycled
    bytes: the 5 s batch (70,000 + 960 samples, padded to 72,000) has a
    zero tail and an empty second row of zeros; the 40 s batch keeps its
    bucket, the cap."""
    from voice100_tpu_torch.inference import ASRPipeline

    rng = np.random.default_rng(3)
    long, short = ((rng.standard_normal(n) * 3000).astype(np.int16) + 1
                   for n in (640_000, 70_000))
    pipe = ASRPipeline(_port_model(jax_model[1]), device="cpu", batch_size=2)
    for clips, width in (([long, long[::-1].copy()], 640_000), ([short], 72_000)):
        (chunk, wav, lengths), = pipe.batches(clips)
        want, want_len = _numpy_pad(clips, 2, width, True)
        np.testing.assert_array_equal(wav.numpy(), want)
        np.testing.assert_array_equal(lengths.numpy(), want_len)
    assert not wav[0, 70_000:].any() and not wav[1].any()


def test_transcripts_from_recycled_buffers_match_jax(jax_model, recycled):
    """``test_pipeline_transcripts_match_jax``'s clips, padded into
    recycled garbage, still give the JAX pipeline's strings."""
    from voice100_tpu.inference import ASRPipeline as JaxPipeline
    from voice100_tpu_torch.inference import ASRPipeline

    model, variables = jax_model
    rng = np.random.default_rng(1)
    floats = [(rng.standard_normal(n) * 0.3).astype(np.float32) for n in (4000, 9000, 2500)]
    pcm = [(rng.standard_normal(n) * 3000).astype(np.int16) for n in (7000, 16000, 1200)]
    kwargs = dict(batch_size=2, buckets_sec=(0.5, 1.0))
    jax_pipe = JaxPipeline(model, variables, **kwargs)
    pipe = ASRPipeline(_port_model(variables), device="cpu", **kwargs)
    for clips in (pcm, floats, floats[:1] + pcm[:2], pcm):
        want = jax_pipe.transcribe(clips)
        assert pipe.transcribe(clips) == want
        assert any(want)
