"""Port ASR v2 serving slice vs the JAX package (CPU).

A narrow AudioToAlignText (two conv blocks of 32 channels, a 2-layer
biLSTM with H=32) is initialised in JAX, carried across with
``from_jax_variables`` and run by both packages. Logits agree to 1e-4:
both are float32, and the conv, LayerNorm and 2 x 2 directions of
recurrence sum in different orders (measured ~1e-7 here), well inside
that bound. Transcripts from the two pipelines must be equal.
"""

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
    train slice; serving puts the model in eval mode, and clips longer
    than the largest bucket still raise."""
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
        pipe.transcribe([np.zeros(8001, np.float32)])
