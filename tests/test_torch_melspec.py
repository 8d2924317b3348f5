"""Port log-mel front end vs the JAX package (CPU).

The port's plain log-mel is held against ``voice100_tpu.ops.melspec``
and against the Pallas kernel in interpret mode at atol 1e-4, the bound
the JAX package holds its own kernel to (tests/test_ops_parity.py:241).
The CUDA kernel runs only on the card (chip_smoke.py); here its wrapper
takes the plain path, and its constants are checked.
"""

import numpy as np
import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)
import jax.numpy as jnp
import torch

from voice100_tpu_torch.ops import melspec as tmel
from voice100_tpu_torch.ops import melspec_cuda


def _wav(seed, shape, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("shape", [(4800,), (2, 4800), (3, 2, 3337)])
def test_plain_log_mel_matches_jax(shape):
    from voice100_tpu.ops.melspec import log_mel_spectrogram

    wav = _wav(0, shape)
    ref = np.asarray(log_mel_spectrogram(jnp.asarray(wav)))
    got = tmel.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_plain_log_mel_matches_pallas_interpret():
    from voice100_tpu.ops.melspec_pallas import log_mel_spectrogram_pallas

    wav = _wav(1, (2, 4800))
    ref = np.asarray(log_mel_spectrogram_pallas(jnp.asarray(wav), interpret=True))
    got = tmel.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_constants_match_jax():
    """The numpy constants rebuilt in the port equal the JAX package's,
    including the window-folded DFT the kernel reads."""
    from voice100_tpu.ops import melspec as jmel
    from voice100_tpu.ops.melspec_pallas import _constants

    np.testing.assert_array_equal(tmel.hann_window(400, 512), jmel.hann_window(400, 512))
    np.testing.assert_array_equal(tmel.mel_filterbank(257, 64, 16000),
                                  jmel.mel_filterbank(257, 64, 16000))
    cos_w, sin_w, fb = melspec_cuda.folded_constants(512, 400, 64, 16000)
    ref_cos, ref_sin, ref_fb = _constants(512, 400, 64, 16000)
    np.testing.assert_array_equal(cos_w, ref_cos[:, :257])
    np.testing.assert_array_equal(sin_w, ref_sin[:, :257])
    np.testing.assert_array_equal(fb, ref_fb[:257])
    assert tmel.LOG_OFFSET == jmel.LOG_OFFSET and tmel.MELSPEC_DIM == jmel.MELSPEC_DIM


def test_frame_signal_matches_jax():
    from voice100_tpu.ops.melspec import frame_signal

    wav = _wav(2, (2, 1000))
    ref = np.asarray(frame_signal(jnp.asarray(wav), 512, 160))
    got = tmel.frame_signal(torch.from_numpy(wav), 512, 160).numpy()
    np.testing.assert_array_equal(got, ref)


def test_wrapper_takes_plain_path_on_cpu():
    wav = torch.from_numpy(_wav(3, (2, 4000)))
    before = melspec_cuda.log_mel_spectrogram_cuda.launches
    got = melspec_cuda.log_mel_spectrogram_cuda(wav)
    assert melspec_cuda.log_mel_spectrogram_cuda.launches == before
    torch.testing.assert_close(got, tmel.log_mel_spectrogram(wav), rtol=0, atol=0)
    with pytest.raises(ValueError):
        melspec_cuda.log_mel_spectrogram_cuda(wav.to("meta"))


def test_pipeline_features_match_jax_ragged_int16():
    """Ragged int16 batch through both pipelines' front ends: int16
    normalised by 1/32768 on the device, frames past each clip's
    ``len // 160 + 1`` set to BLANK_AUDIO."""
    from voice100_tpu.inference import ASRPipeline as JaxPipeline
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText

    rng = np.random.default_rng(4)
    pcm = (rng.standard_normal((3, 8000)) * 3000).astype(np.int16)
    lengths = np.asarray([8000, 5123, 700], np.int32)
    for row, n in enumerate(lengths):
        pcm[row, n:] = 0

    jax_pipe = JaxPipeline(model=None, variables=None)
    ref_mel, ref_len = jax_pipe._features(jnp.asarray(pcm), jnp.asarray(lengths))

    model = AudioToAlignText(64, 29, ((8, False, 3, 2, 1, False),), 1, 8, device="cpu")
    pipe = ASRPipeline(model, device="cpu")
    mel, mel_len = pipe._features(torch.from_numpy(pcm), torch.from_numpy(lengths))
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=1e-4, atol=1e-4)
    from voice100_tpu_torch.ops.mask import BLANK_AUDIO

    assert (mel[2, int(mel_len[2]):] == np.float32(BLANK_AUDIO)).all()

