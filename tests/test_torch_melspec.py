"""Port log-mel front end vs the JAX package (CPU).

The port's plain log-mel is held against ``voice100_tpu.ops.melspec``
and against the Pallas kernel in interpret mode at atol 1e-4, the bound
the JAX package holds its own kernel to (tests/test_ops_parity.py:241).
The CUDA kernel runs only on the card (chip_smoke.py); here its wrapper
takes the plain path, its constants are checked, and its algorithm (tile
framing with reflect padding by index arithmetic, the radix-4 real FFT
with the float32 twiddle table, the band-table mel sums) is replayed in
numpy against ``np.fft.rfft`` and the plain version.
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
    """The numpy constants rebuilt in the port equal the JAX package's;
    the kernel's twiddle table times the window gives the JAX kernel's
    window-folded DFT column of bin 1, and its mel band table expands to
    the JAX filterbank."""
    from voice100_tpu.ops import melspec as jmel
    from voice100_tpu.ops.melspec_pallas import _constants

    np.testing.assert_array_equal(tmel.hann_window(400, 512), jmel.hann_window(400, 512))
    np.testing.assert_array_equal(tmel.mel_filterbank(257, 64, 16000),
                                  jmel.mel_filterbank(257, 64, 16000))
    window, twiddles, bands, weights = melspec_cuda.kernel_constants(512, 400, 64, 16000)
    ref_cos, ref_sin, ref_fb = _constants(512, 400, 64, 16000)
    np.testing.assert_array_equal(window, jmel.hann_window(400, 512).astype(np.float32))
    np.testing.assert_allclose(twiddles[:, 0] * window, ref_cos[:, 1], rtol=0, atol=1e-7)
    np.testing.assert_allclose(twiddles[:, 1] * window, ref_sin[:, 1], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(_expand_bands(bands, weights, 257), ref_fb[:257])
    assert tmel.LOG_OFFSET == jmel.LOG_OFFSET and tmel.MELSPEC_DIM == jmel.MELSPEC_DIM


def _expand_bands(bands, weights, n_freq):
    """The kernel's per-filter bin table -> a dense ``[n_freq, n_mels]``."""
    fb = np.zeros((n_freq, bands.shape[1]), np.float32)
    for m, (first, count, offset) in enumerate(bands.T):
        fb[first:first + count, m] = weights[offset:offset + count]
    return fb


def test_mel_band_table_expands_to_the_filterbank():
    """Each filter's nonzeros are one contiguous bin range, and the table
    holds exactly them: it expands to ``mel_filterbank(257, 64, 16000)``."""
    _, _, bands, weights = melspec_cuda.kernel_constants(512, 400, 64, 16000)
    fb = tmel.mel_filterbank(257, 64, 16000)
    np.testing.assert_array_equal(_expand_bands(bands, weights, 257), fb)
    assert (weights > 0).all() and bands[1].sum() == weights.size == (fb != 0).sum()
    assert bands[1].max() <= 32 and (bands[0] + bands[1] <= 257).all()


def _digit_reverse4(j):
    return ((j & 3) << 6) | (((j >> 2) & 3) << 4) | (((j >> 4) & 3) << 2) | ((j >> 6) & 3)


def _kernel_rfft(frames, twiddles):
    """The kernel's real FFT in numpy, float32 as on the card
    (``csrc/melspec.cu``): the windowed even/odd samples packed as one
    256-point complex sequence in digit-reversed order, four in-place
    radix-4 stages with the float32 twiddle table, then the real split
    into bins 0..256. ``frames [rows, 512]`` -> ``[rows, 257]`` complex."""
    tw = (twiddles[:, 0] + 1j * twiddles[:, 1]).astype(np.complex64)
    z = (frames[:, 0::2] + 1j * frames[:, 1::2]).astype(np.complex64)
    z = z[:, _digit_reverse4(np.arange(256))]
    length = 4
    while length <= 256:
        quarter, stride = length // 4, 512 // length
        b = np.arange(64)
        k = b % quarter
        idx = (b // quarter) * length + k
        a = [z[:, idx + m * quarter] * (tw[m * k * stride] if m else 1) for m in range(4)]
        s02, d02, s13, d13 = a[0] + a[2], a[0] - a[2], a[1] + a[3], a[1] - a[3]
        z[:, idx], z[:, idx + 2 * quarter] = s02 + s13, s02 - s13
        z[:, idx + quarter], z[:, idx + 3 * quarter] = d02 - 1j * d13, d02 + 1j * d13
        length *= 4
    k = np.arange(129)
    zk, zn = z[:, k], np.conj(z[:, (256 - k) % 256])
    even, odd = (zk + zn) / 2, (zk - zn) / 2j
    out = np.empty((frames.shape[0], 257), np.complex64)
    out[:, k] = even + tw[k] * odd
    out[:, 256 - k[1:]] = np.conj(even[:, 1:]) + tw[256 - k[1:]] * np.conj(odd[:, 1:])
    out[:, 256] = even[:, 0] - odd[:, 0]
    return out


def test_kernel_real_fft_matches_numpy_rfft():
    window, twiddles, _, _ = melspec_cuda.kernel_constants(512, 400, 64, 16000)
    frames = _wav(5, (64, 512), scale=1.0) * window
    got = _kernel_rfft(frames, twiddles)
    want = np.fft.rfft(frames.astype(np.float64), axis=-1)
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5


@pytest.mark.parametrize("length", [257, 4096, 3337])
def test_kernel_algorithm_matches_plain_log_mel(length):
    """The kernel's whole algorithm in numpy (tile framing with reflect
    padding by index arithmetic, the real FFT, the band-table mel sums,
    the log) against the plain version, including the shortest waveform
    the kernel takes (257 samples)."""
    window, twiddles, bands, weights = melspec_cuda.kernel_constants(512, 400, 64, 16000)
    wav = _wav(6, (2, length))
    n_frames = length // 160 + 1
    pos = np.arange(n_frames)[:, None] * 160 - 256 + np.arange(512)[None, :]
    pos = np.where(pos < 0, -pos, pos)
    pos = np.where(pos >= length, 2 * (length - 1) - pos, pos)
    frames = wav[:, pos].reshape(-1, 512) * window
    power = np.abs(_kernel_rfft(frames, twiddles)) ** 2
    mel = power @ _expand_bands(bands, weights, 257)
    got = np.log(mel + tmel.LOG_OFFSET).reshape(2, n_frames, 64)
    want = tmel.log_mel_spectrogram(torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


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

