"""Port WORLD decoding vs the JAX package (CPU).

* host copies: the mel-cepstrum -> log-spectrum matrix and
  ``decode_aperiodicity`` bit-equal to the JAX package's numpy;
* synthesis (``synthesize_batch``) against ``voice100_tpu.dsp.world.
  synthesis.synthesize_fn``, fed JAX's own noise
  (``jax.random.normal(PRNGKey(0), (max_pulses, n))``):

  - pulse positions, read off each side's output for a flat envelope
    (sp = 1, all voiced, ap = 1e-6: the impulse response is then a delta,
    so the samples above 1 are the pulses). JAX places pulses by a float32
    prefix sum in XLA's order, the port by a float64 one, so they can
    part where JAX's phase lies within its own rounding (up to ~6e-4
    cycles over 20 s) of a wrap: on the 0.3-0.5 s cases all equal; on the
    10 s case at least 98% equal and the rest within one sample;
  - the waveform, on inputs whose positions agree: within 1e-4 x peak,
    sample by sample (float32 DFT products in another order, ~5e-6
    measured), at 16 kHz and 22.05 kHz (fractional hop), with unvoiced
    spans, and through ``WORLDVocoder.decode_batch`` with muted frames.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.dsp.mcep import create_mc2sp_matrix
from voice100_tpu_torch.dsp.world import WORLDVocoder, synthesis_shape, synthesize_batch
from voice100_tpu_torch.dsp.world.codec import decode_aperiodicity, get_num_aperiodicities

WAVE_TOL = 1e-4  # x peak


def _pulses(y):
    return np.nonzero(np.abs(y) > 1.0)[0]


def _jax_noise(n_frames, fs, n, key=None):
    _, max_pulses = synthesis_shape(n_frames, fs, 10.0, n)
    key = jax.random.PRNGKey(0) if key is None else key
    return np.asarray(jax.random.normal(key, (max_pulses, n)))


def _contour(rng, n_frames, unvoiced=False):
    t = np.arange(n_frames) / 100.0
    f0 = 150 + 40 * np.sin(2 * np.pi * 0.7 * t + rng.uniform(0, 6)) + rng.normal(0, 3, n_frames)
    if unvoiced:
        f0[n_frames // 4:n_frames // 2] = 0.0
        f0[-5:] = 0.0
    return f0.astype(np.float32)


def _both(f0, sp, ap, fs):
    from voice100_tpu.dsp.world.synthesis import synthesize_fn

    n = (sp.shape[1] - 1) * 2
    noise = _jax_noise(len(f0), fs, n)
    want = np.asarray(synthesize_fn(f0, sp, ap, fs=fs))
    got = synthesize_batch(*(torch.from_numpy(np.ascontiguousarray(x))[None] for x in (f0, sp, ap)),
                           fs=fs, noise=torch.from_numpy(noise.copy())[None])[0].numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    return got, want


def _flat(n_frames, fs):
    n = 512 if fs == 16000 else 1024
    return (np.ones((n_frames, n // 2 + 1), np.float32),
            np.full((n_frames, n // 2 + 1), 1e-6, np.float32))


@pytest.mark.parametrize("fs,order,alpha,n_fft", [(16000, 24, 0.410, 512),
                                                  (22050, 34, 0.455, 1024)])
def test_host_copies_are_bit_equal(fs, order, alpha, n_fft):
    from voice100_tpu.dsp import mcep
    from voice100_tpu.dsp.world import codec

    np.testing.assert_array_equal(create_mc2sp_matrix(n_fft, order, alpha),
                                  mcep.create_mc2sp_matrix(n_fft, order, alpha))
    assert get_num_aperiodicities(fs) == codec.get_num_aperiodicities(fs)
    coded = np.random.default_rng(0).uniform(-60, 0, (37, get_num_aperiodicities(fs)))
    np.testing.assert_array_equal(decode_aperiodicity(coded, fs, n_fft),
                                  codec.decode_aperiodicity(coded, fs, n_fft))


@pytest.mark.parametrize("seconds,fs", [(0.3, 16000), (0.5, 16000), (0.4, 22050)])
def test_pulse_positions_equal_on_short_clips(seconds, fs):
    rng = np.random.default_rng(int(seconds * 10) + fs)
    n_frames = int(seconds * 100) + 1
    got, want = _both(_contour(rng, n_frames), *_flat(n_frames, fs), fs)
    np.testing.assert_array_equal(_pulses(got), _pulses(want))
    assert len(_pulses(want)) > 30


def test_pulse_positions_on_a_long_clip():
    """10 s: JAX's float32 phase sum drifts from the exact one by up to
    ~3e-4 cycles, so some pulses sit one sample off; no more than 2%."""
    rng = np.random.default_rng(10)
    n_frames = 1001
    got, want = _both(_contour(rng, n_frames), *_flat(n_frames, 16000), 16000)
    pg, pw = _pulses(got), _pulses(want)
    assert len(pg) == len(pw) > 1400
    diff = np.abs(pg - pw)
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.98, (diff == 0).mean()


@pytest.mark.parametrize("fs", [16000, 22050])
@pytest.mark.parametrize("unvoiced", [False, True], ids=["voiced", "unvoiced_spans"])
def test_waveform_matches_jax(fs, unvoiced):
    rng = np.random.default_rng(fs + unvoiced)
    n_frames = 41
    n = 512 if fs == 16000 else 1024
    f0 = _contour(rng, n_frames, unvoiced)
    # the pulses come from f0 alone: hold them first, then the waveform
    got, want = _both(f0, *_flat(n_frames, fs), fs)
    np.testing.assert_array_equal(_pulses(got), _pulses(want))
    sp = np.exp(rng.normal(-6, 1, (n_frames, 1)) + np.linspace(0, -4, n // 2 + 1)[None, :])
    ap = decode_aperiodicity(rng.uniform(-30, -1, (n_frames, get_num_aperiodicities(fs))),
                             fs, n)
    got, want = _both(f0, sp.astype(np.float32), ap.astype(np.float32), fs)
    peak = np.abs(want).max()
    assert peak > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_TOL * peak)


def test_decode_batch_matches_jax_with_muted_frames():
    """mcep -> spectrum, codeap decode, muting past ``lengths`` and the
    int16 quantization, batch of 2 with JAX's per-row noise."""
    from voice100_tpu.dsp.world import WORLDVocoder as JaxVocoder

    rng = np.random.default_rng(7)
    batch, n_frames = 2, 31
    f0 = np.stack([_contour(rng, n_frames, True) for _ in range(batch)])
    mcep = np.zeros((batch, n_frames, 25), np.float32)
    mcep[:, :, 0] = -4 + rng.normal(0, 0.3, (batch, n_frames))
    mcep[:, :, 1:] = rng.normal(0, 0.2, (batch, n_frames, 24))
    codeap = rng.uniform(-25, -2, (batch, n_frames, 1)).astype(np.float32)
    lengths = np.asarray([n_frames, 17])
    ours = WORLDVocoder(use_mcep=True, device="cpu")
    theirs = JaxVocoder(use_mcep=True)
    assert ours.output_dims == theirs.output_dims == (1, 25, 1)
    assert WORLDVocoder(22050, device="cpu").output_dims == JaxVocoder(22050).output_dims
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    noise = np.stack([_jax_noise(n_frames, 16000, 512, k) for k in keys])
    # pulses from the muted f0 agree (flat envelope, port vs JAX)
    muted = np.where(np.arange(n_frames)[None] < lengths[:, None], f0, 0.0).astype(np.float32)
    for row in range(batch):
        got, want = _both(muted[row], *_flat(n_frames, 16000), 16000)
        np.testing.assert_array_equal(_pulses(got), _pulses(want))
    for dtype in (np.float32, np.int16):
        want = theirs.decode_batch(f0, mcep, codeap, lengths, dtype=dtype)
        got = ours.decode_batch(torch.from_numpy(f0), torch.from_numpy(mcep),
                                torch.from_numpy(codeap), lengths, dtype=dtype,
                                noise=torch.from_numpy(noise.copy()))
        assert got.dtype == want.dtype and got.shape == want.shape
        if dtype == np.float32:
            peak = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_TOL * peak)
            # past the last frame and the last pulse's response (n samples)
            muted_from = int(round((lengths[1] + 1) * 160)) + 512
            assert np.abs(got[1, muted_from:]).max() < 1e-3 * peak
        else:
            assert np.abs(got.astype(int) - want).max() <= 1


def test_decode_matches_jax_and_noise_sources():
    from voice100_tpu.dsp.world import WORLDVocoder as JaxVocoder

    rng = np.random.default_rng(8)
    n_frames = 21
    f0 = _contour(rng, n_frames)
    mcep = np.zeros((n_frames, 25), np.float32)
    mcep[:, 0] = -4
    codeap = np.full((n_frames, 1), -10.0, np.float32)
    ours = WORLDVocoder(use_mcep=True, device="cpu")
    want = JaxVocoder(use_mcep=True).decode(f0, mcep, codeap)
    noise = torch.from_numpy(_jax_noise(n_frames, 16000, 512).copy())
    got = ours.decode(f0, mcep, codeap, noise=noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=WAVE_TOL * np.abs(want).max())
    # default noise: a generator seeded 0, so decoding is deterministic
    a, b = ours.decode(f0, mcep, codeap), ours.decode(f0, mcep, codeap)
    np.testing.assert_array_equal(a, b)
    c = ours.decode(f0, mcep, codeap, noise=torch.Generator().manual_seed(1))
    assert not np.array_equal(a, c)
    with pytest.raises(ValueError, match="noise"):
        ours.decode(f0, mcep, codeap, noise=torch.zeros(3, 4))


def test_encode_raises():
    # the host analysis runs (held to the JAX package in
    # test_torch_world_analysis.py); the device analysis is not ported
    f0, mcep, codeap = WORLDVocoder(device="cpu", use_mcep=True).encode(np.zeros(1600, np.float32))
    assert (f0.shape, mcep.shape, codeap.shape) == ((11,), (11, 25), (11, 1))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7"):
        WORLDVocoder(device="cpu", analysis_backend="jax").encode(np.zeros(1600, np.float32))
