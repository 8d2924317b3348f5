"""The port's WORLD analysis vs the JAX package's host analysis (CPU).

Both packages analyse on the host in float64 NumPy (the JAX package's
default ``analysis_backend="numpy"``), and the port's modules are copies
of the JAX package's NumPy paths, so the features are held bit for bit:
``WORLDVocoder.encode`` on seeded voiced clips (a harmonic tone whose F0
moves in 90-260 Hz, with an unvoiced stretch and noise) and unvoiced
ones (noise alone), at 16 and 22.05 kHz, with and without mel-cepstra;
DIO, CheapTrick and every band-aperiodicity estimator on their own; the
sp2mc and mc2sp matrices. A device analysis backend raises naming its
ROADMAP item, from the argument or the environment.
"""

import numpy as np
import pytest

CLIP_SECONDS = (0.4, 0.8, 1.2)


def _clip(seed: int, seconds: float, fs: int, voiced: bool) -> np.ndarray:
    """A seeded clip: harmonics of a moving F0 (90-260 Hz) with a
    silent-noise gap, or noise alone."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    noise = rng.standard_normal(n) * 0.02
    if not voiced:
        return (noise * 5).astype(np.float32)
    f0 = 175.0 + 85.0 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    wav = sum(rng.uniform(0.05, 0.3) / k * np.sin(k * phase) for k in range(1, 12))
    gap = slice(n // 3, n // 3 + n // 5)
    wav[gap] = 0.0
    return (wav + noise).astype(np.float32)


CLIPS = [(seed, sec, voiced) for seed, (sec, voiced) in
         enumerate([(s, True) for s in CLIP_SECONDS] + [(0.6, False)])]


@pytest.mark.parametrize("use_mcep", [True, False], ids=["mcep", "logspc"])
@pytest.mark.parametrize("fs", [16000, 22050])
@pytest.mark.parametrize("seed,seconds,voiced", CLIPS,
                         ids=[f"{'voiced' if v else 'unvoiced'}_{s}s" for _, s, v in CLIPS])
def test_encode_equals_jax(fs, use_mcep, seed, seconds, voiced):
    from voice100_tpu.dsp.world import WORLDVocoder as JaxVocoder
    from voice100_tpu_torch.dsp.world import WORLDVocoder

    wav = _clip(seed, seconds, fs, voiced)
    want = JaxVocoder(sample_rate=fs, use_mcep=use_mcep, analysis_backend="numpy").encode(wav)
    ours = WORLDVocoder(sample_rate=fs, use_mcep=use_mcep, device="cpu")
    got = ours.encode(wav)
    assert [a.dtype for a in got] == [np.float32] * 3
    assert [a.shape[1:] for a in got[1:]] == [(d,) for d in ours.output_dims[1:]]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    f0 = got[0]
    if voiced:  # both voicing targets of the TTS loss have positives and negatives
        assert 0 < (f0 >= 30).mean() < 1 and 0 < (got[2] < -0.2).mean() < 1
    else:
        assert (f0 == 0).mean() > 0.5


@pytest.mark.parametrize("fs", [16000, 22050])
def test_analysis_stages_equal_jax(fs):
    from voice100_tpu.dsp.world import aperiodicity as ja
    from voice100_tpu.dsp.world.cheaptrick import cheaptrick as jax_cheaptrick
    from voice100_tpu.dsp.world.dio import dio as jax_dio
    from voice100_tpu_torch.dsp.world import aperiodicity as ta
    from voice100_tpu_torch.dsp.world.cheaptrick import cheaptrick
    from voice100_tpu_torch.dsp.world.dio import dio

    x = _clip(7, 0.9, fs, True).astype(np.float64)
    f0, pos = dio(x, fs, f0_floor=80.0, f0_ceil=400.0)
    want_f0, want_pos = jax_dio(x, fs, f0_floor=80.0, f0_ceil=400.0)
    np.testing.assert_array_equal(f0, want_f0)
    np.testing.assert_array_equal(pos, want_pos)
    n_fft = 512 if fs == 16000 else 1024
    np.testing.assert_array_equal(cheaptrick(x, f0, pos, fs, n_fft),
                                  jax_cheaptrick(x, f0, pos, fs, n_fft))
    for method in ("harmonic", "comb"):
        np.testing.assert_array_equal(ta.band_aperiodicity(x, f0, pos, fs, method=method),
                                      ja.band_aperiodicity(x, f0, pos, fs, method=method))
    np.testing.assert_array_equal(ta.band_aperiodicity_gd(x, f0, pos, fs),
                                  ja.band_aperiodicity_gd(x, f0, pos, fs))
    np.testing.assert_array_equal(ta.d4c(x, f0, pos, fs, n_fft), ja.d4c(x, f0, pos, fs, n_fft))
    # the basis solve, the FFT path's cross-check
    basis = ta._harmonic_impl(x, f0, pos, fs, 4.0)
    np.testing.assert_array_equal(basis, ja._harmonic_impl(x, f0, pos, fs, np, 4.0))
    voiced = f0 > 0
    fft = ta.band_aperiodicity(x, f0, pos, fs)
    assert np.abs(basis[voiced] - fft[voiced]).max() < 1.0  # dB


@pytest.mark.parametrize("fftlen,order,alpha", [(512, 24, 0.410), (1024, 34, 0.455)])
def test_mcep_matrices_equal_jax(fftlen, order, alpha):
    from voice100_tpu.dsp import mcep as jax_mcep
    from voice100_tpu_torch.dsp import mcep

    np.testing.assert_array_equal(mcep.create_sp2mc_matrix(fftlen, order, alpha),
                                  jax_mcep.create_sp2mc_matrix(fftlen, order, alpha))
    np.testing.assert_array_equal(mcep.create_mc2sp_matrix(fftlen, order, alpha),
                                  jax_mcep.create_mc2sp_matrix(fftlen, order, alpha))
    np.testing.assert_array_equal(mcep.freqt_matrix(order, order + 3, alpha),
                                  jax_mcep.freqt_matrix(order, order + 3, alpha))
    assert not mcep.create_sp2mc_matrix(fftlen, order, alpha).flags.writeable


def test_device_backend_raises_naming_the_item(monkeypatch):
    from voice100_tpu_torch.dsp.world import WORLDVocoder, band_aperiodicity, cheaptrick
    from voice100_tpu_torch.dsp.world.backend import ANALYSIS_ITEM

    wav = _clip(0, 0.4, 16000, True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 7"):
        WORLDVocoder(device="cpu", analysis_backend="jax").encode(wav)
    monkeypatch.setenv("VOICE100_TPU_WORLD_BACKEND", "jax")
    vocoder = WORLDVocoder(device="cpu")
    with pytest.raises(NotImplementedError, match=ANALYSIS_ITEM):
        vocoder.encode(wav)
    x, f0, pos = wav.astype(np.float64), np.full(41, 150.0), np.arange(41) * 0.01
    with pytest.raises(NotImplementedError, match="item 7"):
        cheaptrick(x, f0, pos, 16000, backend="jax")
    with pytest.raises(NotImplementedError, match="item 7"):
        band_aperiodicity(x, f0, pos, 16000, backend="jax")
