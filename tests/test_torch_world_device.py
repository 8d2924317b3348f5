"""The port's device WORLD analysis vs the JAX package's (CPU).

The JAX package runs its analysis on its device with
``analysis_backend="jax"`` (``dio_jax``, ``_cheaptrick_jax``,
``_harmonic_jax``, ``_band_aperiodicity_jax``, all float32); the port runs
the same estimators in torch float32 (``analysis_backend="device"``, alias
``"jax"``). Both run here on the CPU, the JAX side through XLA, on the
same seeded clips. Float32 against float32 in another order of sums, so
the tolerances below are stated, each at least 10x tighter than the JAX
package's own float32-against-float64 rule for the same quantity
(``tests/test_world.py:177-218``, ``tests/test_world_aperiodicity.py:133-145``),
with the worst case measured here beside it. The four-pitch reanalysis
bars of ``tests/test_world_invariants.py`` hold on the port's device
backend, and noise is unvoiced there as in the JAX package.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import importlib

import numpy as np
import pytest

import test_world_invariants as invariants

jax_cheaptrick = importlib.import_module("voice100_tpu.dsp.world.cheaptrick")
jax_aperiodicity = importlib.import_module("voice100_tpu.dsp.world.aperiodicity")
cheaptrick_mod = importlib.import_module("voice100_tpu_torch.dsp.world.cheaptrick")
aperiodicity_mod = importlib.import_module("voice100_tpu_torch.dsp.world.aperiodicity")

# F0: relative error where both are voiced, and voicing equal on every
# frame (JAX rule: 3% relative, 90% voicing agreement; measured 2.1e-7)
F0_RTOL = 1e-4
# CheapTrick: largest |log| difference of the envelopes (JAX rule: 0.5
# max, 0.01 median over energetic bins; measured 1.9e-5)
LOG_ENVELOPE_ATOL = 1e-3
# harmonic band aperiodicity, dB (JAX rule: 0.3 dB max; measured 9.1e-6)
HARMONIC_DB_ATOL = 0.01
# comb-correlation band aperiodicity, dB (JAX rule: 0.5 dB median;
# measured 9.5e-5)
COMB_DB_ATOL = 0.05
# encode: mel-cepstra or log envelopes (JAX rule: 0.2 median over bins
# within 20 nats of the peak; measured 8.1e-5) and coded aperiodicity in
# dB (measured 1.6e-4)
FEATURE_ATOL = 1e-3
CODEAP_DB_ATOL = 0.01


def _clip(seed: int, seconds: float, fs: int) -> np.ndarray:
    """Harmonics of a moving F0 (110-240 Hz) with a silent gap and noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * fs)
    t = np.arange(n) / fs
    f0 = 175.0 + 65.0 * np.sin(2 * np.pi * rng.uniform(0.5, 2.0) * t + rng.uniform(0, 6.28))
    phase = 2 * np.pi * np.cumsum(f0) / fs
    wav = sum(rng.uniform(0.05, 0.3) / k * np.sin(k * phase) for k in range(1, 15))
    wav[n // 2:n // 2 + n // 6] = 0.0
    return wav + rng.standard_normal(n) * 0.01


def _assert_f0(ours: np.ndarray, ref: np.ndarray) -> None:
    assert ours.shape == ref.shape
    np.testing.assert_array_equal(ours > 0, ref > 0)
    both = ref > 0
    assert np.all(np.abs(ours[both] - ref[both]) <= F0_RTOL * ref[both])


def _analysis_inputs(fs: int, seed: int = 0):
    """A clip and the JAX device F0 track it is analysed at."""
    from voice100_tpu.dsp.world.dio_jax import dio_jax

    x = _clip(seed, 0.4, fs)
    f0, positions = dio_jax(x, fs)
    return x, f0, positions


@pytest.mark.parametrize("fs", [16000, 22050])
@pytest.mark.parametrize("seed", [0, 1])
def test_dio_device_matches_dio_jax(fs, seed):
    from voice100_tpu.dsp.world.dio_jax import dio_jax
    from voice100_tpu_torch.dsp.world import dio_device

    x = _clip(seed, 0.4, fs)
    ref_f0, ref_pos = dio_jax(x, fs)
    f0, positions = dio_device(x, fs, device="cpu")
    assert f0.dtype == np.float64 and (f0 > 0).mean() > 0.5
    _assert_f0(f0, ref_f0)
    np.testing.assert_array_equal(positions, ref_pos)


@pytest.mark.parametrize("fs", [16000, 22050])
def test_dio_device_noise_is_unvoiced(fs):
    # test_world_invariants.py:155 on the port's estimator
    from voice100_tpu.dsp.world.dio_jax import dio_jax
    from voice100_tpu_torch.dsp.world import dio_device

    noise = np.random.RandomState(0).randn(fs) * 0.3
    f0, _ = dio_device(noise, fs, device="cpu")
    assert np.mean(f0 > 0) < 0.2
    _assert_f0(f0, dio_jax(noise, fs)[0])


@pytest.mark.parametrize("fs,n_fft", [(16000, 512), (22050, 1024)])
def test_cheaptrick_device_matches_jax(fs, n_fft):
    x, f0, positions = _analysis_inputs(fs)
    f32 = [np.asarray(a, np.float32) for a in (x, f0, positions)]
    ref = np.asarray(jax_cheaptrick._cheaptrick_jax(*f32, fs, n_fft))
    ours = cheaptrick_mod.cheaptrick(x, f0, positions, fs, n_fft, backend="device", device="cpu")
    assert ours.dtype == np.float32 and ours.shape == ref.shape == (len(f0), n_fft // 2 + 1)
    assert np.abs(np.log(ours) - np.log(ref)).max() < LOG_ENVELOPE_ATOL


# the JAX harmonic solve unrolls its harmonics into one program: 16 kHz
# compiles in seconds, 22.05 kHz in about a minute on the CPU
@pytest.mark.parametrize("fs", [16000])
def test_harmonic_aperiodicity_device_matches_jax(fs):
    x, f0, positions = _analysis_inputs(fs)
    ref = jax_aperiodicity.band_aperiodicity_harmonic(x, f0, positions, fs, backend="jax")
    ours = aperiodicity_mod.band_aperiodicity_harmonic(x, f0, positions, fs, backend="device",
                                                       device="cpu")
    assert ours.dtype == np.float32 and ours.shape == np.shape(ref)
    assert np.abs(ours - np.asarray(ref)).max() < HARMONIC_DB_ATOL


@pytest.mark.parametrize("fs", [16000, 22050])
def test_comb_aperiodicity_device_matches_jax(fs):
    x, f0, positions = _analysis_inputs(fs)
    ref = jax_aperiodicity.band_aperiodicity(x, f0, positions, fs, backend="jax", method="comb")
    ours = aperiodicity_mod.band_aperiodicity(x, f0, positions, fs, backend="device",
                                              method="comb", device="cpu")
    assert ours.shape == np.shape(ref)
    assert np.abs(ours - np.asarray(ref)).max() < COMB_DB_ATOL


@pytest.mark.parametrize("fs", [16000])
@pytest.mark.parametrize("use_mcep", [False, True], ids=["logspc", "mcep"])
def test_vocoder_device_encode_matches_jax(fs, use_mcep):
    from voice100_tpu.dsp.world import WORLDVocoder as JaxVocoder
    from voice100_tpu_torch.dsp.world import WORLDVocoder

    x = _clip(2, 0.4, fs)
    ref = JaxVocoder(sample_rate=fs, use_mcep=use_mcep, analysis_backend="jax").encode(x)
    ours = WORLDVocoder(sample_rate=fs, use_mcep=use_mcep, device="cpu",
                        analysis_backend="device").encode(x)
    for a, b in zip(ours, ref):
        assert a.dtype == np.float32 and a.shape == b.shape
    _assert_f0(ours[0], ref[0])
    assert np.abs(ours[1] - ref[1]).max() < FEATURE_ATOL
    assert np.abs(ours[2] - ref[2]).max() < CODEAP_DB_ATOL


@pytest.mark.parametrize("pitch", [110.0, 160.0, 220.0, 320.0])
def test_reanalysis_invariants_on_the_device_backend(pitch, monkeypatch):
    """``test_world_invariants.py:118-135``'s bars, with the port's device
    analysis in place of the JAX package's."""
    from voice100_tpu_torch.dsp.world import WORLDVocoder

    def analyze(wav, backend="numpy"):
        vocoder = WORLDVocoder(sample_rate=invariants.FS, frame_period=invariants.FRAME_PERIOD,
                               analysis_backend="device", device="cpu")
        f0, logspc, codeap = vocoder.encode(np.asarray(wav))
        return f0.astype(np.float64), logspc, codeap

    monkeypatch.setattr(invariants, "_analyze", analyze)
    m = invariants._metrics(pitch, "device")
    assert m["n_voiced"] > 30
    assert m["f0_rmse_rel"] < 0.01, m
    assert m["octave_rate"] < 0.01, m
    assert m["voicing_acc"] > 0.97, m
    assert m["envelope_rmse_db"] < 6.0, m
    assert m["envelope_lsd45_db"] < 5.0, m
