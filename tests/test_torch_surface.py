"""The port's small public names against the JAX package's (CPU).

* ``ASRPipeline``'s front end: the port has no ``mel_kernel`` switch (the
  JAX package's Pallas/XLA backend switch); its ``_features`` go through
  the kernel's wrapper, which takes the plain version for a CPU tensor,
  and equal the JAX ``_features`` under ``"xla"`` at the front end's
  tolerance of ``tests/test_torch_melspec.py`` (1e-4); a streaming
  session decodes through the same front end;
* ``code_aperiodicity`` bit for bit, ``masked_mean``, ``power_spectrum``
  (against both of JAX's ``use_fft`` paths) and ``MelSpectrogram``'s
  counterpart (``log_mel_spectrogram_cuda``) against JAX;
* every ``voice100-tpu-*`` console script has a ``voice100-tpu-torch-*``
  counterpart whose ``cli_main`` imports.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import importlib
import pathlib
import re

import numpy as np
import pytest

import jax.numpy as jnp
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4


def _pcm():
    rng = np.random.default_rng(21)
    pcm = (rng.standard_normal((3, 8000)) * 3000).astype(np.int16)
    lengths = np.asarray([8000, 4321, 900], np.int32)
    for row, n in enumerate(lengths):
        pcm[row, n:] = 0
    return pcm, lengths


def _asr_model():
    from voice100_tpu_torch.models import AudioToAlignText

    return AudioToAlignText(64, 29, ((8, False, 3, 2, 1, False),), 1, 8, device="cpu")


def _count_front_end(monkeypatch):
    """Record each call of the pipeline's front end (the kernel's wrapper)."""
    from voice100_tpu_torch import inference

    calls, wrapper = [], inference.log_mel_spectrogram_cuda
    monkeypatch.setattr(inference, "log_mel_spectrogram_cuda",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    return calls


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_pipeline_features_match_jax_xla(dtype, monkeypatch):
    from voice100_tpu.inference import ASRPipeline as JaxPipeline
    from voice100_tpu_torch import inference

    pcm, lengths = _pcm()
    wav = pcm if dtype == "int16" else pcm.astype(np.float32) / 32768.0
    ref_mel, ref_len = JaxPipeline(model=None, variables=None, mel_kernel="xla")._features(
        jnp.asarray(wav), jnp.asarray(lengths))
    calls = _count_front_end(monkeypatch)
    pipe = inference.ASRPipeline(_asr_model(), device="cpu")
    mel, mel_len = pipe._features(torch.from_numpy(wav), torch.from_numpy(lengths))
    assert calls == [1]
    np.testing.assert_array_equal(mel_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), rtol=TOL, atol=TOL)


def test_no_mel_kernel_switch_and_streaming_uses_the_front_end(monkeypatch):
    from voice100_tpu_torch import inference

    with pytest.raises(TypeError, match="mel_kernel"):
        inference.ASRPipeline(_asr_model(), device="cpu", mel_kernel="xla")
    calls = _count_front_end(monkeypatch)
    pipe = inference.ASRPipeline(_asr_model(), device="cpu", buckets_sec=(1.0,))
    session = inference.StreamingASRSession(pipe, chunk_sec=0.25, right_context_sec=0.1)
    rng = np.random.default_rng(3)
    session.feed((rng.standard_normal(12000) * 0.3).astype(np.float32))
    session.finish()
    assert session.windows >= 1 and len(calls) == session.windows


def test_code_aperiodicity_is_bit_equal_to_jax():
    from voice100_tpu.dsp.world import code_aperiodicity as jax_code
    from voice100_tpu_torch.dsp.world import code_aperiodicity

    rng = np.random.default_rng(5)
    for fs, n_fft in ((16000, 512), (22050, 1024)):
        ap = rng.uniform(0.0, 1.0, (40, n_fft // 2 + 1))
        ap[3] = 0.0  # the floor
        got, want = code_aperiodicity(ap, fs), jax_code(ap, fs)
        assert got.dtype == want.dtype == np.float64 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_masked_mean_matches_jax():
    from voice100_tpu.ops.mask import masked_mean as jax_masked_mean
    from voice100_tpu_torch.ops.mask import masked_mean

    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 11, 4)).astype(np.float32)
    mask = (rng.random((3, 11, 1)) < 0.6).astype(np.float32)
    for m in (mask, np.zeros_like(mask), mask[:, :, 0][:, :, None]):
        got = masked_mean(torch.from_numpy(x), torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_masked_mean(jnp.asarray(x),
                                                                   jnp.asarray(m))),
                                   rtol=1e-6, atol=1e-7)
    assert float(masked_mean(torch.ones(2, 3), torch.zeros(2, 3))) == 0.0


@pytest.mark.parametrize("use_fft", [False, True])
def test_power_spectrum_matches_jax(use_fft):
    """The port's one path (the DFT products) against each of JAX's."""
    from voice100_tpu.ops.melspec import power_spectrum as jax_power
    from voice100_tpu_torch.ops.melspec import power_spectrum

    wav = (np.random.default_rng(7).standard_normal((2, 3337)) * 0.3).astype(np.float32)
    want = np.asarray(jax_power(jnp.asarray(wav), 512, 160, 400, use_fft))
    got = power_spectrum(torch.from_numpy(wav), 512, 160, 400).numpy()
    assert got.shape == want.shape == (2, 3337 // 160 + 1, 257) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


def test_mel_spectrogram_counterpart_matches_jax():
    """JAX's ``MelSpectrogram`` against its port counterpart, the kernel's
    wrapper at the same defaults, with ``MELSPEC_DIM`` and ``num_frames``."""
    from voice100_tpu.ops.melspec import MelSpectrogram as JaxMel
    from voice100_tpu_torch.ops import melspec_cuda
    from voice100_tpu_torch.ops.melspec import MELSPEC_DIM, num_frames

    wav = (np.random.default_rng(8).standard_normal((2, 4800)) * 0.3).astype(np.float32)
    ref = JaxMel()
    assert MELSPEC_DIM == ref.audio_size == 64
    assert num_frames(4800, 160) == ref.output_length(4800) == 31
    before = melspec_cuda.log_mel_spectrogram_cuda.launches
    got = melspec_cuda.log_mel_spectrogram_cuda(torch.from_numpy(wav)).numpy()
    assert melspec_cuda.log_mel_spectrogram_cuda.launches == before  # the plain path on a CPU tensor
    np.testing.assert_allclose(got, np.asarray(ref(jnp.asarray(wav))), rtol=TOL, atol=TOL)
    with pytest.raises(ValueError, match="unsupported device"):
        melspec_cuda.log_mel_spectrogram_cuda(torch.from_numpy(wav).to("meta"))


def _scripts():
    text = (ROOT / "pyproject.toml").read_text()
    block = text.split("[project.scripts]", 1)[1].split("\n[", 1)[0]
    return dict(re.findall(r'^([\w-]+)\s*=\s*"([\w.:]+)"', block, re.M))


def test_every_jax_script_has_a_port_script():
    scripts = _scripts()
    jax_scripts = [n for n in scripts if n.startswith("voice100-tpu")
                   and not n.startswith("voice100-tpu-torch")]
    assert "voice100-tpu-align-text" in jax_scripts
    for name in jax_scripts:
        port = name.replace("voice100-tpu", "voice100-tpu-torch", 1)
        assert port in scripts, f"{name} has no {port}"
        module, func = scripts[port].split(":")
        assert module.startswith("voice100_tpu_torch.") and func.endswith("cli_main")
        assert callable(getattr(importlib.import_module(module), func))
