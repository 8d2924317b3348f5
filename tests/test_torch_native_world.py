"""The port's native WORLD synthesis (``native/world.cpp``) on the CPU.

The counterpart of ``tests/test_native.py:184-208``: the C++ vocoder,
built into the port's native library beside ``audioio.cpp``, matches the
port's NumPy synthesizer (``dsp/world/synthesis_np.py``) on the
deterministic periodic path within 1e-4 of the peak, and that
synthesizer equals the JAX package's bit for bit. Skipped where no C++
compiler is present, as the JAX package's native tests are.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import shutil

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")


def _features(n_frames: int = 60, n_fft: int = 512):
    t = np.arange(n_frames) * 0.01
    f0 = 160.0 * (1.0 + 0.04 * np.sin(2 * np.pi * 3.0 * t))
    freqs = np.arange(n_fft // 2 + 1) * 16000 / n_fft
    env = np.exp(-0.5 * ((freqs - 600.0) / 250.0) ** 2) + 1e-7
    spc = np.tile(env[None, :], (n_frames, 1))
    ap = np.full((n_frames, n_fft // 2 + 1), 1e-6)
    return f0, spc, ap


def test_native_world_synthesis_matches_numpy():
    from voice100_tpu_torch.dsp.world.synthesis_np import synthesize_np
    from voice100_tpu_torch.native.world import synthesize_native

    f0, spc, ap = _features()
    a = synthesize_np(f0, spc, ap, fs=16000, frame_period=10.0)
    b = synthesize_native(f0, spc, ap, fs=16000, frame_period=10.0)
    assert len(a) == len(b) and b.dtype == np.float32
    scale = np.abs(a).max()
    np.testing.assert_allclose(a / scale, b / scale, atol=1e-4)
    # non-power-of-two fft size is rejected cleanly
    with pytest.raises(ValueError):
        synthesize_native(f0[:4], np.ones((4, 300)), np.ones((4, 300)))


def test_synthesis_np_equals_jax_package():
    from voice100_tpu.dsp.world.synthesis_np import synthesize_np as jax_synthesize_np
    from voice100_tpu_torch.dsp.world.synthesis_np import synthesize_np

    f0, spc, ap = _features(40)
    np.testing.assert_array_equal(synthesize_np(f0, spc, ap, fs=16000),
                                  jax_synthesize_np(f0, spc, ap, fs=16000))


def test_native_library_holds_both_sources():
    import voice100_tpu_torch.native as native

    lib = native.get_lib()
    assert lib.v100_world_synthesize.restype is not None and lib.v100_read_flac
    assert native.library_path().name.startswith("libaudioio-")
    assert native.WORLD_SOURCE.read_bytes() == (
        native.SOURCE.parents[2] / "voice100_tpu" / "native" / "world.cpp").read_bytes()
