"""Port spectrogram augmentation vs the JAX package (CPU).

``apply_augment`` fed the draws that ``batch_spectrogram_augment`` makes
from a fixed key (recomputed here from the same key splits) must give
its output: lengths exactly, features within 1e-5 (float32 on both
sides; exp/log and the linspace of the noise floor may round
differently). The keys are chosen so that every transform fires in at
least one case. ``draw_augment``'s own draws are checked for their
ranges: the JAX bounds, exclusive at the top.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.ops.augment import AUGMENT_RATE, apply_augment, draw_augment

BATCH, TIME, DIM = 3, 40, 16
# JAX keys whose coins cover every transform (and one where none fires)
SEEDS = [1, 3, 10, 15, 26]
BLANK = math.log(1e-6)


def _jax_draws(key, batch, time, dim):
    """The draws of ``voice100_tpu/ops/augment.py:47-116`` for ``key``."""
    keys = jax.random.split(key, 16)

    def coin(k):
        return jax.random.uniform(k) < AUGMENT_RATE

    def uniform(k, lo, hi, shape=()):
        return jax.random.uniform(k, shape, minval=lo, maxval=hi)

    masks = [jax.random.split(jax.random.fold_in(keys[8], m), 3) for m in range(3)]
    k_lo, k_hi, k_std, k_noise = jax.random.split(keys[13], 4)
    draws = {
        "stretch_coin": coin(keys[0]), "stretch_rate": jax.random.randint(keys[1], (), 50, 150),
        "pitch_coin": coin(keys[2]), "pitch_rate": 1.0 + uniform(keys[3], 0.0, 0.2),
        "amp_coin": coin(keys[4]), "amp": 1.0 + uniform(keys[5], 0.0, 3.0),
        "tmask_coin": coin(keys[6]), "tmask_n": jax.random.randint(keys[7], (), 1, 4),
        "tmask_center": jnp.stack([jax.random.randint(k[0], (), 0, time) for k in masks]),
        "tmask_hw": jnp.stack([jax.random.randint(k[1], (), 1, 4) for k in masks]),
        "tmask_val": jnp.stack([uniform(k[2], -BLANK, -5.0) for k in masks]),
        "fmask_coin": coin(keys[9]), "fmask_center": jax.random.randint(keys[10], (), 0, dim),
        "fmask_hw": jax.random.randint(keys[11], (), 1, 11),
        "fmask_val": uniform(keys[12], -BLANK, -5.0),
        "noise_coin": coin(keys[14]),
        "noise_low": -5.0 + 5.0 * jax.random.uniform(k_lo),
        "noise_high": -5.0 + 5.0 * jax.random.uniform(k_hi),
        "noise_std": 5.0 * jax.random.uniform(k_std),
        "noise": jax.random.uniform(k_noise, (batch, time, dim)),
        "mix_coin": coin(keys[15]),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def _batch(seed):
    rng = np.random.default_rng(seed)
    audio = rng.normal(-4.0, 3.0, (BATCH, TIME, DIM)).astype(np.float32)
    return audio, np.asarray([TIME, 27, 9], np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_apply_augment_with_jax_draws_matches_jax(seed):
    from voice100_tpu.ops.augment import batch_spectrogram_augment

    audio, lengths = _batch(seed)
    key = jax.random.PRNGKey(seed)
    want, want_len = batch_spectrogram_augment(key, jnp.asarray(audio), jnp.asarray(lengths))
    got, got_len = apply_augment(torch.from_numpy(audio), torch.from_numpy(lengths),
                                 _jax_draws(key, BATCH, TIME, DIM))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    assert got_len.dtype == torch.int32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_the_chosen_keys_fire_every_transform():
    fired = {name: False for name in ("stretch", "pitch", "amp", "tmask", "fmask", "noise", "mix")}
    for seed in SEEDS:
        draws = _jax_draws(jax.random.PRNGKey(seed), BATCH, TIME, DIM)
        for name in fired:
            fired[name] |= bool(draws[f"{name}_coin"])
    assert all(fired.values()), fired


def test_draws_have_the_jax_ranges():
    gen = torch.Generator().manual_seed(0)
    draws = [draw_augment(gen, BATCH, TIME, DIM) for _ in range(600)]

    def values(name):
        return torch.stack([d[name] for d in draws]).flatten()

    for name, lo, hi in (("stretch_rate", 50, 149), ("tmask_n", 1, 3), ("tmask_center", 0, TIME - 1),
                         ("tmask_hw", 1, 3), ("fmask_center", 0, DIM - 1), ("fmask_hw", 1, 10)):
        v = values(name)
        assert v.dtype == torch.int64
        assert (v.min().item(), v.max().item()) == (lo, hi), name
    for name, lo, hi in (("pitch_rate", 1.0, 1.2), ("amp", 1.0, 4.0), ("noise_low", -5.0, 0.0),
                         ("noise_high", -5.0, 0.0), ("noise_std", 0.0, 5.0)):
        v = values(name)
        assert lo <= v.min().item() and v.max().item() < hi, name
        assert v.max().item() - v.min().item() > 0.9 * (hi - lo), name
    # jax.random.uniform clamps below at minval: (-blank, -5) always gives -blank
    assert (values("tmask_val") == np.float32(-BLANK)).all()
    assert (values("fmask_val") == np.float32(-BLANK)).all()
    for name in ("stretch", "pitch", "amp", "tmask", "fmask", "noise", "mix"):
        rate = values(f"{name}_coin").float().mean().item()
        assert 0.14 < rate < 0.26, (name, rate)
    noise = draws[0]["noise"]
    assert noise.shape == (BATCH, TIME, DIM) and 0.0 <= noise.min() and noise.max() < 1.0


def test_padding_is_blank_and_lengths_stay_within_the_batch():
    gen = torch.Generator().manual_seed(1)
    audio, lengths = _batch(7)
    for _ in range(20):
        out, out_len = apply_augment(torch.from_numpy(audio), torch.from_numpy(lengths),
                                     draw_augment(gen, BATCH, TIME, DIM))
        assert torch.isfinite(out).all()
        assert (out_len <= TIME).all() and (out_len >= 1).all()
        for row, n in enumerate(out_len.tolist()):
            torch.testing.assert_close(out[row, n:], torch.full_like(out[row, n:], BLANK),
                                       rtol=0, atol=1e-6)
