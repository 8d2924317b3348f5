"""The port's v1 model family vs the JAX package (CPU).

Each of the five v1 models is built at a tiny width in both packages
and carried across with ``tools/weights.py`` (the JAX BatchNorms'
``batch_stats`` moved off their initial 0 and 1, so that evaluation
reads them):

* the forward in evaluation mode, at rtol 1e-4 / atol 1e-5;
* ``compute_loss`` and its gradients in training mode, the BatchNorms on
  the batch's statistics, with augmentation and dropout off on both
  sides (the JAX augmentation and ``nn.Dropout`` patched to the
  identity for the call, the port's dropout rates set to 0): the losses
  at rtol 1e-4 / atol 1e-5, each gradient tensor at rtol 1e-4 and atol
  1e-5 times its largest entry (at least 1): through nine BatchNorm
  layers the two frameworks' float32 sums part in the last bits of the
  largest terms (measured: 1.4e-5 on an entry of a tensor whose largest
  gradient is 30.8, 4.7e-7 of it);
* the BatchNorm running averages after that train-mode call against
  flax's mutated ``batch_stats`` at rtol 1e-5 (atol 1e-7): the update
  takes the biased batch variance, and torch's ``nn.BatchNorm1d``
  update, which scales it by ``n / (n - 1)``, misses the bound (checked);
* ``expand_alignment_v1`` on durations that put the cursor on .5 ties,
  ``world_loss_v1`` with and without the mel weights,
  ``mel_logspc_weights``, the multi-task phone loss, the decoders' ``2T -
  1`` length on odd and even T, ``AudioAlignCTC.ctc_best_path``;
* the weights round trip of each model, and the repaired dispatch:
  ``TextToAlignText`` and ``TextToAlignTextModel`` both have ``Embed_0``
  at the top of their params, and the v2 route cannot read the v1
  variables.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import flax.linen
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch import models as P
from voice100_tpu_torch.models import losses as port_losses
from voice100_tpu_torch.models.layers import BatchNorm
from voice100_tpu_torch.models.tts_v1 import VoiceDecoder, expand_alignment_v1
from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables

MELS, VOCAB, TARGET_VOCAB, HIDDEN = 8, 7, 11, 16
RTOL, ATOL = 1e-4, 1e-5
STATS_RTOL, STATS_ATOL = 1e-5, 1e-7
# the running variance of each model's first BatchNorm
FIRST_BN = {"AudioToTextCTC": "encoder.layers.0.conv.0.1.running_var",
            "TextToAlignTextModel": "layers.0.conv.0.1.running_var",
            "AlignTextToAudioModel": "decoder.layers.0.conv.0.1.running_var",
            "AlignTextToAudioMultiTaskModel": "decoder.layer1.0.conv.0.1.running_var"}
NAMES = ("AudioToTextCTC", "AudioAlignCTC", "TextToAlignTextModel", "AlignTextToAudioModel",
         "AlignTextToAudioMultiTaskModel")


class _Identity(flax.linen.Module):
    """Stands in for ``nn.Dropout`` (no parameters, so no name changes)."""

    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x):
        return x


def _kwargs(name):
    return {"AudioToTextCTC": dict(audio_size=MELS, vocab_size=VOCAB, embed_size=HIDDEN,
                                   hidden_size=HIDDEN),
            "AudioAlignCTC": dict(audio_size=MELS, vocab_size=VOCAB, hidden_size=HIDDEN),
            "TextToAlignTextModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN),
            "AlignTextToAudioModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN),
            "AlignTextToAudioMultiTaskModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN,
                                                   target_vocab_size=TARGET_VOCAB)}[name]


def _inputs(name, seed=0):
    """``compute_loss`` arguments as numpy arrays: ragged lengths, padding
    past them."""
    rng = np.random.default_rng(seed)
    if name in ("AudioToTextCTC", "AudioAlignCTC"):
        audio = rng.normal(-2.0, 1.5, (3, 29, MELS)).astype(np.float32)
        audio_len = np.asarray([29, 21, 12], np.int32)
        text = rng.integers(1, VOCAB, (3, 6)).astype(np.int32)
        text_len = np.asarray([6, 4, 2], np.int32)
        text[np.arange(6)[None] >= text_len[:, None]] = 0
        return [audio, audio_len, text, text_len]
    text = rng.integers(1, VOCAB, (3, 9)).astype(np.int32)
    text_len = np.asarray([9, 7, 4], np.int32)
    text[np.arange(9)[None] >= text_len[:, None]] = 0
    if name == "TextToAlignTextModel":
        align = rng.integers(0, 6, (3, 19)).astype(np.int32)
        return [text, text_len, align, np.asarray([19, 15, 9], np.int32)]
    frames = 16  # the 64-frame bucket cut down: below the decoder's 2 * 9 - 1
    f0 = np.where(rng.random((3, frames)) < 0.7, rng.uniform(80, 300, (3, frames)),
                  0.0).astype(np.float32)
    logspc = rng.normal(-5.0, 2.0, (3, frames, 257)).astype(np.float32)
    codeap = -np.abs(rng.normal(0.0, 1.0, (3, frames, 1))).astype(np.float32)
    args = [f0, np.asarray([16, 12, 7], np.int32), logspc, codeap, text, text_len]
    if name == "AlignTextToAudioMultiTaskModel":
        phone = rng.integers(1, TARGET_VOCAB, (3, 12)).astype(np.int32)
        args += [phone, np.asarray([12, 8, 5], np.int32)]
    return args


def _forward_inputs(name, args):
    if name == "AudioToTextCTC":
        return args[:1]
    if name == "AudioAlignCTC":
        return args[:2]
    return [args[4] if name.startswith("AlignTextToAudio") else args[0]]


@pytest.fixture(scope="module")
def pairs():
    """``name -> (JAX model, variables)``, the BatchNorm statistics moved
    to U(0.1, 0.5) off their initial values."""
    import voice100_tpu.models as J

    rng = np.random.default_rng(7)
    out = {}
    for name in NAMES:
        model = getattr(J, name)(**_kwargs(name))
        args = [jnp.asarray(a) for a in _forward_inputs(name, _inputs(name))]
        variables = jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(3), *args))
        variables = dict(variables)
        if "world_norm" in variables:
            # statistics of the scale of real WORLD features, so that the
            # normalized targets and the gradients are of order 1
            size = variables["world_norm"]["norm"]["logspc_mean"].shape
            variables["world_norm"] = {"norm": {
                "f0_mean": np.float32([150.0]), "f0_std": np.float32([30.0]),
                "logspc_mean": np.full(size, -5.0, np.float32),
                "logspc_std": np.full(size, 2.0, np.float32),
                "codeap_mean": np.float32([-0.5]), "codeap_std": np.float32([0.5])}}
        if "batch_stats" in variables:
            variables["batch_stats"] = jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                variables["batch_stats"])
        out[name] = (model, variables)
    return out


def _port(name, variables):
    model = getattr(P, name)(**_kwargs(name), device="cpu")
    model.load_state_dict(from_jax_variables(variables, model=name), strict=True)
    return model


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", NAMES)
def test_eval_forward_matches_jax(pairs, name):
    model, variables = pairs[name]
    inputs = _forward_inputs(name, _inputs(name, seed=1))
    want = model.apply(variables, *(jnp.asarray(a) for a in inputs))
    with torch.no_grad():
        got = _port(name, variables).eval()(*(_t(a) for a in inputs))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def _jax_train_loss(name, model, variables, args, monkeypatch):
    """Loss values, the gradients of their sum by params and the mutated
    batch stats of a training-mode ``compute_loss``, augmentation and
    dropout off."""
    import voice100_tpu.models.align_v1 as jax_align_v1
    import voice100_tpu.models.asr_v1 as jax_asr_v1

    for module in (jax_asr_v1, jax_align_v1):
        monkeypatch.setattr(module, "batch_spectrogram_augment", lambda key, a, n: (a, n))
    monkeypatch.setattr(flax.linen, "Dropout", _Identity)
    jargs = [jnp.asarray(a) for a in args]
    extra = {k: v for k, v in variables.items() if k != "params"}
    deterministic = name == "AudioAlignCTC"  # its biLSTM's dropout: off
    mutable = ["batch_stats"] if "batch_stats" in variables else []

    def loss_fn(params):
        values, mutated = model.apply({"params": params, **extra}, *jargs, deterministic,
                                      method=type(model).compute_loss, mutable=mutable,
                                      rngs={"augment": jax.random.PRNGKey(0),
                                            "dropout": jax.random.PRNGKey(1)})
        values = values if isinstance(values, tuple) else (values,)
        return sum(values), (values, mutated)

    grads, (values, mutated) = jax.grad(loss_fn, has_aux=True)(variables["params"])
    return [float(v) for v in values], grads, dict(mutated).get("batch_stats")


def _port_train_loss(name, port, args):
    port.train()
    for module in port.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    if hasattr(port, "lstm"):
        port.lstm.dropout = 0.0
    values = port.compute_loss(*(_t(a) for a in args), deterministic=True)
    values = values if isinstance(values, tuple) else (values,)
    sum(values).backward()
    return [float(v) for v in values]


@pytest.mark.parametrize("name", NAMES)
def test_train_loss_gradients_and_running_averages_match_flax(pairs, name, monkeypatch):
    model, variables = pairs[name]
    args = _inputs(name, seed=2)
    want_values, grads, mutated = _jax_train_loss(name, model, variables, args, monkeypatch)
    port = _port(name, variables)
    before = {k: v.clone() for k, v in port.state_dict().items() if "running" in k}
    values = _port_train_loss(name, port, args)
    np.testing.assert_allclose(values, want_values, rtol=RTOL, atol=ATOL)
    want_grads = from_jax_variables({**variables, "params": grads}, model=name)
    got_grads = {k: p.grad for k, p in port.named_parameters()}
    assert set(got_grads) <= set(want_grads)
    for key, grad in got_grads.items():
        want = want_grads[key].numpy()
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(grad.numpy(), want, rtol=RTOL, atol=ATOL * scale,
                                   err_msg=f"{key}, largest |grad| {scale}")
    if mutated is None:
        assert not before
        return
    want = from_jax_variables({**variables, "batch_stats": mutated}, model=name)
    state = port.state_dict()
    assert before and all(not torch.equal(state[k], before[k]) for k in before)
    for key in before:
        np.testing.assert_allclose(state[key].numpy(), want[key].numpy(), rtol=STATS_RTOL,
                                   atol=STATS_ATOL, err_msg=key)
    # torch's nn.BatchNorm1d update, ra = 0.9 ra + 0.1 * var * n / (n - 1),
    # misses the bound: the first BatchNorm's n is the input's B * T
    key = FIRST_BN[name]
    ids = args[4] if name.startswith("AlignTextToAudio") else args[0]
    n = ids.shape[0] * ids.shape[1]
    batch_var = (state[key] - 0.9 * before[key]) / 0.1
    unbiased = 0.9 * before[key] + 0.1 * batch_var * n / (n - 1)
    assert not np.allclose(unbiased.numpy(), want[key].numpy(), rtol=STATS_RTOL,
                           atol=STATS_ATOL)


def test_batchnorm_eval_reads_running_averages_and_train_mode_moves_them():
    bn = BatchNorm(3, device="cpu")
    with torch.no_grad():
        bn.running_mean.copy_(torch.tensor([1.0, -2.0, 0.5]))
        bn.running_var.copy_(torch.tensor([4.0, 0.25, 1.0]))
        bn.weight.copy_(torch.tensor([2.0, 1.0, 0.5]))
    x = torch.randn(2, 3, 5, generator=torch.Generator().manual_seed(0))
    want = (x - bn.running_mean[:, None]) / torch.sqrt(bn.running_var[:, None] + 1e-5) * \
        bn.weight[:, None]
    torch.testing.assert_close(bn.eval()(x), want)
    assert torch.equal(bn.running_mean, torch.tensor([1.0, -2.0, 0.5]))
    bn.train()(x)
    mean = x.mean(dim=(0, 2))
    var = (x * x).mean(dim=(0, 2)) - mean ** 2
    torch.testing.assert_close(bn.running_mean, 0.9 * torch.tensor([1.0, -2.0, 0.5]) + 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.tensor([4.0, 0.25, 1.0]) + 0.1 * var)
    assert set(dict(bn.named_buffers())) == {"running_mean", "running_var"}


def test_expand_alignment_v1_matches_jax_on_ties():
    from voice100_tpu.models.tts_v1 import expand_alignment_v1 as jax_expand

    rng = np.random.default_rng(4)
    ties = 0
    for _ in range(40):
        n = int(rng.integers(1, 12))
        text = rng.integers(1, VOCAB, n).astype(np.int32)
        # multiples of 0.5 (a cursor on .5 rounds half to even), some
        # negative and some zero spans
        align = (rng.integers(-1, 7, (n, 2)) / 2.0).astype(np.float32)
        text_len = int(rng.integers(0, n + 1))
        cursor = 5.0 + np.cumsum(align.reshape(-1)[:2 * text_len])
        ties += int(np.sum(cursor % 1.0 == 0.5))
        want = np.asarray(jax_expand(jnp.asarray(text), jnp.asarray(align), text_len, 48))
        got = expand_alignment_v1(torch.from_numpy(text), torch.from_numpy(align), text_len, 48)
        np.testing.assert_array_equal(got.numpy(), want)
    assert ties > 20


def test_world_loss_v1_and_mel_weights_match_jax():
    from voice100_tpu.models import losses as jax_losses

    for sr, n_fft in ((16000, 512), (22050, 1024)):
        np.testing.assert_array_equal(port_losses.mel_logspc_weights(sr, n_fft),
                                      jax_losses.mel_logspc_weights(sr, n_fft))
    rng = np.random.default_rng(5)
    length = np.asarray([14, 9, 3], np.int32)
    hats = [rng.normal(size=s).astype(np.float32) for s in ((3, 15), (3, 15), (3, 15, 257),
                                                             (3, 15, 1))]
    targets = [(rng.random((3, 14)) > 0.4).astype(np.float32)] + [
        rng.normal(size=s).astype(np.float32) for s in ((3, 14), (3, 14, 257), (3, 14, 1))]
    weights = port_losses.mel_logspc_weights(16000, 512)
    for w in (None, weights):
        for loss in ("mse", "l1"):
            want = jax_losses.world_loss_v1(
                jnp.asarray(length), *map(jnp.asarray, hats + targets),
                logspc_weights=None if w is None else jnp.asarray(w), loss=loss)
            got = port_losses.world_loss_v1(
                torch.from_numpy(length), *map(torch.from_numpy, hats + targets),
                logspc_weights=None if w is None else torch.from_numpy(w), loss=loss)
            np.testing.assert_allclose([float(g) for g in got], [float(x) for x in want],
                                       rtol=1e-5)


def test_multitask_phone_loss_matches_jax(pairs):
    """The phone loss over n = min(T_logits, T_phone), with phone targets
    longer (n = T_logits) and shorter (n = T_phone) than the logits."""
    name = "AlignTextToAudioMultiTaskModel"
    model, variables = pairs[name]
    port = _port(name, variables).eval()
    for width in (12, 6):
        args = _inputs(name, seed=8)
        args[6], args[7] = args[6][:, :width], np.minimum(args[7], width)
        want = model.apply(variables, *(jnp.asarray(a) for a in args),
                           method=type(model).compute_loss)
        with torch.no_grad():
            got = port.compute_loss(*(_t(a) for a in args))
        assert len(got) == len(want) == 5
        np.testing.assert_allclose(float(got[4]), float(want[4]), rtol=RTOL)


@pytest.mark.parametrize("frames", [7, 8])
def test_decoder_gives_2t_minus_1_frames(pairs, frames):
    decoder = VoiceDecoder(HIDDEN, 5, device="cpu").eval()
    with torch.no_grad():
        assert decoder(torch.zeros(2, HIDDEN, frames)).shape == (2, 5, 2 * frames - 1)
    name = "AlignTextToAudioMultiTaskModel"
    model, variables = pairs[name]
    text = np.ones((2, frames), np.int32)
    want = model.apply(variables, jnp.asarray(text))
    with torch.no_grad():
        got = _port(name, variables).eval()(_t(text))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    assert got[0].shape[1] == 2 * frames - 1 and got[4].shape[1] == frames


def test_align_ctc_best_path_matches_jax(pairs):
    model, variables = pairs["AudioAlignCTC"]
    audio, audio_len, text, text_len = _inputs("AudioAlignCTC", seed=9)
    audio_len[2] = 9
    text_len = np.asarray([6, 4, 6], np.int32)  # the last past its 5 logits: capped
    ref, ref_len = model.apply(variables, *(jnp.asarray(a) for a in (audio, audio_len, text,
                                                                     text_len)),
                               method=type(model).ctc_best_path)
    got, got_len = _port("AudioAlignCTC", variables).eval().ctc_best_path(
        *(_t(a) for a in (audio, audio_len, text, text_len)))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    assert int(got_len[2]) < int(text_len[2])
    np.testing.assert_array_equal(got.path.numpy(), np.asarray(ref.path))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_allclose(got.score.numpy(), np.asarray(ref.score), rtol=1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_weights_round_trip(pairs, name):
    _, variables = pairs[name]
    state = from_jax_variables(variables, model=name)
    back = to_jax_variables(state, model=name)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(variables)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(variables)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=jax.tree_util.keystr(path))
    # without ``model``: told by names only its variables (state) have
    inferred = from_jax_variables(variables)
    assert inferred.keys() == state.keys()
    assert jax.tree_util.tree_structure(to_jax_variables(state)) == \
        jax.tree_util.tree_structure(variables)
    model = getattr(P, name)(**_kwargs(name), device="cpu")
    assert from_jax_variables(variables, model=model).keys() == state.keys()
    assert from_jax_variables(variables, model=f"voice100.models.{name}").keys() == state.keys()


def test_dispatch_tells_the_duration_models_apart(pairs):
    """Both duration models' params have ``Embed_0`` at the top; a dispatch
    on that name alone sent ``TextToAlignTextModel`` down the v2 route,
    which reads ``BiLSTM_0`` and fails. The model (or its names) routes
    it now."""
    import voice100_tpu.models as J

    v1 = pairs["TextToAlignTextModel"][1]
    v2 = jax.tree_util.tree_map(np.asarray, J.TextToAlignText(vocab_size=VOCAB, hidden_size=8)
                                .init(jax.random.PRNGKey(0), jnp.zeros((1, 5), jnp.int32),
                                      jnp.asarray([5])))
    assert "Embed_0" in v1["params"] and "Embed_0" in v2["params"]
    with pytest.raises(KeyError, match="BiLSTM_0"):
        from_jax_variables(v1, model="TextToAlignText")  # the old route
    for model in (None, "TextToAlignTextModel", P.TextToAlignTextModel):
        P.TextToAlignTextModel(VOCAB, HIDDEN, device="cpu").load_state_dict(
            from_jax_variables(v1, model=model), strict=True)
    v2_state = from_jax_variables(v2)
    P.TextToAlignText(VOCAB, hidden_size=8, device="cpu").load_state_dict(v2_state, strict=True)
    v1_state = from_jax_variables(v1)
    assert "params" in to_jax_variables(v2_state) and "Embed_0" in to_jax_variables(
        v2_state)["params"] and "BiLSTM_0" in to_jax_variables(v2_state)["params"]
    assert "InvertedResidual_0" in to_jax_variables(v1_state)["params"]
    with pytest.raises(ValueError, match="no weights mapping"):
        from_jax_variables(v1, model="NoSuchModel")
