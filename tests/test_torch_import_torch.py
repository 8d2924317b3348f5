"""The port's ``tools/import_torch`` vs the JAX importer (CPU).

The reference-layout modules of ``tests/test_import_torch.py`` (torch
conv blocks with ``conv`` and ``layer_norm``, ``nn.LSTM``, ``nn.Linear``,
``nn.Embedding``, WORLD statistics under ``norm.*``) give state dicts that
go through the port's importer and through the JAX importer followed by
``from_jax_variables``: both give the same tensors, bit for bit, in a
strict load. Lightning's ``state_dict`` wrapper and a ``model.`` prefix
are taken, missing statistics keep the identity, and the CLI writes a
port checkpoint that ``load_model_weights`` reads.

The v1 architectures: the reference twins of ``tests/test_import_torch_v1.py``
(its ``TorchInvertedResidual`` blocks, ``nn.BatchNorm1d`` with
``num_batches_tracked``, statistics warmed by training-mode passes) go
through the port's importer and through the JAX ``convert_*_v1`` followed
by ``from_jax_variables``, bit for bit; the imported model's evaluation
forward matches the twin's at 1e-4, as the JAX test holds flax's.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from test_import_torch import _torch_stack
from test_import_torch_v1 import AUDIO, HIDDEN, VOCAB, TorchInvertedResidual, _warm_bn

V1_EMBED, V1_PHONES = 12, 13
V1_NAMES = ("AudioToTextCTC", "AudioAlignCTC", "TextToAlignTextModel", "AlignTextToAudioModel",
            "AlignTextToAudioMultiTaskModel")

ASR_SETTINGS = ((12, False, 5, 2, 2, False), (12, False, 5, 1, 2, False))
TTS_SETTINGS = ((8, False, 5, 1, 2, False), (8, True, 5, 2, 2, False), (8, False, 5, 1, 2, False))


def _reference(kind: str) -> dict:
    """The reference module's state dict as numpy arrays (seeded)."""
    torch.manual_seed({"asr": 0, "align": 2, "tts": 1}[kind])
    m = nn.Module()
    if kind == "asr":
        m.encoder = _torch_stack(6, ASR_SETTINGS)
        m.lstm = nn.LSTM(12, 12, num_layers=2, bidirectional=True)
        m.dense = nn.Linear(24, 7)
    elif kind == "align":
        m.embedding = nn.Embedding(9, 8)
        m.lstm = nn.LSTM(8, 8, num_layers=2, bidirectional=True)
        m.dense = nn.Linear(16, 2)
    else:
        m.embedding = nn.Embedding(9, 8)
        m.lstm = nn.LSTM(8, 8, num_layers=2, bidirectional=True)
        m.decoder = _torch_stack(16, TTS_SETTINGS)
        m.projection = nn.Linear(8, 2 + 5 + 2)
    state = {k: v.numpy() for k, v in m.state_dict().items()}
    if kind == "tts":
        state.update({"norm.f0_mean": np.asarray([120.0], np.float32),
                      "norm.f0_std": np.asarray([30.0], np.float32),
                      "norm.logspc_mean": np.linspace(-3, 0, 5).astype(np.float32),
                      "norm.logspc_std": np.linspace(0.5, 1, 5).astype(np.float32)})
    return state


def _models(kind: str):
    """(JAX model, port model) of the reference module's sizes."""
    from voice100_tpu import models as jm
    from voice100_tpu_torch import models as pm

    if kind == "asr":
        return (jm.AudioToAlignText(audio_size=6, vocab_size=7, encoder_settings=ASR_SETTINGS,
                                    decoder_num_layers=2, decoder_hidden_size=12),
                pm.AudioToAlignText(6, 7, ASR_SETTINGS, 2, 12, device="cpu"))
    if kind == "align":
        return (jm.TextToAlignText(vocab_size=9, num_layers=2, hidden_size=8),
                pm.TextToAlignText(9, num_layers=2, hidden_size=8, device="cpu"))
    return (jm.AlignTextToAudio(vocab_size=9, logspc_size=5, codeap_size=1, encoder_num_layers=2,
                                encoder_hidden_size=8, decoder_settings=TTS_SETTINGS),
            pm.AlignTextToAudio(9, 5, 1, 2, 8, TTS_SETTINGS, device="cpu"))


@pytest.mark.parametrize("kind", ["asr", "align", "tts"])
def test_port_importer_equals_the_jax_importer_carried_across(kind):
    from voice100_tpu.tools.import_torch import convert_state_dict as jax_convert
    from voice100_tpu_torch.tools.import_torch import convert_state_dict, import_state_dict
    from voice100_tpu_torch.tools.weights import from_jax_variables

    state = _reference(kind)
    jax_model, port = _models(kind)
    variables = jax_convert(state, jax_model)
    if kind == "tts":  # the JAX importer leaves absent statistics out; the port keeps identity
        norm = variables["world_norm"]["norm"]
        norm.update({"codeap_mean": np.zeros(1, np.float32), "codeap_std": np.ones(1, np.float32)})
    want = from_jax_variables(variables, TTS_SETTINGS if kind == "tts" else None)
    got = convert_state_dict(state, port)
    assert got.keys() == want.keys() == port.state_dict().keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    import_state_dict({f"model.{k}": v for k, v in state.items()}, port)
    for key, value in port.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)


def test_missing_tensors_raise_and_v1_names_the_item(tmp_path):
    """A missing tensor raises naming it, a tensor of another shape too, in
    a v2 and a v1 checkpoint; a module that is none of the eight
    architectures raises naming its class."""
    from voice100_tpu_torch.tools.import_torch import convert_state_dict

    state = _reference("asr")
    del state["dense.bias"]
    with pytest.raises(KeyError, match="dense.bias"):
        convert_state_dict(state, _models("asr")[1])
    state = _reference("asr")
    state["dense.weight"] = state["dense.weight"][:3]
    with pytest.raises(ValueError, match="dense.weight"):
        convert_state_dict(state, _models("asr")[1])
    twin, port = _v1_twin("TextToAlignTextModel"), _v1_port("TextToAlignTextModel")
    state = {k: v.numpy() for k, v in twin.state_dict().items()}
    del state["layers.2.conv.3.running_var"]
    with pytest.raises(KeyError, match="layers.2.conv.3.running_var"):
        convert_state_dict(state, port)
    state = {k: v.numpy() for k, v in twin.state_dict().items()}
    state["layers.4.weight"] = state["layers.4.weight"][:1]
    with pytest.raises(ValueError, match="layers.4.weight"):
        convert_state_dict(state, port)
    with pytest.raises(ValueError, match="AudioAlignCTCv0"):
        convert_state_dict({}, type("AudioAlignCTCv0", (nn.Module,), {})())


def test_cli_round_trip_loads(tmp_path):
    from voice100_tpu_torch.tools.import_torch import cli_main
    from voice100_tpu_torch.training.checkpoint import load_model_weights

    state = _reference("tts")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in state.items()},
                "epoch": 3}, tmp_path / "ref.ckpt")
    config = {"model": {"class_path": "voice100_tpu.models.AlignTextToAudio",
                        "init_args": {"vocab_size": 9, "logspc_size": 5, "codeap_size": 1,
                                      "encoder_num_layers": 2, "encoder_hidden_size": 8,
                                      "decoder_settings": [list(s) for s in TTS_SETTINGS],
                                      "audio_stat": "missing.npz"}}}
    (tmp_path / "tts.yaml").write_text(yaml.safe_dump(config))
    cli_main(["--config", str(tmp_path / "tts.yaml"), "--ckpt_path", str(tmp_path / "ref.ckpt"),
              "--output", str(tmp_path / "ckpt" / "port.pt"), "--device", "cpu"])
    port = load_model_weights(str(tmp_path / "ckpt" / "port.pt"), _models("tts")[1])
    for key, value in state.items():
        np.testing.assert_array_equal(port.state_dict()[key].numpy(), value)
    assert float(port.norm.codeap_std[0]) == 1.0


def test_cli_builds_on_cuda_unless_asked(tmp_path, monkeypatch):
    """Without ``--device`` the CLI builds the model on ``cuda``, as every
    entry point does, and raises where CUDA is absent."""
    from voice100_tpu_torch.tools.import_torch import cli_main

    config = {"model": {"class_path": "voice100_tpu.models.TextToAlignText",
                        "init_args": {"vocab_size": 9, "num_layers": 1, "hidden_size": 8}}}
    (tmp_path / "align.yaml").write_text(yaml.safe_dump(config))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["--config", str(tmp_path / "align.yaml"), "--ckpt_path", "x.ckpt",
                  "--output", str(tmp_path / "o.pt")])
    assert not (tmp_path / "o.pt").exists()


class _Twin(nn.Module):
    """The reference v1 architectures' modules (``voice100/models/asr.py``,
    ``align.py``, ``tts.py``) under their state-dict names, with the
    forward of each (the WORLD head's channels concatenated)."""

    def __init__(self, name: str) -> None:
        super().__init__()
        self.name, half = name, HIDDEN // 2
        if name == "AudioToTextCTC":
            self.encoder = nn.Module()
            self.encoder.layers = nn.Sequential(
                TorchInvertedResidual(AUDIO, half, 11, stride=2, residual=False),
                *(TorchInvertedResidual(half, half, k) for k in (19, 27, 35)),
                TorchInvertedResidual(half, HIDDEN, 51, residual=False),
                *(TorchInvertedResidual(HIDDEN, HIDDEN, k) for k in (59, 67, 75)),
                TorchInvertedResidual(HIDDEN, V1_EMBED, 83, residual=False))
            self.decoder = nn.Module()
            self.decoder.layers = nn.Sequential(nn.Dropout(0.2), nn.Conv1d(V1_EMBED, VOCAB, 1))
        elif name == "AudioAlignCTC":
            self.conv = nn.Conv1d(AUDIO, HIDDEN, 3, stride=2, padding=1)
            self.lstm = nn.LSTM(HIDDEN, HIDDEN, num_layers=2, dropout=0.2, bidirectional=True)
            self.dense = nn.Linear(2 * HIDDEN, VOCAB)
        elif name == "TextToAlignTextModel":
            self.embedding = nn.Embedding(VOCAB, HIDDEN)
            self.layers = nn.Sequential(*(TorchInvertedResidual(HIDDEN, HIDDEN, k)
                                          for k in (5, 11, 17, 29)), nn.Conv1d(HIDDEN, 2, 1))
        else:
            audio_size = 2 + 25 + 1
            self.embedding = nn.Embedding(VOCAB, HIDDEN)
            self.decoder = nn.Module()
            up = nn.ConvTranspose1d(HIDDEN, half, 5, padding=2, stride=2)
            if name == "AlignTextToAudioModel":
                self.decoder.layers = nn.Sequential(
                    *(TorchInvertedResidual(HIDDEN, HIDDEN, k) for k in (65, 33, 17, 11)), up,
                    *(TorchInvertedResidual(half, half, k) for k in (33, 11, 7)),
                    nn.Conv1d(half, audio_size, 1))
            else:
                self.decoder.layer1 = nn.Sequential(*(TorchInvertedResidual(HIDDEN, HIDDEN, k)
                                                      for k in (65, 47, 33, 17, 11, 7)))
                self.decoder.layer2 = nn.Sequential(
                    up, *(TorchInvertedResidual(half, half, k) for k in (11, 7)),
                    nn.Conv1d(half, audio_size, 1))
                self.decoder.layer3 = nn.Conv1d(HIDDEN, V1_PHONES, 1)
            self.norm = nn.Module()
            self.norm.register_buffer("f0_mean", torch.tensor([120.0]))
            self.norm.register_buffer("logspc_std", torch.linspace(0.5, 1.5, 25))

    def forward(self, x, lengths=None):
        if self.name == "AudioToTextCTC":
            return self.decoder.layers(self.encoder.layers(x.transpose(1, 2))).transpose(1, 2)
        if self.name == "AudioAlignCTC":
            x = torch.relu(self.conv(x.transpose(1, 2))).transpose(1, 2)
            packed = nn.utils.rnn.pack_padded_sequence(x, (lengths + 1) // 2, batch_first=True,
                                                       enforce_sorted=False)
            out, _ = nn.utils.rnn.pad_packed_sequence(self.lstm(packed)[0], batch_first=True,
                                                      total_length=x.shape[1])
            return self.dense(out)
        x = self.embedding(x).transpose(1, 2)
        if self.name == "TextToAlignTextModel":
            return self.layers(x).transpose(1, 2)
        if self.name == "AlignTextToAudioModel":
            return self.decoder.layers(x).transpose(1, 2)
        x = self.decoder.layer1(x)
        return (self.decoder.layer2(x).transpose(1, 2),
                self.decoder.layer3(x).transpose(1, 2))


def _v1_input(name, seed):
    g = torch.Generator().manual_seed(seed)
    if name.startswith("Audio"):
        return torch.randn(3, 19, AUDIO, generator=g)
    return torch.randint(0, VOCAB, (3, 9), generator=g)


def _v1_twin(name):
    """The seeded twin, its BatchNorm statistics warmed, in eval mode."""
    torch.manual_seed(V1_NAMES.index(name))
    twin = _Twin(name)
    if name != "AudioAlignCTC":
        seeds = iter(range(100, 110))
        _warm_bn(twin, lambda: _v1_input(name, next(seeds)))
    return twin.eval()


def _v1_kwargs(name):
    return {"AudioToTextCTC": dict(audio_size=AUDIO, vocab_size=VOCAB, embed_size=V1_EMBED,
                                   hidden_size=HIDDEN),
            "AudioAlignCTC": dict(audio_size=AUDIO, vocab_size=VOCAB, hidden_size=HIDDEN,
                                  num_layers=2),
            "TextToAlignTextModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN),
            "AlignTextToAudioModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN, use_mcep=True),
            "AlignTextToAudioMultiTaskModel": dict(vocab_size=VOCAB, hidden_size=HIDDEN,
                                                   target_vocab_size=V1_PHONES,
                                                   use_mcep=True)}[name]


def _v1_port(name):
    from voice100_tpu_torch import models as pm

    return getattr(pm, name)(**_v1_kwargs(name), device="cpu")


def _v1_port_forward(name, port, x, lengths):
    """The port model's evaluation forward in the twin's layout."""
    with torch.no_grad():
        if name == "AudioAlignCTC":
            return port(x, lengths)[0]
        out = port(x)
        if not name.startswith("AlignTextToAudio"):
            return out
        hasf0, f0, logspc, codeap = out[:4]
        world = torch.cat([hasf0[:, :, None], f0[:, :, None], logspc, codeap], dim=2)
        return (world, out[4]) if len(out) == 5 else world


@pytest.mark.parametrize("name", V1_NAMES)
def test_v1_importer_equals_the_jax_importer_and_the_twin(name):
    from voice100_tpu import models as jm
    from voice100_tpu.tools.import_torch import convert_state_dict as jax_convert
    from voice100_tpu_torch.tools.import_torch import convert_state_dict, import_state_dict
    from voice100_tpu_torch.tools.weights import from_jax_variables

    twin = _v1_twin(name)
    state = {k: v.numpy() for k, v in twin.state_dict().items()}
    assert any(k.endswith("num_batches_tracked") for k in state) == (name != "AudioAlignCTC")
    port = _v1_port(name)
    want = from_jax_variables(jax_convert(state, getattr(jm, name)(**_v1_kwargs(name))),
                              model=name)
    got = convert_state_dict(state, port)
    assert got.keys() == want.keys() == port.state_dict().keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0)
    if name.startswith("AlignTextToAudio"):  # absent statistics: identity
        assert float(got["norm.f0_mean"][0]) == 120.0
        assert (got["norm.logspc_mean"] == 0).all() and (got["norm.codeap_std"] == 1).all()
    import_state_dict({f"model.{k}": v for k, v in state.items()}, port)
    port.eval()
    x, lengths = _v1_input(name, 7), torch.tensor([19, 12, 7])
    with torch.no_grad():
        ref = twin(x, lengths)
    out = _v1_port_forward(name, port, x, lengths)
    for a, b in zip(out if isinstance(out, tuple) else (out,),
                    ref if isinstance(ref, tuple) else (ref,)):
        if name == "AudioAlignCTC":
            for row, n in enumerate((lengths + 1) // 2):
                np.testing.assert_allclose(a[row, :n].numpy(), b[row, :n].numpy(), rtol=1e-4,
                                           atol=1e-4)
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_v1_cli_round_trip_loads(tmp_path):
    """A Lightning ``.ckpt`` of the multi-task twin (``model.`` prefix,
    ``num_batches_tracked``) through the CLI into a port checkpoint."""
    from voice100_tpu_torch.tools.import_torch import cli_main
    from voice100_tpu_torch.training.checkpoint import load_model_weights

    name = "AlignTextToAudioMultiTaskModel"
    twin = _v1_twin(name)
    torch.save({"state_dict": {f"model.{k}": v for k, v in twin.state_dict().items()},
                "epoch": 3}, tmp_path / "ref.ckpt")
    config = {"model": {"class_path": f"voice100.models.tts.{name}",
                        "init_args": _v1_kwargs(name)}}
    (tmp_path / "mt.yaml").write_text(yaml.safe_dump(config))
    cli_main(["--config", str(tmp_path / "mt.yaml"), "--ckpt_path", str(tmp_path / "ref.ckpt"),
              "--output", str(tmp_path / "ckpt" / "port.pt"), "--device", "cpu"])
    port = load_model_weights(str(tmp_path / "ckpt" / "port.pt"), _v1_port(name)).eval()
    for key, value in port.state_dict().items():
        if key in twin.state_dict():
            torch.testing.assert_close(value, twin.state_dict()[key], rtol=0, atol=0)
    x = _v1_input(name, 3)
    with torch.no_grad():
        ref = twin(x)
    for a, b in zip(_v1_port_forward(name, port, x, None), ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)
