"""The port's ``tools/import_torch`` vs the JAX importer (CPU).

The reference-layout modules of ``tests/test_import_torch.py`` (torch
conv blocks with ``conv`` and ``layer_norm``, ``nn.LSTM``, ``nn.Linear``,
``nn.Embedding``, WORLD statistics under ``norm.*``) give state dicts that
go through the port's importer and through the JAX importer followed by
``from_jax_variables``: both give the same tensors, bit for bit, in a
strict load. Lightning's ``state_dict`` wrapper and a ``model.`` prefix
are taken, missing statistics keep the identity, and the CLI writes a
port checkpoint that ``load_model_weights`` reads. v1 raises naming
ROADMAP item 11.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest
import torch
import yaml
from torch import nn

from test_import_torch import _torch_stack

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
    from voice100_tpu_torch.tools.import_torch import cli_main, convert_state_dict

    state = _reference("asr")
    del state["dense.bias"]
    with pytest.raises(KeyError, match="dense.bias"):
        convert_state_dict(state, _models("asr")[1])
    state = _reference("asr")
    state["dense.weight"] = state["dense.weight"][:3]
    with pytest.raises(ValueError, match="dense.weight"):
        convert_state_dict(state, _models("asr")[1])
    v1 = type("AudioAlignCTC", (nn.Module,), {})()
    with pytest.raises(NotImplementedError, match="item 11"):
        convert_state_dict({}, v1)
    config = {"model": {"class_path": "voice100_tpu.models.AudioToTextCTC", "init_args": {}}}
    (tmp_path / "v1.yaml").write_text(yaml.safe_dump(config))
    with pytest.raises(NotImplementedError, match="item 11"):
        cli_main(["--config", str(tmp_path / "v1.yaml"), "--ckpt_path", "x.ckpt",
                  "--output", str(tmp_path / "o.pt")])


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
