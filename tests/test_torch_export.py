"""The port's ``tools/export`` (``torch.export`` programs) on the CPU.

Narrow v2 and v1 models initialised in JAX and carried to the port
(``test_torch_onnx.make_pairs``, ``make_v1_pairs``). Each predict surface
exported as a ``.pt2`` reloads with ``torch.export.load``, equals the
direct predict call bit for bit (the same ATen ops and the same biLSTM op
on the same inputs), and stays within the port's parity tolerances of the
JAX model's ``apply`` (``tests/test_torch_asr.py``: logits 1e-4; ``tests/
test_torch_tts.py``: durations rtol 1e-5, TTS streams 1e-4 abs; the v1
forward rtol 1e-4 / atol 1e-5 of ``tests/test_torch_v1_models.py``); its
graph holds one ``voice100_torch::bilstm_infer`` node a layer
(``AudioAlignCTC``'s two among the v1 models); the manifest names the JAX
tool's kind; the CLI runs from a v2 or v1 config and a port checkpoint.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from test_torch_onnx import MELS, V1_KINDS, VOCAB, make_pairs, make_v1_pairs

KINDS = ["asr", "align", "tts", "tts_logspc"]


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """kind -> (JAX model, variables, port model, .pt2 path)."""
    from voice100_tpu_torch.tools.export import export_model

    out = {}
    root = tmp_path_factory.mktemp("export")
    for kind, (model, variables, port) in make_pairs().items():
        path = str(root / f"{kind}.pt2")
        assert export_model(port, path) == path
        out[kind] = (model, variables, port, path)
    return out


def _args(kind):
    rng = np.random.default_rng(3)
    if kind == "asr":
        return (torch.from_numpy(rng.standard_normal((1, 512, 64)).astype(np.float32)),
                torch.tensor([431], dtype=torch.int32))
    return (torch.from_numpy(rng.integers(1, VOCAB, (1, 128)).astype(np.int32)),
            torch.tensor([97], dtype=torch.int32))


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


@pytest.mark.parametrize("kind", KINDS)
def test_program_reloads_and_equals_the_direct_call(kind, exported):
    from voice100_tpu_torch.tools.export import load_exported, predict_module

    _, _, port, path = exported[kind]
    args = _args(kind)
    with torch.inference_mode():
        want = _tuple(predict_module(port)(*args))
    got = _tuple(load_exported(path)(*args))
    assert len(got) == len(want) == {"asr": 2, "align": 1}.get(kind, 3)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and not a.requires_grad
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_program_is_within_parity_of_the_jax_model(kind, exported):
    from voice100_tpu import models as jm
    from voice100_tpu_torch.dsp.mcep import create_mc2sp_matrix
    from voice100_tpu_torch.tools.export import load_exported

    model, variables, _, path = exported[kind]
    args = _args(kind)
    got = [t.numpy() for t in _tuple(load_exported(path)(*args))]
    x, n = (jnp.asarray(t.numpy()) for t in args)
    if kind == "asr":
        logits, logits_len = model.apply(variables, x, n)
        np.testing.assert_array_equal(got[1], np.asarray(logits_len))
        valid = int(logits_len[0])
        np.testing.assert_allclose(got[0][:, :valid], np.asarray(logits)[:, :valid],
                                   rtol=1e-4, atol=1e-4)
    elif kind == "align":
        want = model.apply(variables, x, n, method=jm.TextToAlignText.predict)
        np.testing.assert_allclose(got[0][:, :97], np.asarray(want)[:, :97], rtol=1e-5, atol=1e-6)
    else:
        f0, feat, codeap = (np.asarray(a) for a in model.apply(
            variables, x, n, method=jm.AlignTextToAudio.predict))
        if feat.shape[-1] == 25:
            feat = feat @ create_mc2sp_matrix(512, 24, 0.410).astype(np.float32)
        valid = 2 * 97 - 1 - 4
        for a, b in zip(got, (f0, feat, codeap)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a[:, :valid], b[:, :valid], rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
def test_graph_holds_the_bilstm_op_and_the_manifest_names_the_surface(kind, exported):
    from voice100_tpu_torch.tools.export import load_exported

    _, _, port, path = exported[kind]
    program = load_exported(path).program
    ops = [node for node in program.graph.nodes
           if node.op == "call_function" and "bilstm_infer" in str(node.target)]
    assert len(ops) == port.lstm.num_layers
    assert [n.args[5] if len(n.args) > 5 else None for n in ops] == [None] * len(ops)
    manifest = json.load(open(path + ".json"))
    surface = kind.split("_")[0]
    assert manifest["kind"] == surface and manifest["format"] == "torch.export"
    assert manifest["device"] == "cpu" and "load_exported" in manifest["calling_convention"]
    assert manifest["input_shapes"] == ([[1, 512, 64], [1]] if surface == "asr"
                                        else [[1, 128], [1]])
    assert manifest["input_dtypes"] == (["float32", "int32"] if surface == "asr"
                                        else ["int32", "int32"])
    onnx = path[:-len(".pt2")] + ".onnx"
    assert open(onnx, "rb").read(2) == b"\x08\x07"  # ModelProto.ir_version = 7


def test_cli_exports_a_config_and_checkpoint(exported, tmp_path):
    from voice100_tpu_torch.tools.export import cli_main, load_exported, predict_module

    port = exported["align"][2]
    config = {"model": {"class_path": "voice100_tpu.models.TextToAlignText",
                        "init_args": {"vocab_size": VOCAB, "num_layers": 2, "hidden_size": 32}},
              "data": {"class_path": "voice100_tpu.data.AlignTextDataModule"}}
    (tmp_path / "align.yaml").write_text(yaml.safe_dump(config))
    torch.save({"model": port.state_dict()}, tmp_path / "align.pt")
    out = tmp_path / "out" / "align.pt2"
    out.parent.mkdir()
    cli_main(["--config", str(tmp_path / "align.yaml"), "--ckpt_path", str(tmp_path / "align.pt"),
              "--output", str(out), "--device", "cpu"])
    assert json.load(open(str(out) + ".json"))["kind"] == "align"
    assert (tmp_path / "out" / "align.onnx").exists()
    args = _args("align")
    with torch.inference_mode():
        want = predict_module(port)(*args)
    torch.testing.assert_close(load_exported(str(out))(*args), want, rtol=0, atol=0)


def test_v1_architectures_raise_naming_the_item(v1_exported, tmp_path):
    """The CLI exports a v1 config (a reference ``class_path``) and a port
    checkpoint; an architecture without a surface raises naming itself."""
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.tools.export import cli_main, export_model, load_exported
    from voice100_tpu_torch.tools.export import predict_module

    port = v1_exported["align_v1"][2]
    config = {"model": {"class_path": "voice100_tpu.models.AudioAlignCTC",
                        "init_args": {"audio_size": MELS, "vocab_size": VOCAB,
                                      "hidden_size": 16, "num_layers": 2}},
              "data": {"class_path": "voice100_tpu.data.AudioTextDataModule"}}
    (tmp_path / "v1.yaml").write_text(yaml.safe_dump(config))
    torch.save({"model": port.state_dict()}, tmp_path / "v1.pt")
    out = tmp_path / "out" / "v1.pt2"
    out.parent.mkdir()
    cli_main(["--config", str(tmp_path / "v1.yaml"), "--ckpt_path", str(tmp_path / "v1.pt"),
              "--output", str(out), "--device", "cpu"])
    assert json.load(open(str(out) + ".json"))["kind"] == "align_ctc_v1"
    assert (tmp_path / "out" / "v1.onnx").exists()
    args = _v1_args("align_v1")
    with torch.inference_mode():
        want = predict_module(port)(*args)
    for a, b in zip(load_exported(str(out))(*args), want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    other = type("AlignTextToAudioModelV0", (torch.nn.Module,), {})()
    with pytest.raises(ValueError, match="AlignTextToAudioModelV0"):
        export_onnx(other, str(tmp_path / "v0.onnx"))
    with pytest.raises(ValueError, match="AlignTextToAudioModelV0"):
        export_model(other, str(tmp_path / "v0.pt2"))


@pytest.fixture(scope="module")
def v1_exported(tmp_path_factory):
    """kind -> (JAX model, variables, port model, .pt2 path) of the v1 surfaces."""
    from voice100_tpu_torch.tools.export import export_model

    out = {}
    root = tmp_path_factory.mktemp("export_v1")
    for kind, (model, variables, port) in make_v1_pairs().items():
        path = str(root / f"{kind}.pt2")
        assert export_model(port, path) == path
        out[kind] = (model, variables, port, path)
    return out


V1_JAX_KIND = {"asr_v1": "asr_v1", "align_v1": "align_ctc_v1", "ttsalign_v1": "ttsalign_v1"}
V1_ALIGN_LENGTH = 431


def _v1_args(kind):
    """Seeded inputs at the static shapes, a valid length short of the extent."""
    rng = np.random.default_rng(4)
    if kind in ("asr_v1", "align_v1"):
        x = torch.from_numpy(rng.standard_normal((1, 512, MELS)).astype(np.float32))
        return (x, torch.tensor([V1_ALIGN_LENGTH], dtype=torch.int32)) if kind == "align_v1" \
            else (x,)
    return (torch.from_numpy(rng.integers(1, VOCAB, (1, 128)).astype(np.int32)),)


@pytest.mark.parametrize("kind", V1_KINDS)
def test_v1_program_reloads_and_equals_the_direct_call(kind, v1_exported):
    from voice100_tpu_torch.tools.export import load_exported, predict_module

    _, _, port, path = v1_exported[kind]
    args = _v1_args(kind)
    with torch.inference_mode():
        want = _tuple(predict_module(port)(*args))
    got = _tuple(load_exported(path)(*args))
    assert len(got) == len(want) == {"align_v1": 2, "ttsaudio_mt_v1": 4}.get(
        kind, 3 if kind.startswith("ttsaudio") else 1)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and not a.requires_grad
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", V1_KINDS)
def test_v1_program_is_within_parity_of_the_jax_model(kind, v1_exported):
    from voice100_tpu_torch.tools.export import load_exported

    model, variables, _, path = v1_exported[kind]
    args = _v1_args(kind)
    got = [t.numpy() for t in _tuple(load_exported(path)(*args))]
    jargs = [jnp.asarray(t.numpy()) for t in args]
    if kind.startswith("ttsaudio"):  # predict, no mc2sp folded
        want = model.apply(variables, *jargs, method=type(model).predict)
    else:
        want = model.apply(variables, *jargs)
    want = [np.asarray(w) for w in _tuple(want)]
    assert len(got) == len(want)
    valid = (V1_ALIGN_LENGTH + 1) // 2 if kind == "align_v1" else None
    if kind == "align_v1":
        np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got, want):
        assert a.shape == b.shape
        if b.ndim > 1:
            np.testing.assert_allclose(a[:, :valid], b[:, :valid], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", V1_KINDS)
def test_v1_graph_and_manifest_name_the_jax_kind(kind, v1_exported):
    from voice100_tpu_torch.tools.export import load_exported

    path = v1_exported[kind][3]
    program = load_exported(path).program
    ops = [node for node in program.graph.nodes
           if node.op == "call_function" and "bilstm_infer" in str(node.target)]
    assert len(ops) == (2 if kind == "align_v1" else 0)
    manifest = json.load(open(path + ".json"))
    assert manifest["kind"] == V1_JAX_KIND.get(kind, "ttsaudio_v1")
    assert manifest["format"] == "torch.export" and manifest["device"] == "cpu"
    audio = kind in ("asr_v1", "align_v1")
    assert manifest["input_shapes"] == ([[1, 512, MELS]] if audio else [[1, 128]]) + (
        [[1]] if kind == "align_v1" else [])
    assert manifest["input_dtypes"] == (["float32"] if audio else ["int32"]) + (
        ["int32"] if kind == "align_v1" else [])
    onnx = path[:-len(".pt2")] + ".onnx"
    assert open(onnx, "rb").read(2) == b"\x08\x07"


def test_deterministic_cudnn_is_restored_after_overlapping_threads():
    """``load_exported``'s calls and the transposed convolution ask for
    deterministic cuDNN through one switch of the process: with four
    threads inside at once, each sees it set, and it is back to its value
    once the last has left, in whatever order they leave."""
    import threading

    from voice100_tpu_torch.models.layers import deterministic_cudnn

    before = torch.backends.cudnn.deterministic
    barrier, seen = threading.Barrier(4), []

    def call(i):
        with deterministic_cudnn():
            barrier.wait()
            seen.append(torch.backends.cudnn.deterministic)
            with deterministic_cudnn():  # nested, as a program's transposed conv inside a call
                seen.append(torch.backends.cudnn.deterministic)
            barrier.wait()
            if i % 2:
                threading.Event().wait(0.01 * i)

    for _ in range(3):
        threads = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cudnn.deterministic == before
    assert seen == [True] * 24
