"""The port's ``tools/export`` (``torch.export`` programs) on the CPU.

Narrow v2 models initialised in JAX and carried to the port
(``test_torch_onnx.make_pairs``). Each predict surface exported as a
``.pt2`` reloads with ``torch.export.load``, equals the direct predict
call bit for bit (the same ATen ops and the same biLSTM op on the same
inputs), and stays within the port's parity tolerances of the JAX model's
``apply`` (``tests/test_torch_asr.py``: logits 1e-4; ``tests/
test_torch_tts.py``: durations rtol 1e-5, TTS streams 1e-4 abs); its graph
holds one ``voice100_torch::bilstm_infer`` node a layer; the manifest
names the surface; the CLI runs from a config and a port checkpoint; a v1
architecture raises naming ROADMAP item 11.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from test_torch_onnx import VOCAB, make_pairs

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


def test_v1_architectures_raise_naming_the_item(tmp_path):
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.tools.export import cli_main, export_model

    config = {"model": {"class_path": "voice100_tpu.models.AudioToTextCTC",
                        "init_args": {"audio_size": 64, "vocab_size": VOCAB}},
              "data": {"class_path": "voice100_tpu.data.AudioTextDataModule"}}
    (tmp_path / "v1.yaml").write_text(yaml.safe_dump(config))
    with pytest.raises(NotImplementedError, match="item 11"):
        cli_main(["--config", str(tmp_path / "v1.yaml"), "--ckpt_path", "none", "--device", "cpu"])
    v1 = type("AlignTextToAudioModel", (torch.nn.Module,), {})()
    with pytest.raises(NotImplementedError, match="item 11"):
        export_onnx(v1, str(tmp_path / "v1.onnx"))
    with pytest.raises(NotImplementedError, match="item 11"):
        export_model(v1, str(tmp_path / "v1.pt2"))


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
