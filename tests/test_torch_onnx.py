"""The port's ONNX emitter, runtime and serving vs the JAX package's (CPU).

Narrow v2 and v1 models are initialised in JAX and carried to the port
with ``from_jax_variables`` (the v1 BatchNorms' statistics moved off 0
and 1, so that the folded graphs read them). Held here:

* the port's emitter, fed the same weights, writes the JAX emitter's file
  byte for byte (both serialize the same messages in field order), and
  each package's runtime reads the other's file to the same outputs; a
  v1 acoustic model with ``use_mcep`` and ``n_fft=256`` folds the mc2sp
  matrix of its own ``n_fft``;
* the port's NumPy runtime against the port model at rtol/atol 1e-4 on
  valid frames (``tests/test_onnx.py:55-58``);
* ``OnnxASR`` gives the port ``ASRPipeline``'s transcripts, ``OnnxTTS``
  synthesizes, and ``expand_alignment_host`` equals the JAX one;
* the port's schema (protobuf classes made from a descriptor built in
  code): its bytes parse with the JAX package's generated module and it
  parses that module's bytes, unpacked repeated numbers and unknown fields
  included.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from voice100_tpu_torch.tools.weights import from_jax_variables

VOCAB, MELS = 29, 64
ASR_SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
DECODER = ((32, False, 3, 1, 1, False), (32, True, 5, 2, 2, False), (16, False, 3, 1, 1, True))
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25),
         "logspc_std": np.linspace(0.2, 1.5, 25), "codeap_mean": [-20.0], "codeap_std": [6.0]}
RTOL = ATOL = 1e-4


def _init(model, args):
    return jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(3), *args))


def make_pairs():
    """kind -> (JAX model, its variables, the port model with its weights)."""
    from voice100_tpu import models as jm

    out = {}
    model = jm.AudioToAlignText(audio_size=MELS, vocab_size=VOCAB, encoder_settings=ASR_SETTINGS,
                                decoder_num_layers=2, decoder_hidden_size=32)
    variables = _init(model, (jnp.zeros((1, 21, MELS)), jnp.asarray([21])))
    port = AudioToAlignText(MELS, VOCAB, ASR_SETTINGS, 2, 32, device="cpu").eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    out["asr"] = (model, variables, port)

    text = (jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    model = jm.TextToAlignText(vocab_size=VOCAB, num_layers=2, hidden_size=32)
    variables = _init(model, text)
    port = TextToAlignText(VOCAB, num_layers=2, hidden_size=32, device="cpu").eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    out["align"] = (model, variables, port)

    for kind, logspc in (("tts", 25), ("tts_logspc", 9)):
        model = jm.AlignTextToAudio(vocab_size=VOCAB, logspc_size=logspc, codeap_size=1,
                                    encoder_num_layers=2, encoder_hidden_size=16,
                                    decoder_settings=DECODER)
        variables = _init(model, text)
        stats = dict(STATS)
        if logspc != 25:
            stats.update(logspc_mean=np.zeros(logspc), logspc_std=np.ones(logspc))
        variables["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in stats.items()}
        port = AlignTextToAudio(VOCAB, logspc, 1, 2, 16, DECODER, device="cpu").eval()
        port.load_state_dict(from_jax_variables(variables, DECODER), strict=True)
        out[kind] = (model, variables, port)
    return out


# v1 surfaces: name, constructor arguments, the init inputs' kind
V1_HIDDEN = 16
V1_SPECS = {
    "asr_v1": ("AudioToTextCTC", dict(audio_size=MELS, vocab_size=VOCAB, embed_size=12,
                                      hidden_size=V1_HIDDEN)),
    "align_v1": ("AudioAlignCTC", dict(audio_size=MELS, vocab_size=VOCAB, hidden_size=V1_HIDDEN,
                                       num_layers=2)),
    "ttsalign_v1": ("TextToAlignTextModel", dict(vocab_size=VOCAB, hidden_size=V1_HIDDEN)),
    "ttsaudio_v1": ("AlignTextToAudioModel", dict(vocab_size=VOCAB, hidden_size=V1_HIDDEN,
                                                  n_fft=32)),
    "ttsaudio_v1_mcep": ("AlignTextToAudioModel", dict(vocab_size=VOCAB, hidden_size=V1_HIDDEN,
                                                       use_mcep=True, n_fft=256)),
    "ttsaudio_mt_v1": ("AlignTextToAudioMultiTaskModel", dict(
        vocab_size=VOCAB, target_vocab_size=13, hidden_size=V1_HIDDEN, n_fft=32)),
}
V1_KINDS = list(V1_SPECS)


def make_v1_pairs():
    """kind -> (JAX model, its variables, the port model with its weights),
    for the five v1 architectures (two of the acoustic one)."""
    from voice100_tpu import models as jm
    from voice100_tpu_torch import models as pm

    rng = np.random.default_rng(9)
    out = {}
    for kind, (name, kwargs) in V1_SPECS.items():
        model = getattr(jm, name)(**kwargs)
        if name.startswith("Audio"):
            args = (jnp.zeros((1, 21, MELS)),) + ((jnp.asarray([21]),) if name == "AudioAlignCTC"
                                                   else ())
        else:
            args = (jnp.zeros((1, 8), jnp.int32),)
        variables = dict(_init(model, args))
        if "batch_stats" in variables:
            variables["batch_stats"] = jax.tree_util.tree_map(
                lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                variables["batch_stats"])
        if "world_norm" in variables:
            s = model.logspc_size
            variables["world_norm"] = {"norm": {
                "f0_mean": np.float32([150.0]), "f0_std": np.float32([30.0]),
                "logspc_mean": np.linspace(-6, 0.5, s).astype(np.float32),
                "logspc_std": np.linspace(0.2, 1.5, s).astype(np.float32),
                "codeap_mean": np.float32([-20.0]), "codeap_std": np.float32([6.0])}}
        port = getattr(pm, name)(**kwargs, device="cpu").eval()
        port.load_state_dict(from_jax_variables(variables, model=name), strict=True)
        out[kind] = (model, variables, port)
    return out


@pytest.fixture(scope="module")
def v1_pairs():
    return make_v1_pairs()


def _v1_inputs(kind):
    rng = np.random.default_rng(8)
    if kind in ("asr_v1", "align_v1"):
        audio = rng.standard_normal((2, 37, MELS)).astype(np.float32)
        return (audio, np.asarray([37, 22], np.int32)) if kind == "align_v1" else (audio,)
    return (rng.integers(1, VOCAB, (2, 13)).astype(np.int32),)


def _v1_port_outputs(kind, port, args):
    """The port model's outputs on ``args``, as the graph gives them: the
    v1 acoustic models' predict with mc2sp of the model's ``n_fft`` folded
    where it predicts mel-cepstrum."""
    with torch.inference_mode():
        x = [torch.from_numpy(a) for a in args]
        if not kind.startswith("ttsaudio"):
            out = port(*x)
            return tuple(t.numpy() for t in (out if isinstance(out, tuple) else (out,)))
        f0, feat, codeap, *logits = port.predict(*x)
        if port.use_mcep:
            from voice100_tpu_torch.dsp.mcep import create_mc2sp_matrix

            feat = feat @ torch.from_numpy(
                create_mc2sp_matrix(port.n_fft, 24, 0.410).astype(np.float32))
        return tuple(t.numpy() for t in (f0, feat, codeap, *logits))


@pytest.fixture(scope="module")
def pairs():
    return make_pairs()


def _inputs(kind):
    rng = np.random.default_rng(7)
    if kind == "asr":
        return (rng.standard_normal((2, 37, MELS)).astype(np.float32),
                np.asarray([37, 22], np.int32))
    return rng.integers(1, VOCAB, (2, 13)).astype(np.int32), np.asarray([13, 9], np.int32)


def _valid_frames(kind, lengths):
    if kind == "asr":
        return (lengths + 1) // 2
    if kind == "align":
        return lengths
    return 2 * lengths - 1 - 4  # the transposed block doubles time; trim its halo


def _port_outputs(kind, port, args):
    with torch.inference_mode():
        x, n = (torch.from_numpy(a) for a in args)
        if kind == "asr":
            return tuple(t.numpy() for t in port(x, n))
        if kind == "align":
            return (port.predict(x, n).numpy(),)
        f0, feat, codeap = port.predict(x, n)
        if port.logspc_size == 25:
            from voice100_tpu_torch.dsp.mcep import create_mc2sp_matrix

            feat = feat @ torch.from_numpy(create_mc2sp_matrix(512, 24, 0.410).astype(np.float32))
        return f0.numpy(), feat.numpy(), codeap.numpy()


@pytest.mark.parametrize("kind", ["asr", "align", "tts", "tts_logspc"])
def test_emitter_writes_the_jax_file(kind, pairs, tmp_path):
    from voice100_tpu.onnx.export import export_onnx as jax_export_onnx
    from voice100_tpu.onnx.runtime import load_model as jax_load_model
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.runtime import load_model

    model, variables, port = pairs[kind]
    ref_path = jax_export_onnx(model, variables, str(tmp_path / "jax.onnx"))
    path = export_onnx(port, str(tmp_path / "port.onnx"))
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    args = _inputs(kind)
    ours, theirs = load_model(ref_path)(*args), jax_load_model(path)(*args)
    assert len(ours) == len(theirs) >= 1
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["asr", "align", "tts", "tts_logspc"])
def test_runtime_matches_the_port_model(kind, pairs, tmp_path):
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.runtime import load_model

    port = pairs[kind][2]
    args = _inputs(kind)
    got = load_model(export_onnx(port, str(tmp_path / "m.onnx")))(*args)
    want = _port_outputs(kind, port, args)
    assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
    for row, n in enumerate(_valid_frames(kind, args[1])):
        for a, b in zip(got, want):
            if np.ndim(b) == 1:  # logits_len
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a[row, :n], b[row, :n], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", V1_KINDS)
def test_v1_emitter_writes_the_jax_file(kind, v1_pairs, tmp_path):
    from voice100_tpu.onnx.export import export_onnx as jax_export_onnx
    from voice100_tpu.onnx.runtime import load_model as jax_load_model
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.runtime import load_model

    model, variables, port = v1_pairs[kind]
    ref_path = jax_export_onnx(model, variables, str(tmp_path / "jax.onnx"))
    path = export_onnx(port, str(tmp_path / "port.onnx"))
    assert open(path, "rb").read() == open(ref_path, "rb").read()
    args = _v1_inputs(kind)
    ours, theirs = load_model(ref_path)(*args), jax_load_model(path)(*args)
    assert len(ours) == len(theirs) == {"align_v1": 2, "ttsaudio_mt_v1": 4}.get(
        kind, 3 if kind.startswith("ttsaudio") else 1)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    if kind == "ttsaudio_v1_mcep":  # mc2sp of the model's n_fft=256: 129 bins
        assert ours[1].shape[-1] == 129


@pytest.mark.parametrize("kind", V1_KINDS)
def test_v1_runtime_matches_the_port_model(kind, v1_pairs, tmp_path):
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.runtime import load_model

    port = v1_pairs[kind][2]
    args = _v1_inputs(kind)
    got = load_model(export_onnx(port, str(tmp_path / "m.onnx")))(*args)
    want = _v1_port_outputs(kind, port, args)
    assert [np.shape(a) for a in got] == [np.shape(b) for b in want]
    if kind == "align_v1":
        np.testing.assert_array_equal(got[1], want[1])
    for row in range(2):
        n = int(want[1][row]) if kind == "align_v1" else None
        for a, b in zip(got, want):
            if np.ndim(b) > 1:
                np.testing.assert_allclose(a[row, :n], b[row, :n], rtol=RTOL, atol=ATOL)


def test_onnx_asr_transcribes_as_the_pipeline(pairs, tmp_path):
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.serve import OnnxASR

    # one clip a batch in a bucket of its own length, as
    # tests/test_onnx.py:365-389 holds the JAX pair: the pipeline pads no
    # samples the ONNX path does not see
    port = pairs["asr"][2]
    onnx = OnnxASR(export_onnx(port, str(tmp_path / "asr.onnx")))
    rng = np.random.default_rng(11)
    got, want = [], []
    for n in (4000, 9000, 2500):
        clip = (rng.standard_normal(n) * 0.3).astype(np.float32)
        pipe = ASRPipeline(port, device="cpu", batch_size=1, buckets_sec=(n / 16000,))
        want += pipe.transcribe([clip])
        got.append(onnx(clip))
    assert got == want and any(want)


def test_onnx_tts_synthesizes(pairs, tmp_path):
    from voice100_tpu_torch.onnx.export import export_onnx
    from voice100_tpu_torch.onnx.serve import OnnxTTS

    tts = OnnxTTS(export_onnx(pairs["align"][2], str(tmp_path / "align.onnx")),
                  export_onnx(pairs["tts"][2], str(tmp_path / "tts.onnx")), use_phone=False)
    wav = tts("hello world")
    assert wav.ndim == 1 and wav.size > 1600 and np.isfinite(wav).all()
    assert np.abs(wav).max() <= 1.0


def test_expand_alignment_host_equals_jax():
    from voice100_tpu.onnx.serve import expand_alignment_host as jax_expand
    from voice100_tpu_torch.onnx.serve import expand_alignment_host

    rng = np.random.default_rng(5)
    for n in (1, 7, 30):
        text = rng.integers(1, VOCAB, n).astype(np.int32)
        align = rng.uniform(-0.5, 6.0, (n, 2)).astype(np.float32)
        np.testing.assert_array_equal(expand_alignment_host(text, align),
                                      jax_expand(text, align))


def test_schema_reads_and_writes_protobuf(pairs, tmp_path):
    from voice100_tpu.onnx.schema import get_pb as jax_get_pb
    from voice100_tpu_torch.onnx import schema
    from voice100_tpu_torch.onnx.export import export_onnx

    pb = jax_get_pb()
    ours = open(export_onnx(pairs["tts"][2], str(tmp_path / "m.onnx")), "rb").read()
    parsed = pb.ModelProto()
    parsed.ParseFromString(ours)
    assert parsed.SerializeToString() == ours and len(parsed.graph.node) > 20
    back = schema.ModelProto()
    back.ParseFromString(parsed.SerializeToString())
    assert back.SerializeToString() == ours

    # protobuf's bytes of every field kind, negative numbers and -0.0
    ref = pb.AttributeProto()
    ref.name, ref.type, ref.f, ref.i, ref.s = "a", pb.AttributeProto.FLOATS, -0.0, -5, b"\x00\xff"
    ref.floats.extend([1.5, -2.25])
    ref.ints.extend([-1, 2 ** 40])
    ref.t.dims.extend([2, 3])
    ref.t.data_type = 11
    ref.t.double_data.extend([0.1, -7.0])
    ref.t.int32_data.extend([-3, 4])
    ref.strings.extend([b"x", b""])
    got = schema.AttributeProto.FromString(ref.SerializeToString())
    assert got.SerializeToString() == ref.SerializeToString()
    assert (got.i, got.ints, got.t.int32_data, got.t.double_data) == (-5, [-1, 2 ** 40], [-3, 4],
                                                                     [0.1, -7.0])
    dim = pb.TensorShapeProto.Dimension()
    dim.dim_value = 0  # a oneof member is written at its default
    assert schema.TensorShapeProto.Dimension.FromString(dim.SerializeToString()).HasField(
        "dim_value")
    # unpacked repeated numbers (field 8, varints) and an unknown field (99)
    raw = bytes([0x40, 0x03, 0x40, 0x05]) + bytes([0x98, 0x06, 0x01]) + b"\x0a\x01z"
    msg = schema.AttributeProto.FromString(raw)
    assert msg.ints == [3, 5] and msg.name == "z"
    assert pb.AttributeProto.FromString(msg.SerializeToString()).ints == [3, 5]
