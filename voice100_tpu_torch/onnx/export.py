"""Emit ONNX graphs (opset 13) for the predict surfaces of port models.

The emitter of ``voice100_tpu/onnx/export.py``, copied: the graph bodies
read a flax-layout variable tree, which :func:`export_onnx` builds from a
port model's state dict with
:func:`voice100_tpu_torch.tools.weights.to_jax_variables`, and the
model's sizes, so a port model and the JAX model with the same weights
give the same file. Three v2 surfaces and the five v1 ones (below).

Parity with the reference's export_onnx.py:12-161: three serving
graphs with dynamic batch/time axes —

  asr:   (audio[B,T,A] f32, audio_len[B] i32) -> (logits[B,T',V] f32,
         logits_len[B] i32)
  align: (text[B,L] i32, text_len[B] i32)     -> (align[B,L,2] f32)
  tts:   (aligntext[B,L] i32, aligntext_len[B] i32)
         -> (f0[B,T] f32, logspc[B,T,S'] f32, codeap[B,T,C] f32)
         with the mc2sp matrix folded into the graph when the model
         predicts mel-cepstrum (reference export_onnx.py:81-97)

and the five v1 graphs (``voice100_tpu/onnx/export.py:301-588``), their
BatchNorms folded to the running statistics —

  asr_v1:      (audio[B,T,A] f32) -> logits[B,T',V]
  align_v1:    (audio, audio_len) -> (logits, logits_len)
  ttsalign_v1: (text[B,L] i32)    -> align[B,L,2] (log-durations)
  ttsaudio_v1: (aligntext[B,L] i32) -> (f0, logspc, codeap), plus
               phone_logits[B,L,P] for the multi-task model; mc2sp of the
               model's ``n_fft`` folded where it predicts mel-cepstrum

Graphs are built directly from the parameters — no tracing, no onnx
package. LayerNorm and exact GELU are decomposed into opset-13
primitives; the biLSTM maps onto the ONNX LSTM op (gate order converted
from torch i,f,g,o to ONNX i,o,f,c; padding masked via sequence_lens).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Sequence

import numpy as np

from .builder import GraphBuilder, DT_FLOAT, DT_INT32

__all__ = ["export_onnx", "export_asr_onnx", "export_align_onnx", "export_tts_onnx",
           "export_asr_v1_onnx", "export_align_v1_onnx", "export_ttsalign_v1_onnx",
           "export_ttsaudio_v1_onnx", "export_ttsaudio_mt_v1_onnx"]

_SQRT2 = float(np.sqrt(2.0))


def _f32(tree) -> np.ndarray:
    return np.asarray(tree, np.float32)


def _layer_norm(gb: GraphBuilder, x: str, scale: np.ndarray,
                bias: np.ndarray, eps: float = 1e-5) -> str:
    """LayerNorm over the last axis, decomposed (no LN op in opset 13)."""
    mean = gb.node("ReduceMean", [x], axes=[-1], keepdims=1)
    d = gb.node("Sub", [x, mean])
    var = gb.node("ReduceMean", [gb.node("Mul", [d, d])],
                  axes=[-1], keepdims=1)
    eps_c = gb.constant("ln_eps", np.float32(eps))
    denom = gb.node("Sqrt", [gb.node("Add", [var, eps_c])])
    y = gb.node("Div", [d, denom])
    y = gb.node("Mul", [y, gb.constant("ln_scale", _f32(scale))])
    return gb.node("Add", [y, gb.constant("ln_bias", _f32(bias))])


def _gelu(gb: GraphBuilder, x: str) -> str:
    """Exact GELU: 0.5 * x * (1 + erf(x / sqrt(2)))."""
    e = gb.node("Erf", [gb.node("Div", [x, gb.constant(
        "sqrt2", np.float32(_SQRT2))])])
    one = gb.constant("one", np.float32(1.0))
    half = gb.constant("half", np.float32(0.5))
    return gb.node("Mul", [gb.node("Mul", [x, gb.node("Add", [e, one])]),
                           half])


def _conv_block(gb: GraphBuilder, x: str, block_params,
                setting, transpose_block: bool) -> str:
    """One ConvLayerBlock / ConvTransposeLayerBlock in [B, T, C]."""
    _, _, kernel_size, stride, padding, use_bias = setting
    nct = gb.node("Transpose", [x], perm=[0, 2, 1])  # [B, C, T]
    if transpose_block:
        kernel = _f32(block_params["kernel"])  # [k, in, out], time-flipped
        w = np.transpose(kernel[::-1], (1, 2, 0)).copy()  # [in, out, k]
        inputs = [nct, gb.constant("convT_w", w)]
        if use_bias:
            inputs.append(gb.constant("convT_b", _f32(block_params["bias"])))
        y = gb.node(
            "ConvTranspose", inputs,
            kernel_shape=[kernel_size], strides=[stride],
            pads=[padding, padding],
        )
        ln = block_params["LayerNorm_0"]
    else:
        conv = block_params["Conv_0"]
        w = np.transpose(_f32(conv["kernel"]), (2, 1, 0)).copy()  # [o,i,k]
        inputs = [nct, gb.constant("conv_w", w)]
        if use_bias:
            inputs.append(gb.constant("conv_b", _f32(conv["bias"])))
        y = gb.node(
            "Conv", inputs,
            kernel_shape=[kernel_size], strides=[stride],
            pads=[padding, padding],
        )
        ln = block_params["LayerNorm_0"]
    y = gb.node("Transpose", [y], perm=[0, 2, 1])  # back to [B, T, C]
    y = _layer_norm(gb, y, ln["scale"], ln["bias"])
    return _gelu(gb, y)


def _conv_stack(gb: GraphBuilder, x: str, stack_params,
                settings: Sequence) -> str:
    conv_i = transpose_i = 0
    for setting in settings:
        transpose_block = bool(setting[1])
        if transpose_block:
            params = stack_params[f"ConvTransposeLayerBlock_{transpose_i}"]
            transpose_i += 1
        else:
            params = stack_params[f"ConvLayerBlock_{conv_i}"]
            conv_i += 1
        x = _conv_block(gb, x, params, setting, transpose_block)
    return x


def _length_arith(gb: GraphBuilder, length: str, settings) -> str:
    """conv_stack_output_length on an int32 tensor (torch semantics;
    integer Div truncates, lengths are positive so trunc == floor)."""
    for _, transpose, kernel, stride, padding, _ in settings:
        if transpose:
            one = gb.constant("len_one", np.int32(1))
            length = gb.node("Sub", [length, one])
            length = gb.node(
                "Mul", [length, gb.constant("len_s", np.int32(stride))])
            length = gb.node("Add", [length, gb.constant(
                "len_kp", np.int32(kernel - 2 * padding))])
        else:
            length = gb.node("Add", [length, gb.constant(
                "len_pk", np.int32(2 * padding - kernel))])
            length = gb.node(
                "Div", [length, gb.constant("len_s", np.int32(stride))])
            length = gb.node(
                "Add", [length, gb.constant("len_one", np.int32(1))])
    return length


def _torch_to_onnx_gates(w: np.ndarray, hidden: int) -> np.ndarray:
    """Reorder gate blocks from torch (i, f, g, o) to ONNX (i, o, f, c)."""
    i, f, g, o = (w[k * hidden:(k + 1) * hidden] for k in range(4))
    return np.concatenate([i, o, f, g], axis=0)


def _bilstm(gb: GraphBuilder, x: str, seq_lens: str, lstm_params,
            num_layers: int, hidden: int) -> str:
    """Stacked bidirectional LSTM; in/out [B, T, D] (batch-major)."""
    y = gb.node("Transpose", [x], perm=[1, 0, 2])  # [T, B, D]
    for layer in range(num_layers):
        ws, rs, bs = [], [], []
        for direction in ("fwd", "bwd"):
            p = {
                k: _f32(lstm_params[f"l{layer}_{direction}_{k}"])
                for k in ("w_ih", "w_hh", "b_ih", "b_hh")
            }
            ws.append(_torch_to_onnx_gates(p["w_ih"], hidden))
            rs.append(_torch_to_onnx_gates(p["w_hh"], hidden))
            bs.append(np.concatenate([
                _torch_to_onnx_gates(p["b_ih"], hidden),
                _torch_to_onnx_gates(p["b_hh"], hidden),
            ]))
        w = gb.constant(f"lstm_w{layer}", np.stack(ws))   # [2, 4H, D]
        r = gb.constant(f"lstm_r{layer}", np.stack(rs))   # [2, 4H, H]
        b = gb.constant(f"lstm_b{layer}", np.stack(bs))   # [2, 8H]
        out, _, _ = gb.node(
            "LSTM", [y, w, r, b, seq_lens], n_outputs=3,
            hidden_size=hidden, direction="bidirectional",
        )
        # [T, 2, B, H] -> [T, B, 2H]
        out = gb.node("Transpose", [out], perm=[0, 2, 1, 3])
        shape = gb.constant("lstm_shape", np.asarray([0, 0, -1], np.int64))
        y = gb.node("Reshape", [out, shape])
    return gb.node("Transpose", [y], perm=[1, 0, 2])  # [B, T, 2H]


def _dense(gb: GraphBuilder, x: str, dense_params) -> str:
    y = gb.node("MatMul", [x, gb.constant(
        "dense_w", _f32(dense_params["kernel"]))])
    return gb.node("Add", [y, gb.constant(
        "dense_b", _f32(dense_params["bias"]))])


def _slice_last(gb: GraphBuilder, x: str, start: int, end: int) -> str:
    return gb.node("Slice", [
        x,
        gb.constant("sl_start", np.asarray([start], np.int64)),
        gb.constant("sl_end", np.asarray([end], np.int64)),
        gb.constant("sl_axes", np.asarray([-1], np.int64)),
    ])


def _squeeze_last(gb: GraphBuilder, x: str) -> str:
    return gb.node("Squeeze", [
        x, gb.constant("sq_axes", np.asarray([-1], np.int64))])


def export_asr_onnx(model, variables, path: str) -> str:
    """AudioToAlignText predict graph (reference export_onnx.py:12-37)."""
    params = variables["params"]
    gb = GraphBuilder(
        "voice100_asr",
        "voice100_tpu AudioToAlignText (audio, audio_len) -> "
        "(logits, logits_len)",
    )
    audio = gb.add_input("audio", DT_FLOAT,
                         ["batch", "audio_len", model.audio_size])
    audio_len = gb.add_input("audio_len", DT_INT32, ["batch"])
    x = _conv_stack(gb, audio, params["ConvStack_0"],
                    model.encoder_settings)
    x_len = _length_arith(gb, audio_len, model.encoder_settings)
    x = _bilstm(gb, x, x_len, params["BiLSTM_0"],
                model.decoder_num_layers, model.decoder_hidden_size)
    logits = _dense(gb, x, params["Dense_0"])
    gb.node("Identity", [logits], outputs=["logits"])
    gb.node("Identity", [x_len], outputs=["logits_len"])
    gb.add_output("logits", DT_FLOAT,
                  ["batch", "logits_len", model.vocab_size])
    gb.add_output("logits_len", DT_INT32, ["batch"])
    return gb.save(path)


def export_align_onnx(model, variables, path: str) -> str:
    """TextToAlignText predict graph (reference export_onnx.py:49-78):
    durations = exp(forward) - 1."""
    params = variables["params"]
    gb = GraphBuilder(
        "voice100_align",
        "voice100_tpu TextToAlignText (text, text_len) -> align",
    )
    text = gb.add_input("text", DT_INT32, ["batch", "text_len"])
    text_len = gb.add_input("text_len", DT_INT32, ["batch"])
    emb = gb.constant("embedding", _f32(params["Embed_0"]["embedding"]))
    x = gb.node("Gather", [emb, text], axis=0)
    x = _bilstm(gb, x, text_len, params["BiLSTM_0"],
                model.num_layers, model.hidden_size)
    y = _dense(gb, x, params["Dense_0"])
    y = gb.node("Exp", [y])
    y = gb.node("Sub", [y, gb.constant("one", np.float32(1.0))])
    gb.node("Identity", [y], outputs=["align"])
    gb.add_output("align", DT_FLOAT,
                  ["batch", "text_len", model.num_outputs])
    return gb.save(path)


def export_tts_onnx(model, variables, path: str) -> str:
    """AlignTextToAudio predict graph (reference export_onnx.py:100-131)
    with unnormalization, voicing gates, and — when the model predicts
    mel-cepstrum — the mc2sp matrix folded in (export_onnx.py:81-97)."""
    params = variables["params"]
    norm = variables["world_norm"]["norm"]
    gb = GraphBuilder(
        "voice100_tts",
        "voice100_tpu AlignTextToAudio (aligntext, aligntext_len) -> "
        "(f0, logspc, codeap)",
    )
    aligntext = gb.add_input("aligntext", DT_INT32, ["batch", "aligntext_len"])
    aligntext_len = gb.add_input("aligntext_len", DT_INT32, ["batch"])
    emb = gb.constant("embedding", _f32(params["embedding"]["embedding"]))
    x = gb.node("Gather", [emb, aligntext], axis=0)
    x = _bilstm(gb, x, aligntext_len, params["lstm"],
                model.encoder_num_layers, model.encoder_hidden_size)
    x = _conv_stack(gb, x, params["decoder"], model.decoder_settings)
    x = _dense(gb, x, params["projection"])

    f, s, c = model.f0_size, model.logspc_size, model.codeap_size
    hasf0 = _squeeze_last(gb, _slice_last(gb, x, 0, f))
    f0 = _squeeze_last(gb, _slice_last(gb, x, f, 2 * f))
    logspc = _slice_last(gb, x, 2 * f, 2 * f + s)
    hascodeap = _slice_last(gb, x, 2 * f + s, 2 * f + s + c)
    codeap = _slice_last(gb, x, 2 * f + s + c, 2 * f + s + 2 * c)

    def unnorm(y, mean, std, hint):
        y = gb.node("Mul", [y, gb.constant(f"{hint}_std", _f32(std))])
        return gb.node("Add", [y, gb.constant(f"{hint}_mean", _f32(mean))])

    f0 = unnorm(f0, norm["f0_mean"], norm["f0_std"], "f0")
    logspc = unnorm(logspc, norm["logspc_mean"], norm["logspc_std"],
                    "logspc")
    codeap = unnorm(codeap, norm["codeap_mean"], norm["codeap_std"],
                    "codeap")

    zero = gb.constant("zero", np.float32(0.0))

    def gate(cond_logits, y):
        voiced = gb.node("Less", [cond_logits, zero])
        return gb.node("Where", [voiced, zero, y])

    f0 = gate(hasf0, f0)
    codeap = gate(hascodeap, codeap)

    logspc_size = s
    if s == 25:  # mcep form: fold mc2sp into the graph
        from ..dsp.mcep import create_mc2sp_matrix

        mc2sp = create_mc2sp_matrix(512, 24, 0.410).astype(np.float32)
        logspc = gb.node(
            "MatMul", [logspc, gb.constant("mc2sp", mc2sp)])
        logspc_size = mc2sp.shape[1]

    gb.node("Identity", [f0], outputs=["f0"])
    gb.node("Identity", [logspc], outputs=["logspc"])
    gb.node("Identity", [codeap], outputs=["codeap"])
    gb.add_output("f0", DT_FLOAT, ["batch", "audio_frames"])
    gb.add_output("logspc", DT_FLOAT, ["batch", "audio_frames", logspc_size])
    gb.add_output("codeap", DT_FLOAT, ["batch", "audio_frames", c])
    return gb.save(path)


# --- v1 family (reference export_onnx_v1.py:11-182) -----------------------
#
# These graphs stay in [B, C, T] layout throughout the conv trunk (one
# transpose at each end); eval-mode BatchNorm folds into per-channel
# Mul/Add constants; ReLU6 is Clip(0, 6); depthwise convolutions carry
# the ONNX `group` attribute.


def _bn_fold(gb: GraphBuilder, x: str, bn_params, bn_stats,
             eps: float = 1e-5) -> str:
    scale = _f32(bn_params["scale"])
    bias = _f32(bn_params["bias"])
    mean = _f32(bn_stats["mean"])
    var = _f32(bn_stats["var"])
    a = scale / np.sqrt(var + eps)
    b = bias - mean * a
    y = gb.node("Mul", [x, gb.constant("bn_a", a[:, None])])
    return gb.node("Add", [y, gb.constant("bn_b", b[:, None])])


def _relu6(gb: GraphBuilder, x: str) -> str:
    return gb.node("Clip", [
        x,
        gb.constant("clip_lo", np.float32(0.0)),
        gb.constant("clip_hi", np.float32(6.0)),
    ])


def _conv_nct(gb: GraphBuilder, x: str, conv_params, stride: int = 1,
              groups: int = 1, hint: str = "conv") -> str:
    kernel = _f32(conv_params["kernel"])  # [k, in/g, out]
    k = kernel.shape[0]
    w = np.transpose(kernel, (2, 1, 0)).copy()  # [out, in/g, k]
    inputs = [x, gb.constant(f"{hint}_w", w)]
    if "bias" in conv_params:
        inputs.append(gb.constant(f"{hint}_b", _f32(conv_params["bias"])))
    return gb.node(
        "Conv", inputs, kernel_shape=[k], strides=[stride],
        pads=[(k - 1) // 2, (k - 1) // 2], group=groups,
    )


def _conv_bn_act(gb: GraphBuilder, x: str, params, stats,
                 stride: int = 1, groups: int = 1) -> str:
    y = _conv_nct(gb, x, params["Conv_0"], stride=stride, groups=groups)
    y = _bn_fold(gb, y, params["BatchNorm_0"], stats["BatchNorm_0"])
    return _relu6(gb, y)


def _inverted_residual(gb: GraphBuilder, x: str, params, stats,
                       stride: int = 1, residual: bool = True) -> str:
    """flax models/asr_v1.InvertedResidual in NCT layout."""
    dw_kernel = _f32(params["ConvBNActivate_1"]["Conv_0"]["kernel"])
    hidden = dw_kernel.shape[2]
    y = _conv_bn_act(gb, x, params["ConvBNActivate_0"],
                     stats["ConvBNActivate_0"])
    y = _conv_bn_act(gb, y, params["ConvBNActivate_1"],
                     stats["ConvBNActivate_1"], stride=stride,
                     groups=hidden)
    y = _conv_nct(gb, y, params["Conv_0"], hint="pw")
    y = _bn_fold(gb, y, params["BatchNorm_0"], stats["BatchNorm_0"])
    if residual:
        y = gb.node("Add", [x, y])
    return y


def _ir_stack_onnx(gb, x, params, stats, specs):
    """specs: [(name, stride, residual)] over InvertedResidual_{i}."""
    for name, stride, residual in specs:
        x = _inverted_residual(gb, x, params[name], stats[name],
                               stride=stride, residual=residual)
    return x


def export_asr_v1_onnx(model, variables, path: str) -> str:
    """AudioToTextCTC logits graph (reference export_onnx_v1.py asr)."""
    params = variables["params"]["ConvVoiceEncoder_0"]
    stats = variables["batch_stats"]["ConvVoiceEncoder_0"]
    gb = GraphBuilder(
        "voice100_asr_v1",
        "voice100_tpu AudioToTextCTC (audio) -> logits",
    )
    audio = gb.add_input("audio", DT_FLOAT,
                         ["batch", "audio_len", model.audio_size])
    x = gb.node("Transpose", [audio], perm=[0, 2, 1])
    specs = [(f"InvertedResidual_{i}", 2 if i == 0 else 1,
              i in (1, 2, 3, 5, 6, 7))
             for i in range(9)]
    x = _ir_stack_onnx(gb, x, params, stats, specs)
    x = _conv_nct(gb, x, variables["params"]["Conv_0"], hint="dec")
    logits = gb.node("Transpose", [x], outputs=["logits"], perm=[0, 2, 1])
    gb.add_output("logits", DT_FLOAT,
                  ["batch", "logits_len", model.vocab_size])
    return gb.save(path)


def export_align_v1_onnx(model, variables, path: str) -> str:
    """AudioAlignCTC (audio, audio_len) -> (logits, logits_len)."""
    params = variables["params"]
    gb = GraphBuilder(
        "voice100_align_v1",
        "voice100_tpu AudioAlignCTC (audio, audio_len) -> "
        "(logits, logits_len)",
    )
    audio = gb.add_input("audio", DT_FLOAT,
                         ["batch", "audio_len", model.audio_size])
    audio_len = gb.add_input("audio_len", DT_INT32, ["batch"])
    x = gb.node("Transpose", [audio], perm=[0, 2, 1])
    x = _conv_nct(gb, x, params["Conv_0"], stride=2)
    x = gb.node("Relu", [x])
    x = gb.node("Transpose", [x], perm=[0, 2, 1])
    one = gb.constant("one", np.int32(1))
    two = gb.constant("two", np.int32(2))
    x_len = gb.node("Div", [gb.node("Add", [audio_len, one]), two])
    x = _bilstm(gb, x, x_len, params["BiLSTM_0"],
                model.num_layers, model.hidden_size)
    logits = _dense(gb, x, params["Dense_0"])
    gb.node("Identity", [logits], outputs=["logits"])
    gb.node("Identity", [x_len], outputs=["logits_len"])
    gb.add_output("logits", DT_FLOAT,
                  ["batch", "logits_len", model.vocab_size])
    gb.add_output("logits_len", DT_INT32, ["batch"])
    return gb.save(path)


def export_ttsalign_v1_onnx(model, variables, path: str) -> str:
    """TextToAlignTextModel (text) -> log-duration pairs."""
    params = variables["params"]
    stats = variables["batch_stats"]
    gb = GraphBuilder(
        "voice100_ttsalign_v1",
        "voice100_tpu TextToAlignTextModel (text) -> align",
    )
    text = gb.add_input("text", DT_INT32, ["batch", "text_len"])
    emb = gb.constant("embedding", _f32(params["Embed_0"]["embedding"]))
    x = gb.node("Gather", [emb, text], axis=0)
    x = gb.node("Transpose", [x], perm=[0, 2, 1])
    specs = [(f"InvertedResidual_{i}", 1, True) for i in range(4)]
    x = _ir_stack_onnx(gb, x, params, stats, specs)
    x = _conv_nct(gb, x, params["Conv_0"], hint="head")
    gb.node("Transpose", [x], outputs=["align"], perm=[0, 2, 1])
    gb.add_output("align", DT_FLOAT, ["batch", "text_len", 2])
    return gb.save(path)


def _voice_decoder_onnx(gb, x, params, stats, specs1, specs2,
                        final_conv: str):
    x = _ir_stack_onnx(gb, x, params, stats, specs1)
    # x2 upsample: our kernel [k, in, out] is the time-flipped torch
    # ConvTranspose1d weight
    kernel = _f32(params["up_kernel"])
    w = np.transpose(kernel[::-1], (1, 2, 0)).copy()  # [in, out, k]
    x = gb.node(
        "ConvTranspose",
        [x, gb.constant("up_w", w), gb.constant("up_b", _f32(params["up_bias"]))],
        kernel_shape=[kernel.shape[0]], strides=[2], pads=[2, 2],
    )
    x = _ir_stack_onnx(gb, x, params, stats, specs2)
    return _conv_nct(gb, x, params[final_conv], hint="proj")


def _tts_v1_outputs(gb, model, variables, x_nct):
    """Split [B, C, T] projection into unnormalized gated streams."""
    x = gb.node("Transpose", [x_nct], perm=[0, 2, 1])  # [B, T, C]
    norm = variables["world_norm"]["norm"]
    s, c = model.logspc_size, model.codeap_size
    hasf0 = _squeeze_last(gb, _slice_last(gb, x, 0, 1))
    f0 = _squeeze_last(gb, _slice_last(gb, x, 1, 2))
    logspc = _slice_last(gb, x, 2, 2 + s)
    codeap = _slice_last(gb, x, 2 + s, 2 + s + c)

    def unnorm(y, mean, std, hint):
        y = gb.node("Mul", [y, gb.constant(f"{hint}_std", _f32(std))])
        return gb.node("Add", [y, gb.constant(f"{hint}_mean", _f32(mean))])

    f0 = unnorm(f0, norm["f0_mean"], norm["f0_std"], "f0")
    logspc = unnorm(logspc, norm["logspc_mean"], norm["logspc_std"],
                    "logspc")
    codeap = unnorm(codeap, norm["codeap_mean"], norm["codeap_std"],
                    "codeap")
    zero = gb.constant("zero", np.float32(0.0))
    voiced = gb.node("Less", [hasf0, zero])
    f0 = gb.node("Where", [voiced, zero, f0])
    logspc_size = s
    if model.use_mcep:
        from ..dsp.mcep import create_mc2sp_matrix

        mc2sp = create_mc2sp_matrix(
            model.n_fft, 24, 0.410
        ).astype(np.float32)
        logspc = gb.node("MatMul", [logspc, gb.constant("mc2sp", mc2sp)])
        logspc_size = mc2sp.shape[1]
    gb.node("Identity", [f0], outputs=["f0"])
    gb.node("Identity", [logspc], outputs=["logspc"])
    gb.node("Identity", [codeap], outputs=["codeap"])
    gb.add_output("f0", DT_FLOAT, ["batch", "audio_frames"])
    gb.add_output("logspc", DT_FLOAT,
                  ["batch", "audio_frames", logspc_size])
    gb.add_output("codeap", DT_FLOAT, ["batch", "audio_frames", c])


def export_ttsaudio_v1_onnx(model, variables, path: str) -> str:
    """AlignTextToAudioModel predict graph."""
    params = variables["params"]
    gb = GraphBuilder(
        "voice100_ttsaudio_v1",
        "voice100_tpu AlignTextToAudioModel (aligntext) -> "
        "(f0, logspc, codeap)",
    )
    aligntext = gb.add_input("aligntext", DT_INT32,
                             ["batch", "aligntext_len"])
    emb = gb.constant("embedding", _f32(params["embedding"]["embedding"]))
    x = gb.node("Gather", [emb, aligntext], axis=0)
    x = gb.node("Transpose", [x], perm=[0, 2, 1])
    specs1 = [(f"InvertedResidual_{i}", 1, True) for i in range(4)]
    specs2 = [(f"InvertedResidual_{i}", 1, True) for i in (4, 5, 6)]
    x = _voice_decoder_onnx(
        gb, x, params["decoder"], variables["batch_stats"]["decoder"],
        specs1, specs2, "Conv_0",
    )
    _tts_v1_outputs(gb, model, variables, x)
    return gb.save(path)


def export_ttsaudio_mt_v1_onnx(model, variables, path: str) -> str:
    """AlignTextToAudioMultiTaskModel predict graph (+ phone logits)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    gb = GraphBuilder(
        "voice100_ttsaudio_mt_v1",
        "voice100_tpu AlignTextToAudioMultiTaskModel (aligntext) -> "
        "(f0, logspc, codeap, phone_logits)",
    )
    aligntext = gb.add_input("aligntext", DT_INT32,
                             ["batch", "aligntext_len"])
    emb = gb.constant("embedding", _f32(params["embedding"]["embedding"]))
    x = gb.node("Gather", [emb, aligntext], axis=0)
    x = gb.node("Transpose", [x], perm=[0, 2, 1])
    trunk_specs = [(f"InvertedResidual_{i}", 1, True) for i in range(6)]
    trunk = _ir_stack_onnx(gb, x, params["decoder"],
                           stats["decoder"], trunk_specs)
    phone = _conv_nct(gb, trunk, params["decoder"]["Conv_0"],
                      hint="phone")
    gb.node("Transpose", [phone], outputs=["phone_logits"],
            perm=[0, 2, 1])
    kernel = _f32(params["decoder"]["up_kernel"])
    w = np.transpose(kernel[::-1], (1, 2, 0)).copy()
    y = gb.node(
        "ConvTranspose",
        [trunk, gb.constant("up_w", w),
         gb.constant("up_b", _f32(params["decoder"]["up_bias"]))],
        kernel_shape=[kernel.shape[0]], strides=[2], pads=[2, 2],
    )
    tail_specs = [(f"InvertedResidual_{i}", 1, True) for i in (6, 7)]
    y = _ir_stack_onnx(gb, y, params["decoder"], stats["decoder"],
                       tail_specs)
    y = _conv_nct(gb, y, params["decoder"]["Conv_1"], hint="proj")
    _tts_v1_outputs(gb, model, variables, y)
    gb.add_output("phone_logits", DT_FLOAT,
                  ["batch", "aligntext_len", model.target_vocab_size])
    return gb.save(path)


def export_onnx(model, path: str) -> str:
    """Write the ``.onnx`` of a port model's predict surface (v2 ASR, align
    or TTS; the five v1 models) to ``path``; returns the path. The weights
    go through :func:`voice100_tpu_torch.tools.weights.to_jax_variables`
    into the layout the graph bodies read (with ``batch_stats`` and
    ``world_norm`` for the v1 models that have them)."""
    from ..models import (AlignTextToAudio, AlignTextToAudioModel,
                          AlignTextToAudioMultiTaskModel, AudioAlignCTC, AudioToAlignText,
                          AudioToTextCTC, TextToAlignText, TextToAlignTextModel)
    from ..tools.weights import to_jax_variables

    state = model.state_dict()
    if isinstance(model, AudioToAlignText):
        spec = SimpleNamespace(audio_size=model.audio_size, vocab_size=model.vocab_size,
                               encoder_settings=model.encoder_settings,
                               decoder_num_layers=model.lstm.num_layers,
                               decoder_hidden_size=model.lstm.hidden_size)
        return export_asr_onnx(spec, to_jax_variables(state, model.encoder_settings), path)
    if isinstance(model, TextToAlignText):
        spec = SimpleNamespace(num_layers=model.num_layers, hidden_size=model.hidden_size,
                               num_outputs=model.dense.out_features)
        return export_align_onnx(spec, to_jax_variables(state), path)
    if isinstance(model, AlignTextToAudio):
        spec = SimpleNamespace(encoder_num_layers=model.lstm.num_layers,
                               encoder_hidden_size=model.lstm.hidden_size,
                               decoder_settings=model.decoder_settings, f0_size=model.f0_size,
                               logspc_size=model.logspc_size, codeap_size=model.codeap_size)
        return export_tts_onnx(spec, to_jax_variables(state, model.decoder_settings), path)
    v1 = {AudioToTextCTC: export_asr_v1_onnx, AudioAlignCTC: export_align_v1_onnx,
          TextToAlignTextModel: export_ttsalign_v1_onnx,
          # the multi-task model subclasses the acoustic one: its own graph first
          AlignTextToAudioMultiTaskModel: export_ttsaudio_mt_v1_onnx,
          AlignTextToAudioModel: export_ttsaudio_v1_onnx}
    for cls, emit in v1.items():
        if isinstance(model, cls):
            # the v1 graphs read the sizes the port model holds under the same names
            return emit(model, to_jax_variables(state, model=model), path)
    raise ValueError(f"No ONNX exporter for {type(model).__name__}")
