"""Carry model weights between the JAX package and the port.

The JAX models keep flax variables; the port keeps the torch reference's
state-dict names, as ``voice100_tpu/tools/import_torch.py:57-335`` maps
them. The v2 models:

* ``AudioToAlignText``: ``ConvStack_0/ConvLayerBlock_{i}/{Conv_0,
  LayerNorm_0}``, ``BiLSTM_0/l{k}_{fwd,bwd}_{w_ih,w_hh,b_ih,b_hh}``,
  ``Dense_0`` <-> ``encoder.{i}.conv.weight``,
  ``encoder.{i}.layer_norm.{weight,bias}``,
  ``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]``, ``dense.{weight,bias}``;
* ``TextToAlignText``: ``Embed_0``, ``BiLSTM_0``, ``Dense_0`` <->
  ``embedding.weight``, ``lstm.*``, ``dense.*``;
* ``AlignTextToAudio``: ``embedding``, ``lstm``, ``decoder``,
  ``projection`` and the second collection ``world_norm/norm/*`` <->
  ``embedding.weight``, ``lstm.*``, ``decoder.{i}.*``, ``projection.*``,
  ``norm.*``.

The v1 models (``params`` and ``batch_stats``, whose ``mean`` and ``var``
are the BatchNorms' ``running_mean`` and ``running_var``):

* ``AudioToTextCTC``: ``ConvVoiceEncoder_0/InvertedResidual_{i}``,
  ``Conv_0`` <-> ``encoder.layers.{i}``, ``decoder.layers.1``;
* ``AudioAlignCTC``: ``Conv_0``, ``BiLSTM_0``, ``Dense_0`` <-> ``conv``,
  ``lstm``, ``dense``;
* ``TextToAlignTextModel``: ``Embed_0``, ``InvertedResidual_{0-3}``,
  ``Conv_0`` <-> ``embedding``, ``layers.{0-3}``, ``layers.4``;
* ``AlignTextToAudioModel``: ``embedding``, ``decoder/InvertedResidual_
  {0-6}``, ``decoder/up_{kernel,bias}``, ``decoder/Conv_0`` and
  ``world_norm`` <-> ``embedding``, ``decoder.layers.{0-3,5-7}``,
  ``decoder.layers.4``, ``decoder.layers.8``, ``norm.*``;
* ``AlignTextToAudioMultiTaskModel``: ``decoder/InvertedResidual_{0-7}``,
  ``decoder/Conv_0`` (the phone head), ``decoder/up_*``,
  ``decoder/Conv_1`` <-> ``decoder.layer1.{0-5}``, ``decoder.layer2.
  {1,2}``, ``decoder.layer3``, ``decoder.layer2.0``, ``decoder.layer2.3``.

An inverted residual block's ``ConvBNActivate_{0,1}/{Conv_0,BatchNorm_0}``,
``Conv_0`` and ``BatchNorm_0`` are ``conv.{0,1}.{0,1}``, ``conv.2`` and
``conv.3``.

Both directions dispatch on ``model``: a module of the port, its class or
its class name (a ``class_path`` works too). Without it the model is
told by names that only its variables have; ``TextToAlignText`` and
``TextToAlignTextModel`` both have ``Embed_0`` at the top, so the
top-level name alone does not tell them apart.

Flax names a conv stack's blocks by per-class counters
(``ConvLayerBlock_0``, ``ConvTransposeLayerBlock_0``, ``ConvLayerBlock_1``
are ``decoder.0``, ``decoder.1``, ``decoder.2`` for the reference's
decoder), so a stack with a transposed block needs the model's settings
(``conv_settings``: ``encoder_settings`` or ``decoder_settings``) to put
its blocks in order.

Conversion is renaming plus transposes: conv kernel ``[k, in, out]`` <->
weight ``[out, in, k]``; transposed conv kernel ``[k, in, out]`` <->
weight ``[in, out, k]`` flipped in time (the JAX block is a dilated
cross-correlation, torch's applies the kernel flipped); dense kernel
``[in, out]`` <-> weight ``[out, in]``; LSTM, embedding, LayerNorm and
statistics tensors carry over as they are. Both directions work on plain
arrays (numpy, or anything ``np.asarray`` takes), so neither side needs
the other's framework.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

__all__ = ["from_jax_variables", "to_jax_variables", "MODEL_NAMES"]

MODEL_NAMES = ("AudioToAlignText", "TextToAlignText", "AlignTextToAudio", "AudioToTextCTC",
               "AudioAlignCTC", "TextToAlignTextModel", "AlignTextToAudioModel",
               "AlignTextToAudioMultiTaskModel")

_LSTM_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
               ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _block_names(transposed: Sequence[bool]):
    """Flax's per-class counter names of a conv stack's blocks."""
    counts = {False: 0, True: 0}
    names = []
    for t in transposed:
        names.append(f"{'ConvTransposeLayerBlock' if t else 'ConvLayerBlock'}_{counts[t]}")
        counts[t] += 1
    return names


def _conv_from_jax(conv: Mapping, prefix: str, transpose: bool = False):
    kernel = np.asarray(conv["kernel"])
    weight = np.transpose(kernel[::-1], (1, 2, 0)) if transpose else np.transpose(kernel,
                                                                                  (2, 1, 0))
    state = {f"{prefix}.weight": _tensor(weight)}
    if "bias" in conv:
        state[f"{prefix}.bias"] = _tensor(conv["bias"])
    return state


def _conv_to_jax(state: Mapping, prefix: str, arr, transpose: bool = False) -> dict:
    weight = arr(f"{prefix}.weight")
    kernel = (np.ascontiguousarray(np.transpose(weight, (2, 0, 1))[::-1]) if transpose
              else np.transpose(weight, (2, 1, 0)))
    conv = {"kernel": kernel}
    if f"{prefix}.bias" in state:
        conv["bias"] = arr(f"{prefix}.bias")
    return conv


def _stack_from_jax(stack: Mapping, prefix: str, transposed: Sequence[bool]):
    if set(stack) != set(_block_names(transposed)):
        raise ValueError(f"{prefix}: blocks {sorted(stack)} do not match the settings "
                         f"{list(transposed)}")
    state = {}
    for i, (name, t) in enumerate(zip(_block_names(transposed), transposed)):
        block = stack[name]
        state.update(_conv_from_jax(block if t else block["Conv_0"], f"{prefix}.{i}.conv", t))
        state[f"{prefix}.{i}.layer_norm.weight"] = _tensor(block["LayerNorm_0"]["scale"])
        state[f"{prefix}.{i}.layer_norm.bias"] = _tensor(block["LayerNorm_0"]["bias"])
    return state


def _stack_to_jax(state: Mapping, prefix: str, transposed: Sequence[bool], arr):
    stack = {}
    for i, (name, t) in enumerate(zip(_block_names(transposed), transposed)):
        conv = _conv_to_jax(state, f"{prefix}.{i}.conv", arr, t)
        norm = {"scale": arr(f"{prefix}.{i}.layer_norm.weight"),
                "bias": arr(f"{prefix}.{i}.layer_norm.bias")}
        stack[name] = {**conv, "LayerNorm_0": norm} if t else {"Conv_0": conv,
                                                               "LayerNorm_0": norm}
    return stack


def _lstm_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    state = {}
    for name, value in params.items():
        layer, direction, ours = re.fullmatch(r"l(\d+)_(fwd|bwd)_(\w+)", name).groups()
        theirs = dict(_LSTM_NAMES)[ours]
        suffix = dict(_DIRECTIONS)[direction]
        state[f"lstm.{theirs}_l{layer}{suffix}"] = _tensor(value)
    return state


def _lstm_to_jax(state: Mapping, arr) -> dict:
    lstm = {}
    layers = sorted({int(m.group(1)) for k in state
                     if (m := re.fullmatch(r"lstm\.\w+_l(\d+)(_reverse)?", k))})
    for layer in layers:
        for direction, suffix in _DIRECTIONS:
            for ours, theirs in _LSTM_NAMES:
                lstm[f"l{layer}_{direction}_{ours}"] = arr(f"lstm.{theirs}_l{layer}{suffix}")
    return lstm


def _dense_from_jax(params: Mapping, name: str) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": _tensor(np.asarray(params["kernel"]).T),
            f"{name}.bias": _tensor(params["bias"])}


def _transposed(settings, n_blocks: int, has_transposed: bool) -> list:
    """Which blocks of a stack are transposed: from the settings, or, where
    none is, every block a Conv1d one."""
    if settings is not None:
        return [bool(s[1]) for s in settings]
    if has_transposed:
        raise ValueError("a conv stack with a transposed block needs the model's conv_settings "
                         "to order its blocks")
    return [False] * n_blocks


def _model_name(model) -> Optional[str]:
    """The class name of ``model`` (a module, a class, a name or a
    ``class_path``), checked; None for None."""
    if model is None:
        return None
    if isinstance(model, str):
        name = model.rsplit(".", 1)[-1]
    else:
        name = model.__name__ if isinstance(model, type) else type(model).__name__
    if name not in MODEL_NAMES:
        raise ValueError(f"no weights mapping for {name}; the port maps {list(MODEL_NAMES)}")
    return name


def _name_of_params(params: Mapping) -> str:
    """The model whose flax params these are, from names only it has."""
    decoder = params.get("decoder", {})
    for name, test in (
            ("AudioToAlignText", "ConvStack_0" in params),
            ("AudioToTextCTC", "ConvVoiceEncoder_0" in params),
            ("AudioAlignCTC", "Conv_0" in params and "BiLSTM_0" in params),
            ("TextToAlignText", "Embed_0" in params and "BiLSTM_0" in params),
            ("TextToAlignTextModel", "Embed_0" in params and "InvertedResidual_0" in params),
            ("AlignTextToAudio", "projection" in params),
            ("AlignTextToAudioMultiTaskModel", "Conv_1" in decoder),
            ("AlignTextToAudioModel", "up_kernel" in decoder)):
        if test:
            return name
    raise ValueError(f"unknown model variables {sorted(params)}")


def _name_of_state(state: Mapping) -> str:
    """The model whose state dict this is, from names only it has."""
    for name, key in (("AlignTextToAudio", "projection.weight"),
                      ("AlignTextToAudioMultiTaskModel", "decoder.layer3.weight"),
                      ("AlignTextToAudioModel", "decoder.layers.4.weight"),
                      ("TextToAlignTextModel", "layers.4.weight"),
                      ("TextToAlignText", "embedding.weight"),
                      ("AudioToTextCTC", "decoder.layers.1.weight"),
                      ("AudioAlignCTC", "conv.weight")):
        if key in state:
            return name
    return "AudioToAlignText"


def _v1_layout(name: str):
    """``(kind, flax path, torch prefix)`` of each part of a v1 model:
    ``ir`` an inverted residual block, ``conv`` a 1-D conv, ``up`` the
    transposed conv (``up_kernel``/``up_bias`` of the path), ``embed``,
    ``lstm``, ``dense``."""
    if name == "AudioToTextCTC":
        return ([("ir", ("ConvVoiceEncoder_0", f"InvertedResidual_{i}"), f"encoder.layers.{i}")
                 for i in range(9)] + [("conv", ("Conv_0",), "decoder.layers.1")])
    if name == "AudioAlignCTC":
        return [("conv", ("Conv_0",), "conv"), ("lstm", ("BiLSTM_0",), "lstm"),
                ("dense", ("Dense_0",), "dense")]
    if name == "TextToAlignTextModel":
        return ([("embed", ("Embed_0",), "embedding")]
                + [("ir", (f"InvertedResidual_{i}",), f"layers.{i}") for i in range(4)]
                + [("conv", ("Conv_0",), "layers.4")])
    if name == "AlignTextToAudioModel":
        return ([("embed", ("embedding",), "embedding")]
                + [("ir", ("decoder", f"InvertedResidual_{i}"), f"decoder.layers.{i + (i > 3)}")
                   for i in range(7)]
                + [("up", ("decoder",), "decoder.layers.4"),
                   ("conv", ("decoder", "Conv_0"), "decoder.layers.8")])
    return ([("embed", ("embedding",), "embedding")]
            + [("ir", ("decoder", f"InvertedResidual_{i}"), f"decoder.layer1.{i}")
               for i in range(6)]
            + [("ir", ("decoder", f"InvertedResidual_{i + 6}"), f"decoder.layer2.{i + 1}")
               for i in range(2)]
            + [("conv", ("decoder", "Conv_0"), "decoder.layer3"),
               ("up", ("decoder",), "decoder.layer2.0"),
               ("conv", ("decoder", "Conv_1"), "decoder.layer2.3")])


def _at(tree: Mapping, path) -> Mapping:
    for key in path:
        tree = tree[key]
    return tree


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _bn_from_jax(params: Mapping, stats: Mapping, prefix: str):
    return {f"{prefix}.weight": _tensor(params["scale"]), f"{prefix}.bias": _tensor(params["bias"]),
            f"{prefix}.running_mean": _tensor(stats["mean"]),
            f"{prefix}.running_var": _tensor(stats["var"])}


def _bn_to_jax(prefix: str, arr):
    return ({"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")},
            {"mean": arr(f"{prefix}.running_mean"), "var": arr(f"{prefix}.running_var")})


# an inverted residual block's (flax child, torch child) pairs
_IR_PARTS = ((("ConvBNActivate_0", "Conv_0"), "conv.0.0", ("ConvBNActivate_0", "BatchNorm_0"),
              "conv.0.1"),
             (("ConvBNActivate_1", "Conv_0"), "conv.1.0", ("ConvBNActivate_1", "BatchNorm_0"),
              "conv.1.1"),
             (("Conv_0",), "conv.2", ("BatchNorm_0",), "conv.3"))


def _v1_from_jax(name: str, params: Mapping, variables: Mapping) -> Dict[str, torch.Tensor]:
    stats = variables.get("batch_stats", {})
    state = {}
    for kind, path, prefix in _v1_layout(name):
        if kind == "ir":
            p, s = _at(params, path), _at(stats, path)
            for conv, conv_prefix, bn, bn_prefix in _IR_PARTS:
                state.update(_conv_from_jax(_at(p, conv), f"{prefix}.{conv_prefix}"))
                state.update(_bn_from_jax(_at(p, bn), _at(s, bn), f"{prefix}.{bn_prefix}"))
        elif kind == "conv":
            state.update(_conv_from_jax(_at(params, path), prefix))
        elif kind == "up":
            node = _at(params, path)
            state.update(_conv_from_jax({"kernel": node["up_kernel"], "bias": node["up_bias"]},
                                        prefix, transpose=True))
        elif kind == "embed":
            state[f"{prefix}.weight"] = _tensor(_at(params, path)["embedding"])
        elif kind == "lstm":
            state.update(_lstm_from_jax(_at(params, path)))
        else:
            state.update(_dense_from_jax(_at(params, path), prefix))
    norm = (variables.get("world_norm") or {}).get("norm", {})
    state.update({f"norm.{k}": _tensor(v) for k, v in norm.items()})
    return state


def _v1_to_jax(name: str, state: Mapping, arr) -> dict:
    params, stats = {}, {}
    for kind, path, prefix in _v1_layout(name):
        if kind == "ir":
            for conv, conv_prefix, bn, bn_prefix in _IR_PARTS:
                _put(params, path + conv, _conv_to_jax(state, f"{prefix}.{conv_prefix}", arr))
                bn_params, bn_stats = _bn_to_jax(f"{prefix}.{bn_prefix}", arr)
                _put(params, path + bn, bn_params)
                _put(stats, path + bn, bn_stats)
        elif kind == "conv":
            _put(params, path, _conv_to_jax(state, prefix, arr))
        elif kind == "up":
            up = _conv_to_jax(state, prefix, arr, transpose=True)
            _put(params, path + ("up_kernel",), up["kernel"])
            _put(params, path + ("up_bias",), up["bias"])
        elif kind == "embed":
            _put(params, path, {"embedding": arr(f"{prefix}.weight")})
        elif kind == "lstm":
            _put(params, path, _lstm_to_jax(state, arr))
        else:
            _put(params, path, {"kernel": arr(f"{prefix}.weight").T, "bias": arr(f"{prefix}.bias")})
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = stats
    norm = {k[len("norm."):]: arr(k) for k in state if k.startswith("norm.")}
    if norm:
        variables["world_norm"] = {"norm": norm}
    return variables


def from_jax_variables(variables: Mapping, conv_settings: Optional[Sequence] = None,
                       model=None) -> Dict[str, torch.Tensor]:
    """JAX variables of any of :data:`MODEL_NAMES` -> the port's state dict
    (CPU float32 tensors), dispatched on ``model`` (see the module's
    docstring). Takes ``{"params": ..., ...}`` or the params alone, and
    reads ``batch_stats`` and ``world_norm`` where the variables have
    them. A v2 conv stack with a transposed block needs
    ``conv_settings``."""
    params = variables["params"] if "params" in variables else variables
    name = _model_name(model) or _name_of_params(params)

    def stack(key, prefix):
        blocks = params[key]
        return _stack_from_jax(blocks, prefix, _transposed(
            conv_settings, len(blocks), any(b.startswith("ConvTranspose") for b in blocks)))

    if name == "AudioToAlignText":
        return {**stack("ConvStack_0", "encoder"),
                **_lstm_from_jax(params["BiLSTM_0"]), **_dense_from_jax(params["Dense_0"], "dense")}
    if name == "TextToAlignText":
        return {"embedding.weight": _tensor(params["Embed_0"]["embedding"]),
                **_lstm_from_jax(params["BiLSTM_0"]), **_dense_from_jax(params["Dense_0"], "dense")}
    if name == "AlignTextToAudio":
        state = {"embedding.weight": _tensor(params["embedding"]["embedding"]),
                 **_lstm_from_jax(params["lstm"]),
                 **stack("decoder", "decoder"),
                 **_dense_from_jax(params["projection"], "projection")}
        norm = (variables.get("world_norm") or {}).get("norm", {})
        state.update({f"norm.{k}": _tensor(v) for k, v in norm.items()})
        return state
    return _v1_from_jax(name, params, variables)


def to_jax_variables(state: Mapping[str, torch.Tensor],
                     conv_settings: Optional[Sequence] = None, model=None) -> dict:
    """The port's state dict -> JAX variables of numpy arrays, dispatched
    on ``model`` (see the module's docstring): ``{"params": ...}``, with
    ``batch_stats`` for the v1 models that have BatchNorms and
    ``world_norm`` for the TTS acoustic models. Without ``conv_settings``
    a v2 conv stack is taken for Conv1d blocks only, so
    ``AlignTextToAudio``'s decoder needs them."""
    name = _model_name(model) or _name_of_state(state)

    def arr(key):
        return state[key].detach().cpu().numpy()

    def stack(prefix):
        n_blocks = len({k.split(".")[1] for k in state if k.startswith(prefix + ".")})
        if conv_settings is None and prefix == "decoder":
            raise ValueError("AlignTextToAudio weights need the model's decoder_settings "
                             "as conv_settings")
        return _stack_to_jax(state, prefix, _transposed(conv_settings, n_blocks, False), arr)

    def dense(key):
        return {"kernel": arr(f"{key}.weight").T, "bias": arr(f"{key}.bias")}

    if name == "AlignTextToAudio":
        params = {"embedding": {"embedding": arr("embedding.weight")},
                  "lstm": _lstm_to_jax(state, arr),
                  "decoder": stack("decoder"),
                  "projection": dense("projection")}
        norm = {k[len("norm."):]: arr(k) for k in state if k.startswith("norm.")}
        return {"params": params, "world_norm": {"norm": norm}}
    if name == "TextToAlignText":
        return {"params": {"Embed_0": {"embedding": arr("embedding.weight")},
                           "BiLSTM_0": _lstm_to_jax(state, arr), "Dense_0": dense("dense")}}
    if name == "AudioToAlignText":
        return {"params": {"ConvStack_0": stack("encoder"),
                           "BiLSTM_0": _lstm_to_jax(state, arr), "Dense_0": dense("dense")}}
    return _v1_to_jax(name, state, arr)
