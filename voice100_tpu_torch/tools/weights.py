"""Carry v2 model weights between the JAX package and the port.

The JAX models keep flax variables; the port keeps the torch reference's
state-dict names, as ``voice100_tpu/tools/import_torch.py:57-157`` maps
them:

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

__all__ = ["from_jax_variables", "to_jax_variables"]

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


def _stack_from_jax(stack: Mapping, prefix: str, transposed: Sequence[bool]):
    if set(stack) != set(_block_names(transposed)):
        raise ValueError(f"{prefix}: blocks {sorted(stack)} do not match the settings "
                         f"{list(transposed)}")
    state = {}
    for i, (name, t) in enumerate(zip(_block_names(transposed), transposed)):
        block = stack[name]
        conv = block if t else block["Conv_0"]
        kernel = np.asarray(conv["kernel"])
        weight = np.transpose(kernel[::-1], (1, 2, 0)) if t else np.transpose(kernel, (2, 1, 0))
        state[f"{prefix}.{i}.conv.weight"] = _tensor(weight)
        if "bias" in conv:
            state[f"{prefix}.{i}.conv.bias"] = _tensor(conv["bias"])
        state[f"{prefix}.{i}.layer_norm.weight"] = _tensor(block["LayerNorm_0"]["scale"])
        state[f"{prefix}.{i}.layer_norm.bias"] = _tensor(block["LayerNorm_0"]["bias"])
    return state


def _stack_to_jax(state: Mapping, prefix: str, transposed: Sequence[bool], arr):
    stack = {}
    for i, (name, t) in enumerate(zip(_block_names(transposed), transposed)):
        weight = arr(f"{prefix}.{i}.conv.weight")
        kernel = np.ascontiguousarray(np.transpose(weight, (2, 0, 1))[::-1]) if t \
            else np.transpose(weight, (2, 1, 0))
        conv = {"kernel": kernel}
        if f"{prefix}.{i}.conv.bias" in state:
            conv["bias"] = arr(f"{prefix}.{i}.conv.bias")
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


def from_jax_variables(variables: Mapping,
                       conv_settings: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
    """JAX variables of ``AudioToAlignText``, ``TextToAlignText`` or
    ``AlignTextToAudio`` -> the port's state dict (CPU float32 tensors),
    by the top-level names. Takes ``{"params": ..., ...}`` or the params
    alone, and reads ``world_norm`` where the variables have it. A conv
    stack with a transposed block needs ``conv_settings``."""
    params = variables["params"] if "params" in variables else variables

    def stack(name, prefix):
        blocks = params[name]
        return _stack_from_jax(blocks, prefix, _transposed(
            conv_settings, len(blocks), any(b.startswith("ConvTranspose") for b in blocks)))

    if "ConvStack_0" in params:  # AudioToAlignText
        return {**stack("ConvStack_0", "encoder"),
                **_lstm_from_jax(params["BiLSTM_0"]), **_dense_from_jax(params["Dense_0"], "dense")}
    if "Embed_0" in params:  # TextToAlignText
        return {"embedding.weight": _tensor(params["Embed_0"]["embedding"]),
                **_lstm_from_jax(params["BiLSTM_0"]), **_dense_from_jax(params["Dense_0"], "dense")}
    if "projection" in params:  # AlignTextToAudio
        state = {"embedding.weight": _tensor(params["embedding"]["embedding"]),
                 **_lstm_from_jax(params["lstm"]),
                 **stack("decoder", "decoder"),
                 **_dense_from_jax(params["projection"], "projection")}
        norm = (variables.get("world_norm") or {}).get("norm", {})
        state.update({f"norm.{k}": _tensor(v) for k, v in norm.items()})
        return state
    raise ValueError(f"unknown model variables {sorted(params)}")


def to_jax_variables(state: Mapping[str, torch.Tensor],
                     conv_settings: Optional[Sequence] = None) -> dict:
    """The port's state dict -> JAX variables of numpy arrays:
    ``{"params": ...}``, and for ``AlignTextToAudio`` also
    ``{"world_norm": {"norm": ...}}``. Without ``conv_settings`` a conv
    stack is taken for Conv1d blocks only, so ``AlignTextToAudio``'s
    decoder needs them."""
    def arr(key):
        return state[key].detach().cpu().numpy()

    def stack(prefix):
        n_blocks = len({k.split(".")[1] for k in state if k.startswith(prefix + ".")})
        if conv_settings is None and prefix == "decoder":
            raise ValueError("AlignTextToAudio weights need the model's decoder_settings "
                             "as conv_settings")
        return _stack_to_jax(state, prefix, _transposed(conv_settings, n_blocks, False), arr)

    def dense(name):
        return {"kernel": arr(f"{name}.weight").T, "bias": arr(f"{name}.bias")}

    if "projection.weight" in state:  # AlignTextToAudio
        params = {"embedding": {"embedding": arr("embedding.weight")},
                  "lstm": _lstm_to_jax(state, arr),
                  "decoder": stack("decoder"),
                  "projection": dense("projection")}
        norm = {k[len("norm."):]: arr(k) for k in state if k.startswith("norm.")}
        return {"params": params, "world_norm": {"norm": norm}}
    if "embedding.weight" in state:  # TextToAlignText
        return {"params": {"Embed_0": {"embedding": arr("embedding.weight")},
                           "BiLSTM_0": _lstm_to_jax(state, arr), "Dense_0": dense("dense")}}
    return {"params": {"ConvStack_0": stack("encoder"),
                       "BiLSTM_0": _lstm_to_jax(state, arr), "Dense_0": dense("dense")}}
