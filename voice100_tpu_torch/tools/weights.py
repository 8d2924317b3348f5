"""Carry AudioToAlignText weights between the JAX package and the port.

The JAX model keeps flax variables (``ConvStack_0/ConvLayerBlock_{i}/
{Conv_0,LayerNorm_0}``, ``BiLSTM_0/l{k}_{fwd,bwd}_{w_ih,w_hh,b_ih,b_hh}``,
``Dense_0``); the port keeps the torch reference's state-dict names
(``encoder.{i}.conv.weight``, ``encoder.{i}.layer_norm.{weight,bias}``,
``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]``, ``dense.{weight,bias}``),
as ``voice100_tpu/tools/import_torch.py:57-126`` maps them. Conversion is
renaming plus transposes: conv kernel ``[k, in, out]`` <-> weight
``[out, in, k]``, dense kernel ``[in, out]`` <-> weight ``[out, in]``;
LSTM and LayerNorm tensors carry over as they are.

Both directions work on plain arrays (numpy, or anything ``np.asarray``
takes), so neither side needs the other's framework.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["from_jax_variables", "to_jax_variables"]

_LSTM_NAMES = (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
               ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
_DIRECTIONS = (("fwd", ""), ("bwd", "_reverse"))


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def from_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``AudioToAlignText`` variables -> the port's state dict (CPU
    float32 tensors). Takes ``{"params": ...}`` or the params alone."""
    params = variables["params"] if "params" in variables else variables
    state: Dict[str, torch.Tensor] = {}
    for name, block in params["ConvStack_0"].items():
        match = re.fullmatch(r"ConvLayerBlock_(\d+)", name)
        if match is None:
            raise NotImplementedError(f"{name}: only Conv1d blocks are ported")
        prefix = f"encoder.{match.group(1)}"
        conv = block["Conv_0"]
        state[f"{prefix}.conv.weight"] = _tensor(np.transpose(np.asarray(conv["kernel"]), (2, 1, 0)))
        if "bias" in conv:
            state[f"{prefix}.conv.bias"] = _tensor(conv["bias"])
        state[f"{prefix}.layer_norm.weight"] = _tensor(block["LayerNorm_0"]["scale"])
        state[f"{prefix}.layer_norm.bias"] = _tensor(block["LayerNorm_0"]["bias"])
    for name, value in params["BiLSTM_0"].items():
        layer, direction, ours = re.fullmatch(r"l(\d+)_(fwd|bwd)_(\w+)", name).groups()
        theirs = dict(_LSTM_NAMES)[ours]
        suffix = dict(_DIRECTIONS)[direction]
        state[f"lstm.{theirs}_l{layer}{suffix}"] = _tensor(value)
    state["dense.weight"] = _tensor(np.asarray(params["Dense_0"]["kernel"]).T)
    state["dense.bias"] = _tensor(params["Dense_0"]["bias"])
    return state


def to_jax_variables(state: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict -> JAX ``{"params": ...}`` of numpy arrays."""
    def arr(key):
        return state[key].detach().cpu().numpy()

    conv_stack, lstm = {}, {}
    blocks = sorted({int(k.split(".")[1]) for k in state if k.startswith("encoder.")})
    for i in blocks:
        prefix = f"encoder.{i}"
        conv = {"kernel": np.transpose(arr(f"{prefix}.conv.weight"), (2, 1, 0))}
        if f"{prefix}.conv.bias" in state:
            conv["bias"] = arr(f"{prefix}.conv.bias")
        conv_stack[f"ConvLayerBlock_{i}"] = {
            "Conv_0": conv,
            "LayerNorm_0": {"scale": arr(f"{prefix}.layer_norm.weight"),
                            "bias": arr(f"{prefix}.layer_norm.bias")},
        }
    layers = sorted({int(m.group(1)) for k in state
                     if (m := re.fullmatch(r"lstm\.\w+_l(\d+)(_reverse)?", k))})
    for layer in layers:
        for direction, suffix in _DIRECTIONS:
            for ours, theirs in _LSTM_NAMES:
                lstm[f"l{layer}_{direction}_{ours}"] = arr(f"lstm.{theirs}_l{layer}{suffix}")
    dense = {"kernel": arr("dense.weight").T, "bias": arr("dense.bias")}
    return {"params": {"ConvStack_0": conv_stack, "BiLSTM_0": lstm, "Dense_0": dense}}
