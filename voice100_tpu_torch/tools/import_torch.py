"""Import reference (PyTorch Lightning) checkpoints into port checkpoints.

Port of ``voice100_tpu/tools/import_torch.py``. The reference
distributes pretrained ``.ckpt`` files (torch pickles with a
``state_dict``). The port keeps the reference's state-dict names
(:mod:`voice100_tpu_torch.tools.weights`), so an import is the
reference's tensors under the model's own keys, for all eight
architectures (the JAX package's ``convert_*_v2`` and ``convert_*_v1``
are this one mapping here):

  v2 ASR   (AudioToAlignText): ``encoder.*``, ``lstm.*``, ``dense.*``
  v2 align (TextToAlignText):  ``embedding.*``, ``lstm.*``, ``dense.*``
  v2 TTS   (AlignTextToAudio): ``embedding.*``, ``lstm.*``, ``decoder.*``,
           ``projection.*`` and the WORLD statistics ``norm.*``
  v1 ASR   (AudioToTextCTC):   ``encoder.layers.{0-8}.conv.*``,
           ``decoder.layers.1.*``
  v1 align (AudioAlignCTC):    ``conv.*``, ``lstm.*``, ``dense.*``
  v1 TTS   (TextToAlignTextModel, AlignTextToAudioModel,
           AlignTextToAudioMultiTaskModel): ``embedding.*``, ``layers.*``
           or ``decoder.layers.*`` / ``decoder.layer{1,2,3}.*``, and
           ``norm.*`` for the acoustic models

with each BatchNorm's ``weight``, ``bias``, ``running_mean`` and
``running_var``. A Lightning ``model.`` prefix is dropped; keys the model
does not have are ignored (the reference BatchNorms'
``num_batches_tracked`` among them), as the JAX converters pick theirs by
name; a statistic the checkpoint lacks keeps the model's identity value
(mean 0, std 1; the JAX ``_world_norm``); any other missing tensor
raises, a shape that is not the model's raises, and the result loads
with ``load_state_dict(strict=True)``.

  python -m voice100_tpu_torch.tools.import_torch --config C \\
      --ckpt_path reference.ckpt --output port.pt [--device cpu]

builds the model on ``cuda`` unless ``--device`` asks for another (as
every entry point of the port) and writes a port checkpoint that
:func:`voice100_tpu_torch.training.checkpoint.load_model_weights` reads.
"""

from __future__ import annotations

import os
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_torch_state_dict", "convert_state_dict", "import_state_dict", "cli_main"]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a Lightning ``.ckpt`` (or a raw state dict) as numpy arrays."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    state = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def _strip_prefix(state: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Drop the ``model.`` prefix a Lightning module's wrapped model adds."""
    if state and all(k.startswith("model.") for k in state):
        return {k[len("model."):]: v for k, v in state.items()}
    return dict(state)


def convert_state_dict(state: Mapping[str, np.ndarray], model) -> Dict[str, torch.Tensor]:
    """A reference state dict -> the state dict of ``model`` (any of the
    eight architectures of :data:`voice100_tpu_torch.tools.weights.MODEL_NAMES`),
    float32 CPU tensors in the model's shapes."""
    from .weights import MODEL_NAMES

    if type(model).__name__ not in MODEL_NAMES:
        raise ValueError(f"no converter for {type(model).__name__}")
    state = _strip_prefix(state)
    out = {}
    for key, ref in model.state_dict().items():
        if key in state:
            value = torch.from_numpy(np.array(state[key], dtype=np.float32))
            if tuple(value.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, model "
                                 f"{tuple(ref.shape)}")
        elif key.startswith("norm."):
            # identity statistics, as the JAX importer's _world_norm gives them
            value = (torch.zeros if key.endswith("_mean") else torch.ones)(ref.shape)
        else:
            raise KeyError(f"reference checkpoint has no {key!r}")
        out[key] = value
    return out


def import_state_dict(state: Mapping[str, np.ndarray], model: torch.nn.Module) -> torch.nn.Module:
    """Load a reference state dict into ``model`` in place (strict); returns
    the model."""
    model.load_state_dict(convert_state_dict(state, model), strict=True)
    return model


def cli_main(argv=None) -> None:
    """Convert a reference ``.ckpt`` into a port checkpoint file."""
    from argparse import ArgumentParser

    from ..device import resolve_device
    from ..training.cli import _MODEL_CLASSES, _filter_kwargs, _resolve_class, load_config

    parser = ArgumentParser(description="Import a reference checkpoint into the port.")
    parser.add_argument("--config", required=True, help="matching config YAML (defines the model)")
    parser.add_argument("--ckpt_path", required=True, help="reference .ckpt (torch pickle)")
    parser.add_argument("--output", required=True, help="port checkpoint (.pt) to write")
    parser.add_argument("--device", default=None,
                        help="device the model is built on (default cuda, which raises "
                             "without CUDA)")
    args = parser.parse_args(argv)

    model_cfg = load_config(args.config)["model"]
    cls = _resolve_class(model_cfg["class_path"], _MODEL_CLASSES)
    kwargs = dict(model_cfg.get("init_args") or {})
    kwargs.pop("audio_stat", None)
    model = cls(**_filter_kwargs(cls, kwargs), device=resolve_device(args.device))
    import_state_dict(load_torch_state_dict(args.ckpt_path), model)
    output = os.path.abspath(args.output)
    os.makedirs(os.path.dirname(output), exist_ok=True)
    tmp = f"{output}.{os.getpid()}.tmp"
    torch.save({"model": model.state_dict(), "optimizer": {}, "step": 0, "epoch": 0,
                "best_monitor": float("inf")}, tmp)
    os.replace(tmp, output)
    print(f"[import-torch] wrote {args.output}")


if __name__ == "__main__":
    cli_main()
