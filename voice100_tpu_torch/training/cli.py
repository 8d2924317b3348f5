"""YAML configs: load one and build the model and data module it names.

Port of ``load_config`` and ``build_from_config`` of
``voice100_tpu/training/cli.py:26-150`` for the pair the port has,
``AudioToAlignText`` with ``AudioTextDataModule``. Configs keep their
``class_path`` strings (``voice100_tpu.*``, or the reference's
``voice100.*``); the last component names the port's class. Keys a
constructor does not take are dropped with a note, lists become tuples,
``data_dir``, ``cache_dir`` and ``batch_size`` can be overridden, and a
model whose ``vocab_size`` or ``audio_size`` disagrees with the data's
stops the run. The ``fit`` and ``predict`` subcommands wait
(``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict

import yaml

from ..data.datamodule import AudioTextDataModule
from ..models import AudioToAlignText

__all__ = ["load_config", "build_from_config"]

_MODEL_CLASSES = {"AudioToAlignText": AudioToAlignText}
_DATA_CLASSES = {"AudioTextDataModule": AudioTextDataModule}


def _resolve_class(class_path: str, table: Dict[str, Any]):
    name = class_path.rsplit(".", 1)[-1]
    if name not in table:
        raise ValueError(f"class_path {class_path!r} is not ported; the port builds "
                         f"{sorted(table)}")
    return table[name]


def _filter_kwargs(cls, kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Drop keys the constructor does not take; lists become tuples."""
    accepted = set(inspect.signature(cls.__init__).parameters)
    out, dropped = {}, []
    for k, v in kwargs.items():
        if k not in accepted:
            dropped.append(k)
            continue
        if isinstance(v, list):
            v = tuple(tuple(e) if isinstance(e, list) else e for e in v)
        out[k] = v
    if dropped:
        print(f"[cli] note: ignoring config keys {dropped} for {cls.__name__}")
    return out


def load_config(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return yaml.safe_load(f)


def build_from_config(config: Dict[str, Any], overrides: Dict[str, Any], device=None):
    """``(model, datamodule)`` on ``device`` (default ``cuda``) from a
    config; the model's weights are freshly drawn."""
    model_cls = _resolve_class(config["model"]["class_path"], _MODEL_CLASSES)
    data_cls = _resolve_class(config["data"]["class_path"], _DATA_CLASSES)
    model_kwargs = _filter_kwargs(model_cls, dict(config["model"].get("init_args") or {}))
    model = model_cls(**model_kwargs, device=device)
    data_kwargs = dict(config["data"].get("init_args") or {})
    data_kwargs.update({k: v for k, v in overrides.items()
                        if k in ("data_dir", "cache_dir", "batch_size")})
    data = data_cls(**_filter_kwargs(data_cls, data_kwargs), device=device)
    # out-of-range labels would make the CTC lattice read past the logits
    for attr in ("vocab_size", "audio_size"):
        if getattr(model, attr) != getattr(data, attr):
            raise SystemExit(
                f"[cli] model.{attr}={getattr(model, attr)} does not match "
                f"data.{attr}={getattr(data, attr)} (language/use_phone/vocoder determine the "
                f"data side); fix the config's model.init_args.{attr}")
    return model, data
