"""YAML CLI: ``python -m voice100_tpu_torch fit --config config/asr_en_base.yaml``.

Port of ``voice100_tpu/training/cli.py`` for the v2 models the port
trains: ``AudioToAlignText`` with ``AudioTextDataModule`` (log-mel), and
the TTS pair, ``TextToAlignText`` with ``AlignTextDataModule`` and
``AlignTextToAudio`` with ``AudioTextDataModule`` (WORLD features). The
subcommands ``fit``, ``validate``, ``test`` and ``predict`` and the JAX
CLI's flags, with ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path) in place of ``--platform``. Configs keep their
``class_path`` strings (``voice100_tpu.*``, or the reference's
``voice100.*``); the last component names the port's class. Keys a
constructor does not take are dropped with a note, lists become tuples,
``data_dir``, ``cache_dir`` and ``batch_size`` can be overridden, and an
audio-input model whose ``vocab_size`` or ``audio_size`` disagrees with
the data's stops the run (TTS models use ``audio_size`` for their output
width). A TTS config's ``audio_stat``, or ``--audio_stat`` over it, names
the WORLD statistics (``tools/calc_stat.py``) that ``fit`` loads into the
model's ``norm`` buffers before the first step, where the file exists.

Checkpoints are the port's ``.pt`` files (``best.pt``, ``last.pt``,
``epoch_N.pt`` under ``--checkpoint_dir``, default
``checkpoints/<config stem>``); ``validate``, ``test`` and ``predict``
read ``--restore_from``, else ``best.pt``, else ``last.pt``. ``predict``
writes CTC transcripts (``.txt``), or per-text durations or per-clip
WORLD features (``.npz`` of object arrays). An orbax checkpoint of the
JAX package crosses over through ``tools/weights.py``. Meshes and
multi-process runs (``--mesh_model_axis`` > 1, ``--distributed``) are
not ported yet and raise. Serving builds a model from a config and a
checkpoint alone with :func:`load_model`.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import os
from typing import Any, Dict, Optional

import torch
import yaml

import numpy as np

from ..data.datamodule import AlignTextDataModule, AudioTextDataModule
from ..models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from .checkpoint import load_model_weights, merge_world_stats
from .tasks import make_task
from .trainer import BF16_ITEM, Trainer, TrainerConfig, _host

__all__ = ["load_config", "build_from_config", "build_trainer_config", "config_audio_stat",
           "load_model", "main", "cli_main", "UNPORTED"]

DATA_SHELL_ITEM = "ROADMAP.md queue 1, item 8: the rest of the data shell"
DISTRIBUTED_ITEM = "ROADMAP.md queue 1, item 10: serving, tools and distributed"

# The JAX trainer's settings that the port does not run: a config key
# -> (the values that ask for nothing the port lacks, the item that ports
# the rest)
UNPORTED = {
    "mesh_model_axis": ((1,), DISTRIBUTED_ITEM),
    "profile_dir": ((None,), DISTRIBUTED_ITEM),
    # "float32" is what the port uploads anyway
    "upload_dtype": (("auto", "float32"), BF16_ITEM),
    "device_cache": ((False,), DATA_SHELL_ITEM),
    "device_cache_max_bytes": ((8 * 1024**3,), DATA_SHELL_ITEM),
    "steps_per_dispatch": ((1,), DATA_SHELL_ITEM),
}

_MODEL_CLASSES = {"AudioToAlignText": AudioToAlignText, "TextToAlignText": TextToAlignText,
                  "AlignTextToAudio": AlignTextToAudio}
_DATA_CLASSES = {"AudioTextDataModule": AudioTextDataModule,
                 "AlignTextDataModule": AlignTextDataModule}


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
    config; the model's weights are freshly drawn. The model's
    ``audio_stat`` key is left for :func:`config_audio_stat`."""
    model_cls = _resolve_class(config["model"]["class_path"], _MODEL_CLASSES)
    data_cls = _resolve_class(config["data"]["class_path"], _DATA_CLASSES)
    model_kwargs = dict(config["model"].get("init_args") or {})
    model_kwargs.pop("audio_stat", None)
    model = model_cls(**_filter_kwargs(model_cls, model_kwargs), device=device)
    data_kwargs = dict(config["data"].get("init_args") or {})
    data_kwargs.update({k: v for k, v in overrides.items()
                        if k in ("data_dir", "cache_dir", "batch_size")})
    data_kwargs = _filter_kwargs(data_cls, data_kwargs)
    if "device" in inspect.signature(data_cls.__init__).parameters:
        data_kwargs["device"] = device
    data = data_cls(**data_kwargs)
    # out-of-range labels would make the CTC lattice read past the logits;
    # audio_size is a shared contract of the audio-input models only (the
    # TTS model's is its output width, reference models/_tts_v2.py:34)
    checks = ("vocab_size", "audio_size") if hasattr(model, "greedy_decode") else ("vocab_size",)
    for attr in checks:
        if getattr(model, attr) != getattr(data, attr):
            raise SystemExit(
                f"[cli] model.{attr}={getattr(model, attr)} does not match "
                f"data.{attr}={getattr(data, attr)} (language/use_phone/vocoder determine the "
                f"data side); fix the config's model.init_args.{attr}")
    return model, data


def config_audio_stat(config: Dict[str, Any]) -> Optional[str]:
    """The WORLD statistics file a config's model names (``audio_stat``),
    or None."""
    return (config["model"].get("init_args") or {}).get("audio_stat")


def load_model(config_path: str, ckpt_path: str, device=None) -> torch.nn.Module:
    """The model of a config's ``model`` section alone, on ``device``
    (default ``cuda``), with the weights of a port checkpoint (the
    counterpart of ``voice100_tpu/server.py:315-329``): serving needs no
    data module or trainer settings, and ``audio_stat`` is dropped (the
    statistics come with the checkpoint's ``norm`` buffers, or from
    :func:`voice100_tpu_torch.training.checkpoint.merge_world_stats`)."""
    model_cfg = load_config(config_path)["model"]
    cls = _resolve_class(model_cfg["class_path"], _MODEL_CLASSES)
    kwargs = dict(model_cfg.get("init_args") or {})
    kwargs.pop("audio_stat", None)
    model = cls(**_filter_kwargs(cls, kwargs), device=device)
    return load_model_weights(ckpt_path, model).eval()


def build_trainer_config(config: Dict[str, Any], overrides: Dict[str, Any]) -> TrainerConfig:
    """The trainer settings of a config, as the JAX ``build_from_config``
    makes them (``voice100_tpu/training/cli.py:111-150``): ``max_epochs``
    and ``gradient_clip_val``, the checkpoint callback's ``monitor`` and
    ``every_n_epochs``, ``seed_everything``, the CLI's overrides, and the
    config's other trainer keys where a ``TrainerConfig`` field has their
    name. A setting of :data:`UNPORTED` that asks for more than the port
    runs raises ``NotImplementedError`` naming its ``ROADMAP.md`` item."""
    trainer_cfg = config.get("trainer") or {}
    # the config's key wins over the flag, as the JAX pass-through has it
    unported = {"mesh_model_axis": overrides.get("mesh_model_axis", 1), **trainer_cfg}
    for key, (accepted, item) in UNPORTED.items():
        if unported.get(key, accepted[0]) not in accepted:
            raise NotImplementedError(f"trainer.{key}={unported[key]!r} is not ported yet "
                                      f"({item})")
    monitor, every_n = "val_loss", 10
    for cb in trainer_cfg.get("callbacks") or []:
        init = cb.get("init_args") or {}
        monitor = init.get("monitor", monitor)
        every_n = init.get("every_n_epochs", every_n)
    tc = TrainerConfig(
        max_epochs=int(overrides.get("max_epochs") or trainer_cfg.get("max_epochs", 1)),
        gradient_clip_val=float(trainer_cfg.get("gradient_clip_val", 1.0)),
        monitor=monitor,
        every_n_epochs=every_n,
        seed=int(config.get("seed_everything", 1234)),
        checkpoint_dir=overrides.get("checkpoint_dir"),
        log_path=overrides.get("log_path"),
        precision=str(overrides.get("precision") or trainer_cfg.get("precision", "32")),
    )
    # the remaining trainer keys pass through to matching TrainerConfig
    # fields (e.g. log_every_n_steps, save_last); keys no field has,
    # Lightning knobs like accelerator/devices in the reference's configs,
    # keep being ignored, as the JAX CLI ignores them
    handled = {"max_epochs", "gradient_clip_val", "callbacks", "precision"}
    fields = {f.name for f in dataclasses.fields(TrainerConfig)}
    for key, val in trainer_cfg.items():
        if key not in handled and key in fields:
            setattr(tc, key, val)
    return tc


def _run_predict(model, data, output: str) -> None:
    """``predict`` over the predict loader's real rows
    (``voice100_tpu/training/cli.py:153-258``): the CTC model writes greedy
    transcripts, one a line, to ``output`` (``.txt`` appended where
    missing); the duration model each text's ``durations [len, 2]``, the
    acoustic model each clip's ``f0``, ``logspc`` and ``codeap`` cut to its
    output length, as object arrays of an ``.npz`` (appended where
    missing)."""
    task = make_task(model)
    model.eval()
    if hasattr(type(model), "greedy_decode"):
        tokenizer = data.text_transform
        path = output if output.endswith(".txt") else output + ".txt"
        n = 0
        with open(path, "w", encoding="utf-8") as f, torch.no_grad():
            for batch, n_real in data.predict_dataloader().iter_with_counts():
                audio, audio_len, _, _ = task.upload(batch)
                ids, out_len = (_host(t) for t in model.greedy_decode(audio, audio_len))
                for i in range(n_real):
                    f.write(tokenizer.merge_repeated(
                        tokenizer.decode(ids[i, :int(out_len[i])])) + "\n")
                    n += 1
        print(f"[predict] wrote {n} transcripts to {path}")
        return
    path = output if output.endswith(".npz") else output + ".npz"
    device = next(model.parameters()).device
    rows = {}
    for batch, n_real in data.predict_dataloader().iter_with_counts():
        if isinstance(model, TextToAlignText):
            text, text_len = (torch.as_tensor(t).to(device) for t in batch[0])
            outputs = {"durations": model.predict(text, text_len)}
            lengths = _host(text_len)
        else:
            text, text_len = (torch.as_tensor(t).to(device) for t in batch[-1])
            outputs = dict(zip(("f0", "logspc", "codeap"), model.predict(text, text_len)))
            lengths = _host(model.output_length(text_len))
        for name, out in outputs.items():
            out = _host(out)
            rows.setdefault(name, []).extend(out[i, :int(lengths[i])] for i in range(n_real))
    np.savez(path, **{name: np.asarray(r, dtype=object) for name, r in rows.items()})
    n = len(next(iter(rows.values())))
    what = "durations for {} texts" if isinstance(model, TextToAlignText) else \
        "WORLD features for {} clips"
    print(f"[predict] wrote {what.format(n)} to {path}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="voice100-tpu-torch")
    parser.add_argument("subcommand", choices=["fit", "validate", "test", "predict"])
    parser.add_argument("--config", required=True)
    parser.add_argument("--output", type=str, default=None,
                        help="predict: output path (.txt for CTC transcripts, .npz for "
                             "durations or WORLD features)")
    parser.add_argument("--max_epochs", type=int, default=None)
    parser.add_argument("--data_dir", type=str, default=None)
    parser.add_argument("--cache_dir", type=str, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--checkpoint_dir", type=str, default=None)
    parser.add_argument("--restore_from", type=str, default=None,
                        help="a checkpoint of the port (.pt)")
    parser.add_argument("--log_path", type=str, default=None)
    parser.add_argument("--audio_stat", type=str, default=None,
                        help="fit: WORLD statistics (.npz of tools/calc_stat) for a TTS "
                             "model, over the config's audio_stat")
    parser.add_argument("--precision", type=str, default=None,
                        help="32 (default); the bf16 path is not ported yet")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu (the plain PyTorch path)")
    parser.add_argument("--mesh_model_axis", type=int, default=1,
                        help=f"1 only; meshes are not ported yet ({DISTRIBUTED_ITEM})")
    parser.add_argument("--distributed", action="store_true",
                        help=f"not ported yet ({DISTRIBUTED_ITEM})")
    return parser


def main(argv=None) -> Optional[Dict[str, float]]:
    """Run one subcommand; returns the metrics of ``validate`` and
    ``test`` (:func:`cli_main` prints them), else None."""
    return _run(_parser().parse_args(argv))


def _run(args) -> Optional[Dict[str, float]]:
    if args.distributed:
        raise NotImplementedError(f"--distributed: multi-process training is not ported yet "
                                  f"({DISTRIBUTED_ITEM})")
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("subcommand", "config", "distributed", "device",
                                                "audio_stat")}
    config = load_config(args.config)
    tc = build_trainer_config(config, overrides)
    base = os.path.splitext(os.path.basename(args.config))[0]
    if tc.checkpoint_dir is None:
        tc.checkpoint_dir = os.path.join("checkpoints", base)
    trainer = Trainer(tc)
    try:
        model, data = build_from_config(config, overrides, device=args.device)
        if args.subcommand == "fit":
            audio_stat = args.audio_stat or config_audio_stat(config)
            if audio_stat and os.path.exists(audio_stat):
                merge_world_stats(model, audio_stat)
            trainer.fit(model, data, restore_from=args.restore_from)
            return None
        ckpt = args.restore_from or next(
            (path for path in (os.path.join(tc.checkpoint_dir, name)
                               for name in ("best.pt", "last.pt")) if os.path.isfile(path)),
            None)
        if ckpt is None:
            raise SystemExit(f"no checkpoint found under {tc.checkpoint_dir}; "
                             f"pass --restore_from")
        load_model_weights(ckpt, model)
        if args.subcommand == "predict":
            data.setup("predict")
            _run_predict(model, data, args.output or f"{base}-predictions")
            return None
        stage = "test" if args.subcommand == "test" else "fit"
        return trainer.run_eval(model, data, stage=stage)
    finally:
        trainer.close()


def cli_main(argv=None) -> None:
    """The console entry point: one subcommand, then the ``validate`` and
    ``test`` metrics in the JAX CLI's format (``val_loss=... val_cer=...``)."""
    args = _parser().parse_args(argv)
    metrics = _run(args)
    if metrics is not None:
        prefix = "test" if args.subcommand == "test" else "val"
        print(" ".join(f"{prefix}_{k}={v:.4f}" for k, v in metrics.items()))


if __name__ == "__main__":
    cli_main()
