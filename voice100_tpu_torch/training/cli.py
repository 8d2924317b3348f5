"""YAML CLI: ``python -m voice100_tpu_torch fit --config config/asr_en_base.yaml``.

Port of ``voice100_tpu/training/cli.py`` for every model of the JAX
package: ``AudioToAlignText`` with ``AudioTextDataModule`` (log-mel),
the TTS pair, ``TextToAlignText`` with ``AlignTextDataModule`` and
``AlignTextToAudio`` with ``AudioTextDataModule`` (WORLD features), and
the v1 family (``AudioToTextCTC``, ``AudioAlignCTC``,
``TextToAlignTextModel``, ``AlignTextToAudioModel``,
``AlignTextToAudioMultiTaskModel``; ``tools/train_v1.py`` has their
argparse CLIs). The
subcommands ``fit``, ``validate``, ``test`` and ``predict`` and the JAX
CLI's flags, with ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch path) in place of ``--platform``. Configs keep their
``class_path`` strings (``voice100_tpu.*``, or the reference's
``voice100.*``); the last component names the port's class. Keys a
constructor does not take are dropped with a note, lists become tuples,
``data_dir``, ``cache_dir`` and ``batch_size`` can be overridden, and an
audio-input model (one with ``greedy_decode`` or ``ctc_best_path``)
whose ``vocab_size`` or ``audio_size`` disagrees with the data's stops
the run (TTS models use ``audio_size`` for their output
width). A TTS config's ``audio_stat``, or ``--audio_stat`` over it, names
the WORLD statistics (``tools/calc_stat.py``) that ``fit`` loads into the
model's ``norm`` buffers before the first step, where the file exists.
``fit`` draws the model's initial weights on the CPU from a generator
seeded with the config's ``seed_everything``, so one config gives one
start on any device. ``--precision`` (or ``trainer.precision``) ``16``,
``bf16``, ``bfloat16`` or ``16-mixed`` runs every subcommand in bf16
mixed precision (``training/trainer.py``), ``32`` in float32. The
trainer keys ``device_cache``, ``device_cache_max_bytes`` and
``steps_per_dispatch`` reach the ``TrainerConfig`` fields of their names,
and the data's ``num_workers`` and ``prefetch`` its loaders.

Checkpoints are the port's ``.pt`` files (``best.pt``, ``last.pt``,
``epoch_N.pt`` under ``--checkpoint_dir``, default
``checkpoints/<config stem>``); ``validate``, ``test`` and ``predict``
read ``--restore_from``, else ``best.pt``, else ``last.pt``. ``predict``
writes CTC transcripts (``.txt``), or per-text durations or per-clip
WORLD features (``.npz`` of object arrays); the v1 CTC models have no
``predict``, as in the JAX CLI. An orbax checkpoint of the
JAX package crosses over through ``tools/weights.py``. Serving builds a
model from a config and a checkpoint alone with :func:`load_model`.

``--distributed`` runs one process a device, joined by
``torch.distributed`` (``parallel/mesh.py``; ``voice100_tpu/training/
cli.py:295-334``): with ``--coordinator_address host:port``,
``--num_processes N`` and ``--process_id i`` over ``tcp://``, or with none
of them from torchrun's environment. Rank i runs on
``cuda:{i % device_count}`` (``--device cpu``: the CPU) over NCCL on CUDA
and gloo on the CPU; ``--dist_backend gloo`` takes gloo for tensors on a
card too, which lets two ranks share one GPU (NCCL refuses that). Each
rank reads its share of every global batch of ``batch_size *
num_processes`` rows (``training/trainer.py``); ``predict`` runs on rank
0 alone, over every row. ``--mesh_model_axis m`` (or
``trainer.mesh_model_axis``, the key over the flag) with m > 1 makes the
ranks a ``(num_processes / m, m)`` mesh: each rank keeps its shards of
the large parameters and their Adam moments and gathers the weights each
step (tensor parallelism, ``parallel/mesh.py``); m must divide the
process count, so without ``--distributed`` it raises.
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
from .. import models as _models
from ..models import (AlignTextToAudio, AlignTextToAudioModel, TextToAlignText,
                      TextToAlignTextModel)
from ..parallel import mesh as parallel
from .checkpoint import load_model_weights, merge_world_stats
from .tasks import make_task
from .trainer import Trainer, TrainerConfig, _host

__all__ = ["load_config", "build_from_config", "build_trainer_config", "config_audio_stat",
           "load_model", "main", "cli_main"]

_MODEL_CLASSES = {name: getattr(_models, name) for name in _models.__all__}
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


def build_from_config(config: Dict[str, Any], overrides: Dict[str, Any], device=None,
                      generator: Optional[torch.Generator] = None):
    """``(model, datamodule)`` on ``device`` (default ``cuda``) from a
    config; the model's weights are drawn on the CPU from ``generator``
    (torch's global generator if None) and then moved, so one generator
    state gives one set of weights on any device. The model's
    ``audio_stat`` key is left for :func:`config_audio_stat`."""
    model_cls = _resolve_class(config["model"]["class_path"], _MODEL_CLASSES)
    data_cls = _resolve_class(config["data"]["class_path"], _DATA_CLASSES)
    model_kwargs = dict(config["model"].get("init_args") or {})
    model_kwargs.pop("audio_stat", None)
    model = model_cls(**_filter_kwargs(model_cls, model_kwargs), device=device,
                      generator=generator)
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
    audio_input = hasattr(model, "greedy_decode") or hasattr(model, "ctc_best_path")
    checks = ("vocab_size", "audio_size") if audio_input else ("vocab_size",)
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
    name (a config's ``mesh_model_axis`` over the flag, as the JAX
    pass-through has it)."""
    trainer_cfg = config.get("trainer") or {}
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
        mesh_model_axis=int(overrides.get("mesh_model_axis", 1)),
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
    (``voice100_tpu/training/cli.py:153-262``): the CTC model writes greedy
    transcripts, one a line, to ``output`` (``.txt`` appended where
    missing); the duration models each text's ``durations [len, 2]``
    (``exp(y) - 1``), the acoustic models each clip's ``f0``, ``logspc``
    and ``codeap``, as object arrays of an ``.npz`` (appended where
    missing). The v2 acoustic model's rows are cut to its output length,
    the v1 models' to ``2 * aligntext_len`` frames, as the JAX CLI cuts
    them (the decoder gives ``2 T - 1``). The v1 acoustic models read the
    batch's aligned text (its second pair; the JAX CLI reads the last
    pair, which in the multi-task layout is the phone target). Any other
    model stops with the JAX CLI's ``predict is not supported``."""
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
    duration_models = (TextToAlignText, TextToAlignTextModel)
    if not isinstance(model, duration_models + (AlignTextToAudio, AlignTextToAudioModel)):
        raise SystemExit(f"predict is not supported for {type(model).__name__}")
    path = output if output.endswith(".npz") else output + ".npz"
    device = next(model.parameters()).device
    rows = {}
    for batch, n_real in data.predict_dataloader().iter_with_counts():
        if isinstance(model, duration_models):
            text, text_len = (torch.as_tensor(t).to(device) for t in batch[0])
            durations = (model.predict(text, text_len) if isinstance(model, TextToAlignText)
                         else model.predict(text))
            outputs, lengths = {"durations": durations}, _host(text_len)
        elif isinstance(model, AlignTextToAudio):
            text, text_len = (torch.as_tensor(t).to(device) for t in batch[-1])
            outputs = dict(zip(("f0", "logspc", "codeap"), model.predict(text, text_len)))
            lengths = _host(model.output_length(text_len))
        else:
            text, text_len = (torch.as_tensor(t).to(device) for t in batch[1])
            outputs = dict(zip(("f0", "logspc", "codeap"), model.predict(text)[:3]))
            lengths = 2 * _host(text_len)
        for name, out in outputs.items():
            out = _host(out)
            rows.setdefault(name, []).extend(out[i, :int(lengths[i])] for i in range(n_real))
    np.savez(path, **{name: np.asarray(r, dtype=object) for name, r in rows.items()})
    n = len(next(iter(rows.values())))
    what = "durations for {} texts" if isinstance(model, duration_models) else \
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
                        help="32 (default) or 16/bf16/bfloat16/16-mixed: bf16 mixed precision "
                             "with float32 master weights (the reference's --trainer.precision "
                             "16); every subcommand runs the model in it")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu (the plain PyTorch path)")
    parser.add_argument("--mesh_model_axis", type=int, default=1,
                        help="the mesh's model axis over the ranks of --distributed: m > 1 "
                             "shards the large parameters and their Adam moments over m ranks "
                             "(tensor parallelism; m divides the process count); 1 (default) "
                             "is data parallelism")
    parser.add_argument("--distributed", action="store_true",
                        help="data-parallel training, one process a device: join the process "
                             "group (the three flags below, or torchrun's environment) before "
                             "building anything; each rank loads its share of every global "
                             "batch")
    parser.add_argument("--coordinator_address", type=str, default=None,
                        help="with --distributed: host:port of rank 0")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="with --distributed: the number of processes")
    parser.add_argument("--process_id", type=int, default=None,
                        help="with --distributed: this process's rank")
    parser.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                        help="with --distributed: nccl (the default on cuda) or gloo (the "
                             "default on cpu; on cuda it carries the gradients through host "
                             "memory, and lets ranks share a GPU)")
    return parser


def main(argv=None) -> Optional[Dict[str, float]]:
    """Run one subcommand; returns the metrics of ``validate`` and
    ``test`` (:func:`cli_main` prints them), else None."""
    return _run(_parser().parse_args(argv))


def _join_process_group(args):
    """``--distributed``: join the process group; returns this rank's
    device, ``cuda:{rank % device_count}`` unless ``--device`` names the
    CPU."""
    device = torch.device(args.device or "cuda")
    parallel.init_distributed(args.coordinator_address, args.num_processes, args.process_id,
                              device=device, backend=args.dist_backend)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", parallel.process_index() % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


def _run(args) -> Optional[Dict[str, float]]:
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("subcommand", "config", "distributed", "device",
                                                "audio_stat", "coordinator_address",
                                                "num_processes", "process_id", "dist_backend")}
    config = load_config(args.config)
    tc = build_trainer_config(config, overrides)
    if not args.distributed:
        return _run_subcommand(args, config, overrides, tc, args.device)
    device = _join_process_group(args)
    try:
        return _run_subcommand(args, config, overrides, tc, device)
    finally:
        parallel.shutdown_distributed()


def _run_subcommand(args, config, overrides, tc, device) -> Optional[Dict[str, float]]:
    base = os.path.splitext(os.path.basename(args.config))[0]
    if tc.checkpoint_dir is None:
        tc.checkpoint_dir = os.path.join("checkpoints", base)
    trainer = Trainer(tc)
    trainer.apply_precision()
    try:
        # fit starts from the weights of the config's seed_everything, as the
        # JAX trainer draws them from PRNGKey(seed); the other subcommands
        # load theirs from a checkpoint
        generator = torch.Generator().manual_seed(tc.seed) if args.subcommand == "fit" else None
        model, data = build_from_config(config, overrides, device=device,
                                        generator=generator)
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
            if parallel.process_index() == 0:  # one writer, over every row
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
