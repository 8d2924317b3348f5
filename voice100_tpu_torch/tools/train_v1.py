"""The v1 family's argparse training CLIs.

Port of ``voice100_tpu/tools/train_v1.py`` (the reference's console
scripts train_asr, train_align, train_ttsalign, train_ttsaudio and
train_ttsaudio_mt, voice100/train_*.py): the same flags and defaults,
each composing a data module, a v1 model and a trainer with seed 1234,
gradient clip 1.0, a checkpoint every 10 epochs and ``val_loss``
monitored. The console scripts are ``voice100-tpu-torch-train-{asr,align,
ttsalign,ttsaudio,ttsaudio-mt}``. ``--device`` (default ``cuda``; ``cpu``
runs the plain PyTorch path) is the port's one flag more. The initial
weights are drawn on the CPU from a generator seeded with 1234.
Checkpoints are the port's ``.pt`` files under ``--checkpoint_dir``
(default ``checkpoints/<name>_v1``); ``--resume_from_checkpoint`` takes
one. The acoustic models load the WORLD statistics (``--audio_stat``,
else ``<data_dir>/<dataset>-stat.npz``) into the fresh weights when the
file exists and the run does not resume (``train_v1.py:157-168``).

    python -m voice100_tpu_torch.tools.train_v1 asr --dataset ljspeech --device cpu
"""

from __future__ import annotations

import os
import sys
from argparse import ArgumentParser

import torch

from ..data import AlignTextDataModule, AudioTextDataModule
from ..models import (AlignTextToAudioModel, AlignTextToAudioMultiTaskModel, AudioAlignCTC,
                      AudioToTextCTC, TextToAlignTextModel)
from ..training import Trainer, TrainerConfig
from ..training.checkpoint import merge_world_stats

__all__ = ["asr_cli_main", "align_cli_main", "ttsalign_cli_main", "ttsaudio_cli_main",
           "ttsaudio_mt_cli_main"]

SEED = 1234


def _common_parser(vocoder_default: str) -> ArgumentParser:
    parser = ArgumentParser()
    parser.add_argument("--dataset", default="ljspeech")
    parser.add_argument("--language", default="en")
    parser.add_argument("--vocoder", default=vocoder_default)
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--use_phone", action="store_true")
    parser.add_argument("--data_dir", default="./data")
    parser.add_argument("--cache_dir", default="./cache")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--max_epochs", type=int, default=100)
    parser.add_argument("--learning_rate", type=float, default=1e-3)
    parser.add_argument("--hidden_size", type=int, default=None)
    parser.add_argument("--checkpoint_dir", default=None)
    parser.add_argument("--resume_from_checkpoint", default=None,
                        help="a checkpoint of the port (.pt)")
    parser.add_argument("--audio_stat", default=None)
    parser.add_argument("--device", default=None,
                        help="cuda (default) or cpu (the plain PyTorch path)")
    return parser


def _fit(args, name: str, model, data) -> None:
    ckpt = args.checkpoint_dir or os.path.join("checkpoints", name)
    trainer = Trainer(TrainerConfig(max_epochs=args.max_epochs, gradient_clip_val=1.0,
                                    checkpoint_dir=ckpt, monitor="val_loss", every_n_epochs=10,
                                    seed=SEED))
    try:
        trainer.fit(model, data, restore_from=args.resume_from_checkpoint)
    finally:
        trainer.close()


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def _mel_data(args) -> AudioTextDataModule:
    return AudioTextDataModule(vocoder="mel", dataset=args.dataset, language=args.language,
                               sample_rate=args.sample_rate, use_phone=args.use_phone,
                               data_dir=args.data_dir, cache_dir=args.cache_dir,
                               batch_size=args.batch_size, device=args.device)


def asr_cli_main(argv=None) -> None:
    """v1 conv-CTC ASR (reference voice100/train_asr.py)."""
    parser = _common_parser("mel")
    parser.add_argument("--embed_size", type=int, default=512)
    parser.add_argument("--weight_decay", type=float, default=4e-5)
    args = parser.parse_args(argv)
    data = _mel_data(args)
    model = AudioToTextCTC(audio_size=data.audio_size, vocab_size=data.vocab_size,
                           embed_size=args.embed_size, hidden_size=args.hidden_size or 512,
                           learning_rate=args.learning_rate, weight_decay=args.weight_decay,
                           device=args.device, generator=_generator())
    _fit(args, "asr_v1", model, data)


def align_cli_main(argv=None) -> None:
    """v1 biLSTM forced aligner (reference voice100/train_align.py)."""
    args = _common_parser("mel").parse_args(argv)
    data = _mel_data(args)
    model = AudioAlignCTC(audio_size=data.audio_size, vocab_size=data.vocab_size,
                          hidden_size=args.hidden_size or 128, num_layers=2,
                          learning_rate=args.learning_rate, device=args.device,
                          generator=_generator())
    _fit(args, "align_v1", model, data)


def ttsalign_cli_main(argv=None) -> None:
    """v1 conv duration model (reference voice100/train_ttsalign.py)."""
    args = _common_parser("mel").parse_args(argv)
    data = AlignTextDataModule(data_dir=args.data_dir, dataset=args.dataset,
                               language=args.language, use_phone=args.use_phone,
                               batch_size=args.batch_size)
    model = TextToAlignTextModel(vocab_size=data.vocab_size, hidden_size=args.hidden_size or 512,
                                 learning_rate=args.learning_rate, device=args.device,
                                 generator=_generator())
    _fit(args, "ttsalign_v1", model, data)


def _fit_ttsaudio(args, model_cls, name: str, use_target: bool) -> None:
    data = AudioTextDataModule(vocoder=args.vocoder, dataset=args.dataset,
                               language=args.language, sample_rate=args.sample_rate,
                               use_align=True, use_phone=args.use_phone, use_target=use_target,
                               data_dir=args.data_dir, cache_dir=args.cache_dir,
                               batch_size=args.batch_size, device=args.device)
    kwargs = dict(vocab_size=data.vocab_size, hidden_size=args.hidden_size or 512,
                  use_mcep=args.vocoder == "world_mcep", learning_rate=args.learning_rate)
    if use_target:
        kwargs["target_vocab_size"] = data.target_vocab_size
    model = model_cls(**kwargs, device=args.device, generator=_generator())
    stat_path = args.audio_stat or os.path.join(args.data_dir, f"{args.dataset}-stat.npz")
    if not args.resume_from_checkpoint and os.path.exists(stat_path):
        merge_world_stats(model, stat_path)
    _fit(args, name, model, data)


def ttsaudio_cli_main(argv=None) -> None:
    """v1 acoustic model (reference voice100/train_ttsaudio.py)."""
    _fit_ttsaudio(_common_parser("world").parse_args(argv), AlignTextToAudioModel,
                  "ttsaudio_v1", False)


def ttsaudio_mt_cli_main(argv=None) -> None:
    """v1 multi-task acoustic model (reference voice100/train_ttsaudio_mt.py)."""
    _fit_ttsaudio(_common_parser("world").parse_args(argv), AlignTextToAudioMultiTaskModel,
                  "ttsaudio_mt_v1", True)


_MAINS = {"asr": asr_cli_main, "align": align_cli_main, "ttsalign": ttsalign_cli_main,
          "ttsaudio": ttsaudio_cli_main, "ttsaudio-mt": ttsaudio_mt_cli_main}

if __name__ == "__main__":
    if len(sys.argv) < 2 or sys.argv[1] not in _MAINS:
        raise SystemExit(f"usage: python -m voice100_tpu_torch.tools.train_v1 "
                         f"{{{','.join(_MAINS)}}} [flags]")
    _MAINS[sys.argv[1]](sys.argv[2:])
