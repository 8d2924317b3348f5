"""End-to-end TTS samples: text -> phones -> durations -> WORLD -> WAV.

Port of ``voice100_tpu/tools/update_samples.py`` (the reference's
voice100/update_samples.py:30-113): phonemize, tokenize, predict
durations with the align model, expand them to aligned text, predict
WORLD features with the audio model, synthesize each utterance, clip to
+/-0.8 and write 16 kHz PCM16 WAVs. Checkpoints are the port's ``.pt``
files; the models run on ``--device`` (default ``cuda``, which raises
without CUDA; ``cpu`` runs the plain PyTorch path). Phone models (the
default) read CMU phones from the English G2P or the Japanese reader's
phones (``--language ja``); ``--no_phone`` is for character models::

    python -m voice100_tpu_torch.tools.update_samples \\
        --align_config config/align_en_phone_base.yaml --align_ckpt align.pt \\
        --audio_config config/tts_en_phone_base.yaml --audio_ckpt tts.pt \\
        --device cuda
"""

from __future__ import annotations

from argparse import ArgumentParser
from typing import List, Optional

import numpy as np
import torch

__all__ = ["make_samples", "cli_main"]


def make_samples(
    align_config: str,
    align_ckpt_path: str,
    audio_config: str,
    audio_ckpt_path: str,
    sample_texts: List[str],
    language: str,
    output_prefix: str = "sample",
    audio_stat: Optional[str] = None,
    use_phone: bool = True,
    device=None,
) -> List[str]:
    """Write one WAV a text, ``{output_prefix}-{language}-{i}.wav``; returns
    the paths."""
    from ..data.collate import pad_stack
    from ..device import resolve_device
    from ..dsp.wav import write_wav
    from ..dsp.world import WORLDVocoder
    from ..models import AlignTextToAudio, TextToAlignText
    from ..text import get_phonemizer, get_tokenizer
    from ..training.checkpoint import merge_world_stats
    from ..training.cli import load_model

    device = resolve_device(device)
    align_model = load_model(align_config, align_ckpt_path, device=device)
    audio_model = load_model(audio_config, audio_ckpt_path, device=device)
    if not isinstance(align_model, TextToAlignText) or not isinstance(audio_model,
                                                                      AlignTextToAudio):
        raise ValueError("update_samples needs a TextToAlignText and an AlignTextToAudio config")
    if audio_stat:
        merge_world_stats(audio_model, audio_stat)

    phonemizer = get_phonemizer(language=language, use_phone=use_phone)
    tokenizer = get_tokenizer(language=language, use_phone=use_phone)
    phones = [phonemizer(t) for t in sample_texts]
    encoded = [tokenizer(p) for p in phones]
    text, text_len = pad_stack(encoded, 0, 16)
    for i, t in enumerate(sample_texts):
        print(f"text {i}: {t}")
        print(f"phones {i}: {phones[i][:100]}...")

    text_t = torch.from_numpy(text).to(device)
    durations = align_model.predict(text_t, torch.from_numpy(text_len).to(device)).cpu().numpy()
    mask = np.arange(text.shape[1])[None, :] < text_len[:, None]
    totals = (durations * mask[:, :, None]).sum(axis=(1, 2))
    # capacity: duration total + one forced frame per token + head/tail
    out_len = int(np.ceil(float(np.max(totals)))) + int(text.shape[1]) + 16
    aligntext, aligntext_len = align_model.align(text_t, durations, text_len, out_len)
    aligntext_len = aligntext_len.cpu().numpy()
    for i in range(aligntext.shape[0]):
        decoded = tokenizer.decode(aligntext[i, :int(aligntext_len[i])].cpu().numpy())
        print(f"aligntext {i}: {decoded[:100]}...")

    f0, feat, codeap = (t.cpu().numpy() for t in audio_model.predict(
        aligntext, torch.from_numpy(aligntext_len).to(device)))
    vocoder = WORLDVocoder(sample_rate=16000, use_mcep=audio_model.logspc_size == 25,
                           device=device)
    paths = []
    for i in range(f0.shape[0]):
        audio_len = int(aligntext_len[i]) * 2
        wav = vocoder.decode(f0[i, :audio_len], feat[i, :audio_len], codeap[i, :audio_len])
        wav = np.clip(wav, -0.8, 0.8)
        path = f"{output_prefix}-{language}-{i + 1}.wav"
        write_wav(path, (wav * 32765).astype(np.int16), 16000)
        paths.append(path)
        print(f"wrote {path} ({len(wav) / 16000:.2f}s)")
    return paths


_DEFAULT_TEXTS = {
    "en": [
        "beginnings are apt to be determinative and when reinforced by "
        "continuous applications of similar influence",
        "which had restored the courage of noirtier for ever since he "
        "had conversed with the priest his violent despair had yielded "
        "to a calm resignation which surprised all who knew his "
        "excessive affection",
    ],
    "ja": [
        "また、東寺のように五大明王と呼ばれる主要な明王の中央に配されることも多い。",
        "ニューイングランド風は牛乳をベースとした白いクリームスープであり"
        "ボストンクラムチャウダーとも呼ばれる",
    ],
}


def cli_main(argv=None) -> None:
    parser = ArgumentParser(prog="voice100-tpu-torch-update-samples")
    parser.add_argument("--align_config", required=True)
    parser.add_argument("--align_ckpt", required=True)
    parser.add_argument("--audio_config", required=True)
    parser.add_argument("--audio_ckpt", required=True)
    parser.add_argument("--language", default="en")
    parser.add_argument("--audio_stat", default=None)
    parser.add_argument("--text", action="append", default=None)
    parser.add_argument("--output_prefix", default="sample")
    parser.add_argument("--no_phone", action="store_true",
                        help="character models (CharTokenizer); the default reads phones")
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)
    make_samples(
        align_config=args.align_config,
        align_ckpt_path=args.align_ckpt,
        audio_config=args.audio_config,
        audio_ckpt_path=args.audio_ckpt,
        sample_texts=args.text or _DEFAULT_TEXTS[args.language],
        language=args.language,
        output_prefix=args.output_prefix,
        audio_stat=args.audio_stat,
        use_phone=not args.no_phone,
        device=args.device,
    )


if __name__ == "__main__":
    cli_main()
