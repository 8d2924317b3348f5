"""Corpus transcript phonemization -> ``{ds}-[phone-]{split}.txt``.

A copy of ``voice100_tpu/tools/prepare_dataset.py`` on the port's
registry and phonemizers: parity with the reference CLI
(voice100/prepare_dataset.py:25-64), including the kokoro pass-through
branch (its transcripts are already phone strings). Host code only::

    python -m voice100_tpu_torch.tools.prepare_dataset --data_dir ./data \\
        --dataset ljspeech,librispeech --split train,valid --language en --use_phone
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

from ..data.registry import get_base_dataset
from ..text import get_phonemizer

__all__ = ["convert_phone", "cli_main"]


def convert_phone_kokoro(
    data_dir: str, dataset: str, split: str, language: str,
    use_phone: bool, output_file: str,
) -> None:
    if split != "train":
        raise ValueError(f"kokoro has no {split!r} split (train only)")
    if not use_phone:
        raise ValueError(
            "kokoro transcripts are phone strings; pass --use_phone"
        )
    if language != "ja":
        raise ValueError(
            f"kokoro is a Japanese corpus; got language={language!r}"
        )
    ds = get_base_dataset(data_dir, dataset, split)
    with open(output_file, "wt", encoding="utf-8") as outf:
        for clipid, _, phone_text in ds:
            outf.write(f"{clipid}|{phone_text}\n")


def convert_phone(
    data_dir: str, dataset: str, split: str, language: str,
    use_phone: bool, output_file: str,
) -> None:
    phonemizer = get_phonemizer(language=language, use_phone=use_phone)
    ds = get_base_dataset(data_dir, dataset, split)
    with open(output_file, "wt", encoding="utf-8") as outf:
        for clipid, _, text in ds:
            outf.write(f"{clipid}|{phonemizer(text)}\n")


def cli_main(argv=None) -> None:
    parser = ArgumentParser(prog="voice100-tpu-torch-prepare-dataset")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--split", type=str, default="train")
    parser.add_argument("--language", type=str, required=True)
    parser.add_argument("--use_phone", action="store_true")
    args = parser.parse_args(argv)
    for dataset in args.dataset.split(","):
        for split in args.split.split(","):
            infix = "phone-" if args.use_phone else ""
            output_file = os.path.join(
                args.data_dir, f"{dataset}-{infix}{split}.txt"
            )
            fn = (
                convert_phone_kokoro
                if dataset.startswith("kokoro_")
                else convert_phone
            )
            fn(
                args.data_dir, dataset, split=split,
                language=args.language, use_phone=args.use_phone,
                output_file=output_file,
            )
            print(f"[prepare-dataset] wrote {output_file}")


if __name__ == "__main__":
    cli_main()
