"""Dataset registry: corpus names -> readers, with text/align merging.

Same names and file conventions as the reference
(voice100/data_modules.py:319-412): ``dummy_{lang}``, ``librispeech``,
``librispeech_360``, ``ljspeech``, ``cv_ja``, ``kokoro_{size}``; text
files ``{ds}-[phone-]{split}.txt``; align files
``{ds}-[phone-]align-{split}.txt``; comma-joined corpus lists. A copy of
``voice100_tpu/data/registry.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import os

from .datasets import (
    ConcatDataset,
    LibriSpeechDataset,
    MergeDataset,
    MetafileDataset,
    TextDataset,
)

__all__ = ["get_dataset", "get_base_dataset"]


def get_base_dataset(data_dir: str, dataset: str, split: str):
    if dataset.startswith("dummy_"):
        language = dataset.replace("dummy_", "", 1)
        root = os.path.join(data_dir, f"dummy-speech-{language}")
        return MetafileDataset(
            root, metafile="metadata.csv", sep="|", header=False,
            idcol=0, ext=".wav",
        )
    if dataset in ("librispeech", "librispeech_360"):
        variant = "360" if dataset.endswith("_360") else "100"
        root = os.path.join(data_dir, "LibriSpeech")
        subdir = {
            "train": f"train-clean-{variant}",
            "valid": "dev-clean",
            "test": "test-clean",
        }
        if split not in subdir:
            raise ValueError(f"Unknown split {split!r}")
        return LibriSpeechDataset(os.path.join(root, subdir[split]))
    if dataset == "ljspeech":
        root = os.path.join(data_dir, "LJSpeech-1.1")
        return MetafileDataset(
            root, metafile="metadata.csv", sep="|", header=False,
            idcol=0, ext=".flac",
        )
    if dataset == "cv_ja":
        root = os.path.join(data_dir, "cv-corpus-12.0-2022-12-07/ja")
        return MetafileDataset(
            root, sep="\t", idcol=1, textcol=2, wavsdir="clips", ext="",
        )
    if dataset.startswith("kokoro_"):
        size = dataset.replace("kokoro_", "")
        root = os.path.join(data_dir, f"kokoro-speech-v1_2-{size}")
        return MetafileDataset(
            root, metafile="metadata.csv", sep="|", header=False,
            idcol=0, ext=".flac",
        )
    raise ValueError(f"Unknown dataset {dataset!r}")


def get_dataset(
    data_dir: str,
    dataset: str,
    split: str,
    use_align: bool = False,
    use_phone: bool = False,
    use_target: bool = False,
):
    """Assemble (possibly comma-joined) corpora with their text/align
    columns (reference voice100/data_modules.py:319-367)."""
    parts = []
    for name in dataset.split(","):
        base = get_base_dataset(data_dir, name, split)
        if use_target:
            assert use_align
            align_ds = TextDataset(
                os.path.join(data_dir, f"{name}-align-{split}.txt"),
                idcol=-1, textcol=1,
            )
            target_ds = TextDataset(
                os.path.join(data_dir, f"{name}-phone-align-{split}.txt"),
                idcol=-1, textcol=1,
            )
            parts.append(
                MergeDataset(base, align_ds=align_ds, target_ds=target_ds)
            )
        elif use_align:
            infix = "phone-align" if use_phone else "align"
            align_ds = TextDataset(
                os.path.join(data_dir, f"{name}-{infix}-{split}.txt"),
                idcol=-1, textcol=1,
            )
            parts.append(MergeDataset(base, align_ds=align_ds))
        else:
            infix = "phone-" if use_phone else ""
            text_ds = TextDataset(
                os.path.join(data_dir, f"{name}-{infix}{split}.txt")
            )
            parts.append(MergeDataset(base, text_ds=text_ds))
    return parts[0] if len(parts) == 1 else ConcatDataset(parts)
