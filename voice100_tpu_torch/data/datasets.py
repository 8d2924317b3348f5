"""Corpus readers and dataset combinators (host-side).

Same corpus surface as the reference data layer
(voice100/data_modules.py:31-159,244-259): TSV/pipe metafile corpora,
LibriSpeech transcript trees, pipe-separated text files, zip-merging
audio with text/align/target columns, and align-text files for the
duration model. Readers return (clipid, audiopath, text) tuples; feature
extraction happens downstream. A copy of ``voice100_tpu/data/datasets.py``:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import os
from glob import glob
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "MetafileDataset",
    "LibriSpeechDataset",
    "TextDataset",
    "MergeDataset",
    "ConcatDataset",
    "SubsetDataset",
    "AlignTextDataset",
]


class MetafileDataset:
    """TSV/pipe metafile corpora: LJSpeech, CommonVoice, Kokoro
    (voice100/data_modules.py:31-65)."""

    def __init__(
        self,
        root: str,
        metafile: str = "validated.tsv",
        sep: str = "|",
        header: bool = True,
        idcol: int = 1,
        textcol: int = 2,
        wavsdir: str = "wavs",
        ext: str = ".wav",
    ) -> None:
        self._root = root
        self._wavsdir = wavsdir
        self._ext = ext
        self._data: List[Tuple[str, str]] = []
        with open(os.path.join(root, metafile), encoding="utf-8") as f:
            if header:
                f.readline()
            for line in f:
                parts = line.rstrip("\r\n").split(sep)
                self._data.append((parts[idcol], parts[textcol]))

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> Tuple[str, str, str]:
        clipid, text = self._data[index]
        path = os.path.join(self._root, self._wavsdir, clipid + self._ext)
        return clipid, path, text


class LibriSpeechDataset:
    """Recursive ``*.txt`` transcript scan -> flac clips
    (voice100/data_modules.py:68-96)."""

    def __init__(self, root: str) -> None:
        self._root = root
        self._data: List[Tuple[str, str, str]] = []
        for file in sorted(glob(os.path.join(root, "**", "*.txt"), recursive=True)):
            reldir = os.path.relpath(os.path.dirname(file), start=root)
            with open(file, encoding="utf-8") as f:
                for line in f:
                    clipid, _, text = line.rstrip("\r\n").partition(" ")
                    self._data.append(
                        (clipid, os.path.join(reldir, clipid + ".flac"), text)
                    )

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int) -> Tuple[str, str, str]:
        clipid, relpath, text = self._data[index]
        return clipid, os.path.join(self._root, relpath), text


class TextDataset:
    """Pipe-separated id/text file (voice100/data_modules.py:99-116)."""

    def __init__(self, file: str, idcol: int = 0, textcol: int = 1) -> None:
        self._data: List[Tuple[Optional[str], str]] = []
        with open(file, "rt", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\r\n").split("|")
                clipid = parts[idcol] if idcol >= 0 else None
                self._data.append((clipid, parts[textcol]))

    def __len__(self) -> int:
        return len(self._data)

    def __getitem__(self, index: int):
        return self._data[index]


class MergeDataset:
    """Zip an audio dataset with text / align / target-align columns
    (voice100/data_modules.py:119-159)."""

    def __init__(
        self,
        audiotext_ds,
        align_ds=None,
        text_ds=None,
        target_ds=None,
    ) -> None:
        for other in (align_ds, text_ds, target_ds):
            if other is not None:
                assert len(audiotext_ds) == len(other)
        self._audiotext_ds = audiotext_ds
        self._align_ds = align_ds
        self._text_ds = text_ds
        self._target_ds = target_ds

    def __len__(self) -> int:
        return len(self._audiotext_ds)

    def __getitem__(self, index: int):
        clipid, audio, _ = self._audiotext_ds[index]
        if self._align_ds is not None and self._target_ds is not None:
            _, aligntext = self._align_ds[index]
            _, targettext = self._target_ds[index]
            return clipid, audio, aligntext, targettext
        if self._align_ds is not None:
            _, aligntext = self._align_ds[index]
            return clipid, audio, aligntext
        id2, text = self._text_ds[index]
        assert clipid == id2, f"id mismatch: {clipid} != {id2}"
        return clipid, audio, text


class ConcatDataset:
    """Concatenation of datasets (the reference's ``ds + ds``)."""

    def __init__(self, datasets: Sequence) -> None:
        self._datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self._datasets])

    def __len__(self) -> int:
        return int(self._offsets[-1])

    def __getitem__(self, index: int):
        which = int(np.searchsorted(self._offsets, index, side="right")) - 1
        return self._datasets[which][index - int(self._offsets[which])]


class SubsetDataset:
    """Index-subset view (the reference's random_split pieces)."""

    def __init__(self, dataset, indices: Sequence[int]) -> None:
        self._dataset = dataset
        self._indices = list(indices)

    def __len__(self) -> int:
        return len(self._indices)

    def __getitem__(self, index: int):
        return self._dataset[self._indices[index]]


class AlignTextDataset:
    """``text|aligntext|a0 a1 ...`` files for the duration model
    (voice100/data_modules.py:244-259)."""

    def __init__(self, file: str, tokenizer) -> None:
        self.tokenizer = tokenizer
        self.data: List[Tuple[np.ndarray, np.ndarray]] = []
        with open(file, "rt", encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\r\n").split("|")
                text = tokenizer(parts[0])
                align = np.asarray(
                    [int(x) for x in parts[2].split()], dtype=np.int32
                )
                self.data.append((text, align))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, index: int):
        return self.data[index]
