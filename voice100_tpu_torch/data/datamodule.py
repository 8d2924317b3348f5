"""The audio+text data module: dataset, feature cache and stage loaders.

Port of ``AudioTextDataModule`` of ``voice100_tpu/data/datamodule.py:28-205``
(the reference's voice100/data_modules.py:503-670) for ``vocoder="mel"``:
tokenizer and collate from the flags, the corpus from the registry, the
90/10 split seeded with ``seed`` (librispeech uses its dev-clean), the
feature cache with the JAX package's salt (``mel@float16`` by default), so
either package reads the other's cache, and the stage loaders. The log-mel
transform runs on ``device`` (default ``cuda``). The WORLD vocoders,
their multi-task targets (``use_target``) and ``AlignTextDataModule``
wait for the TTS slice; ``num_workers > 0`` waits for the data shell.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..text import get_tokenizer
from .collate import get_collate_fn
from .datasets import SubsetDataset
from .loader import DataLoader
from .registry import get_dataset
from .transforms import EncodedCacheDataset, get_audio_transform

__all__ = ["AudioTextDataModule"]


class AudioTextDataModule:
    """Audio+text pairs, optionally with aligned text."""

    def __init__(
        self,
        vocoder: str,
        dataset: str = "ljspeech",
        sample_rate: int = 16000,
        language: str = "en",
        use_align: bool = False,
        use_phone: bool = False,
        data_dir: str = "./data",
        cache_dir: str = "./cache",
        batch_size: int = 128,
        num_workers: int = 0,
        valid_ratio: float = 0.1,
        seed: int = 1234,
        cache_dtype: Optional[str] = "auto",
        bucket_by_length: bool = False,
        device=None,
    ) -> None:
        self.vocoder = vocoder
        self.dataset = dataset
        self.split_dataset = dataset != "librispeech"
        self.valid_ratio = valid_ratio
        self.sample_rate = sample_rate
        self.language = language
        self.use_align = use_align
        self.use_phone = use_phone
        self.data_dir = data_dir
        self.cache_dir = cache_dir
        # the JAX package's salt: the vocoder, the rate when not 16 kHz,
        # and the cache dtype, so runs that would read other features
        # never share entries
        self.cache_salt = vocoder.encode("utf-8")
        if sample_rate != 16000:
            self.cache_salt += f"@{sample_rate}".encode("utf-8")
        # log-mel features are model inputs only: they cache as float16
        if cache_dtype == "auto":
            cache_dtype = "float16" if vocoder == "mel" else None
        self.cache_dtype = cache_dtype
        if cache_dtype is not None:
            self.cache_salt += f"@{cache_dtype}".encode("utf-8")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.seed = seed
        # length-bucketed train batches from the cache files' headers
        self.bucket_by_length = bucket_by_length
        self.collate_fn = get_collate_fn(vocoder)
        self.audio_transform = get_audio_transform(vocoder, sample_rate, device=device)
        self.text_transform = get_tokenizer(language, use_phone)
        self.train_ds = self.valid_ds = self.test_ds = self.predict_ds = None

    @property
    def audio_size(self) -> int:
        return self.audio_transform.audio_size

    @property
    def vocab_size(self) -> int:
        return self.text_transform.vocab_size

    def _wrap_cache(self, ds):
        return EncodedCacheDataset(ds, self.audio_transform, self.text_transform,
                                   cachedir=self.cache_dir, salt=self.cache_salt,
                                   cache_dtype=self.cache_dtype)

    def _get_dataset(self, split: str):
        return get_dataset(self.data_dir, self.dataset, split=split, use_align=self.use_align,
                           use_phone=self.use_phone)

    def setup(self, stage: Optional[str] = None) -> None:
        ds = self._get_dataset("train")
        os.makedirs(self.cache_dir, exist_ok=True)
        if stage == "predict":
            self.predict_ds = self._wrap_cache(ds)
        elif stage == "test":
            self.test_ds = self._wrap_cache(ds)
        else:
            if self.split_dataset:
                total = len(ds)
                valid_len = int(total * self.valid_ratio)
                order = np.random.default_rng(self.seed).permutation(total)
                train_ds = SubsetDataset(ds, order[valid_len:])
                valid_ds = SubsetDataset(ds, order[:valid_len])
            else:
                train_ds, valid_ds = ds, self._get_dataset("valid")
            self.train_ds = self._wrap_cache(train_ds)
            self.valid_ds = self._wrap_cache(valid_ds)

    def _loader(self, ds, shuffle: bool) -> Optional[DataLoader]:
        if ds is None:
            return None
        return DataLoader(
            ds, batch_size=self.batch_size, collate_fn=self.collate_fn, shuffle=shuffle,
            seed=self.seed, num_workers=self.num_workers,
            length_hint=ds.audio_frames if self.bucket_by_length and shuffle else None,
        )

    def train_dataloader(self):
        return self._loader(self.train_ds, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.valid_ds, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.test_ds, shuffle=False)

    def predict_dataloader(self):
        return self._loader(self.predict_ds, shuffle=False)
