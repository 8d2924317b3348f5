"""Data modules: dataset, feature cache and stage loaders.

Port of ``voice100_tpu/data/datamodule.py`` (the reference's
voice100/data_modules.py:503-670,685-742):

* ``AudioTextDataModule``: tokenizer and collate from the flags, the
  corpus from the registry, the 90/10 split seeded with ``seed``
  (librispeech uses its dev-clean), the feature cache with the JAX
  package's salt, so either package reads the other's cache, and the
  stage loaders. ``vocoder="mel"`` runs the log-mel kernel on ``device``
  (default ``cuda``) and caches float16 (``mel@float16``);
  ``"world"`` and ``"world_mcep"`` analyse on the host and share one
  float32 cache (``world@ap-harmonic1``). ``use_target`` (the v1
  multi-task model, WORLD vocoders and ``use_align``) adds each clip's
  phone-aligned text as a target, tokenized by the phone tokenizer
  (``target_vocab_size``), and batches with ``collate_world_text_target``
  (``voice100_tpu/data/datamodule.py:104-125``).
* ``AlignTextDataModule``: the duration model's ``{ds}-[phone-]align-
  train.txt``, a 90/10 split seeded with ``seed``, ``collate_text_align``.

``AudioTextDataModule``'s ``num_workers`` and ``prefetch`` reach its
loaders: ``num_workers > 0`` reads and collates in spawned worker
processes on the host CPU (``data/loader.py``).

In a process group (``parallel/mesh.py``) the train, val and test
loaders of both modules read this rank's share of each global batch
(``process_index`` of ``process_count``,
``voice100_tpu/data/datamodule.py:185-186``); the predict loaders read
every row. The JAX package's align-text loaders are not sharded; the
port shards them as it does the audio ones, so that each rank trains on
its share of the global batch.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..parallel.mesh import process_count, process_index
from ..text import get_tokenizer
from .collate import collate_text_align, get_collate_fn
from .datasets import AlignTextDataset, SubsetDataset
from .loader import DataLoader
from .registry import get_dataset
from .transforms import EncodedCacheDataset, get_audio_transform

__all__ = ["AudioTextDataModule", "AlignTextDataModule"]


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
        use_target: bool = False,
        data_dir: str = "./data",
        cache_dir: str = "./cache",
        batch_size: int = 128,
        num_workers: int = 0,
        valid_ratio: float = 0.1,
        seed: int = 1234,
        cache_dtype: Optional[str] = "auto",
        bucket_by_length: bool = False,
        prefetch: int = 2,
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
        self.use_target = use_target
        self.data_dir = data_dir
        self.cache_dir = cache_dir
        # the JAX package's salt: the vocoder (world and world_mcep share
        # one mcep-form cache), the rate when not 16 kHz, the WORLD
        # analysis version and the cache dtype, so runs that would read
        # other features never share entries
        self.cache_salt = ("world" if vocoder == "world_mcep" else vocoder).encode("utf-8")
        if sample_rate != 16000:
            self.cache_salt += f"@{sample_rate}".encode("utf-8")
        if vocoder in ("world", "world_mcep"):
            from ..dsp.world import FEATURE_VERSION

            self.cache_salt += f"@{FEATURE_VERSION}".encode("utf-8")
        # log-mel features are model inputs only: they cache as float16;
        # WORLD features are supervision targets and stay float32
        if cache_dtype == "auto":
            cache_dtype = "float16" if vocoder == "mel" else None
        self.cache_dtype = cache_dtype
        if cache_dtype is not None:
            self.cache_salt += f"@{cache_dtype}".encode("utf-8")
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        # length-bucketed train batches from the cache files' headers
        self.bucket_by_length = bucket_by_length
        self.collate_fn = get_collate_fn(vocoder, use_target)
        self.audio_transform = get_audio_transform(vocoder, sample_rate, device=device)
        self.text_transform = get_tokenizer(language, use_phone)
        self.targettext_transform = get_tokenizer(language, True) if use_target else None
        self.train_ds = self.valid_ds = self.test_ds = self.predict_ds = None

    @property
    def audio_size(self) -> int:
        return self.audio_transform.audio_size

    @property
    def vocab_size(self) -> int:
        return self.text_transform.vocab_size

    @property
    def target_vocab_size(self) -> int:
        return self.targettext_transform.vocab_size

    def _wrap_cache(self, ds):
        return EncodedCacheDataset(ds, self.audio_transform, self.text_transform,
                                   cachedir=self.cache_dir, salt=self.cache_salt,
                                   cache_dtype=self.cache_dtype,
                                   targettext_transform=self.targettext_transform)

    def _get_dataset(self, split: str):
        return get_dataset(self.data_dir, self.dataset, split=split, use_align=self.use_align,
                           use_phone=self.use_phone, use_target=self.use_target)

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

    def _loader(self, ds, shuffle: bool, shard: bool = True) -> Optional[DataLoader]:
        if ds is None:
            return None
        return DataLoader(
            ds, batch_size=self.batch_size, collate_fn=self.collate_fn, shuffle=shuffle,
            seed=self.seed, num_workers=self.num_workers, prefetch=self.prefetch,
            length_hint=ds.audio_frames if self.bucket_by_length and shuffle else None,
            **_shard_args(shard),
        )

    def train_dataloader(self):
        return self._loader(self.train_ds, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.valid_ds, shuffle=False)

    def test_dataloader(self):
        return self._loader(self.test_ds, shuffle=False)

    def predict_dataloader(self):
        return self._loader(self.predict_ds, shuffle=False, shard=False)


def _shard_args(shard: bool) -> dict:
    """A loader's share of each global batch: this rank's, or every row."""
    if not shard:
        return {}
    return {"process_index": process_index(), "process_count": process_count()}


class AlignTextDataModule:
    """Text and frame-count pairs for the duration model (reference
    voice100/data_modules.py:685-742): ``{dataset}-align-train.txt`` (or
    ``-phone-align-``) under ``data_dir``, split 90/10 by
    ``default_rng(seed).permutation``."""

    def __init__(self, data_dir: str = "./data", dataset: str = "ljspeech",
                 language: str = "en", use_phone: bool = False, valid_ratio: float = 0.1,
                 batch_size: int = 256, seed: int = 1234) -> None:
        self.data_dir = data_dir
        self.dataset = dataset
        self.language = language
        self.use_phone = use_phone
        self.valid_ratio = valid_ratio
        self.batch_size = batch_size
        self.seed = seed
        self.collate_fn = collate_text_align
        self.encoder = get_tokenizer(language, use_phone)
        self.train_ds = self.valid_ds = self.predict_ds = None

    @property
    def vocab_size(self) -> int:
        return self.encoder.vocab_size

    def setup(self, stage: Optional[str] = None) -> None:
        infix = "phone-align" if self.use_phone else "align"
        ds = AlignTextDataset(os.path.join(self.data_dir, f"{self.dataset}-{infix}-train.txt"),
                              tokenizer=self.encoder)
        if stage == "predict":
            self.predict_ds = ds
            return
        total = len(ds)
        valid_len = int(total * self.valid_ratio)
        order = np.random.default_rng(self.seed).permutation(total)
        self.train_ds = SubsetDataset(ds, order[valid_len:])
        self.valid_ds = SubsetDataset(ds, order[:valid_len])

    def _loader(self, ds, shuffle: bool, shard: bool = True) -> DataLoader:
        return DataLoader(ds, self.batch_size, self.collate_fn, shuffle=shuffle, seed=self.seed,
                          **_shard_args(shard))

    def train_dataloader(self):
        return self._loader(self.train_ds, shuffle=True)

    def val_dataloader(self):
        return self._loader(self.valid_ds, shuffle=False)

    def predict_dataloader(self):
        return self._loader(self.predict_ds, shuffle=False, shard=False)
