"""Data path of the port: corpus readers, registry, log-mel feature cache,
collation, loader and the audio+text data module (mel only)."""

from .collate import get_collate_fn
from .datamodule import AudioTextDataModule
from .datasets import (
    AlignTextDataset, ConcatDataset, LibriSpeechDataset, MergeDataset, MetafileDataset,
    SubsetDataset, TextDataset,
)
from .loader import DataLoader
from .registry import get_base_dataset, get_dataset
from .transforms import EncodedCacheDataset, MelSpectrogramAudioTransform, get_audio_transform

__all__ = [
    "MetafileDataset", "LibriSpeechDataset", "TextDataset", "MergeDataset", "ConcatDataset",
    "SubsetDataset", "AlignTextDataset", "get_dataset", "get_base_dataset",
    "MelSpectrogramAudioTransform", "EncodedCacheDataset", "get_audio_transform",
    "get_collate_fn", "DataLoader", "AudioTextDataModule",
]
