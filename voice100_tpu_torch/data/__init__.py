"""Data path of the port: corpus readers, registry, the log-mel and WORLD
feature cache, collation, loader, and the audio+text and align-text data
modules."""

from .collate import get_collate_fn
from .datamodule import AlignTextDataModule, AudioTextDataModule
from .datasets import (
    AlignTextDataset, ConcatDataset, LibriSpeechDataset, MergeDataset, MetafileDataset,
    SubsetDataset, TextDataset,
)
from .loader import DataLoader
from .registry import get_base_dataset, get_dataset
from .transforms import (EncodedCacheDataset, MelSpectrogramAudioTransform, WORLDAudioProcessor,
                         get_audio_transform)

__all__ = [
    "MetafileDataset", "LibriSpeechDataset", "TextDataset", "MergeDataset", "ConcatDataset",
    "SubsetDataset", "AlignTextDataset", "get_dataset", "get_base_dataset",
    "MelSpectrogramAudioTransform", "WORLDAudioProcessor", "EncodedCacheDataset",
    "get_audio_transform", "get_collate_fn", "DataLoader", "AudioTextDataModule",
    "AlignTextDataModule",
]
