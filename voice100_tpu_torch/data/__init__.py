"""Data path of the port: corpus readers, registry, the log-mel and WORLD
feature cache, collation, loader (a thread or a worker pool), packed
uploads, device prefetch, the device feature cache, and the audio+text
and align-text data modules."""

from .collate import get_collate_fn
from .datamodule import AlignTextDataModule, AudioTextDataModule
from .device_cache import DeviceFeatureCache
from .datasets import (
    AlignTextDataset, ConcatDataset, LibriSpeechDataset, MergeDataset, MetafileDataset,
    SubsetDataset, TextDataset,
)
from .loader import DataLoader
from .pack import device_put_packed, pack_batch, unpack_batch
from .prefetch import DevicePrefetcher, prefetch_to_device
from .registry import get_base_dataset, get_dataset
from .transforms import (EncodedCacheDataset, MelSpectrogramAudioTransform, WORLDAudioProcessor,
                         get_audio_transform)

__all__ = [
    "MetafileDataset", "LibriSpeechDataset", "TextDataset", "MergeDataset", "ConcatDataset",
    "SubsetDataset", "AlignTextDataset", "get_dataset", "get_base_dataset",
    "MelSpectrogramAudioTransform", "WORLDAudioProcessor", "EncodedCacheDataset",
    "get_audio_transform", "get_collate_fn", "DataLoader", "AudioTextDataModule",
    "AlignTextDataModule", "DeviceFeatureCache", "DevicePrefetcher", "prefetch_to_device",
    "pack_batch", "unpack_batch", "device_put_packed",
]
