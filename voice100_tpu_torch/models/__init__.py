"""Models of the port: ASR v2 so far."""

from .asr_v2 import AudioToAlignText

__all__ = ["AudioToAlignText"]
