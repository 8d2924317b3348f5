"""Models of the port: ASR v2 and the TTS v2 pair."""

from .align_v2 import TextToAlignText
from .asr_v2 import AudioToAlignText
from .tts_v2 import AlignTextToAudio

__all__ = ["AudioToAlignText", "TextToAlignText", "AlignTextToAudio"]
