"""Models of the port: the v2 models (ASR and the TTS pair) and the v1
family (``AudioToTextCTC``, ``AudioAlignCTC``, ``TextToAlignTextModel``,
``AlignTextToAudioModel``, ``AlignTextToAudioMultiTaskModel``), as
``voice100_tpu/models/__init__.py`` exports them; and the port's own
``ConformerCTC`` (NeMo's Conformer-CTC), which the JAX package lacks."""

from .align_v1 import AudioAlignCTC
from .align_v2 import TextToAlignText
from .asr_v1 import AudioToTextCTC
from .asr_v2 import AudioToAlignText
from .conformer_ctc import ConformerCTC
from .tts_v1 import AlignTextToAudioModel, AlignTextToAudioMultiTaskModel, TextToAlignTextModel
from .tts_v2 import AlignTextToAudio

__all__ = ["AudioToAlignText", "TextToAlignText", "AlignTextToAudio", "AudioToTextCTC",
           "AudioAlignCTC", "TextToAlignTextModel", "AlignTextToAudioModel",
           "AlignTextToAudioMultiTaskModel", "ConformerCTC"]

