"""English phonemizers.

Port of ``voice100_tpu/text/phonemizers.py``: ``BasicPhonemizer`` (the
reference's voice100/text.py:47-56), which character models
(``use_phone: false``) read. CMU G2P (English phones) and the Japanese
reader are not ported yet; asking for them raises.
"""

from __future__ import annotations

import re

__all__ = ["BasicPhonemizer", "get_phonemizer", "TEXT_FRONT_END_ITEM"]

TEXT_FRONT_END_ITEM = "ROADMAP.md queue 1, item 6: the TTS text front end (G2P, Japanese)"

_NOT_DEFAULT_CHARACTERS_RX = re.compile(r"[^ abcdefghijklmnopqrstuvwxyz']")


class BasicPhonemizer:
    """Lowercase and strip everything outside ``[a-z ']``."""

    def __call__(self, text: str) -> str:
        return _NOT_DEFAULT_CHARACTERS_RX.sub("", text.lower())


def get_phonemizer(language: str, use_phone: bool):
    """Phonemizer factory (reference voice100/prepare_dataset.py:10-22)."""
    if language == "en":
        if use_phone:
            raise NotImplementedError(f"English phones (CMU G2P) are not ported yet "
                                      f"({TEXT_FRONT_END_ITEM})")
        return BasicPhonemizer()
    if language == "ja":
        raise NotImplementedError(f"the Japanese phonemizer is not ported yet "
                                  f"({TEXT_FRONT_END_ITEM})")
    raise ValueError(f"Unknown language {language!r}")
