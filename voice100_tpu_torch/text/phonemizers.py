"""English and Japanese phonemizers.

Port of ``voice100_tpu/text/phonemizers.py``: ``BasicPhonemizer`` (the
reference's voice100/text.py:47-56), which character models
(``use_phone: false``) read, ``CMUPhonemizer`` (voice100/text.py:59-71),
English G2P to CMU phones through :class:`voice100_tpu_torch.text.g2p.G2P`,
and the Japanese reader (:mod:`voice100_tpu_torch.text.japanese`).
"""

from __future__ import annotations

import re
from typing import Optional

from .g2p import G2P

__all__ = ["BasicPhonemizer", "CMUPhonemizer", "get_phonemizer"]

_NOT_DEFAULT_CHARACTERS_RX = re.compile(r"[^ abcdefghijklmnopqrstuvwxyz']")


class BasicPhonemizer:
    """Lowercase and strip everything outside ``[a-z ']``."""

    def __call__(self, text: str) -> str:
        return _NOT_DEFAULT_CHARACTERS_RX.sub("", text.lower())


class CMUPhonemizer:
    """English G2P to CMU phones joined with ``/``."""

    def __init__(self, lexicon_path: Optional[str] = None) -> None:
        self._g2p = G2P(lexicon_path=lexicon_path)

    def __call__(self, text: str) -> str:
        return "/".join(self._g2p(text))


def get_phonemizer(language: str, use_phone: bool):
    """Phonemizer factory (reference voice100/prepare_dataset.py:10-22)."""
    if language == "en":
        return CMUPhonemizer() if use_phone else BasicPhonemizer()
    if language == "ja":
        from .japanese import JapanesePhonemizer

        return JapanesePhonemizer(use_phone=use_phone)
    raise ValueError(f"Unknown language {language!r}")
