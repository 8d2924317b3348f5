"""Japanese phonemizer (Julius-style phones or romaji characters).

Behavioral parity with the reference JapanesePhonemizer
(voice100/japanese/__init__.py:17-45).
"""

from __future__ import annotations

import re

from .kana import kata2phoneme, hira2kata
from .yomi import text2kata

__all__ = ["JapanesePhonemizer", "text2kata", "kata2phoneme", "hira2kata"]

_CHOON_RX = re.compile(r"(.):")
_CLEAN_RX = re.compile(r"[^ a-z']")
_SPACES_RX = re.compile(r"\s+")


class JapanesePhonemizer:
    """Kana-kanji text -> phonemes.

    ``use_phone=True`` yields space-separated Julius phone tokens
    (JA_VOCAB); otherwise a romaji character string for CharTokenizer.
    """

    def __init__(self, use_phone: bool = False) -> None:
        self._use_phone = use_phone

    def __call__(self, text: str) -> str:
        text = kata2phoneme(text2kata(text))
        if self._use_phone:
            # Keep the moraic nasal N capitalized through lowercasing
            # (voice100/japanese/__init__.py:29-37).
            text = text.replace("N", "n'")
            text = text.lower()
            text = text.replace("n'", "N")
            text = text.replace("-", "")
            text = text.replace("c ", "k ")
            text = text.replace("x", "k")
            text = text.replace("v", "b")
            # unknown characters stay in the output as their own token
            # (reference parity, tests/test_text.py garbage case:
            # ★ survives phonemization and BasicTokenizer.encode drops
            # it) — phone corpora therefore may contain passthrough
            # junk exactly like the reference's prepare_dataset output
            return _SPACES_RX.sub(" ", text)
        # Character mode: romaji, with long vowels doubled and the moraic
        # nasal/gemination mapped into the 29-char vocabulary
        # (voice100/japanese/__init__.py:38-45).
        text = text.replace(" ", "")
        text = text.replace(",", " ")
        text = text.replace(".", " ")
        text = _CHOON_RX.sub(r"\1\1", text)
        text = text.replace("N", "n'")
        text = text.replace("q", "'")
        return _CLEAN_RX.sub("", text.lower())
