"""Character and phone tokenizers.

Behavioral parity with the reference tokenizers
(voice100/text.py:74-145): same vocabularies (29 chars / 71 CMU phones /
44 Julius phones), blank at index 0, unknown symbols silently dropped on
encode and decode, and the same CTC ``merge_repeated`` collapse rules.

Host-side text processing is plain Python/NumPy. A copy of
``voice100_tpu/text/tokenizers.py``: the port imports nothing of the JAX
package.
"""

from __future__ import annotations

import re
from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "DEFAULT_CHARACTERS",
    "CMU_VOCAB",
    "JA_VOCAB",
    "CharTokenizer",
    "BasicTokenizer",
    "get_tokenizer",
]

# 29 symbols; blank "_" at index 0 (reference voice100/text.py:14-17).
DEFAULT_CHARACTERS = "_ abcdefghijklmnopqrstuvwxyz'"

# 71 CMU phones incl. blank "_" (reference voice100/text.py:19-31).
CMU_VOCAB = [
    "_",
    "AA0", "AA1", "AA2", "AE0", "AE1", "AE2", "AH0", "AH1", "AH2", "AO0",
    "AO1", "AO2", "AW0", "AW1", "AW2", "AY0", "AY1", "AY2", "B", "CH", "D",
    "DH",
    "EH0", "EH1", "EH2", "ER0", "ER1", "ER2", "EY0", "EY1",
    "EY2", "F", "G", "HH",
    "IH0", "IH1", "IH2", "IY0", "IY1", "IY2", "JH", "K", "L",
    "M", "N", "NG", "OW0", "OW1",
    "OW2", "OY0", "OY1", "OY2", "P", "R", "S", "SH", "T", "TH",
    "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

# 44 Julius-style phones incl. blank "-" (reference voice100/text.py:33-39).
JA_VOCAB = [
    "-", "!", ",", ".", "?", "N", "a", "a:", "b", "by",
    "ch", "d", "e", "e:", "f", "g", "gy", "h", "hy", "i",
    "i:", "j", "k", "ky", "m", "my", "n", "ny", "o", "o:",
    "p", "py", "q", "r", "ry", "s", "sh", "t", "ts", "u",
    "u:", "w", "y", "z",
]

assert len(DEFAULT_CHARACTERS) == 29
assert len(CMU_VOCAB) == 71
assert len(JA_VOCAB) == 44

_REPEATED_CHAR_RX = re.compile(r"(.)\1+")

IntArray = np.ndarray


class CharTokenizer:
    """One character per token.

    Same encode/decode/merge semantics as the reference CharTokenizer
    (voice100/text.py:74-104).
    """

    def __init__(self, vocab: Optional[Union[str, Sequence[str]]] = None) -> None:
        if vocab is None:
            vocab = DEFAULT_CHARACTERS
        self._vocab: List[str] = list(vocab)
        self.vocab_size = len(self._vocab)
        self._v2i = {ch: i for i, ch in enumerate(self._vocab)}

    def __call__(self, text: str) -> IntArray:
        return self.encode(text)

    def encode(self, text: str) -> IntArray:
        ids = [self._v2i[ch] for ch in text if ch in self._v2i]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, encoded: Sequence[int]) -> str:
        return "".join(
            self._vocab[int(i)] for i in encoded if 0 <= int(i) < self.vocab_size
        )

    def merge_repeated(self, text: str) -> str:
        """Collapse CTC repeats, then drop blanks (voice100/text.py:99-104)."""
        text = _REPEATED_CHAR_RX.sub(r"\1", text)
        text = text.replace(self._vocab[0], "")
        return "" if text == " " else text


class BasicTokenizer:
    """Phone tokenizer over separator-joined phone strings.

    EN uses the CMU vocab with "/" separators; JA uses the Julius vocab
    with spaces (voice100/text.py:107-145).
    """

    def __init__(self, language: str) -> None:
        if language == "en":
            vocab, separator = CMU_VOCAB, "/"
        elif language == "ja":
            vocab, separator = JA_VOCAB, " "
        else:
            raise ValueError(f"Unsupported language: {language!r}")
        self._vocab = list(vocab)
        self._separator = separator
        self.vocab_size = len(self._vocab)
        self._v2i = {p: i for i, p in enumerate(self._vocab)}

    def __call__(self, text: str) -> IntArray:
        return self.encode(text)

    def encode(self, text: str) -> IntArray:
        ids = [
            self._v2i[tok]
            for tok in text.split(self._separator)
            if tok in self._v2i
        ]
        return np.asarray(ids, dtype=np.int32)

    def decode(self, encoded: Sequence[int]) -> str:
        return self._separator.join(
            self._vocab[int(i)] for i in encoded if 0 <= int(i) < self.vocab_size
        )

    def merge_repeated(self, text: str) -> str:
        """CTC collapse: dedup consecutive tokens, then drop blanks.

        Equivalent to the reference's two-regex pipeline
        (voice100/text.py:140-145): repeats are collapsed *before* blank
        removal, so duplicates separated by a blank survive.
        """
        merged: List[str] = []
        for tok in text.split(self._separator):
            if not merged or merged[-1] != tok:
                merged.append(tok)
        blank = self._vocab[0]
        return self._separator.join(t for t in merged if t != blank)


def get_tokenizer(language: str, use_phone: bool) -> Union[CharTokenizer, BasicTokenizer]:
    """Tokenizer factory (reference voice100/data_modules.py:427-430)."""
    if use_phone:
        return BasicTokenizer(language=language)
    return CharTokenizer()
