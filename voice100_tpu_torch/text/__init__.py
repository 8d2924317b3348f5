"""Host-side text processing: tokenizers and phonemizers (English
characters, CMU phones through G2P, and Japanese)."""

from .phonemizers import BasicPhonemizer, CMUPhonemizer, get_phonemizer
from .tokenizers import (CMU_VOCAB, DEFAULT_CHARACTERS, JA_VOCAB, BasicTokenizer, CharTokenizer,
                         get_tokenizer)

__all__ = ["DEFAULT_CHARACTERS", "CMU_VOCAB", "JA_VOCAB", "CharTokenizer", "BasicTokenizer",
           "get_tokenizer", "BasicPhonemizer", "CMUPhonemizer", "get_phonemizer"]
