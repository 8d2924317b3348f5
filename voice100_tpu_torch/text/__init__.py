"""Host-side text processing: tokenizers and the English character
phonemizer."""

from .phonemizers import BasicPhonemizer, get_phonemizer
from .tokenizers import BasicTokenizer, CharTokenizer, get_tokenizer

__all__ = ["CharTokenizer", "BasicTokenizer", "get_tokenizer", "BasicPhonemizer",
           "get_phonemizer"]
