"""Host-side text processing: the tokenizers ASR decoding needs."""

from .tokenizers import BasicTokenizer, CharTokenizer, get_tokenizer

__all__ = ["CharTokenizer", "BasicTokenizer", "get_tokenizer"]
