"""Estimate a trigram LM for beam-search fusion from prepared text.

Reads the ``{ds}-[phone-]{split}.txt`` files that prepare_dataset
writes (``clipid|text`` lines), tokenizes each transcript with the
language's tokenizer, fits the dense trigram of text/ngram.py, and
saves it as an ``.npz`` that ``ASRPipeline(lm=...)`` loads. A copy of
``voice100_tpu/tools/train_lm.py`` over the port's ``text`` modules; the
file is the JAX package's, so either package's pipeline reads it.

Usage::

    python -m voice100_tpu_torch.tools.train_lm \
        --text data/ljspeech-train.txt [more.txt ...] \
        --language en [--use_phone] --output lm_en.npz
"""

from __future__ import annotations

from argparse import ArgumentParser

__all__ = ["cli_main"]


def cli_main(argv=None) -> None:
    parser = ArgumentParser(prog="voice100-tpu-torch-train-lm")
    parser.add_argument(
        "--text", nargs="+", required=True,
        help="prepared transcript files (clipid|text per line)",
    )
    parser.add_argument("--language", default="en")
    parser.add_argument("--use_phone", action="store_true")
    parser.add_argument("--output", required=True, help=".npz path")
    args = parser.parse_args(argv)

    from ..text import get_tokenizer
    from ..text.ngram import CharNgramLM

    tokenizer = get_tokenizer(args.language, args.use_phone)
    seqs = []
    for path in args.text:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                text = line.split("|", 1)[1] if "|" in line else line
                ids = list(tokenizer(text))
                if ids:
                    seqs.append(ids)
    lm = CharNgramLM.fit(seqs, vocab_size=tokenizer.vocab_size)
    lm.save(args.output)
    print(
        f"[train-lm] {len(seqs)} transcripts -> {args.output} "
        f"(vocab {tokenizer.vocab_size}, "
        f"table {lm.table.nbytes / 1e6:.2f} MB)"
    )


if __name__ == "__main__":
    cli_main()
