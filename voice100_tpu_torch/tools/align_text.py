"""Batch forced alignment -> ``{ds}-[phone-]align-{split}.txt``.

Port of ``voice100_tpu/tools/align_text.py`` (the reference CLI,
voice100/align_text.py:12-57): runs the ASR model over the corpus,
Viterbi-aligns each clip to its text and writes ``text|aligntext|counts``
lines, counts being the frames spent in each of the ``2L + 1`` slots of
the blank-interleaved lattice. These files are what the TTS models train
on.

    python -m voice100_tpu_torch.tools.align_text --config config/asr_en_base.yaml \\
        --checkpoint CKPT [--data_dir ./data] [--cache_dir ./cache] [--device cpu]

The path of a batch: cached log-mel features (the fused log-mel kernel on
a cache miss), collate, upload, the model, log-softmax and the Viterbi
kernels (``AudioToAlignText.ctc_best_path``), then one host fetch of the
path, labels and logit lengths. It runs on ``cuda`` unless ``--device
cpu`` (or ``device="cpu"``) asks for the plain PyTorch path.
"""

from __future__ import annotations

import os
from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["run_align", "cli_main", "upload_batch", "fetch_alignment"]


def upload_batch(batch, device):
    """A collated batch on ``device``: ``(audio float32, audio_len, text,
    text_len)``; the features cross as they were cached (float16) and
    widen on the device."""
    (audio, audio_len), (text, text_len) = batch
    return (torch.from_numpy(audio).to(device).float(), torch.from_numpy(audio_len).to(device),
            torch.from_numpy(text).to(device), torch.from_numpy(text_len).to(device))


def fetch_alignment(res, logits_len: torch.Tensor):
    """``(path, labels, logits_len)`` as NumPy arrays, in one copy from
    the device."""
    time = res.path.shape[1]
    host = torch.cat([res.path, res.labels, logits_len.to(torch.int32)[:, None]], dim=1).cpu()
    host = host.numpy()
    return host[:, :time], host[:, time:2 * time], host[:, 2 * time]


def run_align(model, data, output_path: str, device=None) -> int:
    """Write align-text lines for every clip of ``data``'s predict loader
    (``data.setup("predict")`` first), with ``model`` on ``device``
    (default ``cuda``); returns the line count."""
    device = resolve_device(device)
    model = model.to(device).eval()
    tokenizer = data.text_transform
    n = 0
    with open(output_path, "w", encoding="utf-8") as f:
        for batch, n_real in data.predict_dataloader().iter_with_counts():
            _, (text, text_len) = batch
            res, logits_len = model.ctc_best_path(*upload_batch(batch, device))
            path, labels, logits_len = fetch_alignment(res, logits_len)
            # only the real rows: the loader fills the last batch by
            # repeating items, and duplicate lines would break the
            # downstream MergeDataset length checks
            for i in range(n_real):
                n_slots = 2 * int(text_len[i]) + 1
                hist = np.bincount(path[i, :logits_len[i]], minlength=n_slots)[:n_slots]
                raw_text = tokenizer.decode(text[i, :int(text_len[i])])
                aligntext = tokenizer.decode(labels[i, :logits_len[i]])
                counts = " ".join(str(int(c)) for c in hist)
                f.write(f"{raw_text}|{aligntext}|{counts}\n")
                n += 1
    return n


def cli_main(argv=None) -> None:
    from ..training.checkpoint import load_model_weights
    from ..training.cli import build_from_config, load_config

    parser = ArgumentParser()
    parser.add_argument("--config", required=True, help="model config YAML (asr_*)")
    parser.add_argument("--checkpoint", required=True, help="a checkpoint of the port")
    parser.add_argument("--data_dir", default="./data")
    parser.add_argument("--cache_dir", default="./cache")
    parser.add_argument("--dataset", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    overrides = {"data_dir": args.data_dir, "cache_dir": args.cache_dir,
                 "batch_size": args.batch_size}
    model, data = build_from_config(load_config(args.config),
                                    {k: v for k, v in overrides.items() if v is not None},
                                    device=args.device)
    if args.dataset:
        data.dataset = args.dataset
    load_model_weights(args.checkpoint, model)
    infix = "phone-align" if data.use_phone else "align"
    output = args.output or os.path.join(args.data_dir, f"{data.dataset}-{infix}-{args.split}.txt")
    data.setup("predict")
    n = run_align(model, data, output, device=args.device)
    print(f"[align-text] wrote {n} lines to {output}")


if __name__ == "__main__":
    cli_main()
