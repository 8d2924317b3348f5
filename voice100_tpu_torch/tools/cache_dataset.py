"""Warm the WORLD or log-mel feature cache by iterating the predict loader
once (port of ``voice100_tpu/tools/cache_dataset.py``).

    python -m voice100_tpu_torch.tools.cache_dataset --vocoder mel \
        --dataset ljspeech --data_dir ./data --cache_dir ./cache [--device cpu]

The JAX tool's flags, plus ``--device`` (default ``cuda``, which raises
without CUDA; ``cpu`` runs the plain PyTorch path): a cache miss of the
``mel`` vocoder runs the log-mel kernel there, and the WORLD analysis of
``world``/``world_mcep`` runs on the host. The entries are the JAX
package's: the same salts and files (``data/datamodule.py``).
"""

from __future__ import annotations

from argparse import ArgumentParser


def cli_main(argv=None) -> None:
    from ..data import AudioTextDataModule

    parser = ArgumentParser(prog="voice100-tpu-torch-cache-dataset")
    parser.add_argument("--vocoder", default="world", choices=["mel", "world", "world_mcep"])
    parser.add_argument("--dataset", default="ljspeech")
    parser.add_argument("--language", default="en")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--use_align", action="store_true")
    parser.add_argument("--use_phone", action="store_true")
    parser.add_argument("--data_dir", default="./data")
    parser.add_argument("--cache_dir", default="./cache")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu (the plain PyTorch path)")
    args = parser.parse_args(argv)

    data = AudioTextDataModule(vocoder=args.vocoder, dataset=args.dataset,
                               sample_rate=args.sample_rate, language=args.language,
                               use_align=args.use_align, use_phone=args.use_phone,
                               data_dir=args.data_dir, cache_dir=args.cache_dir,
                               batch_size=args.batch_size, device=args.device)
    data.setup("predict")
    loader = data.predict_dataloader()
    n = 0
    try:
        for _ in loader:
            n += 1
    finally:
        if hasattr(loader, "close"):
            loader.close()
    print(f"[cache-dataset] warmed cache over {n} batches")


if __name__ == "__main__":
    cli_main()
