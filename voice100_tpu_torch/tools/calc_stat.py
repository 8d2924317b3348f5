"""WORLD feature statistics -> ``{ds}-stat.npz`` for the TTS model's norm.

Port of ``voice100_tpu/tools/calc_stat.py`` (the reference CLI,
voice100/calc_stat.py:24-80): the streaming masked mean and std, in
float64 on the host, of f0 (frames with f0 > 30), the log spectrum or
mel-cepstrum (every frame within the length) and codeap (frames with
codeap < -0.2, over the spectrum's frame count, as the reference has it)
over the predict loader of a WORLD ``AudioTextDataModule``. The keys are
the norm buffers' names (``f0_mean`` ... ``codeap_std``).

    python -m voice100_tpu_torch.tools.calc_stat --output stat.npz \\
        [--dataset ljspeech] [--vocoder world|world_mcep] [--data_dir ./data] \\
        [--cache_dir ./cache] [--device cpu]

The analysis runs on the host and fills the feature cache the TTS data
module reads. ``--device`` is the data module's (default ``cuda``,
which raises where CUDA is absent).
"""

from __future__ import annotations

from argparse import ArgumentParser

import numpy as np

__all__ = ["calc_stat", "cli_main"]


def calc_stat(data, output_path: str) -> dict:
    """Statistics over ``data``'s predict loader (``data.setup("predict")``
    first), written to ``output_path``; returns them."""
    f0_dim, spc_dim, codeap_dim = data.audio_transform.vocoder.output_dims
    assert f0_dim == 1
    f0_sum = f0_sqr = f0_cnt = 0.0
    spc_sum, spc_sqr, spc_cnt = np.zeros(spc_dim), np.zeros(spc_dim), 0.0
    cap_sum, cap_sqr = np.zeros(codeap_dim), np.zeros(codeap_dim)

    for (f0, f0_len, logspc, codeap), _ in data.predict_dataloader():
        mask = (np.arange(f0.shape[1])[None, :] < f0_len[:, None]).astype(np.float64)
        f0mask = (f0 > 30.0) * mask
        capmask = (codeap < -0.2) * mask[:, :, None]
        f0_sum += float((f0 * f0mask).sum())
        f0_sqr += float((f0**2 * f0mask).sum())
        f0_cnt += float(f0mask.sum())
        spc_sum += (logspc * mask[:, :, None]).sum(axis=(0, 1))
        spc_sqr += (logspc**2 * mask[:, :, None]).sum(axis=(0, 1))
        spc_cnt += float(mask.sum())
        cap_sum += (codeap * capmask).sum(axis=(0, 1))
        cap_sqr += (codeap**2 * capmask).sum(axis=(0, 1))

    def mean_std(s, sq, n):
        n = np.maximum(n, 1.0)
        mean = s / n
        return mean, np.sqrt(np.maximum(sq / n - mean**2, 1e-12))

    f0_mean, f0_std = mean_std(f0_sum, f0_sqr, f0_cnt)
    spc_mean, spc_std = mean_std(spc_sum, spc_sqr, spc_cnt)
    # codeap over the spectrum's count, as the reference (calc_stat.py:58)
    cap_mean, cap_std = mean_std(cap_sum, cap_sqr, spc_cnt)
    stats = {
        "f0_mean": np.asarray([f0_mean], np.float32),
        "f0_std": np.asarray([f0_std], np.float32),
        "logspc_mean": spc_mean.astype(np.float32),
        "logspc_std": spc_std.astype(np.float32),
        "codeap_mean": cap_mean.astype(np.float32),
        "codeap_std": cap_std.astype(np.float32),
    }
    np.savez(output_path, **stats)
    return stats


def cli_main(argv=None) -> None:
    from ..data import AudioTextDataModule

    parser = ArgumentParser(description="Make the WORLD stat file for TTS training")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--dataset", type=str, default="ljspeech")
    parser.add_argument("--vocoder", type=str, default="world", choices=["world", "world_mcep"])
    parser.add_argument("--language", type=str, default="en")
    parser.add_argument("--sample_rate", type=int, default=16000)
    parser.add_argument("--use_phone", action="store_true")
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--cache_dir", type=str, default="./cache")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--device", type=str, default=None,
                        help="the data module's device: cuda (default) or cpu")
    args = parser.parse_args(argv)
    data = AudioTextDataModule(
        vocoder=args.vocoder, dataset=args.dataset, sample_rate=args.sample_rate,
        language=args.language, use_align=True, use_phone=args.use_phone,
        data_dir=args.data_dir, cache_dir=args.cache_dir, batch_size=args.batch_size,
        device=args.device)
    data.setup("predict")
    calc_stat(data, args.output)
    print(f"[calc-stat] wrote {args.output}")


if __name__ == "__main__":
    cli_main()
