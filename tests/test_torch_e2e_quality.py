"""End-to-end learning quality of the port (CPU), the counterpart of
tests/test_e2e_quality.py:37: overfit the narrow ASR model on the dummy
corpus through the training CLI (``fit --device cpu``), then transcribe
the training clips with ``ASRPipeline`` and force-align them with
``tools/align_text``, both from the checkpoint the fit wrote.

The JAX test takes 400 full-batch Adam steps without augmentation; the
CLI's ``fit`` always augments, so it runs 1000 epochs of one batch at the
same learning rate (3e-3). The thresholds are the JAX test's: the loss
without augmentation (``test`` on the checkpoint) under 0.35 and the mean
of the clips' character error rates under 0.25. The weights are trained
here; nothing is downloaded.
"""

import os

import numpy as np
import pytest
import yaml

from corpus_fixture import make_dummy_corpus

EPOCHS = 1000


@pytest.mark.slow
def test_overfit_asr_through_the_cli_then_transcribe_and_align(tmp_path):
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.ops.metrics import levenshtein
    from voice100_tpu_torch.tools.align_text import cli_main as align_cli
    from voice100_tpu_torch.training import load_model_weights
    from voice100_tpu_torch.training.cli import build_from_config, load_config, main

    data_dir = str(tmp_path / "data")
    make_dummy_corpus(data_dir, n_clips=4)
    cfg = str(tmp_path / "overfit.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({
            "seed_everything": 1234,
            "trainer": {"max_epochs": EPOCHS, "gradient_clip_val": 1.0,
                        "log_every_n_steps": 100,
                        "callbacks": [{"class_path": "voice100_tpu.training.ModelCheckpoint",
                                       "init_args": {"monitor": "train_loss",
                                                     "every_n_epochs": EPOCHS}}]},
            "model": {"class_path": "voice100_tpu.models.AudioToAlignText",
                      "init_args": {"vocab_size": 29, "audio_size": 64,
                                    "encoder_settings": [[64, False, 3, 2, 1, False]],
                                    "decoder_num_layers": 1, "decoder_hidden_size": 64,
                                    "learning_rate": 3e-3}},
            "data": {"class_path": "voice100_tpu.data.AudioTextDataModule",
                     "init_args": {"vocoder": "mel", "dataset": "dummy_en", "language": "en",
                                   "batch_size": 4, "valid_ratio": 0.0}},
        }, f)
    common = ["--config", cfg, "--data_dir", data_dir, "--cache_dir", str(tmp_path / "cache"),
              "--checkpoint_dir", str(tmp_path / "ckpt"), "--device", "cpu"]
    main(["fit", *common])
    # last.pt: best.pt follows the augmented train loss, which an epoch
    # whose stretch makes every row infeasible takes to 0
    last = str(tmp_path / "ckpt" / "last.pt")
    final = main(["test", *common, "--restore_from", last])
    assert final["loss"] < 0.35, final

    model, _ = build_from_config(load_config(cfg), {}, device="cpu")
    load_model_weights(last, model)
    pipe = ASRPipeline(model, batch_size=4, buckets_sec=(2.0,), device="cpu")
    root = os.path.join(data_dir, "dummy-speech-en")
    with open(os.path.join(root, "metadata.csv")) as f:
        rows = [line.strip().split("|") for line in f]
    wavs = [load_audio(os.path.join(root, "wavs", clipid + ".wav")) for clipid, _, _ in rows]
    refs = [text for _, text, _ in rows]
    hyps = pipe.transcribe(wavs)
    cers = [levenshtein(h, r) / max(len(r), 1) for h, r in zip(hyps, refs)]
    assert float(np.mean(cers)) < 0.25, list(zip(hyps, refs))

    out = str(tmp_path / "dummy_en-align-train.txt")
    align_cli(["--config", cfg, "--checkpoint", last, "--data_dir", data_dir,
               "--cache_dir", str(tmp_path / "cache"), "--output", out, "--device", "cpu"])
    lines = open(out).read().splitlines()
    assert [ln.split("|")[0] for ln in lines] == refs
    for ln in lines:
        text, aligntext, counts = ln.split("|")
        counts = [int(c) for c in counts.split()]
        assert len(counts) == 2 * len(text) + 1 and sum(counts) == len(aligntext) > 0
