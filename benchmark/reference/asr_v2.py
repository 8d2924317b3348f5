"""Plain reference of ``asr_en_base`` (AudioToAlignText): conv encoder,
biLSTM, dense logits; its CTC training step with the spectrogram
augmentation (upstream voice100's BatchSpectrogramAugumentation, as the
JAX package ports it: each transform behind a coin of 0.2, then mixaudio
or maskaudio); and the served path from int16 PCM (log-mel, the blank
level past each clip's frames, the model)."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import (BLANK_AUDIO, LOG_OFFSET, TEXT_BUCKET, TIME_BUCKET, BiLSTMStack, conv_block,
                     conv_length, log_mel, pad_rows, sequence_mask, train_steps)

AUGMENT_RATE = 0.2
N_TIME_MASKS = 3


class ASRReference:
    def __init__(self, init_args: dict, weights: Dict[str, torch.Tensor]) -> None:
        self.args = init_args
        self.settings = [tuple(s) for s in init_args["encoder_settings"]]
        self.w = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()
                  if not n.startswith("lstm.")}
        self.lstm = BiLSTMStack(weights, "lstm.", int(init_args["decoder_num_layers"]))
        self.params = {**self.w, **self.lstm.names}

    def lengths(self, frames):
        for s in self.settings:
            frames = conv_length(frames, s)
        return frames

    def forward(self, audio, audio_len, train=False, generator=None):
        x = audio
        for i, s in enumerate(self.settings):
            x = conv_block(x, self.w, f"encoder.{i}.", s)
        x_len = self.lengths(audio_len)
        x = self.lstm(x, x_len, 0.2 if train else 0.0, generator)
        return F.linear(x, self.w["dense.weight"], self.w["dense.bias"]), x_len

    # -- serving --------------------------------------------------------------
    @torch.no_grad()
    def served_logits(self, clips: Sequence[np.ndarray], width: int, device):
        """Logits and lengths of int16 clips padded with zeros to ``width``
        samples, as a serving batch holds them."""
        pcm = np.zeros((len(clips), width), np.int16)
        for i, c in enumerate(clips):
            pcm[i, :len(c)] = c
        wav = torch.from_numpy(pcm).to(device).to(torch.float32) / 32768.0
        wav_len = torch.as_tensor([len(c) for c in clips], device=device)
        mel = log_mel(wav)
        mel_len = wav_len // 160 + 1
        mel = torch.where(sequence_mask(mel_len, mel.shape[1])[:, :, None], mel, BLANK_AUDIO)
        return self.forward(mel, mel_len)

    # -- training -------------------------------------------------------------
    def collate(self, items, device):
        audio, audio_len = pad_rows([f for f, _ in items], BLANK_AUDIO, TIME_BUCKET)
        text, text_len = pad_rows([t for _, t in items], 0, TEXT_BUCKET)
        to = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        return to(audio).float(), to(audio_len), to(text).long(), to(text_len)

    def loss(self, batch, generator):
        audio, audio_len, text, text_len = batch
        draws = draw_augment(generator, *audio.shape)
        audio, audio_len = apply_augment(audio, audio_len, draws)
        logits, logits_len = self.forward(audio, audio_len, True, generator)
        log_probs = torch.log_softmax(logits, dim=-1)
        return F.ctc_loss(log_probs.transpose(0, 1), text, logits_len, text_len, blank=0,
                          reduction="mean", zero_infinity=True)

    def train(self, batches: List, generator, lr: float, clip: float):
        device = next(iter(self.params.values())).device
        collated = [self.collate(items, device) for items in batches]
        return train_steps(self.params, lambda b: self.loss(b, generator), collated, lr, clip)


def draw_augment(generator: torch.Generator, batch: int, time: int, dim: int) -> dict:
    """Every draw of one augmented batch, in the trained model's order."""
    device = generator.device

    def coin():
        return torch.rand((), generator=generator, device=device) < AUGMENT_RATE

    def uniform(lo, hi, shape=()):
        u = torch.rand(shape, generator=generator, device=device)
        return torch.clamp(u * (hi - lo) + lo, min=lo)

    def randint(lo, hi, shape=()):
        return torch.randint(lo, hi, shape, generator=generator, device=device)

    d = {}
    d["stretch_coin"] = coin()
    d["stretch_rate"] = randint(50, 150)
    d["pitch_coin"] = coin()
    d["pitch_rate"] = 1.0 + uniform(0.0, 0.2)
    d["amp_coin"] = coin()
    d["amp"] = 1.0 + uniform(0.0, 3.0)
    d["tmask_coin"] = coin()
    d["tmask_n"] = randint(1, N_TIME_MASKS + 1)
    d["tmask_center"] = randint(0, time, (N_TIME_MASKS,))
    d["tmask_hw"] = randint(1, 4, (N_TIME_MASKS,))
    d["tmask_val"] = uniform(-BLANK_AUDIO, -5.0, (N_TIME_MASKS,))
    d["fmask_coin"] = coin()
    d["fmask_center"] = randint(0, dim)
    d["fmask_hw"] = randint(1, 11)
    d["fmask_val"] = uniform(-BLANK_AUDIO, -5.0)
    d["noise_coin"] = coin()
    d["noise_low"] = -5.0 + 5.0 * uniform(0.0, 1.0)
    d["noise_high"] = -5.0 + 5.0 * uniform(0.0, 1.0)
    d["noise_std"] = 5.0 * uniform(0.0, 1.0)
    d["noise"] = uniform(0.0, 1.0, (batch, time, dim))
    d["mix_coin"] = coin()
    return d


def apply_augment(audio, audio_len, d) -> Tuple[torch.Tensor, torch.Tensor]:
    _, time, dim = audio.shape
    device = audio.device
    rate = d["stretch_rate"]
    t_idx = torch.arange(time, device=device)
    src = torch.clamp(t_idx * 100 // rate, 0, time - 1)
    new_len = torch.clamp(audio_len * rate // 100, max=time)
    audio = torch.where(d["stretch_coin"], audio.index_select(1, src), audio)
    audio_len = torch.where(d["stretch_coin"], new_len.to(audio_len.dtype), audio_len)

    f_idx = torch.arange(dim, device=device)
    src = torch.clamp((f_idx.to(torch.float32) * d["pitch_rate"]).to(torch.int64), 0, dim - 1)
    audio = torch.where(d["pitch_coin"], audio.index_select(2, src), audio)

    audio = torch.where(d["amp_coin"], audio - d["amp"], audio)

    masked = audio
    for m in range(N_TIME_MASKS):
        center, hw = d["tmask_center"][m], d["tmask_hw"][m]
        band = (t_idx >= center - hw) & (t_idx < center + hw) & (m < d["tmask_n"])
        masked = torch.where(band[None, :, None], d["tmask_val"][m], masked)
    audio = torch.where(d["tmask_coin"], masked, audio)

    band = (f_idx >= d["fmask_center"] - d["fmask_hw"]) & (f_idx < d["fmask_center"] + d["fmask_hw"])
    audio = torch.where(d["fmask_coin"] & band[None, None, :], d["fmask_val"], audio)

    step = torch.arange(dim, device=device, dtype=torch.float32) / max(dim - 1, 1)
    scale = d["noise_low"] * (1.0 - step) + d["noise_high"] * step
    scale[-1] = d["noise_high"]
    noise = d["noise"] * d["noise_std"] + scale
    mixed = torch.log(torch.clamp(torch.exp(audio) + torch.exp(noise), min=LOG_OFFSET))
    audio = torch.where(d["noise_coin"], mixed, audio)

    mask = (t_idx[None, :, None] < audio_len[:, None, None]).to(audio.dtype)
    x = torch.exp(audio) * mask
    rolled = torch.roll(x, shifts=-1, dims=0)
    mixed = torch.log(torch.clamp((0.9 * x + 0.1 * rolled) * mask, min=LOG_OFFSET))
    masked = torch.log(torch.clamp(x, min=LOG_OFFSET))
    return torch.where(d["mix_coin"], mixed, masked), audio_len
