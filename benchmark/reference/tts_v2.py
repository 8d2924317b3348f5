"""Plain reference of ``tts_en_base`` (AlignTextToAudio): embedding,
biLSTM with dropout between layers, the conv decoder (x2 in time by its
transposed conv), the projection split into hasf0, f0, mel-cepstrum,
hascodeap and codeap; the masked WORLD loss v2 against targets
normalised by the statistics the benchmark computed, summed with the
spectrum weighted 5."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from .common import TEXT_BUCKET, TIME_BUCKET, BiLSTMStack, conv_block, pad_rows, sequence_mask, \
    train_steps

LOGSPC_WEIGHT = 5.0


def _bce(logits, labels):
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


class TTSReference:
    def __init__(self, init_args: dict, weights: Dict[str, torch.Tensor],
                 stats: Dict[str, torch.Tensor]) -> None:
        self.args = init_args
        self.settings = [tuple(s) for s in init_args["decoder_settings"]]
        self.stats = stats
        self.w = {n: t.detach().clone().requires_grad_(True) for n, t in weights.items()
                  if not n.startswith("lstm.")}
        self.lstm = BiLSTMStack(weights, "lstm.", int(init_args["encoder_num_layers"]))
        self.params = {**self.w, **self.lstm.names}

    def forward(self, text, text_len, train=False, generator=None):
        x = F.embedding(text, self.w["embedding.weight"])
        x = self.lstm(x, text_len, 0.2 if train else 0.0, generator)
        for i, s in enumerate(self.settings):
            x = conv_block(x, self.w, f"decoder.{i}.", s)
        x = F.linear(x, self.w["projection.weight"], self.w["projection.bias"])
        f, s, c = (int(self.args[k]) for k in ("f0_size", "logspc_size", "codeap_size"))
        return (x[:, :, 0], x[:, :, f], x[:, :, 2 * f:2 * f + s],
                x[:, :, 2 * f + s:2 * f + s + c], x[:, :, 2 * f + s + c:])

    def collate(self, items, device):
        f0, f0_len = pad_rows([i[0][0] for i in items], 0.0, TIME_BUCKET)
        mc, _ = pad_rows([i[0][1] for i in items], 0.0, TIME_BUCKET)
        cap, _ = pad_rows([i[0][2] for i in items], 0.0, TIME_BUCKET)
        text, text_len = pad_rows([i[1] for i in items], 0, TEXT_BUCKET)
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
        return to(f0).float(), to(f0_len), to(mc).float(), to(cap).float(), to(text).long(), \
            to(text_len)

    def loss(self, batch, generator):
        f0, f0_len, mc, cap, text, text_len = batch
        st = self.stats
        hasf0 = (f0 >= 30.0).float()
        hascap = (cap < -0.2).float()
        f0n = (f0 - st["f0_mean"]) / st["f0_std"]
        mcn = (mc - st["logspc_mean"]) / st["logspc_std"]
        capn = (cap - st["codeap_mean"]) / st["codeap_std"]
        hasf0_hat, f0_hat, mc_hat, hascap_hat, cap_hat = self.forward(text, text_len, True,
                                                                      generator)
        n = min(f0.shape[1], f0_hat.shape[1])
        mask = sequence_mask(f0_len, n).float()
        mask_sum = torch.clamp(mask.sum(), min=1.0)
        hasf0_loss = (_bce(hasf0_hat[:, :n], hasf0[:, :n]) * mask).sum() / mask_sum
        f0_loss = ((f0_hat[:, :n] - f0n[:, :n]) ** 2 * hasf0[:, :n] * mask).sum() / mask_sum
        mc_loss = (((mc_hat[:, :n] - mcn[:, :n]) ** 2).mean(dim=2) * mask).sum() / mask_sum
        hascap_loss = (_bce(hascap_hat[:, :n], hascap[:, :n]).mean(dim=2) * mask).sum() / mask_sum
        cap_loss = ((((cap_hat[:, :n] - capn[:, :n]) ** 2) * hascap[:, :n]).mean(dim=2)
                    * mask).sum() / mask_sum
        return hasf0_loss + f0_loss + LOGSPC_WEIGHT * mc_loss + hascap_loss + cap_loss

    def train(self, batches: List, generator, lr: float, clip: float):
        device = next(iter(self.params.values())).device
        collated = [self.collate(items, device) for items in batches]
        return train_steps(self.params, lambda b: self.loss(b, generator), collated, lr, clip)
