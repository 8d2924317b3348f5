"""Drive the PyTorch/CUDA port (voice100_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (nvcc under $CUDA_HOME, default /usr/local/cuda). In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the serving path from voice100_tpu_torch/csrc/
   with nvcc, all sources at once (set-up, timed);
3. holds the fused log-mel kernel against its plain PyTorch version on
   the card at 8 x 10 s, and times kernel, plain and torch.stft;
4. holds the biLSTM recurrence kernel against its plain version at
   B=8, T=501, H=512 for both layer widths of asr_en_base (input 512 and
   1024) with ragged lengths, and times kernel, plain and cuDNN nn.LSTM;
5. serves asr_en_base end to end through ASRPipeline on the card (16
   int16 clips of 2-10 s, batch 8, seeded random weights), with the
   kernels' launch counts set to 0 just before and read just after,
   holds its logits and greedy ids against the same pipeline on the CPU,
   and its transcripts to those greedy ids;
6. prints one JSON line of per-kernel results, then, last,
   {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed. Without
CUDA, or without the voice100_tpu_torch package beside it, it exits
non-zero at once. Times are CUDA-event times with the L2 cache warm; the
bounds use the H100 SXM data sheet's peaks (67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s HBM), which assume a 700 W power limit.
"""

from __future__ import annotations

import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SAMPLE_RATE = 16000
BATCH = 8
# config/asr_en_base.yaml, at full width
ASR_EN_BASE = dict(
    audio_size=64,
    vocab_size=29,
    encoder_settings=((512, False, 5, 2, 2, False), (512, False, 5, 1, 2, False)),
    decoder_num_layers=2,
    decoder_hidden_size=512,
)
# Tolerances, max abs error, both sides float32 on the card.
# log-mel: sums of 512 taps in another order (window folded into the DFT
# constants); the plain float32 path is 4.7e-5 from float64 at 8 x 10 s.
MEL_TOL = 1e-3
# biLSTM outputs lie in [-1, 1]; 512-term dot products in another order,
# carried through 501 steps of a contracting recurrence.
LSTM_TOL = 1e-4
# logits end to end, card vs CPU: the two differences above through the
# conv encoder, LayerNorm and two biLSTM layers. Greedy ids are compared
# where the top-2 margin exceeds 2 * LOGIT_TOL, where no flip is possible.
LOGIT_TOL = 2e-3
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def fail(message: str) -> None:
    print(f"chip_smoke: FAIL: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def int16_clips(rng, seconds):
    """Noise bursts under a slow envelope, as int16 PCM."""
    clips = []
    for sec in seconds:
        n = int(sec * SAMPLE_RATE)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * np.arange(n) / SAMPLE_RATE)
        clips.append((rng.standard_normal(n) * 4000 * env).clip(-32768, 32767).astype(np.int16))
    return clips


def check_melspec(device):
    from voice100_tpu_torch.ops.melspec import log_mel_spectrogram, mel_filterbank
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    rng = np.random.default_rng(SEED)
    pcm = np.stack(int16_clips(rng, [10.0] * BATCH))
    wav = torch.from_numpy(pcm).to(device).float() * (1.0 / 32768.0)
    got = log_mel_spectrogram_cuda(wav)
    ref = log_mel_spectrogram(wav)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        fail(f"log-mel kernel: shape {tuple(got.shape)} or non-finite values")
    err = (got - ref).abs().max().item()

    window = torch.hann_window(400, periodic=True, device=device)
    fb = torch.from_numpy(mel_filterbank(257, 64, SAMPLE_RATE)).to(device)

    def library():
        spec = torch.stft(wav, 512, 160, 400, window, center=True, pad_mode="reflect",
                          return_complex=True)
        power = spec.real ** 2 + spec.imag ** 2                    # [B, 257, F]
        return torch.log(power.transpose(1, 2) @ fb + 1e-6)

    library_err = (library() - ref).abs().max().item()
    ms = time_ms(lambda: log_mel_spectrogram_cuda(wav), iters=20)
    plain_ms = time_ms(lambda: log_mel_spectrogram(wav), iters=20)
    library_ms = time_ms(library, iters=20)
    rows = got.shape[0] * got.shape[1]
    # The least work of the function, not of this kernel's design (which
    # does the DFT as two dense 512 x 257 products, ~4.2 GFLOP here): a
    # window of 400 taps, a 512-point real FFT (~2.5 N log2 N flops), the
    # power of 257 bins, the filterbank's nonzero entries, 64 logs. Bytes:
    # the waveform read and the features written once, and the window and
    # filterbank nonzeros.
    fb_nnz = int((fb != 0).sum())
    n_bytes = (wav.numel() + rows * 64 + 400 + fb_nnz) * 4
    n_ops = rows * (400 + 2.5 * 512 * 9 + 3 * 257 + 2 * fb_nnz + 64)
    bound, bound_by = bound_ms(n_bytes, n_ops)
    print(f"log-mel {BATCH} x 10 s ({rows} frames): max_abs_err {err:.3e} (tol {MEL_TOL:.0e}), "
          f"torch.stft vs plain {library_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"torch.stft {library_ms:.4f} ms, bound {bound:.4f} ms ({bound_by})", flush=True)
    if not err <= MEL_TOL:
        fail(f"log-mel kernel disagrees with the plain version: {err:.3e} > {MEL_TOL:.0e}")
    return {
        "name": "log_mel", "route": "cuda", "source": "voice100_tpu_torch/csrc/melspec.cu",
        "replaces": "voice100_tpu/ops/melspec_pallas.py:64", "launches": None,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": library_ms,
    }


def check_bilstm(device):
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import bilstm
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda

    hidden, time_steps = 512, 501
    lengths_list = [501, 463, 420, 377, 250, 128, 17, 1]
    module = BiLSTM(512, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    total = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    for layer, params in enumerate(module.stacked_layers()):
        d_in = params[0].shape[2]
        x = torch.randn(BATCH, time_steps, d_in, device=device, generator=gen)
        with torch.no_grad():
            got = bilstm_cuda(*params, x, lengths)
            ref = bilstm(*params, x, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"biLSTM kernel layer {layer}: non-finite outputs")
            err = (got - ref).abs().max().item()

            lstm = torch.nn.LSTM(d_in, hidden, bidirectional=True, batch_first=True,
                                 device=device)
            for suffix in ("", "_reverse"):
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    getattr(lstm, f"{name}_l0{suffix}").copy_(
                        getattr(module, f"{name}_l{layer}{suffix}"))
            cpu_lengths = lengths.cpu()

            def library():
                packed = torch.nn.utils.rnn.pack_padded_sequence(
                    x, cpu_lengths, batch_first=True, enforce_sorted=False)
                out, _ = lstm(packed)
                return torch.nn.utils.rnn.pad_packed_sequence(
                    out, batch_first=True, total_length=time_steps)[0]

            library_err = (library() - ref).abs().max().item()
            ms = time_ms(lambda: bilstm_cuda(*params, x, lengths), iters=5)
            plain_ms = time_ms(lambda: bilstm(*params, x, lengths), iters=3, warmup=1)
            library_ms = time_ms(library, iters=5)
        valid = sum(lengths_list)
        n_bytes = (x.numel() + 2 * 4 * hidden * (d_in + hidden + 2) + BATCH * time_steps
                   * 2 * hidden) * 4 + BATCH * 4
        # the work these lengths need: projections and recurrence of valid steps only
        n_ops = 2 * 2 * valid * 4 * hidden * (d_in + hidden)
        bound, bound_by = bound_ms(n_bytes, n_ops)
        print(f"biLSTM layer {layer} (B={BATCH}, T={time_steps}, D={d_in}, H={hidden}): "
              f"max_abs_err {err:.3e} (tol {LSTM_TOL:.0e}), nn.LSTM vs plain {library_err:.3e}; "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, nn.LSTM {library_ms:.3f} ms, "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        if not err <= LSTM_TOL:
            fail(f"biLSTM kernel layer {layer} disagrees with the plain version: "
                 f"{err:.3e} > {LSTM_TOL:.0e}")
        total["err"] = max(total["err"], err)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("bytes", n_bytes), ("ops", n_ops)):
            total[key] += value
    bound, bound_by = bound_ms(total["bytes"], total["ops"])
    return {
        "name": "bilstm_recurrence", "route": "cuda",
        "source": "voice100_tpu_torch/csrc/bilstm.cu",
        "replaces": "voice100_tpu/ops/lstm_pallas.py:41", "launches": None,
        "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": total["library_ms"],
        "shapes": "both layers of one 8 x 10 s batch: B=8, T=501, H=512, D=512 then 1024",
    }


def serve(device, card):
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    cpu_pipe = ASRPipeline(model, batch_size=BATCH, device="cpu")
    gpu_pipe = ASRPipeline(copy.deepcopy(model), batch_size=BATCH, device=device)
    rng = np.random.default_rng(SEED)
    clips = int16_clips(rng, rng.uniform(2.0, 10.0, size=16))
    audio_sec = sum(len(c) for c in clips) / SAMPLE_RATE

    gpu_pipe.transcribe(clips)  # warm-up: constants, cuDNN plans
    torch.cuda.synchronize()
    log_mel_spectrogram_cuda.launches = 0
    bilstm_cuda.launches = 0
    start = time.perf_counter()
    texts = gpu_pipe.transcribe(clips)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = {"log_mel": log_mel_spectrogram_cuda.launches,
                "bilstm_recurrence": bilstm_cuda.launches}
    print(f"serve asr_en_base: {len(clips)} clips, {audio_sec:.2f} s of audio, batch {BATCH}: "
          f"transcribe {wall * 1e3:.2f} ms, RTF {audio_sec / wall:.1f}x on {card}; "
          f"launches {launches}", flush=True)
    for name, count in launches.items():
        if count == 0:
            fail(f"the serving path never launched the {name} kernel")

    start = time.perf_counter()
    cpu_texts = cpu_pipe.transcribe(clips)
    cpu_wall = time.perf_counter() - start

    worst, frames, compared = 0.0, 0, 0
    tokenizer = gpu_pipe.tokenizer
    for (chunk, wav, lens), (_, cwav, clens) in zip(gpu_pipe.batches(clips),
                                                     cpu_pipe.batches(clips)):
        logits, n = gpu_pipe.logits(wav, lens)
        ref, ref_n = cpu_pipe.logits(cwav, clens)
        logits, n = logits.cpu(), n.cpu()
        if not torch.isfinite(logits).all() or logits.shape[-1] != ASR_EN_BASE["vocab_size"]:
            fail(f"serve: logits of shape {tuple(logits.shape)} or non-finite")
        if not torch.equal(n, ref_n):
            fail("serve: logit lengths differ between card and CPU")
        for row in range(len(chunk)):
            a, b = logits[row, :n[row]], ref[row, :n[row]]
            worst = max(worst, (a - b).abs().max().item())
            top2 = b.topk(2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * LOGIT_TOL
            frames += int(n[row])
            compared += int(clear.sum())
            if not torch.equal(a.argmax(-1)[clear], b.argmax(-1)[clear]):
                fail(f"serve: greedy ids differ from the CPU path in clip {chunk[row]}")
            # the timed call's transcript is the one these checked ids give
            ids = a.argmax(-1).numpy()
            if texts[chunk[row]] != tokenizer.merge_repeated(tokenizer.decode(ids)):
                fail(f"serve: the timed transcript of clip {chunk[row]} is not the "
                     f"one its checked greedy ids give")
    same = sum(a == b for a, b in zip(texts, cpu_texts))
    print(f"serve vs CPU plain path: logits max_abs_err {worst:.3e} (tol {LOGIT_TOL:.0e}); "
          f"greedy ids equal on {compared}/{frames} frames with margin > {2 * LOGIT_TOL:.0e}; "
          f"timed transcripts equal the CPU path's {same}/{len(texts)}; "
          f"CPU transcribe {cpu_wall * 1e3:.1f} ms", flush=True)
    if not worst <= LOGIT_TOL:
        fail(f"serve: logits differ from the CPU path by {worst:.3e} > {LOGIT_TOL:.0e}")
    if compared < frames // 2:
        fail(f"serve: only {compared}/{frames} frames have a clear top-2 margin")
    stages(gpu_pipe, clips)
    return launches


def stages(pipe, clips):
    """Card time of each layer on the 10 s batch (CUDA events)."""
    from voice100_tpu_torch.models.layers import conv_stack_output_length

    chunk, wav, lens = list(pipe.batches(clips))[-1]
    model = pipe.model
    with torch.inference_mode():
        mel, mel_len = pipe._features(wav, lens)
        x = model.encoder(mel)
        x_len = conv_stack_output_length(model.encoder_settings, mel_len)
        h = model.lstm(x, x_len)
        parts = {
            "upload_int16": time_ms(lambda: torch.from_numpy(
                np.zeros(tuple(wav.shape), np.int16)).to(wav.device)),
            "features": time_ms(lambda: pipe._features(wav, lens)),
            "conv_encoder": time_ms(lambda: model.encoder(mel)),
            "bilstm": time_ms(lambda: model.lstm(x, x_len), iters=5),
            "dense_argmax": time_ms(lambda: model.dense(h).argmax(-1)),
        }
        # host time to enqueue the biLSTM's 2 x 501 launches: when it is
        # close to the card time above, the card waits on the host loop
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(5):
            model.lstm(x, x_len)
        parts["bilstm_host_enqueue"] = (time.perf_counter() - start) * 1e3 / 5
        torch.cuda.synchronize()
    print("stages_ms " + json.dumps({"batch": list(wav.shape), **parts}), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    try:
        from voice100_tpu_torch.device import resolve_device
        from voice100_tpu_torch.kernels import build
    except ImportError as err:
        fail(f"the voice100_tpu_torch package is missing: {err}")

    card = card_line()
    print(card, flush=True)
    start = time.perf_counter()
    report = build.build()
    for name, info in report.items():
        ptxas = [line.strip() for line in info["log"].splitlines()
                 if "registers" in line or "spill" in line]
        print(f"built {name} in {info['seconds']:.1f} s: " + " | ".join(ptxas), flush=True)
    print(f"kernel build: {time.perf_counter() - start:.1f} s", flush=True)

    device = resolve_device("cuda")
    kernels = [check_melspec(device), check_bilstm(device)]
    launches = serve(device, card)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
