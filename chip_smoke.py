"""Drive the PyTorch/CUDA port (voice100_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root on a machine with a CUDA card and the CUDA
toolkit (nvcc under $CUDA_HOME, default /usr/local/cuda). In order:

1. prints the card's name and power limit (nvidia-smi);
2. builds every kernel of the serve, train and align paths from
   voice100_tpu_torch/csrc/ with nvcc, all sources at once (set-up, timed);
3. holds the fused log-mel kernel against its plain PyTorch version on
   the card at 8 x 10 s, checks that one call is one launch and cuts no
   frames in PyTorch, and times kernel and torch.stft in turns (event
   and device time) and the plain version;
4. holds the biLSTM inference kernel (one persistent launch a layer)
   against its plain version at B=8, T=501, H=512 for both layer widths
   of asr_en_base (input 512 and 1024) with ragged lengths, checks one
   launch a call, and times kernel and cuDNN nn.LSTM in turns (event and
   device time) and the plain version;
5. holds the biLSTM training kernels (state-saving forward, one launch a
   call; dG backward) and their autograd Function against the plain
   versions and torch autograd at the train shapes, B=64, T=501, H=512,
   both input widths; times each kernel against cuDNN nn.LSTM's forward
   or backward in turns, and the Function's whole backward (kernel 3 and
   the dW/dx GEMMs) against cuDNN's, event and device time, and the
   plain versions; checks that kernels 1, 2 and 3 raise, launching
   nothing, where their cooperative grids cannot be resident (H=544: 136
   blocks);
6. holds the CTC lattice kernels (alpha forward, adjoint) and the loss
   Function against the plain versions at B=64, T=501, V=29 with a
   repeated-label row, an empty target and an infeasible row, and on
   edge batches (an input of one frame, a row held for most of T, 150
   labels, an empty label axis, S=1201 and S=4095); checks that the
   wrapper's limits equal ctc.cu's and that S past them raises, launching
   nothing; times each kernel in turns with F.ctc_loss's forward or
   backward (event and device time), the plain versions and the loss
   backward's vocabulary scatter; then tools/probe_ctc.py splits the steps
   of kernels 4 and 5 and of the Viterbi launch (kernels 6 and 7) by cause
   and gives each one's chain floor;
7. holds the align path's shapes: the biLSTM inference kernel at B=64,
   T=512, kernels 1 and 2 at B=128, T=501, H=256 (asr_en_small's batch
   and width; two 64-row passes, a 64-block grid, a zero-length row), the
   log-mel kernel on single clips of 1.0, 3.7 and 9.3 s padded to a
   multiple of 4096 samples, and the CTC Viterbi launch (kernels 6 and 7
   and the final state in one launch) against the plain versions at B=64,
   T=512, V=29, S=321 with a repeated-label row, an empty target, a row
   that cannot align, inputs of one frame and of none and ragged lengths,
   on a batch with an empty label axis (S=1), at the 40 s bucket's shape
   (B=8, T=2001, S=1121, four warps a sample, 9 states a lane), at S=3071
   and with a vocabulary of 1000 classes (S=2001, rows not staged in shared
   memory): unpacked moves, last row, score, path and labels must be
   equal; checks that S
   past the limit raises, launching nothing; times the launch (event and
   device time; each phase alone from the probe) and the plain versions;
8. serves asr_en_base end to end through ASRPipeline on the card (16
   int16 clips of 2-10 s, batch 8, seeded random weights), with the
   kernels' launch counts set to 0 just before and read just after (the
   log-mel kernel once a batch, the biLSTM kernel once a layer a batch),
   holds its logits and greedy ids against the same pipeline on the CPU,
   and its transcripts to those greedy ids;
9. trains asr_en_base on the card through Trainer.train_step (batch 64
   of 2-10 s clips in the 10 s bucket, augmentation and dropout on, Adam
   1e-3, clip 1.0): one warm-up step, then 10 timed steps with the launch
   counts set to 0 just before and read just after (kernel 2 once and
   kernel 3 twice a layer a step, kernels 4 and 5 once a step); the loss
   must be finite and fall;
   prints the card time by layer;
10. takes 3 training steps from the same weights on the first 8 clips,
    augmentation and dropout off, on the card and on the CPU's plain path,
    and holds the first step's gradients and the 3 losses together;
11. force-aligns a dummy_en corpus of 128 int16 WAVs of 2-10 s (random
    texts of about 14 characters a second) with asr_en_base (seeded random
    weights saved as a port checkpoint, batch 64) through
    tools/align_text.cli_main on the card, twice: a cold feature cache,
    then a warm one; the launch counts of kernels 1, 8 and the Viterbi
    launch set to 0 just before each run and read just after (1 once a
    layer a batch, the Viterbi once a batch, 8 once a clip cold and never
    warm); checks the lines, and every batch's labels against the plain
    Viterbi on the card's own log-probs; prints the throughput of both
    runs and the card time by layer of one batch;
12. aligns the first 8 clips from the same warm cache on the card and on
    the CPU's plain path and holds log-probs, Viterbi scores and paths
    together;
13. trains asr_en_base through the training CLI (training/cli.py main,
    what ``python -m voice100_tpu_torch`` runs): ``fit`` for 3 epochs on
    the same corpus with a cold feature cache (116 train clips, 2 steps an
    epoch at batch 64; 12 val clips), then ``validate``, ``test`` and
    ``predict`` on the last.pt it wrote, with the launch counts set to 0
    just before each subcommand and read just after (fit: kernel 8 once a
    clip, kernels 2-5 as in step 9; every evaluated batch, in fit,
    validate and test: kernel 1 twice a layer, for the loss and the CER
    decode, and kernel 4 once, for the loss; predict: kernel 1 once a
    layer a batch; nothing else); checks
    the log (fit_start, three epoch records with finite val_loss, val_cer
    and val_wer, a falling train loss), best.pt and last.pt, validate's
    loss against the last epoch's (1e-5 relative) and every predicted line
    against the card's own greedy decode; prints the fit's host-clock
    seconds an epoch and audio seconds a second;
14. serves TTS v2 at config/align_en_base.yaml and config/tts_en_base.yaml
    width through TTSPipeline on the card (seeded random weights saved as
    port checkpoints and loaded through training/cli.py load_model, the
    align model's output bias set for ~3.3 aligned frames a character,
    constant WORLD statistics): 16 English texts of 21-239 characters in
    one batch (text bucket 256, frame bucket 2048), with the launch counts
    set to 0 just before one synthesize call and read just after (kernel 1
    once a layer of each model, 4 in all, nothing else); the median wall
    time of 5 warm calls, float32 and int16, every call's float32
    waveforms equal to the first's, int16 equal to round(clip(float) *
    32767) +/- 1; the time of each stage; the card against the CPU's plain
    path on 4 of the texts, stage by stage on the card's inputs of each
    stage and the same noise (durations, aligned ids and lengths,
    features, pulse positions, waveform); kernel 1 against its plain
    version and nn.LSTM at the run's align (B=16, T=256, H=256) and audio
    encoder (B=16, T=2048, H=512) shapes;
15. builds every TTS config of config/ on the card through
    training/cli.py, then trains TTS v2 at config/align_en_base.yaml and
    config/tts_en_base.yaml width and depth: writes a dummy_en corpus of 144 voiced 16 kHz clips
    of 2-10 s (harmonics of an F0 moving in 90-260 Hz, unvoiced noise
    stretches; texts of about 14 characters a second), its align file
    through tools/align_text.cli_main with the align phase's ASR
    checkpoint, and its WORLD statistics through tools/calc_stat (the
    cold host analysis, timed); takes one train batch of 128 from each
    real data module (AudioTextDataModule world_mcep with aligned text,
    AlignTextDataModule) and runs Trainer.train_step 1 + 10 times on each
    model (dropout on), with the launch counts set to 0 just before the
    timed steps and read just after (kernel 2 once and kernel 3 twice a
    layer a step, nothing else), then one evaluated batch (kernel 1 once
    a layer, nothing else); times the audio model's step by stage; holds
    3 steps from the same weights on 8 rows of each batch, dropout off,
    on the card and on the CPU's plain path (losses and first-step
    gradients 1e-3 relative); trains both through the training CLI
    (``fit`` 2 epochs at a batch_size override of 64, the audio model
    with --audio_stat, then ``validate`` and ``predict`` on last.pt;
    launch counts, the log, validate against the last epoch's val_loss
    1e-5 relative, one prediction a clip); and holds kernels 2 and 3 at
    the two batches' shapes (B=128, T=512, H=512 with the audio batch's
    lengths: 156,672 and 221,184 B of shared memory a block; B=128,
    T=144, H=256 with the align batch's) against their plain versions,
    timed against cuDNN nn.LSTM's forward and backward in turns;
16. holds kernel 1 at the TTS configs' training batch (B=128, T=512,
    H=512, a zero-length row): its shared memory a block, 156,672 B,
    within the 232,448 B opt-in, and its outputs against the plain
    version;
17. prints one JSON line of per-kernel results, then, last,
    {"ok": true, "device": {...}}.

Any failed check exits non-zero before the last line is printed. Without
CUDA, or without the voice100_tpu_torch package beside it, it exits
non-zero at once. Times are CUDA-event times with the L2 cache warm
(``ms``: per call, of back-to-back calls) and, where a kernel is held
against a library call, the card's own time per call from torch.profiler
(``device_ms``: the summed durations of the kernels, copies and memsets
it ran; also for the Viterbi launch, which has none), which leaves out the
host's enqueue; ``device_ms`` is "not measured" (null) where the profiler
recorded another number of events of one of the port's kernels than its
wrappers counted launches (``events_launches``). The bounds use the H100
SXM data sheet's peaks (67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s HBM), which assume a 700 W power limit.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
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
# log-mel: the kernel's FFT against the plain version's dense float32 DFT
# products; the plain path is 4.7e-5 from float64 at 8 x 10 s, the FFT's
# rounding smaller (log2 of 256 stages a bin, not 512-term sums).
MEL_TOL = 1e-3
# biLSTM outputs lie in [-1, 1]; 512-term dot products in another order,
# carried through 501 steps of a contracting recurrence.
LSTM_TOL = 1e-4
# logits end to end, card vs CPU: the two differences above through the
# conv encoder, LayerNorm and two biLSTM layers. Greedy ids are compared
# where the top-2 margin exceeds 2 * LOGIT_TOL, where no flip is possible.
LOGIT_TOL = 2e-3
# Training slice, asr_en_base's train batch (config/asr_en_base.yaml:41).
TRAIN_BATCH = 64
TIMED_STEPS = 10
PARITY_BATCH = 8
PARITY_STEPS = 3
# LSTM training kernels' outputs and saved states, max abs error: values in
# [-1, 1] (c a little beyond), the same 512-term dot products summed in
# another order through 501 contracting steps; a wrong index or mask moves
# an entry by O(0.1).
LSTM_STATE_TOL = 1e-4
# dG and the Function's gradients, max error over the tensor's max
# magnitude: a 2048-term dh product a step and (B*T)-term weight sums in
# another order; a masking or time-reversal fault gives O(1).
GRAD_REL_TOL = 1e-3
# CTC ll and finite alpha entries, error over max(1, |value|): each entry
# is the same three-way log-sum-exp on both sides, only exp/log rounding
# differs; a skip-gate or length-hold fault moves values by O(1).
CTC_REL_TOL = 1e-5
# CTC gradient with respect to log_probs, max abs: entries are posteriors
# over the target length, within [-1, 1].
CTC_GRAD_TOL = 1e-4
# Card vs CPU training steps from the same weights: each first-step
# gradient by ||g_card - g_cpu|| / ||g_cpu||, and the losses relatively.
PARITY_GRAD_TOL = 1e-3
PARITY_LOSS_TOL = 1e-3
# Align slice: the config's batch (config/asr_en_base.yaml:41), the
# Viterbi launch's check shape (S = 2 * 160 + 1 = 321), single clips of
# odd lengths for the log-mel kernel, and the synthetic corpus.
ALIGN_BATCH = 64
VITERBI_T, VITERBI_L = 512, 160
CLIP_SECONDS = (1.0, 3.7, 9.3)
ALIGN_CLIPS = 128
ALIGN_PARITY_CLIPS = 8
# Card vs CPU alignment of the same clips from the same cache: Viterbi
# scores sum ~500 log-probs, each within LOGIT_TOL; near-ties may flip a
# frame under that tolerance, while an indexing or gate fault moves whole
# segments of the path.
ALIGN_SCORE_REL_TOL = 1e-3
ALIGN_PATH_AGREEMENT = 0.99
# TTS serving: config/align_en_base.yaml and config/tts_en_base.yaml at full
# width, seeded random weights saved as port checkpoints and loaded through
# training.cli.load_model.
ALIGN_EN_BASE = dict(vocab_size=29, num_layers=2, hidden_size=256, num_outputs=2)
TTS_EN_BASE = dict(vocab_size=29, f0_size=1, logspc_size=25, codeap_size=1,
                   encoder_num_layers=2, encoder_hidden_size=512,
                   decoder_settings=((512, False, 5, 1, 2, False), (512, True, 5, 2, 2, False),
                                     (512, False, 5, 1, 2, False)))
# the align model's output bias: durations of about (0.3, 3.0) aligned
# frames a character, 3.3 in all (66 ms: LJSpeech's ~15 characters a second)
TTS_DURATION_BIAS = (float(np.log(1.3)), float(np.log(4.0)))
# constant WORLDNorm statistics (no stat file is in the repository): F0 about
# 150 +/- 30 Hz, a mel-cepstrum of a plausible level and tilt, codeap -15 dB
TTS_STATS = {"f0_mean": [150.0], "f0_std": [30.0],
             "logspc_mean": [-4.0, 0.6, -0.1] + [0.0] * 22,
             "logspc_std": [0.5, 0.3] + [0.1] * 23,
             "codeap_mean": [-15.0], "codeap_std": [5.0]}
# 16 English sentences of 21-239 characters; the 2nd and 4th are the
# sample texts of voice100_tpu/tools/update_samples.py:119-127
TTS_TEXTS = [
    "The birch canoe slid on the smooth planks.",
    "beginnings are apt to be determinative and when reinforced by continuous applications "
    "of similar influence",
    "In the early evening the committee met again, and after a long discussion of the "
    "accounts, the reports of the treasurer and the letters from the county, it resolved "
    "that the old bridge should be repaired before the winter floods came down.",
    "which had restored the courage of noirtier for ever since he had conversed with the "
    "priest his violent despair had yielded to a calm resignation which surprised all who "
    "knew his excessive affection",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "The printing press changed the way that books were made and sold across the whole of "
    "Europe.",
    "These days a chicken leg is a rare dish.",
    "He had been told that the witness would arrive on the morning train, but by noon nobody "
    "had seen him at the station or in the town.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch, and the box was thrown beside the parked truck "
    "while the hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "The report described the condition of the prison in great detail, from the crowded yards "
    "and the narrow cells to the poor food and the lack of any useful employment for the "
    "prisoners.",
    "A large size in stockings is hard to sell.",
    "Yes, we will see you.",
    "The secret service agents moved quickly through the crowd, watching the windows of the "
    "buildings along the route and the faces of the people who lined the street on both sides.",
]
TTS_PARITY_TEXTS = 4  # the first four: 42-239 characters, the 2048 frame bucket
TTS_TIMED_CALLS = 5
# card vs CPU, stage by stage on the card's inputs of each stage: durations
# (exp of log-durations from two biLSTM layers summed in another order)
# relatively; features (the audio model's float32 differences scaled by the
# statistics, F0 by 30 Hz) absolutely; the waveform of the same features and
# noise (float32 DFT products in another order) relative to its peak
TTS_DURATION_REL_TOL = 1e-3
TTS_FEATURE_TOL = 2e-3
TTS_WAVE_TOL = 1e-3
# aligned ids may differ where a cursor value lies this close to an integer
TTS_CURSOR_TIE = 1e-5
# kernel 1's shared memory a block at B=128, H=512 (persistent::smem_bytes)
TTS_B128_SMEM = 156672
PEAK_F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
# kernel and library call timed in turns: rounds, each of `iters` calls
TURN_ROUNDS = 5


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


def counted_kernels():
    """The port's kernels by a part of their names on the card, each with
    the wrappers that count its launches (kernels 1 and 2 share one
    template)."""
    from voice100_tpu_torch.ops.ctc_cuda import ctc_alpha_adjoint_cuda, ctc_alpha_cuda
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_fwd_cuda)
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda
    from voice100_tpu_torch.ops.viterbi_cuda import viterbi_align_lattice_cuda

    return {"log_mel_kernel": (log_mel_spectrogram_cuda,),
            "bilstm_persistent_kernel": (bilstm_cuda, bilstm_train_fwd_cuda),
            "lstm_train_bwd_": (bilstm_train_bwd_cuda,),
            "ctc_alpha_kernel": (ctc_alpha_cuda,), "ctc_adjoint_kernel": (ctc_alpha_adjoint_cuda,),
            "viterbi_align_kernel": (viterbi_align_lattice_cuda,)}


def device_profile(fn, calls: int = 2):
    """The card's time per call of ``fn``: the durations of the kernels,
    copies and memsets torch.profiler records on the card over ``calls``
    calls after one warm-up call, in total and by kernel name, and for
    each of the port's kernels that ran, ``[events recorded, launches its
    wrappers counted]`` over those calls. The time is None ("not
    measured") where the profiler records no device activity or fails, or
    where it recorded another number of events of one of the port's
    kernels than its wrappers launched: it has dropped events of a
    cooperative launch before."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = counted_kernels()
    by_name = {}
    before = {w: w.launches for ws in kernels.values() for w in ws}
    events = dict.fromkeys(kernels, 0)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA:
                by_name[evt.name] = (by_name.get(evt.name, 0.0)
                                     + evt.time_range.elapsed_us() * 1e-3 / calls)
                for part in kernels:
                    events[part] += part in evt.name
    except Exception as err:  # the profiler is a measurement aid, not a check
        print(f"torch.profiler failed ({err!r}): device time not measured", flush=True)
        return None, {}, {}
    counts = {part: [events[part], sum(w.launches - before[w] for w in ws)]
              for part, ws in kernels.items()}
    counts = {part: c for part, c in counts.items() if any(c)}
    dropped = {part: c for part, c in counts.items() if c[0] != c[1]}
    if dropped:
        print(f"torch.profiler recorded [events, launches] {dropped}: device time not "
              f"measured", flush=True)
        return None, by_name, counts
    return (sum(by_name.values()) if by_name else None), by_name, counts


def timed_in_turns(fns, iters: int, rounds: int = TURN_ROUNDS):
    """Each callable of ``fns`` ({name: fn}) timed in turns within this
    call: ``rounds`` rounds, each timing ``iters`` back-to-back calls of
    every function with CUDA events, the order reversed every other
    round; the median per call (``ms``), then the card's own time per
    call (``device_ms``, :func:`device_profile`) and its split by kernel
    name (``kernels``)."""
    for fn in fns.values():
        fn()
    samples = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            samples[name].append(time_ms(fns[name], iters=iters, warmup=0))
    out = {}
    for name, fn in fns.items():
        device, kernels, counts = device_profile(fn)
        out[name] = {"ms": float(np.median(samples[name])), "device_ms": device,
                     "kernels": kernels, "events_launches": counts}
    return out


def fmt_ms(value) -> str:
    return "not measured" if value is None else f"{value:.4f}"


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
    from voice100_tpu_torch.ops import melspec
    from voice100_tpu_torch.ops.melspec import log_mel_spectrogram, mel_filterbank
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    rng = np.random.default_rng(SEED)
    pcm = np.stack(int16_clips(rng, [10.0] * BATCH))
    wav = torch.from_numpy(pcm).to(device).float() * (1.0 / 32768.0)
    # one call is one launch, and no frames are cut in PyTorch on the way
    framed, frame_signal = [], melspec.frame_signal
    melspec.frame_signal = lambda *a, **k: framed.append(1) or frame_signal(*a, **k)
    try:
        before = log_mel_spectrogram_cuda.launches
        got = log_mel_spectrogram_cuda(wav)
        one_call = log_mel_spectrogram_cuda.launches - before
    finally:
        melspec.frame_signal = frame_signal
    if one_call != 1 or framed:
        fail(f"log-mel: one call made {one_call} launches and {len(framed)} frame_signal calls")
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
    turns = timed_in_turns({"kernel": lambda: log_mel_spectrogram_cuda(wav),
                            "library": library}, iters=20)
    plain_ms = time_ms(lambda: log_mel_spectrogram(wav), iters=20)
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
    kernel, lib = turns["kernel"], turns["library"]
    print(f"log-mel {BATCH} x 10 s ({rows} frames): max_abs_err {err:.3e} (tol {MEL_TOL:.0e}), "
          f"torch.stft vs plain {library_err:.3e}; one launch a call; in turns: kernel "
          f"{kernel['ms']:.4f} ms (device {fmt_ms(kernel['device_ms'])}), torch.stft + mel + log "
          f"{lib['ms']:.4f} ms (device {fmt_ms(lib['device_ms'])}); plain {plain_ms:.4f} ms, "
          f"bound {bound:.4f} ms ({bound_by})", flush=True)
    if not err <= MEL_TOL:
        fail(f"log-mel kernel disagrees with the plain version: {err:.3e} > {MEL_TOL:.0e}")
    return {
        "name": "log_mel", "route": "cuda", "source": "voice100_tpu_torch/csrc/melspec.cu",
        "replaces": "voice100_tpu/ops/melspec_pallas.py:64", "launches": None,
        "max_abs_err": err, "ms": kernel["ms"], "plain_ms": plain_ms, "bound_ms": bound,
        "bound_by": bound_by, "library_ms": lib["ms"], "device_ms": kernel["device_ms"],
        "library_device_ms": lib["device_ms"], "events_launches": kernel["events_launches"],
    }


def check_melspec_clips(device):
    """The log-mel kernel on single clips of odd lengths, each padded with
    zeros to a multiple of 4096 samples as the feature transform pads it
    (data/transforms.py), against the plain version."""
    from voice100_tpu_torch.data.transforms import WAVE_BUCKET
    from voice100_tpu_torch.ops.melspec import log_mel_spectrogram
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    rng = np.random.default_rng(SEED + 5)
    worst, shapes = 0.0, []
    for clip in int16_clips(rng, CLIP_SECONDS):
        padded = -(-len(clip) // WAVE_BUCKET) * WAVE_BUCKET
        wav = torch.zeros(padded, device=device)
        wav[:len(clip)] = torch.from_numpy(clip).to(device).float() * (1.0 / 32768.0)
        got = log_mel_spectrogram_cuda(wav)
        ref = log_mel_spectrogram(wav)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not torch.isfinite(got).all():
            fail(f"log-mel kernel on one clip of {len(clip)} samples: shape "
                 f"{tuple(got.shape)} or non-finite values")
        worst = max(worst, (got - ref).abs().max().item())
        shapes.append(f"{len(clip)} -> {padded} samples, {got.shape[0]} frames")
    print(f"log-mel single clips ({'; '.join(shapes)}): max_abs_err {worst:.3e} "
          f"(tol {MEL_TOL:.0e})", flush=True)
    if not worst <= MEL_TOL:
        fail(f"log-mel kernel on single clips disagrees with the plain version: {worst:.3e}")
    return worst


def check_bilstm(device, batch=BATCH, time_steps=501, lengths_list=None, hidden=512,
                 input_size=512):
    """The biLSTM inference kernel against its plain version for both
    layer widths of a 2-layer biLSTM (input ``input_size``, then 2 H) with
    ragged lengths, timed with the plain version and cuDNN nn.LSTM; one
    call must be one launch. The default shapes are one 8 x 10 s serve
    batch of asr_en_base; the align phase runs it at the config's batch of
    64 (one 64-row pass of the kernel's product), the TTS phase at the
    align and audio models' shapes."""
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import bilstm
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda

    if lengths_list is None:
        lengths_list = [501, 463, 420, 377, 250, 128, 17, 1]
    module = BiLSTM(input_size, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    lengths = torch.tensor(lengths_list, dtype=torch.int32, device=device)
    gen = torch.Generator(device=device).manual_seed(SEED)
    total = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
             "library_device_ms": 0.0, "recurrence_device_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    counts = []
    for layer, params in enumerate(module.stacked_layers()):
        d_in = params[0].shape[2]
        x = torch.randn(batch, time_steps, d_in, device=device, generator=gen)
        with torch.no_grad():
            before = bilstm_cuda.launches
            got = bilstm_cuda(*params, x, lengths)
            one_call = bilstm_cuda.launches - before
            ref = bilstm(*params, x, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"biLSTM kernel layer {layer}: non-finite outputs")
            if one_call != 1:
                fail(f"biLSTM kernel layer {layer}: one call made {one_call} launches, not 1")
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
            turns = timed_in_turns({"kernel": lambda: bilstm_cuda(*params, x, lengths),
                                    "library": library}, iters=2)
            plain_ms = time_ms(lambda: bilstm(*params, x, lengths), iters=3, warmup=1)
            ms, library_ms = turns["kernel"]["ms"], turns["library"]["ms"]
            device_ms = turns["kernel"]["device_ms"]
            library_device_ms = turns["library"]["device_ms"]
            counts.append(turns["kernel"]["events_launches"])
            # the persistent launch alone, without the projection and the order
            recurrence_ms = sum(v for k, v in turns["kernel"]["kernels"].items()
                                if "bilstm_persistent_kernel" in k) or None
        valid = sum(lengths_list)
        n_bytes = (x.numel() + 2 * 4 * hidden * (d_in + hidden + 2) + batch * time_steps
                   * 2 * hidden) * 4 + batch * 4
        # the work these lengths need: projections and recurrence of valid steps only
        n_ops = 2 * 2 * valid * 4 * hidden * (d_in + hidden)
        bound, bound_by = bound_ms(n_bytes, n_ops)
        print(f"biLSTM layer {layer} (B={batch}, T={time_steps}, D={d_in}, H={hidden}): "
              f"max_abs_err {err:.3e} (tol {LSTM_TOL:.0e}), nn.LSTM vs plain {library_err:.3e}; "
              f"one launch a call; "
              f"in turns: kernel {ms:.3f} ms (device {fmt_ms(device_ms)}, of which the persistent "
              f"launch {fmt_ms(recurrence_ms)}), nn.LSTM "
              f"{library_ms:.3f} ms (device {fmt_ms(library_device_ms)}); plain {plain_ms:.3f} ms, "
              f"bound {bound:.4f} ms ({bound_by})", flush=True)
        if not err <= LSTM_TOL:
            fail(f"biLSTM kernel layer {layer} disagrees with the plain version: "
                 f"{err:.3e} > {LSTM_TOL:.0e}")
        total["err"] = max(total["err"], err)
        for key, value in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                           ("device_ms", device_ms), ("library_device_ms", library_device_ms),
                           ("recurrence_device_ms", recurrence_ms), ("bytes", n_bytes),
                           ("ops", n_ops)):
            total[key] = None if value is None or total[key] is None else total[key] + value
    bound, bound_by = bound_ms(total["bytes"], total["ops"])
    return {
        "name": "bilstm_recurrence", "route": "cuda",
        "source": "voice100_tpu_torch/csrc/bilstm.cu",
        "replaces": "voice100_tpu/ops/lstm_pallas.py:41", "launches": None,
        "max_abs_err": total["err"], "ms": total["ms"], "plain_ms": total["plain_ms"],
        "bound_ms": bound, "bound_by": bound_by, "library_ms": total["library_ms"],
        "device_ms": total["device_ms"], "library_device_ms": total["library_device_ms"],
        "recurrence_device_ms": total["recurrence_device_ms"], "events_launches": counts,
        "shapes": f"both layers: B={batch}, T={time_steps}, H={hidden}, D={input_size} then "
                  f"{2 * hidden}",
    }


def check_forward_b128(device):
    """Kernels 1 and 2 at asr_en_small's shapes (config/asr_en_small.yaml:
    H=256, conv width 256, batch 128): two 64-row passes of the product and
    a 64-block grid, ragged lengths with a zero-length row, both layer
    widths, against their plain twins; kernel 1 timed with its plain twin
    (cuDNN's packed nn.LSTM takes no zero-length row)."""
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import bilstm, bilstm_train_fwd, project_inputs
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda, bilstm_train_fwd_cuda

    batch, time_steps, hidden = 128, 501, 256
    lengths_np = np.random.default_rng(SEED + 10).integers(1, time_steps + 1, size=batch)
    lengths_np[0], lengths_np[1], lengths_np[2] = time_steps, 0, 1
    lengths = torch.tensor(lengths_np, dtype=torch.int32, device=device)
    module = BiLSTM(hidden, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=device).manual_seed(SEED)
    errs = {"bilstm_recurrence": 0.0, "bilstm_train_fwd": 0.0}
    ms = plain_ms = 0.0
    for layer, (w_ih, w_hh, bias) in enumerate(module.stacked_layers()):
        x = torch.randn(batch, time_steps, w_ih.shape[2], device=device, generator=gen)
        with torch.no_grad():
            got = bilstm_cuda(w_ih, w_hh, bias, x, lengths)
            ref = bilstm(w_ih, w_hh, bias, x, lengths)
            xg = project_inputs(w_ih, bias, x).contiguous()
            got_t = bilstm_train_fwd_cuda(xg, w_hh, lengths)
            ref_t = bilstm_train_fwd(xg, w_hh, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or not all(torch.isfinite(t).all() for t in got_t):
                fail(f"biLSTM kernels at B={batch}, H={hidden}, layer {layer}: non-finite outputs")
            errs["bilstm_recurrence"] = max(errs["bilstm_recurrence"],
                                            (got - ref).abs().max().item())
            errs["bilstm_train_fwd"] = max(errs["bilstm_train_fwd"], max(
                (a - b).abs().max().item() for a, b in zip(got_t, ref_t)))
            ms += time_ms(lambda: bilstm_cuda(w_ih, w_hh, bias, x, lengths), iters=3)
            plain_ms += time_ms(lambda: bilstm(w_ih, w_hh, bias, x, lengths), iters=2, warmup=1)
    print(f"biLSTM kernels 1 and 2 at B={batch}, T={time_steps}, H={hidden} (a zero-length "
          f"row, both layers): max_abs_err kernel 1 {errs['bilstm_recurrence']:.3e} (tol "
          f"{LSTM_TOL:.0e}), kernel 2 out/states {errs['bilstm_train_fwd']:.3e} (tol "
          f"{LSTM_STATE_TOL:.0e}); kernel 1 {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
    if not errs["bilstm_recurrence"] <= LSTM_TOL or not errs["bilstm_train_fwd"] <= LSTM_STATE_TOL:
        fail(f"biLSTM kernels at B={batch}, H={hidden} disagree with the plain twins: {errs}")
    return {"shapes": f"B={batch}, T={time_steps}, H={hidden}, both layers, a zero-length row",
            "max_abs_err": errs, "kernel_1_ms": ms, "kernel_1_plain_ms": plain_ms}


def check_bilstm_b128_h512(device):
    """Kernel 1 at the TTS configs' training batch (config/tts_en_base.yaml:
    H=512, batch 128): its shared memory a block within the opt-in limit,
    ragged lengths with a zero-length row, both layer widths, against the
    plain version on the card."""
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import bilstm
    from voice100_tpu_torch.ops.lstm_cuda import _SMEM_OPTIN_LIMIT, _lib, bilstm_cuda

    batch, time_steps, hidden = 128, 512, 512
    smem = _lib().bilstm_smem_bytes(batch, hidden)
    if smem != TTS_B128_SMEM or smem > _SMEM_OPTIN_LIMIT:
        fail(f"kernel 1 at B={batch}, H={hidden}: {smem} B of shared memory a block, not "
             f"{TTS_B128_SMEM} within the {_SMEM_OPTIN_LIMIT} B opt-in")
    lengths_np = np.random.default_rng(SEED + 11).integers(1, time_steps + 1, size=batch)
    lengths_np[0], lengths_np[1], lengths_np[2] = time_steps, 0, 1
    lengths = torch.tensor(lengths_np, dtype=torch.int32, device=device)
    module = BiLSTM(hidden, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED + 11))
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    err, ms = 0.0, 0.0
    for layer, (w_ih, w_hh, bias) in enumerate(module.stacked_layers()):
        x = torch.randn(batch, time_steps, w_ih.shape[2], device=device, generator=gen)
        with torch.no_grad():
            got = bilstm_cuda(w_ih, w_hh, bias, x, lengths)
            ref = bilstm(w_ih, w_hh, bias, x, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"kernel 1 at B={batch}, H={hidden}, layer {layer}: non-finite outputs")
            err = max(err, (got - ref).abs().max().item())
            ms += time_ms(lambda: bilstm_cuda(w_ih, w_hh, bias, x, lengths), iters=3)
    print(f"biLSTM kernel 1 at B={batch}, T={time_steps}, H={hidden} (the TTS configs' training "
          f"batch; a zero-length row, both layers): {smem} B of shared memory a block (opt-in "
          f"{_SMEM_OPTIN_LIMIT}); max_abs_err {err:.3e} (tol {LSTM_TOL:.0e}); {ms:.3f} ms",
          flush=True)
    if not err <= LSTM_TOL:
        fail(f"kernel 1 at B={batch}, H={hidden} disagrees with the plain version: {err:.3e}")
    return {"shapes": f"B={batch}, T={time_steps}, H={hidden}, both layers, a zero-length row",
            "smem_bytes": smem, "max_abs_err": err, "ms": ms}


def rel_err(got, ref) -> float:
    """Max abs error over the reference's max magnitude."""
    return ((got - ref).abs().max() / ref.abs().max().clamp(min=1e-30)).item()


def train_lengths(rng, time_steps, batch=TRAIN_BATCH):
    """Ragged lengths of a train batch, the full length and 1 included."""
    lengths = rng.integers(1, time_steps + 1, size=batch)
    lengths[0], lengths[1] = time_steps, 1
    return lengths


def check_lstm_train(device, batch=TRAIN_BATCH, time_steps=501, hidden=512, input_size=512,
                     lengths_np=None):
    """The biLSTM training kernels (2 and 3) and their autograd Function
    against the plain versions and torch autograd, for both layers of a
    2-layer biLSTM (input ``input_size``, then 2 H), timed against cuDNN
    nn.LSTM's forward and backward in turns. The default shapes are
    asr_en_base's train batch; the TTS training phase runs it at the TTS
    configs' batch of 128. Returns the kernel lines of kernels 2 and 3."""
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import (bilstm, bilstm_train_bwd, bilstm_train_fwd,
                                             project_inputs)
    from voice100_tpu_torch.ops.lstm_cuda import (_train_lib, bilstm_train_bwd_cuda,
                                                  bilstm_train_cuda, bilstm_train_fwd_cuda)

    if lengths_np is None:
        lengths_np = train_lengths(np.random.default_rng(SEED + 1), time_steps, batch)
    lengths = torch.tensor(lengths_np, dtype=torch.int32, device=device)
    cpu_lengths = lengths.cpu()
    valid = int(lengths_np.sum())
    smem = {"kernel_2": _train_lib().lstm_train_fwd_smem_bytes(batch, hidden),
            "kernel_3": _train_lib().lstm_train_bwd_smem_bytes(batch, hidden)}
    module = BiLSTM(input_size, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED))
    gen = torch.Generator(device=device).manual_seed(SEED)
    fwd = {"err": 0.0, "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "device_ms": 0.0,
           "library_device_ms": 0.0, "bytes": 0.0, "ops": 0.0}
    bwd = dict(fwd, function_ms=0.0, function_device_ms=0.0, gate_pass_device_ms=0.0,
               recurrence_device_ms=0.0)
    counts = {"fwd": [], "bwd": []}
    for layer, (w_ih, w_hh, bias) in enumerate(module.stacked_layers()):
        d_in = w_ih.shape[2]
        x = torch.randn(batch, time_steps, d_in, device=device, generator=gen)
        dout = torch.randn(batch, time_steps, 2 * hidden, device=device, generator=gen)
        with torch.no_grad():
            xg = project_inputs(w_ih, bias, x).contiguous()
            before = bilstm_train_fwd_cuda.launches
            got = bilstm_train_fwd_cuda(xg, w_hh, lengths)
            if bilstm_train_fwd_cuda.launches - before != 1:
                fail(f"biLSTM train forward kernel layer {layer}: one call made "
                     f"{bilstm_train_fwd_cuda.launches - before} launches, not 1")
            ref = bilstm_train_fwd(xg, w_hh, lengths)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in got):
                fail(f"biLSTM train forward kernel layer {layer}: non-finite outputs")
            fwd_err = max((a - b).abs().max().item() for a, b in zip(got, ref))
            h_prev, c_prev = ref[1], ref[2]
            dg = bilstm_train_bwd_cuda(xg, w_hh, lengths, h_prev, c_prev, dout)
            dg_ref = bilstm_train_bwd(xg, w_hh, lengths, h_prev, c_prev, dout)
            torch.cuda.synchronize()
            dg_err = rel_err(dg, dg_ref)
            dg_abs = (dg - dg_ref).abs().max().item()
            del got, ref, dg, dg_ref
        # the Function (both kernels + products) vs autograd through the plain loop
        grads = []
        for fn in (bilstm_train_cuda, bilstm):
            leaves = [t.detach().clone().requires_grad_() for t in (w_ih, w_hh, bias, x)]
            (fn(*leaves, lengths) * dout).sum().backward()
            grads.append([t.grad for t in leaves])
        grad_err = max(rel_err(a, b) for a, b in zip(*grads))
        del grads

        lstm = torch.nn.LSTM(d_in, hidden, bidirectional=True, batch_first=True, device=device)
        with torch.no_grad():
            for suffix in ("", "_reverse"):
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    getattr(lstm, f"{name}_l0{suffix}").copy_(
                        getattr(module, f"{name}_l{layer}{suffix}"))
        x_leaf = x.clone().requires_grad_()

        def library_fwd():
            packed = torch.nn.utils.rnn.pack_padded_sequence(
                x_leaf, cpu_lengths, batch_first=True, enforce_sorted=False)
            return torch.nn.utils.rnn.pad_packed_sequence(
                lstm(packed)[0], batch_first=True, total_length=time_steps)[0]

        y = library_fwd()
        inputs = [x_leaf, *lstm.parameters()]
        # the like-for-like pair: the Function's whole backward (kernel 3 and
        # the dW/dx GEMMs) against cuDNN's (dx and dW too)
        leaves = [t.detach().clone().requires_grad_() for t in (w_ih, w_hh, bias, x)]
        y_port = bilstm_train_cuda(*leaves, lengths)
        fwd_turns = timed_in_turns({
            "kernel": lambda: bilstm_train_fwd_cuda(xg, w_hh, lengths),
            "library": library_fwd}, iters=3)
        bwd_turns = timed_in_turns({
            "kernel": lambda: bilstm_train_bwd_cuda(xg, w_hh, lengths, h_prev, c_prev, dout),
            "library": lambda: torch.autograd.grad(y, inputs, dout, retain_graph=True),
            "function": lambda: torch.autograd.grad(y_port, leaves, dout, retain_graph=True),
        }, iters=3)
        del y, y_port
        counts["fwd"].append(fwd_turns["kernel"]["events_launches"])
        counts["bwd"].append(bwd_turns["kernel"]["events_launches"])
        by_launch = {part: sum(v for k, v in bwd_turns["kernel"]["kernels"].items()
                               if f"lstm_train_bwd_{part}_kernel" in k) or None
                     for part in ("gates", "recurrence")}
        timings = {
            "fwd_ms": fwd_turns["kernel"]["ms"],
            "fwd_device_ms": fwd_turns["kernel"]["device_ms"],
            "fwd_plain_ms": time_ms(lambda: bilstm_train_fwd(xg, w_hh, lengths), iters=2, warmup=1),
            "fwd_library_ms": fwd_turns["library"]["ms"],
            "fwd_library_device_ms": fwd_turns["library"]["device_ms"],
            "bwd_ms": bwd_turns["kernel"]["ms"],
            "bwd_device_ms": bwd_turns["kernel"]["device_ms"],
            "bwd_gate_pass_device_ms": by_launch["gates"],
            "bwd_recurrence_device_ms": by_launch["recurrence"],
            "bwd_plain_ms": time_ms(lambda: bilstm_train_bwd(xg, w_hh, lengths, h_prev, c_prev,
                                                             dout), iters=2, warmup=1),
            "bwd_library_ms": bwd_turns["library"]["ms"],
            "bwd_library_device_ms": bwd_turns["library"]["device_ms"],
            "bwd_function_ms": bwd_turns["function"]["ms"],
            "bwd_function_device_ms": bwd_turns["function"]["device_ms"],
        }
        # least work of each function at these lengths (valid rows only):
        # forward, h W_hh^T of both directions (8 H^2 flops a row) reading
        # xg and writing out, h_prev and c_prev; backward, the gate
        # recompute and dG W_hh (16 H^2 a row) reading xg, the states and
        # dout and writing dG. W_hh is read once.
        w_bytes = w_hh.numel() * 4
        state_bytes = batch * time_steps * 2 * hidden * 4       # one [2, B, T, H] tensor
        fwd_bytes = 2 * valid * 4 * hidden * 4 + w_bytes + 3 * state_bytes
        bwd_bytes = 2 * valid * 7 * hidden * 4 + w_bytes + 4 * state_bytes
        for total, err, n_bytes, n_ops, key in (
                (fwd, fwd_err, fwd_bytes, 2 * valid * 8 * hidden * hidden, "fwd"),
                (bwd, dg_abs, bwd_bytes, 2 * valid * 16 * hidden * hidden, "bwd")):
            total["err"] = max(total["err"], err)
            total["bytes"] += n_bytes
            total["ops"] += n_ops
            for name in total:
                value = timings.get(f"{key}_{name}")
                if name.endswith("ms"):
                    total[name] = None if value is None or total[name] is None \
                        else total[name] + value
        print(f"biLSTM train layer {layer} (B={batch}, T={time_steps}, D={d_in}, H={hidden}, "
              f"{valid} valid rows, shared memory a block {smem}): forward out/states max_abs_err {fwd_err:.3e} "
              f"(tol {LSTM_STATE_TOL:.0e}), dG rel err {dg_err:.3e}, Function gradients rel err "
              f"{grad_err:.3e} (tol {GRAD_REL_TOL:.0e}); kernel and library in turns: "
              + ", ".join(f"{k} {fmt_ms(v)}" for k, v in timings.items()), flush=True)
        if not fwd_err <= LSTM_STATE_TOL:
            fail(f"biLSTM train forward kernel layer {layer} disagrees with the plain version: "
                 f"{fwd_err:.3e} > {LSTM_STATE_TOL:.0e}")
        if not max(dg_err, grad_err) <= GRAD_REL_TOL:
            fail(f"biLSTM train backward layer {layer} disagrees with the plain version: dG "
                 f"{dg_err:.3e}, gradients {grad_err:.3e} > {GRAD_REL_TOL:.0e}")
    shapes = (f"both layers of one train batch: B={batch}, T={time_steps}, H={hidden}, "
              f"{valid} valid rows of {batch * time_steps}")
    entries = []
    for total, name, source_line, what, key in (
            (fwd, "bilstm_train_fwd", "voice100_tpu/ops/lstm_pallas.py:232", "nn.LSTM forward",
             "fwd"),
            (bwd, "bilstm_train_bwd", "voice100_tpu/ops/lstm_pallas.py:267",
             "nn.LSTM backward (dx and dW too)", "bwd")):
        bound, bound_by = bound_ms(total["bytes"], total["ops"])
        entries.append({
            "name": name, "route": "cuda", "source": "voice100_tpu_torch/csrc/bilstm_train.cu",
            "replaces": source_line, "launches": None, "max_abs_err": total["err"],
            "ms": total["ms"], "plain_ms": total["plain_ms"], "bound_ms": bound,
            "bound_by": bound_by, "library_ms": total["library_ms"],
            "device_ms": total["device_ms"], "library_device_ms": total["library_device_ms"],
            "events_launches": counts[key], "shapes": shapes + f"; library: cuDNN {what}, packed",
        })
    entries[1]["device_ms_by_launch"] = {"gate_pass": bwd["gate_pass_device_ms"],
                                         "recurrence": bwd["recurrence_device_ms"]}
    entries[1]["whole_backward"] = {
        "what": "BiLSTMFunction backward (kernel 3 + dW/dx GEMMs) vs cuDNN backward",
        "ms": bwd["function_ms"], "device_ms": bwd["function_device_ms"],
        "library_ms": bwd["library_ms"], "library_device_ms": bwd["library_device_ms"]}
    entries[0]["smem_bytes"], entries[1]["smem_bytes"] = smem["kernel_2"], smem["kernel_3"]
    return entries


def check_not_resident(device):
    """Kernels 1, 2 and 3's recurrence are each one cooperative grid of
    2 H / 8 blocks, one an SM: at H=544 (136 blocks) on a card of fewer SMs
    each wrapper must raise before launching anything, with no other path
    taken."""
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_fwd_cuda)

    hidden, batch, time_steps = 544, 2, 5
    blocks = 2 * hidden // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms >= blocks:
        print(f"residency checks skipped: {sms} SMs hold {blocks} blocks", flush=True)
        return
    zeros = lambda *shape: torch.zeros(*shape, device=device)  # noqa: E731
    lengths = torch.tensor([5, 3], device=device)
    state = zeros(2, batch, time_steps, hidden)
    calls = {
        "kernel 1": (bilstm_cuda, lambda: bilstm_cuda(
            zeros(2, 4 * hidden, 8), zeros(2, 4 * hidden, hidden), zeros(2, 4 * hidden),
            zeros(batch, time_steps, 8), lengths)),
        "kernel 2": (bilstm_train_fwd_cuda, lambda: bilstm_train_fwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden), zeros(2, 4 * hidden, hidden), lengths)),
        "kernel 3": (bilstm_train_bwd_cuda, lambda: bilstm_train_bwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden), zeros(2, 4 * hidden, hidden), lengths,
            state, state, zeros(batch, time_steps, 2 * hidden))),
    }
    for name, (wrapper, call) in calls.items():
        before = wrapper.launches
        try:
            call()
        except RuntimeError as err:
            if wrapper.launches != before:
                fail(f"{name} launched before finding its grid cannot be resident")
            print(f"{name} at H={hidden} ({blocks} blocks, {sms} SMs) raised, launching "
                  f"nothing: {err}", flush=True)
            continue
        fail(f"{name} at H={hidden} ran although {blocks} blocks cannot be resident on {sms} SMs")


def ctc_targets(rng, seconds, vocab):
    """Target ids for clips of ``seconds``: about 14 a second, at most 150."""
    target_lengths = np.minimum(np.round(np.asarray(seconds) * 14).astype(np.int64), 150)
    targets = rng.integers(1, vocab, size=(len(target_lengths), int(target_lengths.max())))
    return targets, target_lengths


def loss_seed(alpha, target_lengths):
    """The seed the loss gives the adjoint, dLL/d alpha[T-1]: on the two end
    states, zero on infeasible rows as zero_infinity makes it (there every
    log-sum-exp weight is 1 and the adjoint would grow like 3^t). Returns
    the seed and the rows that are feasible."""
    from voice100_tpu_torch.ops.ctc import NEG_INF, ll_from_alpha

    ll, a_last, a_prev = ll_from_alpha(alpha[-1], target_lengths)
    feasible = ll > NEG_INF / 2
    end = 2 * target_lengths
    seed = torch.zeros(alpha.shape[1], alpha.shape[2], device=alpha.device)
    seed.scatter_add_(1, end[:, None], torch.exp(a_last - ll)[:, None])
    seed.scatter_add_(1, (end - 1).clamp(min=0)[:, None],
                      torch.where(target_lengths > 0, torch.exp(a_prev - ll), 0.0)[:, None])
    return seed * feasible[:, None], feasible


def ctc_errors(log_probs, targets, input_lengths, target_lengths):
    """Kernels 4 and 5 and the loss Function against their plain versions
    on one batch: alpha and ll (error over max(1, |value|), finite
    entries), the adjoint from the loss's seed (error over the max
    magnitude), the loss gradient (max abs), and the infeasible rows'
    gradient (max abs, exactly 0 when right). Fails where the reachable
    states differ or a value is not finite."""
    from voice100_tpu_torch.ops.ctc import (NEG_INF, ctc_alpha, ctc_alpha_adjoint, ctc_loss,
                                            ctc_prep, ll_from_alpha)
    from voice100_tpu_torch.ops.ctc_cuda import (ctc_alpha_adjoint_cuda, ctc_alpha_cuda,
                                                 ctc_loss_cuda)

    z, can_skip, valid = ctc_prep(targets, target_lengths)
    alpha = ctc_alpha_cuda(log_probs, z, can_skip, valid, input_lengths)
    alpha_ref = ctc_alpha(log_probs, z, can_skip, valid, input_lengths)
    torch.cuda.synchronize()
    finite = alpha_ref > NEG_INF / 2
    if not torch.equal(alpha > NEG_INF / 2, finite) or not torch.isfinite(alpha).all():
        fail("CTC alpha kernel: its reachable states differ from the plain version's")
    err = {"alpha": ((alpha - alpha_ref).abs() / alpha_ref.abs().clamp(min=1.0))[finite].max().item()
           if bool(finite.any()) else 0.0,
           "alpha_abs": (alpha - alpha_ref).abs()[finite].max().item() if bool(finite.any())
           else 0.0}
    ll = ll_from_alpha(alpha[-1], target_lengths)[0]
    seed, feasible = loss_seed(alpha_ref, target_lengths)
    ll_ref = ll_from_alpha(alpha_ref[-1], target_lengths)[0]
    err["ll"] = (((ll - ll_ref).abs() / ll_ref.abs().clamp(min=1.0))[feasible].max().item()
                 if bool(feasible.any()) else 0.0)
    if not bool((ll[~feasible] < NEG_INF / 2).all()):
        fail("CTC: an infeasible row is feasible on the card")
    adj = ctc_alpha_adjoint_cuda(alpha_ref, seed, can_skip, valid, input_lengths)
    adj_ref = ctc_alpha_adjoint(alpha_ref, seed, can_skip, valid, input_lengths)
    if not torch.isfinite(adj).all():
        fail("CTC adjoint kernel: non-finite values")
    err["adjoint"] = rel_err(adj, adj_ref) if bool(adj_ref.abs().max() > 0) else \
        adj.abs().max().item()
    err["adjoint_abs"] = (adj - adj_ref).abs().max().item()
    grads = []
    for fn in (ctc_loss_cuda, ctc_loss):
        leaf = log_probs.clone().requires_grad_()
        fn(leaf, targets, input_lengths, target_lengths).backward()
        grads.append(leaf.grad)
    err["grad"] = (grads[0] - grads[1]).abs().max().item()
    err["infeasible_rows"] = [int(i) for i in torch.nonzero(~feasible).flatten()]
    err["infeasible_grad"] = (grads[0][~feasible].abs().max().item()
                              if err["infeasible_rows"] else 0.0)
    return err, (z, can_skip, valid, alpha_ref, seed)


def ctc_edge_batches(device):
    """Batches at the edges of the kernels' loops and limits, seeded:
    an input of one frame, no target, a row held for all but 5 of 501
    steps, one label repeated, the longest target the train phase draws
    (150 labels, S = 301), all in one batch; a batch with an empty label
    axis (S = 1); and lattices of 2 and 4 states a thread (S = 1201 and
    S = 4095, the largest below MAX_STATES = 4096)."""
    rng = np.random.default_rng(SEED + 11)
    vocab = ASR_EN_BASE["vocab_size"]

    def batch(time_steps, input_lengths, target_lengths, repeat_row=None):
        label_len = max(target_lengths) if max(target_lengths) else 0
        targets = rng.integers(1, vocab, size=(len(target_lengths), label_len))
        for i in range(1, label_len):             # no equal neighbours: every row can align
            same = targets[:, i] == targets[:, i - 1]
            targets[same, i] = targets[same, i] % (vocab - 1) + 1
        if repeat_row is not None:
            targets[repeat_row] = 7
        tl = np.asarray(target_lengths)
        targets[np.arange(label_len)[None, :] >= tl[:, None]] = 0
        logits = torch.from_numpy(rng.standard_normal((len(tl), time_steps, vocab)) * 2.0)
        return (torch.log_softmax(logits.float(), dim=-1).to(device),
                torch.from_numpy(targets).to(device),
                torch.tensor(input_lengths, device=device), torch.from_numpy(tl).to(device))

    return {
        "edges (il=1; tl=0; held 496 of 501; one repeated label; 150 labels)":
            batch(501, [1, 400, 5, 501, 501, 480], [1, 0, 2, 100, 150, 60], repeat_row=3),
        "empty label axis (S=1)": batch(64, [64, 1, 30], [0, 0, 0]),
        "S=1201 (2 states a thread)": batch(700, [700, 650], [600, 300]),
        "S=4095 (4 states a thread)": batch(2100, [2100, 2100], [2047, 1000]),
    }


def check_ctc_limits(device):
    """The wrapper's limits (MAX_STATES and the shared-memory formulas)
    equal the library's, and an S past them raises ValueError on the card,
    launching nothing."""
    from voice100_tpu_torch.ops import ctc_cuda

    lib = ctc_cuda._lib()
    if lib.ctc_max_states() != ctc_cuda.MAX_STATES or any(
            lib.ctc_alpha_smem_bytes(s, v) != ctc_cuda.alpha_smem_bytes(s, v)
            or lib.ctc_adjoint_smem_bytes(s) != ctc_cuda.adjoint_smem_bytes(s)
            for s in (1, 281, 4095, 4096) for v in (1, 29, 200, 5000)):
        fail("CTC: the wrapper's limits differ from ctc.cu's")
    s_len = ctc_cuda.MAX_STATES + 2
    z = torch.zeros(2, s_len, dtype=torch.int64, device=device)
    before = (ctc_cuda.ctc_alpha_cuda.launches, ctc_cuda.ctc_alpha_adjoint_cuda.launches)
    for call in (lambda: ctc_cuda.ctc_alpha_cuda(torch.zeros(2, 5, 7, device=device), z,
                                                 z.bool(), z.bool(), torch.tensor([5, 4])),
                 lambda: ctc_cuda.ctc_alpha_adjoint_cuda(
                     torch.zeros(5, 2, s_len, device=device), torch.zeros(2, s_len, device=device),
                     z.bool(), z.bool(), torch.tensor([5, 4]))):
        try:
            call()
        except ValueError:
            continue
        fail(f"CTC: S={s_len} did not raise")
    if (ctc_cuda.ctc_alpha_cuda.launches, ctc_cuda.ctc_alpha_adjoint_cuda.launches) != before:
        fail(f"CTC: S={s_len} launched a kernel before raising")
    print(f"CTC limits: S <= {ctc_cuda.MAX_STATES}, shared memory at that S "
          f"{ctc_cuda.alpha_smem_bytes(ctc_cuda.MAX_STATES, ASR_EN_BASE['vocab_size'])} / "
          f"{ctc_cuda.adjoint_smem_bytes(ctc_cuda.MAX_STATES)} bytes, equal to ctc.cu's; "
          f"S={s_len} raised ValueError, launching nothing", flush=True)


def check_ctc(device):
    from voice100_tpu_torch.ops.ctc import ctc_alpha, ctc_alpha_adjoint
    from voice100_tpu_torch.ops.ctc_cuda import (ctc_alpha_adjoint_cuda, ctc_alpha_cuda,
                                                 ctc_loss_cuda)

    time_steps, vocab = 501, ASR_EN_BASE["vocab_size"]
    rng = np.random.default_rng(SEED + 2)
    seconds = rng.uniform(2.0, 10.0, size=TRAIN_BATCH)
    seconds[0] = 10.0
    input_lengths = np.minimum((seconds * 50).astype(np.int64) + 1, time_steps)
    targets, target_lengths = ctc_targets(rng, seconds, vocab)
    # row 1 repeats one label, row 2 has no target, row 3 cannot fit its 100
    targets[1] = 7
    target_lengths[2] = 0
    input_lengths[3], target_lengths[3] = 40, 100
    targets[np.arange(targets.shape[1])[None, :] >= target_lengths[:, None]] = 0
    logits = torch.from_numpy(rng.standard_normal((TRAIN_BATCH, time_steps, vocab)) * 2.0)
    log_probs = torch.log_softmax(logits.float(), dim=-1).to(device)
    targets, input_lengths, target_lengths = (torch.from_numpy(a).to(device) for a in (
        targets, input_lengths, target_lengths))
    batch = TRAIN_BATCH

    err, (z, can_skip, valid, alpha_ref, seed) = ctc_errors(log_probs, targets, input_lengths,
                                                            target_lengths)
    s_len = z.shape[1]
    if err["infeasible_rows"] != [3] or err["infeasible_grad"] != 0.0:
        fail(f"CTC: infeasible rows {err['infeasible_rows']} (row 3 only expected), their "
             f"gradient {err['infeasible_grad']:.1e} (exactly 0 expected)")
    edges = {name: ctc_errors(*case)[0] for name, case in ctc_edge_batches(device).items()}
    check_ctc_limits(device)

    lp_leaf = log_probs.clone().requires_grad_()
    lp_tbv = lp_leaf.transpose(0, 1)

    def library_fwd():
        return torch.nn.functional.ctc_loss(lp_tbv, targets, input_lengths, target_lengths,
                                            zero_infinity=True)

    library_loss = library_fwd()
    library_diff = abs(library_loss.item() - ctc_loss_cuda(
        log_probs, targets, input_lengths, target_lengths).item())
    # each kernel in turns with F.ctc_loss's forward or backward (event and
    # device time)
    alpha_turns = timed_in_turns({
        "kernel": lambda: ctc_alpha_cuda(log_probs, z, can_skip, valid, input_lengths),
        "library": library_fwd}, iters=20)
    adjoint_turns = timed_in_turns({
        "kernel": lambda: ctc_alpha_adjoint_cuda(alpha_ref, seed, can_skip, valid, input_lengths),
        "library": lambda: torch.autograd.grad(library_loss, lp_leaf, retain_graph=True)},
        iters=20)
    # the vocabulary scatter of CTCLogLikelihood.backward on the adjoint's output
    grad_e = ctc_alpha_adjoint_cuda(alpha_ref, seed, can_skip, valid, input_lengths)
    index = z[:, None, :].expand(batch, time_steps, s_len)

    def scatter():
        grad_lp = torch.zeros(batch, time_steps, vocab, device=device)
        return grad_lp.scatter_add_(2, index, grad_e.permute(1, 0, 2))

    timings = {
        "alpha_plain_ms": time_ms(lambda: ctc_alpha(log_probs, z, can_skip, valid,
                                                    input_lengths), iters=3, warmup=1),
        "adjoint_plain_ms": time_ms(lambda: ctc_alpha_adjoint(alpha_ref, seed, can_skip, valid,
                                                              input_lengths), iters=3, warmup=1),
        "vocab_scatter_ms": time_ms(scatter, iters=20),
        "vocab_scatter_device_ms": device_profile(scatter)[0],
    }
    for key, turns in (("alpha", alpha_turns), ("adjoint", adjoint_turns)):
        timings.update({f"{key}_ms": turns["kernel"]["ms"],
                        f"{key}_device_ms": turns["kernel"]["device_ms"],
                        f"{key}_library_ms": turns["library"]["ms"],
                        f"{key}_library_device_ms": turns["library"]["device_ms"]})
    print(f"CTC lattice (B={batch}, T={time_steps}, V={vocab}, S={s_len}): alpha rel err "
          f"{err['alpha']:.3e}, ll rel err {err['ll']:.3e} (tol {CTC_REL_TOL:.0e}), adjoint rel "
          f"err {err['adjoint']:.3e} (tol {CTC_REL_TOL:.0e}), loss gradient max_abs_err "
          f"{err['grad']:.3e} (tol {CTC_GRAD_TOL:.0e}), infeasible row's gradient "
          f"{err['infeasible_grad']:.1e}; |F.ctc_loss - kernel loss| {library_diff:.3e}; kernel "
          f"and F.ctc_loss in turns: " + ", ".join(f"{k} {fmt_ms(v)}" for k, v in timings.items()),
          flush=True)
    for name, e in edges.items():
        print(f"CTC edge batch {name}: alpha {e['alpha']:.3e}, ll {e['ll']:.3e}, adjoint "
              f"{e['adjoint']:.3e} (tol {CTC_REL_TOL:.0e}), loss gradient {e['grad']:.3e} "
              f"(tol {CTC_GRAD_TOL:.0e}), infeasible rows' gradient {e['infeasible_grad']:.1e}",
              flush=True)
    for name, e in {"train batch": err, **edges}.items():
        if not max(e["alpha"], e["ll"], e["adjoint"]) <= CTC_REL_TOL:
            fail(f"CTC kernels disagree with the plain versions on the {name}: alpha "
                 f"{e['alpha']:.3e}, ll {e['ll']:.3e}, adjoint {e['adjoint']:.3e} > "
                 f"{CTC_REL_TOL:.0e}")
        if not e["grad"] <= CTC_GRAD_TOL or e["infeasible_grad"] != 0.0:
            fail(f"CTC loss gradient disagrees with the plain version on the {name}: "
                 f"{e['grad']:.3e}, infeasible rows {e['infeasible_grad']:.1e}")

    # least work, bytes-bound both: the forward reads log_probs and the
    # lattice constants and writes alpha; the adjoint reads alpha, the
    # seed and the constants and writes dLL/d lp_z. Operations: about 10
    # a valid state of an active step (3 exp, 1 log, adds and maxes).
    active_states = int((input_lengths.clamp(max=time_steps) * (2 * target_lengths + 1)).sum())
    lattice_bytes = time_steps * batch * s_len * 4
    const_bytes = 3 * batch * s_len * 4 + batch * 4
    shapes = (f"one train batch: B={batch}, T={time_steps}, V={vocab}, S={s_len}, "
              f"{active_states} active lattice states; library: F.ctc_loss")
    entries = []
    for name, source_line, key, n_bytes, abs_err in (
            ("ctc_alpha", "voice100_tpu/ops/ctc_pallas.py:64", "alpha",
             log_probs.numel() * 4 + const_bytes + lattice_bytes, err["alpha_abs"]),
            ("ctc_adjoint", "voice100_tpu/ops/ctc_pallas.py:88", "adjoint",
             2 * lattice_bytes + const_bytes + batch * s_len * 4, err["adjoint_abs"])):
        bound, bound_by = bound_ms(n_bytes, 10 * active_states)
        turns = alpha_turns if key == "alpha" else adjoint_turns
        entries.append({
            "name": name, "route": "cuda", "source": "voice100_tpu_torch/csrc/ctc.cu",
            "replaces": source_line, "launches": None, "max_abs_err": abs_err,
            "ms": timings[f"{key}_ms"], "plain_ms": timings[f"{key}_plain_ms"],
            "bound_ms": bound, "bound_by": bound_by,
            "library_ms": timings[f"{key}_library_ms"],
            "device_ms": timings[f"{key}_device_ms"],
            "library_device_ms": timings[f"{key}_library_device_ms"],
            "events_launches": turns["kernel"]["events_launches"],
            "edge_rel_err": {n: e[key] for n, e in edges.items()},
            "shapes": shapes + (" forward" if key == "alpha" else " backward"),
        })
    entries[1]["vocab_scatter"] = {"ms": timings["vocab_scatter_ms"],
                                   "device_ms": timings["vocab_scatter_device_ms"]}
    return entries


def viterbi_errors(log_probs, targets, input_lengths, target_lengths):
    """The Viterbi launch against the plain versions on one batch: the
    unpacked moves over the whole [T, B, S], the last row, score, path and
    labels, and ctc_viterbi_align_cuda against ctc_viterbi_align, each
    equal or not; the last row's max abs error; the outputs."""
    from voice100_tpu_torch.ops.ctc import (ctc_prep, ctc_viterbi_align, viterbi_backtrace,
                                            viterbi_final, viterbi_forward)
    from voice100_tpu_torch.ops.viterbi_cuda import (ctc_viterbi_align_cuda, unpack_moves,
                                                     viterbi_align_lattice_cuda)

    z, _, valid = ctc_prep(targets, target_lengths)
    score, path, labels, packed, last = viterbi_align_lattice_cuda(
        log_probs, z, valid, input_lengths, target_lengths)
    moves_ref, last_ref = viterbi_forward(log_probs, z, valid, input_lengths)
    final_ref, score_ref = viterbi_final(last_ref, target_lengths)
    path_ref, labels_ref = viterbi_backtrace(moves_ref, final_ref, input_lengths, z)
    whole = ctc_viterbi_align_cuda(log_probs, targets, input_lengths, target_lengths)
    whole_ref = ctc_viterbi_align(log_probs, targets, input_lengths, target_lengths)
    torch.cuda.synchronize()
    equal = {
        "moves": torch.equal(unpack_moves(packed, input_lengths, z.shape[1],
                                          log_probs.shape[1]), moves_ref),
        "last_row": torch.equal(last, last_ref), "score": torch.equal(score, score_ref),
        "path": torch.equal(path, path_ref), "labels": torch.equal(labels, labels_ref),
        "align_score": torch.equal(whole.score, whole_ref.score),
        "align_path": torch.equal(whole.path, whole_ref.path),
        "align_labels": torch.equal(whole.labels, whole_ref.labels),
    }
    return equal, (last - last_ref).abs().max().item(), (z, valid, score)


def viterbi_batch(rng, batch, time_steps, label_len, vocab=ASR_EN_BASE["vocab_size"]):
    """Seeded log-probs [B, T, V], random targets (ids 1..V-1, zeros past
    each target length), input lengths in [T/3, T] and target lengths at
    most half of them; row 0 takes the full T and label_len labels."""
    input_lengths = rng.integers(time_steps // 3, time_steps + 1, size=batch)
    target_lengths = np.minimum(rng.integers(1, label_len + 1, size=batch), input_lengths // 2)
    input_lengths[0], target_lengths[0] = time_steps, label_len
    targets = rng.integers(1, vocab, size=(batch, label_len))
    targets[np.arange(label_len)[None, :] >= target_lengths[:, None]] = 0
    logits = torch.from_numpy(rng.standard_normal((batch, time_steps, vocab)) * 2.0)
    return torch.log_softmax(logits.float(), dim=-1), targets, input_lengths, target_lengths


def on_card(device, log_probs, *arrays):
    return (log_probs.to(device),) + tuple(torch.from_numpy(np.asarray(a)).to(device)
                                           for a in arrays)


def check_viterbi_limit(device):
    """An S one past MAX_STATES raises ValueError on the card, launching
    nothing."""
    from voice100_tpu_torch.ops import viterbi_cuda

    s_len = viterbi_cuda.MAX_STATES + 1
    z = torch.zeros(2, s_len, dtype=torch.int32, device=device)
    lengths = torch.tensor([5, 4], dtype=torch.int32, device=device)
    before = viterbi_cuda.viterbi_align_lattice_cuda.launches
    try:
        viterbi_cuda.viterbi_align_lattice_cuda(torch.zeros(2, 5, 7, device=device), z, z,
                                                lengths, lengths)
    except ValueError as err:
        if viterbi_cuda.viterbi_align_lattice_cuda.launches != before:
            fail(f"Viterbi: S={s_len} launched before raising")
        return f"S={s_len} raised ValueError ({err}), launching nothing"
    fail(f"Viterbi: S={s_len} did not raise")


def check_viterbi(device, probe_us):
    """The Viterbi launch (kernels 6 and 7 and the final state) against the
    plain versions at B=64, T=512, V=29, L=160 (S=321) with ragged input
    lengths, a row of one repeated label, an empty target, a row that
    cannot align (100 frames for 160 labels), a row with nonzero labels
    past its target length, an input of one frame and one of no frames;
    then a batch with an empty label axis (S=1), the 40 s bucket's shape
    (B=8, T=2001, 560 labels: S=1121, 9 states a lane), the largest S
    (3071: six warps a sample, 16 states a lane) and a vocabulary of 1000
    classes (S=2001, about the largest S the two-kernel pair took there;
    its rows do not fit the shared-memory ring); and that S past the limit
    raises. Max and one float32 add are exact, so the unpacked
    moves, last row, score, path and labels must be equal. ``probe_us``:
    probe_ctc.py's Viterbi variants, microseconds a step at this shape."""
    from voice100_tpu_torch.ops.ctc import viterbi_backtrace, viterbi_final, viterbi_forward
    from voice100_tpu_torch.ops.viterbi_cuda import (viterbi_align_lattice_cuda,
                                                     viterbi_launch_smem, viterbi_layout)
    from voice100_tpu_torch.tools.probe_ctc import VITERBI_SHAPE

    batch, time_steps, vocab, label_len = ALIGN_BATCH, VITERBI_T, ASR_EN_BASE["vocab_size"], VITERBI_L
    rng = np.random.default_rng(SEED + 6)
    log_probs, targets, input_lengths, target_lengths = viterbi_batch(rng, batch, time_steps,
                                                                      label_len)
    targets[1], target_lengths[1] = 7, label_len                 # one repeated label
    target_lengths[2] = 0                                        # empty target
    input_lengths[3], target_lengths[3] = 100, label_len         # cannot align
    targets[4] = rng.integers(1, vocab, size=label_len)          # labels past its length
    input_lengths[5], target_lengths[5] = 1, 1                   # one frame
    input_lengths[6], target_lengths[6] = 0, 2                   # no frames
    main = on_card(device, log_probs, targets, input_lengths, target_lengths)
    log_probs, targets, input_lengths, target_lengths = main
    equal, err, (z, valid, score) = viterbi_errors(*main)
    s_len = z.shape[1]
    infeasible = score[3].item()

    others = {"empty label axis (S=1)": on_card(
        device, viterbi_batch(rng, 4, 64, 1)[0], np.zeros((4, 0), np.int64),
        [64, 1, 0, 30], [0, 0, 0, 0])}
    for name, (b, t, labels, v) in (
            ("40 s bucket (B=8, T=2001, S=1121)", (8, 2001, 560, vocab)),
            ("largest S (B=2, T=1600, S=3071)", (2, 1600, 1535, vocab)),
            ("1000 classes (B=4, T=400, S=2001)", (4, 400, 1000, 1000))):
        lp, tgt, il, tl = viterbi_batch(rng, b, t, labels, v)
        others[name] = on_card(device, lp, tgt, il, tl)
    edges = {}
    for name, case in others.items():
        e_equal, e_err, (e_z, e_valid, _) = viterbi_errors(*case)
        lay = viterbi_layout(e_z.shape[1])
        ring, _ = viterbi_launch_smem(e_z.shape[1], case[0].shape[2], lay.warps)
        args32 = [t.int().contiguous() for t in (e_z, e_valid, case[2], case[3])]
        edges[name] = {"equal": e_equal, "last_row_max_abs_err": e_err, "k": lay.k,
                       "warps": lay.warps, "ring": ring, "launch_ms": time_ms(
                           lambda: viterbi_align_lattice_cuda(case[0], *args32), iters=5)}
    limit = check_viterbi_limit(device)

    # the launch as the main path makes it, and the plain versions
    z32, valid32, il32, tl32 = (t.int().contiguous() for t in (z, valid, input_lengths,
                                                               target_lengths))

    def launch():
        return viterbi_align_lattice_cuda(log_probs, z32, valid32, il32, tl32)

    moves, last = viterbi_forward(log_probs, z, valid, input_lengths)
    final_pos, _ = viterbi_final(last, target_lengths)
    timings = {
        "launch_ms": time_ms(launch, iters=20),
        "forward_plain_ms": time_ms(lambda: viterbi_forward(log_probs, z, valid, input_lengths),
                                    iters=3, warmup=1),
        "backtrace_plain_ms": time_ms(lambda: viterbi_backtrace(moves, final_pos, input_lengths,
                                                                z), iters=3, warmup=1),
    }
    # the profiler has recorded none or one of the two events of this
    # launch in some runs: up to three tries before "not measured"
    for _ in range(3):
        timings["launch_device_ms"], _, counts = device_profile(launch)
        if timings["launch_device_ms"] is not None:
            break
    print(f"CTC Viterbi launch (B={batch}, T={time_steps}, V={vocab}, S={s_len}, "
          f"{viterbi_layout(s_len)}): equal to the plain versions {equal}; last-row max_abs_err "
          f"{err:.3e}; infeasible row score {infeasible:.3e}; "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in timings.items()), flush=True)
    for name, e in edges.items():
        print(f"CTC Viterbi edge batch {name}: k={e['k']}, {e['warps']} warp(s) a sample, rows "
              f"{'in the shared-memory ring' if e['ring'] else 'from device memory'}; equal "
              f"{e['equal']}; last-row max_abs_err {e['last_row_max_abs_err']:.3e}; launch "
              f"{e['launch_ms']:.4f} ms", flush=True)
    print(f"CTC Viterbi limit: {limit}", flush=True)
    for name, eq in {"check batch": equal, **{n: e["equal"] for n, e in edges.items()}}.items():
        if not all(eq.values()):
            fail(f"Viterbi launch differs from the plain versions on the {name}: {eq}")
    if infeasible > -1e29:
        fail(f"Viterbi: the row that cannot align scored {infeasible:.3e}")

    # least work of each phase on the inputs probe_ctc.py timed it on (every
    # row the full T and all its labels, so every step moves all S states),
    # whatever the kernel's own layout. Forward phase: the log_probs rows,
    # z, valid and the lengths read, the moves written at 2 bits a state of
    # a moved step, the last row and the score written; about 4 operations
    # a state of a moved step (two compares, a select, an add). Backtrace
    # phase: one move (2 bits) a moved step, z and the lengths read, path
    # and labels written; 2 operations a step.
    p_batch, p_time, p_vocab, p_labels = VITERBI_SHAPE
    p_states, p_moved = 2 * p_labels + 1, p_batch * (p_time - 1)
    fwd_bytes = (p_batch * p_time * p_vocab * 4 + 3 * p_batch * p_states * 4 + 3 * p_batch * 4
                 + p_moved * p_states / 4)
    bt_bytes = p_moved / 4 + p_batch * p_states * 4 + p_batch * 4 + 2 * p_batch * p_time * 4
    active = int(input_lengths.clamp(min=0, max=time_steps).sum())
    shapes = (f"ms, bound_ms and chain_floor_ms: probe_ctc.py's inputs (B={p_batch}, "
              f"T={p_time}, V={p_vocab}, S={p_states}, every row T: {p_moved} moved steps); "
              f"launch_ms and device_ms: the check batch (B={batch}, T={time_steps}, V={vocab}, "
              f"S={s_len}, ragged: {active} active steps), as plain_ms; no library call "
              f"computes a Viterbi alignment")
    # each phase timed alone by probe_ctc.py
    phase_ms = {v: us * p_time * 1e-3 for v, us in probe_us.items()}
    entries = []
    for name, source_line, variant, n_bytes, n_ops, abs_err, plain in (
            ("viterbi_forward", "voice100_tpu/ops/ctc_pallas.py:405", "no_backtrace", fwd_bytes,
             4 * p_moved * p_states, err, timings["forward_plain_ms"]),
            ("viterbi_backtrace", "voice100_tpu/ops/ctc_pallas.py:440", "no_forward", bt_bytes,
             2 * p_batch * p_time, 0.0, timings["backtrace_plain_ms"])):
        bound, bound_by = bound_ms(n_bytes, n_ops)
        entries.append({
            "name": name, "route": "cuda", "source": "voice100_tpu_torch/csrc/viterbi.cu",
            "replaces": source_line, "counter": "viterbi_align", "launches": None,
            "max_abs_err": abs_err, "ms": phase_ms[variant],
            "ms_is": f"this phase of the one launch: probe_ctc.py's {variant} variant",
            "plain_ms": plain, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "launch_probe_ms": phase_ms["full"],
            "launch_ms": timings["launch_ms"], "device_ms": timings["launch_device_ms"],
            "device_ms_is": "the whole launch (both phases and the final state)",
            "library_device_ms": None, "events_launches": counts, "shapes": shapes,
            "step_us_by_variant": probe_us,
        })
    entries[0]["chain_floor_ms"] = phase_ms["chain_floor"]
    entries[1]["chain_floor_ms"] = phase_ms["walk_only"]
    entries[0]["edge_batches"] = edges
    entries[0]["limit"] = limit
    return entries


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
    n_batches = sum(1 for _ in gpu_pipe.batches(clips))
    if launches["log_mel"] != n_batches:
        fail(f"serve: the log-mel kernel launched {launches['log_mel']} times for "
             f"{n_batches} batches, not once a batch")
    # kernel 1: one persistent launch a layer a batch
    if launches["bilstm_recurrence"] != ASR_EN_BASE["decoder_num_layers"] * n_batches:
        fail(f"serve: the biLSTM kernel launched {launches['bilstm_recurrence']} times for "
             f"{n_batches} batches, not once a layer a batch")

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
        # host time to enqueue the biLSTM (two projections, two persistent
        # launches): when it is close to the card time above, the card
        # waits on the host
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(5):
            model.lstm(x, x_len)
        parts["bilstm_host_enqueue"] = (time.perf_counter() - start) * 1e3 / 5
        torch.cuda.synchronize()
    print("stages_ms " + json.dumps({"batch": list(wav.shape), **parts}), flush=True)


TRAIN_KERNELS = ("bilstm_train_fwd", "bilstm_train_bwd", "ctc_alpha", "ctc_adjoint")


def train_counters():
    from voice100_tpu_torch.ops.ctc_cuda import ctc_alpha_adjoint_cuda, ctc_alpha_cuda
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_train_bwd_cuda, bilstm_train_fwd_cuda

    return dict(zip(TRAIN_KERNELS, (bilstm_train_fwd_cuda, bilstm_train_bwd_cuda,
                                    ctc_alpha_cuda, ctc_alpha_adjoint_cuda)))


def train_batch(device):
    """64 int16 clips of 2-10 s in the 10 s bucket, turned into features
    by the log-mel kernel and masked past each clip to the blank level,
    with random targets of about 14 ids a second:
    ``((mel, mel_len), (text, text_len))`` on the card, and the seconds."""
    from voice100_tpu_torch.ops.mask import BLANK_AUDIO, sequence_mask
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    rng = np.random.default_rng(SEED + 3)
    seconds = rng.uniform(2.0, 10.0, size=TRAIN_BATCH)
    seconds[0] = 10.0
    clips = int16_clips(rng, seconds)
    pcm = np.zeros((TRAIN_BATCH, 10 * SAMPLE_RATE), np.int16)
    for row, clip in enumerate(clips):
        pcm[row, :len(clip)] = clip
    wav_len = torch.tensor([len(c) for c in clips], device=device)
    with torch.no_grad():
        wav = torch.from_numpy(pcm).to(device).float() * (1.0 / 32768.0)
        mel = log_mel_spectrogram_cuda(wav, sample_rate=SAMPLE_RATE)
        mel_len = wav_len // 160 + 1
        mel = torch.where(sequence_mask(mel_len, mel.shape[1], torch.bool)[:, :, None], mel,
                          BLANK_AUDIO)
    targets, target_lengths = ctc_targets(rng, seconds, ASR_EN_BASE["vocab_size"])
    targets[np.arange(targets.shape[1])[None, :] >= target_lengths[:, None]] = 0
    text = torch.from_numpy(targets).to(device)
    text_len = torch.from_numpy(target_lengths).to(device)
    return ((mel, mel_len), (text, text_len)), float(seconds.sum())


def train(device, card):
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    model = AudioToAlignText(**ASR_EN_BASE, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    batch, audio_sec = train_batch(device)
    trainer = Trainer(TrainerConfig(gradient_clip_val=1.0))
    task = make_task(model)
    state = TrainState(model, task.make_optimizer())
    gen = torch.Generator(device=device).manual_seed(SEED)
    counters = train_counters()
    warm = float(trainer.train_step(task, state, batch, gen)["loss"])   # warm-up
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = [], []
    for _ in range(TIMED_STEPS):
        start = time.perf_counter()
        losses.append(float(trainer.train_step(task, state, batch, gen)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    median = float(np.median(step_ms))
    print(f"train asr_en_base: batch {TRAIN_BATCH} ({audio_sec:.2f} s of audio, 10 s bucket), "
          f"augmentation and dropout on; loss warm-up {warm:.4f}, then "
          f"{[round(v, 4) for v in losses]}; step median {median:.2f} ms "
          f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
          f"{audio_sec / (median * 1e-3):.1f} audio s/s on {card}; launches over "
          f"{TIMED_STEPS} steps {launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"train: non-finite loss {losses}")
    if not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"train: the loss does not fall on one repeated batch: {losses}")
    for name, count in launches.items():
        if count == 0:
            fail(f"the training path never launched the {name} kernel")
    # kernel 2: one persistent launch a layer a step; kernel 3: a gate pass
    # and one cooperative recurrence a layer a step; kernels 4 and 5 once a step
    layers = ASR_EN_BASE["decoder_num_layers"]
    for name, per_step in (("bilstm_train_fwd", layers), ("bilstm_train_bwd", 2 * layers),
                           ("ctc_alpha", 1), ("ctc_adjoint", 1)):
        want = per_step * TIMED_STEPS
        if launches[name] != want:
            fail(f"train: {name} launched {launches[name]} times in {TIMED_STEPS} steps, "
                 f"not {want}")
    train_stages(trainer, task, state, batch, gen)
    return launches


def train_stages(trainer, task, state, batch, gen):
    """Card time of each layer of one training step (CUDA events), the
    backward split by layer through autograd.grad on a retained graph."""
    from voice100_tpu_torch.models.layers import conv_stack_output_length
    from voice100_tpu_torch.ops.augment import apply_augment, draw_augment
    from voice100_tpu_torch.ops.ctc_cuda import ctc_loss_cuda
    from voice100_tpu_torch.training.trainer import clip_by_global_norm

    model = state.model.train()
    (audio, audio_len), (text, text_len) = batch
    enc_params = list(model.encoder.parameters())
    lstm_params = list(model.lstm.parameters())
    dense_params = list(model.dense.parameters())

    def augment():
        return apply_augment(audio, audio_len, draw_augment(gen, *audio.shape))

    mel, mel_len = augment()
    x = model.encoder(mel)
    x_len = conv_stack_output_length(model.encoder_settings, mel_len)
    h = model.lstm(x, x_len, gen)
    lp = torch.log_softmax(model.dense(h), dim=-1)
    loss = ctc_loss_cuda(lp, text, x_len, text_len)
    g_lp, g_h, g_x = torch.autograd.grad(loss, [lp, h, x], retain_graph=True)
    parts = {
        "augment": time_ms(augment),
        "conv_encoder_fwd": time_ms(lambda: model.encoder(mel)),
        "bilstm_fwd": time_ms(lambda: model.lstm(x, x_len, gen), iters=3),
        "dense_logsoftmax_fwd": time_ms(lambda: torch.log_softmax(model.dense(h), dim=-1)),
        "ctc_fwd": time_ms(lambda: ctc_loss_cuda(lp, text, x_len, text_len)),
        "ctc_bwd": time_ms(lambda: torch.autograd.grad(loss, lp, retain_graph=True)),
        "dense_logsoftmax_bwd": time_ms(lambda: torch.autograd.grad(
            lp, [h, *dense_params], g_lp, retain_graph=True)),
        "bilstm_bwd": time_ms(lambda: torch.autograd.grad(
            h, [x, *lstm_params], g_h, retain_graph=True), iters=3),
        "conv_encoder_bwd": time_ms(lambda: torch.autograd.grad(
            x, enc_params, g_x, retain_graph=True)),
        "backward_total": time_ms(lambda: torch.autograd.grad(
            loss, list(model.parameters()), retain_graph=True), iters=3),
    }
    loss.backward()
    parts["clip_adam"] = time_ms(lambda: (clip_by_global_norm(model.parameters(), 1.0),
                                          state.optimizer.step()))
    # host time to enqueue one whole step: close to its card time, the
    # card waits on the host's launch loops
    torch.cuda.synchronize()
    start = time.perf_counter()
    trainer.train_step(task, state, batch, gen)
    parts["step_host_enqueue"] = (time.perf_counter() - start) * 1e3
    torch.cuda.synchronize()
    print("train_stages_ms " + json.dumps({"batch": list(audio.shape), **parts}), flush=True)


def train_parity(device):
    """Three steps from the same weights on the first clips of the train
    batch, augmentation and dropout off, on the card and on the CPU."""
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    (mel, mel_len), (text, text_len) = train_batch(device)[0]
    rows = slice(0, PARITY_BATCH)
    batch = ((mel[rows], mel_len[rows]), (text[rows], text_len[rows]))
    cpu_model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                                 generator=torch.Generator().manual_seed(SEED + 4))
    results = []
    for model, where in ((copy.deepcopy(cpu_model).to(device), device), (cpu_model, "cpu")):
        trainer = Trainer(TrainerConfig(gradient_clip_val=1.0))
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        side_batch = tuple(tuple(t.to(where) for t in pair) for pair in batch)
        losses, first_grads = [], None
        start = time.perf_counter()
        for _ in range(PARITY_STEPS):
            losses.append(float(trainer.train_step(task, state, side_batch, train=False)["loss"]))
            if first_grads is None:
                first_grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        results.append((losses, first_grads, time.perf_counter() - start))
    (card_losses, card_grads, card_s), (cpu_losses, cpu_grads, cpu_s) = results
    grad_err = max(((card_grads[n] - g).norm() / g.norm()).item() for n, g in cpu_grads.items())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    print(f"train parity, card vs CPU plain path (batch {PARITY_BATCH}, {PARITY_STEPS} steps, "
          f"augmentation and dropout off): losses card {card_losses}, CPU {cpu_losses}, "
          f"max rel err {loss_err:.3e} (tol {PARITY_LOSS_TOL:.0e}); first-step gradients max "
          f"rel-norm err {grad_err:.3e} over {len(cpu_grads)} tensors (tol "
          f"{PARITY_GRAD_TOL:.0e}); card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
    if not all(np.isfinite(card_losses)) or not loss_err <= PARITY_LOSS_TOL:
        fail(f"train parity: card losses {card_losses} vs CPU {cpu_losses}")
    if not grad_err <= PARITY_GRAD_TOL:
        fail(f"train parity: first-step gradients differ by {grad_err:.3e} (relative norm)")


ALIGN_KERNELS = ("bilstm_recurrence", "viterbi_align", "log_mel")


def align_counters():
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda
    from voice100_tpu_torch.ops.viterbi_cuda import viterbi_align_lattice_cuda

    return dict(zip(ALIGN_KERNELS, (bilstm_cuda, viterbi_align_lattice_cuda,
                                    log_mel_spectrogram_cuda)))


def write_align_corpus(root: str):
    """A dummy_en corpus (the registry's layout) of ALIGN_CLIPS int16 WAVs
    of 2-10 s, noise under a slow envelope, each with a text of random
    letters and spaces, about 14 characters a second and at most 150;
    the config asr_en_base with dataset dummy_en; seeded random weights
    saved as a port checkpoint. Returns (the align CLI's arguments as a
    dict, the texts, the clip lengths in samples)."""
    import yaml
    from voice100_tpu_torch.dsp.wav import write_wav
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    rng = np.random.default_rng(SEED + 8)
    seconds = rng.uniform(2.0, 10.0, size=ALIGN_CLIPS)
    clips = int16_clips(rng, seconds)
    data_dir = os.path.join(root, "data")
    wavs = os.path.join(data_dir, "dummy-speech-en", "wavs")
    os.makedirs(wavs)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz  "))
    texts = []
    for i, (sec, clip) in enumerate(zip(seconds, clips)):
        chars = rng.choice(letters, size=min(int(round(sec * 14)), 150))
        chars[0] = chars[-1] = "a"
        texts.append("".join(chars))
        write_wav(os.path.join(wavs, f"clip{i:04d}.wav"), clip, SAMPLE_RATE)
    ids = [f"clip{i:04d}" for i in range(ALIGN_CLIPS)]
    with open(os.path.join(data_dir, "dummy-speech-en", "metadata.csv"), "w") as f:
        f.writelines(f"{c}|{t}|{t}\n" for c, t in zip(ids, texts))
    with open(os.path.join(data_dir, "dummy_en-train.txt"), "w") as f:
        f.writelines(f"{c}|{t}\n" for c, t in zip(ids, texts))
    with open("config/asr_en_base.yaml") as f:
        config = yaml.safe_load(f)
    config["data"]["init_args"]["dataset"] = "dummy_en"
    config_path = os.path.join(root, "asr_en_base_dummy_en.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(config, f)
    model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                             generator=torch.Generator().manual_seed(SEED + 9))
    ckpt = os.path.join(root, "asr_en_base_random.pt")
    save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())))
    args = {"config": config_path, "checkpoint": ckpt, "data_dir": data_dir,
            "cache_dir": os.path.join(root, "cache"),
            "output": os.path.join(root, "dummy_en-align-train.txt")}
    return args, texts, [len(c) for c in clips]


def check_align_lines(path, texts, samples):
    """128 lines, the clips' texts in order, and counts of 2 len(text) + 1
    slots summing to each clip's logit length; returns the lines."""
    from voice100_tpu_torch.models.layers import conv_stack_output_length

    with open(path) as f:
        lines = [line.rstrip("\n").split("|") for line in f]
    if len(lines) != ALIGN_CLIPS:
        fail(f"align: {len(lines)} lines for {ALIGN_CLIPS} clips")
    for i, ((text, aligntext, counts), want, n) in enumerate(zip(lines, texts, samples)):
        counts = [int(c) for c in counts.split()]
        frames = conv_stack_output_length(ASR_EN_BASE["encoder_settings"], n // 160 + 1)
        if text != want or len(counts) != 2 * len(text) + 1 or sum(counts) != frames \
                or len(aligntext) != frames:
            fail(f"align: line {i} has text {text[:20]!r}..., {len(counts)} counts summing to "
                 f"{sum(counts)}, for {len(want)} characters and {frames} frames")
    return lines


def align(device, card, workdir):
    """Forced alignment of a 128-clip corpus through the align CLI on the
    card, twice: a cold feature cache (the log-mel kernel once a clip),
    then a warm one, timed; launch counts set to 0 just before each run
    and read just after. Then each batch's labels against the plain
    Viterbi on the card's own log-probs, and the card time by layer of
    one batch."""
    from voice100_tpu_torch.tools.align_text import cli_main

    args, texts, samples = write_align_corpus(workdir)
    argv = [item for key, value in args.items() for item in (f"--{key}", value)]
    audio_sec = sum(samples) / SAMPLE_RATE
    counters = align_counters()
    runs = {}
    for run in ("cold", "warm"):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        start = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        runs[run] = {"wall_s": wall, "audio_s_per_s": audio_sec / wall,
                     "launches": {name: fn.launches for name, fn in counters.items()}}
        lines = check_align_lines(args["output"], texts, samples)
    batches = -(-ALIGN_CLIPS // ALIGN_BATCH)
    print(f"align asr_en_base: {ALIGN_CLIPS} clips, {audio_sec:.2f} s of audio, batch "
          f"{ALIGN_BATCH} on {card}: " + "; ".join(
              f"{run} cache {r['wall_s']:.3f} s, {r['audio_s_per_s']:.1f} audio s/s, launches "
              f"{r['launches']}" for run, r in runs.items()), flush=True)
    for run, r in runs.items():
        got = r["launches"]
        if got["viterbi_align"] != batches:
            fail(f"align ({run}): the Viterbi kernel launched {got}, not once a batch")
        if got["bilstm_recurrence"] != ASR_EN_BASE["decoder_num_layers"] * batches:
            fail(f"align ({run}): the biLSTM kernel launched {got['bilstm_recurrence']} times, "
                 f"not once a layer a batch")
    if runs["cold"]["launches"]["log_mel"] != ALIGN_CLIPS or runs["warm"]["launches"]["log_mel"]:
        fail(f"align: the log-mel kernel launched {runs['cold']['launches']['log_mel']} times cold "
             f"and {runs['warm']['launches']['log_mel']} warm, not once a clip and then never")
    align_batches_vs_plain(device, args, lines)
    return runs, args, samples


def build_align(args, device, batch_size=None):
    """The CLI's model (weights loaded) and predict data module."""
    from voice100_tpu_torch.training import load_model_weights
    from voice100_tpu_torch.training.cli import build_from_config, load_config

    overrides = {"data_dir": args["data_dir"], "cache_dir": args["cache_dir"]}
    if batch_size:
        overrides["batch_size"] = batch_size
    model, data = build_from_config(load_config(args["config"]), overrides, device=device)
    load_model_weights(args["checkpoint"], model)
    data.setup("predict")
    return model.eval(), data


def align_batches_vs_plain(device, args, lines):
    """Each batch of the run again: the kernels' labels against the plain
    Viterbi on the same card log-probs, and against the written aligned
    text; then the card time by layer of the first batch."""
    from voice100_tpu_torch.ops.ctc import ctc_prep, ctc_viterbi_align
    from voice100_tpu_torch.ops.viterbi_cuda import viterbi_align_lattice_cuda
    from voice100_tpu_torch.tools.align_text import fetch_alignment, upload_batch as upload

    model, data = build_align(args, device)
    tokenizer = data.text_transform
    row = 0
    for batch, n_real in data.predict_dataloader().iter_with_counts():
        audio, audio_len, text, text_len = upload(batch, device)
        with torch.inference_mode():
            logits, logits_len = model(audio, audio_len)
            log_probs = torch.log_softmax(logits, dim=-1)
            res, _ = model.ctc_best_path(audio, audio_len, text, text_len)
            ref = ctc_viterbi_align(log_probs, text, logits_len,
                                    torch.minimum(logits_len, text_len))
        if not (torch.equal(res.labels, ref.labels) and torch.equal(res.path, ref.path)
                and torch.equal(res.score, ref.score)):
            fail(f"align: the kernels' alignment of the batch at row {row} differs from the "
                 f"plain Viterbi on the same log-probs")
        _, labels, n_frames = fetch_alignment(res, logits_len)
        for i in range(n_real):
            if tokenizer.decode(labels[i, :n_frames[i]]) != lines[row + i][1]:
                fail(f"align: line {row + i}'s aligned text is not the kernels' labels")
        row += n_real
    print(f"align: labels, paths and scores of all {row} rows equal the plain Viterbi on the "
          f"card's log-probs, and the written aligned texts", flush=True)

    loader = data.predict_dataloader()
    start = time.perf_counter()
    batch, n_real = next(loader.iter_with_counts())
    data_ms = (time.perf_counter() - start) * 1e3
    audio, audio_len, text, text_len = upload(batch, device)
    with torch.inference_mode():
        logits, logits_len = model(audio, audio_len)
        lp = torch.log_softmax(logits, dim=-1)
        text_cap = torch.minimum(logits_len, text_len)
        z, _, valid = ctc_prep(text, text_cap)
        res, _ = model.ctc_best_path(audio, audio_len, text, text_len)
        parts = {
            "data_load_collate_host": data_ms,
            "upload": time_ms(lambda: upload(batch, device)),
            "model_forward": time_ms(lambda: model(audio, audio_len), iters=5),
            "log_softmax": time_ms(lambda: torch.log_softmax(logits, dim=-1)),
            "viterbi_align_kernel": time_ms(lambda: viterbi_align_lattice_cuda(
                lp, z, valid, logits_len, text_cap)),
        }
        torch.cuda.synchronize()
        start = time.perf_counter()
        _, labels, n_frames = fetch_alignment(res, logits_len)
        out = [tokenizer.decode(labels[i, :n_frames[i]]) for i in range(n_real)]
        parts["fetch_and_write_host"] = (time.perf_counter() - start) * 1e3
    print("align_stages_ms " + json.dumps({"batch": list(audio.shape), "rows": n_real,
                                           "lines": len(out), **parts}), flush=True)
    return parts


def align_parity(device, args, workdir):
    """The first 8 clips through run_align on the card and on the CPU's
    plain path, from the same warm cache, and their log-probs, Viterbi
    scores and paths side by side."""
    from voice100_tpu_torch.data.datasets import SubsetDataset
    from voice100_tpu_torch.tools.align_text import run_align, upload_batch as upload

    sides = []
    for where in (device, "cpu"):
        model, data = build_align(args, where, batch_size=ALIGN_PARITY_CLIPS)
        data.predict_ds = SubsetDataset(data.predict_ds, range(ALIGN_PARITY_CLIPS))
        batch, _ = next(data.predict_dataloader().iter_with_counts())
        audio, audio_len, text, text_len = upload(batch, where)
        start = time.perf_counter()
        with torch.inference_mode():
            logits, logits_len = model(audio, audio_len)
            log_probs = torch.log_softmax(logits, dim=-1).cpu()
            res, _ = model.ctc_best_path(audio, audio_len, text, text_len)
        out = os.path.join(workdir, f"parity-{len(sides)}.txt")
        run_align(model, data, out, device=where)
        with open(out) as f:
            sides.append((log_probs, logits_len.cpu(), res.score.cpu(), res.path.cpu(),
                          f.read().splitlines(), time.perf_counter() - start))
    (lp, n, score, path, lines, card_s), (lp_c, n_c, score_c, path_c, lines_c, cpu_s) = sides
    if not torch.equal(n, n_c):
        fail("align parity: logit lengths differ between card and CPU")
    valid = torch.arange(lp.shape[1])[None, :] < n[:, None]
    lp_err = (lp - lp_c).abs()[valid].max().item()
    score_err = ((score - score_c).abs() / score_c.abs()).max().item()
    agree = (path == path_c)[valid].float().mean().item()
    same_lines = sum(a == b for a, b in zip(lines, lines_c))
    print(f"align parity, card vs CPU plain path ({ALIGN_PARITY_CLIPS} clips, "
          f"{int(valid.sum())} frames): log-probs max_abs_err {lp_err:.3e} (tol {LOGIT_TOL:.0e}); "
          f"scores max rel err {score_err:.3e} (tol {ALIGN_SCORE_REL_TOL:.0e}); paths equal on "
          f"{agree:.4%} of frames (min {ALIGN_PATH_AGREEMENT:.0%}); run_align lines equal "
          f"{same_lines}/{len(lines_c)}; card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
    if not lp_err <= LOGIT_TOL:
        fail(f"align parity: log-probs differ by {lp_err:.3e}")
    if not score_err <= ALIGN_SCORE_REL_TOL:
        fail(f"align parity: Viterbi scores differ by {score_err:.3e} relative")
    if not agree >= ALIGN_PATH_AGREEMENT:
        fail(f"align parity: paths agree on {agree:.4%} of frames only")
    return {"log_probs_max_abs_err": lp_err, "score_max_rel_err": score_err,
            "path_agreement": agree}


CLI_EPOCHS = 3
# validate on last.pt against the last epoch's val_loss: the same weights,
# batch and kernels, so only a stale weight (the biLSTM's stacked-weight
# cache) or a different val split could move it by more
CLI_VAL_REL_TOL = 1e-5


def cli_counters():
    return {**align_counters(), **train_counters()}


def cli_phase(device, card, workdir, align_args, samples):
    """asr_en_base through the training CLI on the card (training/cli.py
    ``main``, as ``python -m voice100_tpu_torch`` runs it): ``fit`` for
    CLI_EPOCHS epochs on the align corpus with a cold feature cache, then
    ``validate``, ``test`` and ``predict`` on the ``last.pt`` it wrote; the
    launch counts set to 0 just before each subcommand and read just
    after. Checks the log, the checkpoints, the validate loss against the
    last epoch's and the predictions against the card's own greedy
    decode."""
    import yaml
    from voice100_tpu_torch.training import load_model_weights
    from voice100_tpu_torch.training.cli import build_from_config, load_config, main

    config = load_config(align_args["config"])
    config["trainer"].update(max_epochs=CLI_EPOCHS, log_every_n_steps=1)
    cfg = os.path.join(workdir, "asr_en_base_dummy_en_fit.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    ckpt = os.path.join(workdir, "fit_ckpt")
    log = os.path.join(workdir, "fit_log.jsonl")
    common = ["--config", cfg, "--data_dir", align_args["data_dir"],
              "--cache_dir", os.path.join(workdir, "fit_cache"), "--checkpoint_dir", ckpt,
              "--device", str(device)]
    last = os.path.join(ckpt, "last.pt")
    predictions = os.path.join(workdir, "predictions.txt")
    counters = cli_counters()
    runs, results = {}, {}
    for sub, extra in (("fit", ["--log_path", log]), ("validate", ["--restore_from", last]),
                       ("test", ["--restore_from", last]),
                       ("predict", ["--restore_from", last, "--output", predictions])):
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        start = time.perf_counter()
        results[sub] = main([sub, *common, *extra])
        torch.cuda.synchronize()
        runs[sub] = {"wall_s": time.perf_counter() - start,
                     "launches": {name: fn.launches for name, fn in counters.items()}}

    model, data = build_from_config(config, {"data_dir": align_args["data_dir"],
                                             "cache_dir": os.path.join(workdir, "fit_cache")},
                                    device=device)
    data.setup("fit")
    n_train, n_val = len(data.train_ds), len(data.valid_ds)
    train_sec = sum(samples[i] for i in data.train_ds._dataset._indices) / SAMPLE_RATE
    bs, layers = data.batch_size, ASR_EN_BASE["decoder_num_layers"]
    steps, val_batches = CLI_EPOCHS * -(-n_train // bs), -(-n_val // bs)
    all_batches = -(-ALIGN_CLIPS // bs)
    # an evaluated batch: kernel 1 twice a layer (the loss and the CER
    # decode are two forwards) and kernel 4 once (the loss)
    evals = val_batches * CLI_EPOCHS
    want = {
        "fit": {"log_mel": ALIGN_CLIPS, "bilstm_recurrence": 2 * layers * evals,
                "bilstm_train_fwd": layers * steps, "bilstm_train_bwd": 2 * layers * steps,
                "ctc_alpha": steps + evals, "ctc_adjoint": steps, "viterbi_align": 0},
        "validate": {"bilstm_recurrence": 2 * layers * val_batches, "ctc_alpha": val_batches},
        "test": {"bilstm_recurrence": 2 * layers * all_batches, "ctc_alpha": all_batches},
        "predict": {"bilstm_recurrence": layers * all_batches},
    }
    for sub, counts in want.items():
        full = dict.fromkeys(counters, 0)
        full.update(counts)
        if runs[sub]["launches"] != full:
            fail(f"cli {sub}: launches {runs[sub]['launches']}, not {full}")

    with open(log) as f:
        records = [json.loads(line) for line in f]
    starts = [r for r in records if r.get("event") == "fit_start"]
    epochs = [r for r in records if "train_time_s" in r]
    step_losses = [r["train_loss"] for r in records
                   if "train_loss" in r and "train_time_s" not in r]
    keys = ("val_loss", "val_cer", "val_wer")
    if len(starts) != 1 or len(epochs) != CLI_EPOCHS or not all(
            np.isfinite(r.get(k, np.nan)) for r in epochs for k in keys):
        fail(f"cli fit: log has {len(starts)} fit_start records and epoch records {epochs}")
    per_epoch = steps // CLI_EPOCHS
    if len(step_losses) != steps or not np.all(np.isfinite(step_losses)) or not (
            np.mean(step_losses[-per_epoch:]) < np.mean(step_losses[:per_epoch])):
        fail(f"cli fit: the train loss is not finite or does not fall: {step_losses}")
    for name in ("best.pt", "last.pt"):
        if not os.path.isfile(os.path.join(ckpt, name)):
            fail(f"cli fit: {name} was not written")
    val, last_val = results["validate"], epochs[-1]["val_loss"]
    val_err = abs(val["loss"] - last_val) / abs(last_val)
    if not val_err <= CLI_VAL_REL_TOL:
        fail(f"cli validate: val_loss {val['loss']} on last.pt, the last epoch logged {last_val}")

    load_model_weights(last, model)
    model.eval()
    data.setup("predict")
    tokenizer = data.text_transform
    want_lines = []
    with torch.no_grad():
        for batch, n_real in data.predict_dataloader().iter_with_counts():
            (audio, audio_len), _ = batch
            ids, out_len = model.greedy_decode(torch.from_numpy(audio).to(device).float(),
                                               torch.from_numpy(audio_len).to(device))
            ids, out_len = ids.cpu().numpy(), out_len.cpu().numpy()
            want_lines += [tokenizer.merge_repeated(tokenizer.decode(ids[i, :out_len[i]]))
                           for i in range(n_real)]
    with open(predictions) as f:
        lines = f.read().splitlines()
    if len(lines) != ALIGN_CLIPS or lines != want_lines:
        fail(f"cli predict: {len(lines)} lines for {ALIGN_CLIPS} clips, "
             f"{sum(a == b for a, b in zip(lines, want_lines))} equal to the card's greedy decode")

    fit_s = runs["fit"]["wall_s"]
    print(f"cli asr_en_base on {card}: fit {CLI_EPOCHS} epochs ({n_train} train clips, "
          f"{train_sec:.2f} s of audio, {n_val} val clips, batch {bs}, cold feature cache) "
          f"{fit_s:.3f} s, {fit_s / CLI_EPOCHS:.3f} s an epoch by host clock with validation; "
          f"train time by epoch " + ", ".join(
              f"{r['train_time_s']} s ({train_sec / max(r['train_time_s'], 1e-9):.1f} audio s/s)"
              for r in epochs) + f"; step losses {[round(v, 4) for v in step_losses]}; "
          f"val_loss by epoch {[round(r['val_loss'], 4) for r in epochs]}", flush=True)
    print(f"cli validate on last.pt: val_loss {val['loss']:.6f} against the last epoch's "
          f"{last_val:.6f} (rel err {val_err:.2e}, tol {CLI_VAL_REL_TOL:.0e}), val_cer "
          f"{val['cer']:.4f} ({epochs[-1]['val_cer']:.4f} logged); test {results['test']}; "
          f"predict wrote {len(lines)} lines, all equal to the card's greedy decode", flush=True)
    print("cli_runs " + json.dumps({sub: {"wall_s": r["wall_s"], "launches": r["launches"]}
                                    for sub, r in runs.items()}), flush=True)
    return {sub: r["launches"] for sub, r in runs.items()}


TTS_STAGE_KEYS = ("phonemize_tokenize", "align_model", "duration_fetch", "cursor_host",
                  "expansion", "audio_encoder", "decoder_convs", "projection_unnormalize",
                  "mc2sp", "codeap_host", "synthesis", "fetch")


def write_tts_checkpoints(root: str):
    """Seeded full-width align and audio models, the duration bias and the
    statistics set, saved as port checkpoints; returns {name: (config,
    checkpoint)}."""
    from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    paths = {}
    for i, (name, cls, kwargs, config) in enumerate((
            ("align", TextToAlignText, ALIGN_EN_BASE, "config/align_en_base.yaml"),
            ("audio", AlignTextToAudio, TTS_EN_BASE, "config/tts_en_base.yaml"))):
        model = cls(**kwargs, device="cpu", generator=torch.Generator().manual_seed(SEED + 12 + i))
        with torch.no_grad():
            if name == "align":
                model.dense.bias.copy_(torch.tensor(TTS_DURATION_BIAS))
            else:
                for key, value in TTS_STATS.items():
                    getattr(model.norm, key).copy_(torch.tensor(value))
        ckpt = os.path.join(root, f"{name}_en_base_random.pt")
        save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())))
        paths[name] = (config, ckpt)
    return paths


def tts_stages(pipe, texts, noise=None, timed=False):
    """TTSPipeline._synthesize_batch stage by stage on one batch: each
    intermediate (host arrays, and the stage's inputs on the pipeline's
    device), and with ``timed`` each stage's time (``tts_stages_ms``: card
    stages by CUDA events, host stages by host clock after a sync)."""
    from voice100_tpu_torch.inference import _bucket
    from voice100_tpu_torch.ops.duration import duration_spans

    dev, model, vocoder = pipe.device, pipe.audio_model, pipe.vocoder
    ms = {}

    def host_ms(fn, reps=5):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(reps):
            out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return (time.perf_counter() - start) * 1e3 / reps, out

    def card_ms(fn, iters=5):
        return time_ms(fn, iters=iters, warmup=1) if timed else None

    def encode():
        return [pipe.tokenizer(pipe.phonemizer(t)) for t in texts]

    out = {}
    with torch.inference_mode():
        ms["phonemize_tokenize"], encoded = host_ms(encode)
        text_bucket = _bucket(max(len(e) for e in encoded), pipe.text_buckets)
        text = np.zeros((len(texts), text_bucket), np.int32)
        text_len = np.ones(len(texts), np.int32)
        for i, e in enumerate(encoded):
            e = e[:text_bucket]
            text[i, :len(e)] = e
            text_len[i] = max(len(e), 1)
        text_t = torch.from_numpy(text).to(dev)
        len_t = torch.from_numpy(text_len).to(dev)
        durations_t = pipe.align_model.predict(text_t, len_t)
        ms["align_model"] = card_ms(lambda: pipe.align_model.predict(text_t, len_t))
        ms["duration_fetch"], durations = host_ms(lambda: durations_t.cpu().numpy())
        ms["cursor_host"], _ = host_ms(lambda: duration_spans(durations))
        mask = np.arange(text_bucket)[None, :] < text_len[:, None]
        need = int(np.max((durations * mask[:, :, None]).sum(axis=(1, 2)))) + text_bucket + 16
        out_len = _bucket(need, pipe.frame_buckets)
        aligntext, aligntext_len = pipe.align_model.align(text_t, durations, len_t, out_len)
        ms["expansion"] = card_ms(
            lambda: pipe.align_model.align(text_t, durations, len_t, out_len))
        x = model.embedding(aligntext.long())
        h = model.lstm(x, aligntext_len)
        ms["audio_encoder"] = card_ms(lambda: model.lstm(model.embedding(aligntext.long()),
                                                         aligntext_len))
        y = model.decoder(h)
        ms["decoder_convs"] = card_ms(lambda: model.decoder(h))
        f0, feat, codeap = model.predict(aligntext, aligntext_len)

        def tail():
            p = model.projection(y)
            f0_, sp_, cap_ = model.norm.unnormalize(p[:, :, 1], p[:, :, 2:27], p[:, :, 28:])
            return (torch.where(p[:, :, 0] < 0, 0.0, f0_), sp_,
                    torch.where(p[:, :, 27:28] < 0, 0.0, cap_))

        ms["projection_unnormalize"] = card_ms(tail)
        ms["mc2sp"] = card_ms(
            lambda: torch.clamp(torch.exp(feat @ vocoder._mc2sp32) - vocoder.log_offset, min=0.0))
        ms["codeap_host"], ap = host_ms(lambda: torch.from_numpy(
            vocoder._aperiodicity(codeap.cpu().numpy()).astype(np.float32)).to(dev))
        audio_lens = np.minimum(aligntext_len.cpu().numpy() * 2, f0.shape[1])
        wav_t = None
        if timed:
            from voice100_tpu_torch.dsp.world import synthesize_batch

            spc = torch.clamp(torch.exp(feat @ vocoder._mc2sp32) - vocoder.log_offset, min=0.0)
            ms["synthesis"] = card_ms(lambda: synthesize_batch(f0, spc, ap), iters=3)
            wav_t = synthesize_batch(f0, spc, ap)
            ms["fetch"], _ = host_ms(lambda: wav_t.cpu().numpy())
        wav = vocoder.decode_batch(f0, feat, codeap, audio_lens, noise=noise)
    out.update(text=text, text_len=text_len, durations=durations, out_len=out_len,
               aligntext=aligntext.cpu().numpy(), aligntext_len=aligntext_len.cpu().numpy(),
               f0=f0.cpu().numpy(), feat=feat.cpu().numpy(), codeap=codeap.cpu().numpy(),
               audio_lens=audio_lens, wav=wav)
    return out, ms


def cursor_ties(durations, text_len, head=5):
    """By row, the tokens whose cursor values (float64 from ``durations``)
    lie within TTS_CURSOR_TIE of an integer."""
    ties = {}
    for b, n in enumerate(text_len):
        steps = durations[b, :n].astype(np.float64).reshape(-1).copy()
        steps[0] = 0.0
        cursor = head + np.cumsum(steps)
        near = np.nonzero(np.abs(cursor - np.round(cursor)) < TTS_CURSOR_TIE)[0] // 2
        if len(near):
            ties[b] = sorted(set(near.tolist()))
    return ties


def pulse_positions(f0, audio_lens, device):
    """The pulses synthesis places for ``f0 [B, T]`` muted past each
    length, on ``device`` (the synthesis module's own steps)."""
    from voice100_tpu_torch.dsp.world import synthesis

    f0 = torch.from_numpy(f0).to(device)
    f0 = torch.where(torch.arange(f0.shape[1], device=device)[None] <
                     torch.from_numpy(audio_lens).to(device)[:, None], f0, 0.0)
    out_len, max_pulses = synthesis.synthesis_shape(f0.shape[1], SAMPLE_RATE, 10.0, 512)
    f0_s = synthesis._per_sample_f0(f0, SAMPLE_RATE * 10.0 / 1000.0, out_len)
    rate = torch.where(f0_s > 0, f0_s, synthesis._DEFAULT_F0).clamp(synthesis._MIN_RATE,
                                                                    synthesis._MAX_RATE)
    return synthesis._pulse_positions(rate, SAMPLE_RATE, max_pulses).cpu().numpy()


def tts_parity(pipe, cpu_pipe, texts):
    """The card against the port's CPU path on ``texts``, stage by stage,
    each stage on the card's inputs of that stage and the same noise
    (drawn on the CPU from one seed): durations, aligned ids and lengths,
    features, the pulses and the waveform. End to end (each device's own
    features) the waveforms are reported, not gated: F0 that differs by
    float32 rounding moves the phase, and with it some pulses, by a
    sample."""
    def gen():
        return torch.Generator().manual_seed(SEED + 14)

    card, _ = tts_stages(pipe, texts, noise=gen())
    host, _ = tts_stages(cpu_pipe, texts, noise=gen())
    err = {}
    d_card, d_cpu = card["durations"], host["durations"]
    err["durations_rel"] = float((np.abs(d_card - d_cpu) / np.maximum(1.0, np.abs(d_cpu))).max())
    if not err["durations_rel"] <= TTS_DURATION_REL_TOL:
        fail(f"tts parity: durations differ by {err['durations_rel']:.3e} relative")
    if card["out_len"] != host["out_len"]:
        fail(f"tts parity: frame buckets {card['out_len']} and {host['out_len']}")
    ties = cursor_ties(d_cpu, host["text_len"])
    differ = {b: np.nonzero(card["aligntext"][b] != host["aligntext"][b])[0].tolist()
              for b in range(len(texts))}
    differ = {b: v for b, v in differ.items() if v}
    if any(b not in ties for b in differ):
        fail(f"tts parity: aligned ids differ at {differ} with no cursor tie ({ties})")
    if not np.array_equal(card["aligntext_len"], host["aligntext_len"]) and not ties:
        fail(f"tts parity: aligned lengths {card['aligntext_len']} and {host['aligntext_len']}")
    # the expansion alone: the card's and the CPU's on the same host durations
    with torch.inference_mode():
        same_ids, same_len = cpu_pipe.align_model.align(
            torch.from_numpy(card["text"]), d_card, torch.from_numpy(card["text_len"]),
            card["out_len"])
    if not (np.array_equal(same_ids.numpy(), card["aligntext"])
            and np.array_equal(same_len.numpy(), card["aligntext_len"])):
        fail("tts parity: the expansion of the same durations differs between card and CPU")
    # features: the CPU's audio model on the card's aligned ids
    with torch.inference_mode():
        feats = cpu_pipe.audio_model.predict(torch.from_numpy(card["aligntext"]),
                                             torch.from_numpy(card["aligntext_len"]))
    err["features"] = max(float(np.abs(a.numpy() - card[k]).max())
                          for a, k in zip(feats, ("f0", "feat", "codeap")))
    if not err["features"] <= TTS_FEATURE_TOL:
        fail(f"tts parity: features differ by {err['features']:.3e} > {TTS_FEATURE_TOL:.0e}")
    # synthesis: the CPU's vocoder on the card's features, the same noise
    wav_cpu = cpu_pipe.vocoder.decode_batch(card["f0"], card["feat"], card["codeap"],
                                            card["audio_lens"], noise=gen())
    pulses_card = pulse_positions(card["f0"], card["audio_lens"], pipe.device)
    pulses_cpu = pulse_positions(card["f0"], card["audio_lens"], torch.device("cpu"))
    if not np.array_equal(pulses_card, pulses_cpu):
        fail(f"tts parity: pulse positions differ at "
             f"{int((pulses_card != pulses_cpu).sum())} slots")
    peak = float(np.abs(wav_cpu).max())
    err["waveform_over_peak"] = float(np.abs(card["wav"] - wav_cpu).max()) / peak
    if not np.isfinite(card["wav"]).all() or not err["waveform_over_peak"] <= TTS_WAVE_TOL:
        fail(f"tts parity: waveforms differ by {err['waveform_over_peak']:.3e} x peak")
    # end to end, each device on its own features: reported only
    e2e_card = pulse_positions(card["f0"], card["audio_lens"], pipe.device)
    e2e_cpu = pulse_positions(host["f0"], host["audio_lens"], torch.device("cpu"))
    valid = (e2e_card >= 0) | (e2e_cpu >= 0)
    report = {"errors": err, "cursor_ties": ties, "ids_differ": differ,
              "pulses": int((pulses_card >= 0).sum()),
              "end_to_end_pulses_equal": float((e2e_card == e2e_cpu)[valid].mean()),
              "end_to_end_waveform_over_peak": float(
                  np.abs(card["wav"] - host["wav"]).max()) / float(np.abs(host["wav"]).max())}
    print(f"tts parity (card vs CPU, {len(texts)} texts, stage by stage): durations rel "
          f"{err['durations_rel']:.3e} (tol {TTS_DURATION_REL_TOL:.0e}), aligned ids equal"
          f"{'' if not differ else f' except at cursor ties {differ}'}, features "
          f"{err['features']:.3e} (tol {TTS_FEATURE_TOL:.0e}), {report['pulses']} pulses equal, "
          f"waveform {err['waveform_over_peak']:.3e} x peak (tol {TTS_WAVE_TOL:.0e}); end to "
          f"end (reported): pulses equal {report['end_to_end_pulses_equal']:.4f}, waveform "
          f"{report['end_to_end_waveform_over_peak']:.3e} x peak", flush=True)
    return report


def tts_phase(device, card, workdir):
    """TTS serving at align_en_base and tts_en_base width through
    TTSPipeline on the card: launches of one call, the wall time of warm
    calls (float32 and int16), the stages, the card against the CPU, and
    kernel 1 at the run's shapes."""
    from voice100_tpu_torch.inference import TTSPipeline
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.training.cli import load_model

    paths = write_tts_checkpoints(workdir)
    pipes = {dev: TTSPipeline(load_model(*paths["align"], device=dev),
                              load_model(*paths["audio"], device=dev),
                              language="en", use_phone=False, device=dev)
             for dev in (device, "cpu")}
    pipe = pipes[device]
    pipe.synthesize(TTS_TEXTS)  # warm-up: constants, cuDNN plans
    torch.cuda.synchronize()
    wrappers = {w for ws in counted_kernels().values() for w in ws}
    for w in wrappers:
        w.launches = 0
    wavs = pipe.synthesize(TTS_TEXTS)
    torch.cuda.synchronize()
    launches = {"bilstm_recurrence": bilstm_cuda.launches}
    others = {w.__name__: w.launches for w in wrappers if w is not bilstm_cuda and w.launches}
    # one batch of 16: the align model's two layers, the audio encoder's two
    if launches["bilstm_recurrence"] != 4 or others:
        fail(f"tts: one synthesize call of one batch launched kernel 1 "
             f"{launches['bilstm_recurrence']} times, not 4, and {others}")
    timed = {}
    for dtype in (np.float32, np.int16):
        walls = []
        for _ in range(TTS_TIMED_CALLS):
            start = time.perf_counter()
            out = pipe.synthesize(TTS_TEXTS, output_dtype=dtype)
            walls.append(time.perf_counter() - start)
            # the same texts and noise give the same waveforms, bit for bit
            if dtype == np.float32 and not all(map(np.array_equal, out, wavs)):
                fail("tts: two synthesize calls of the same texts gave different waveforms")
        audio_s = sum(len(w) for w in out) / SAMPLE_RATE
        wall = float(np.median(walls))
        timed[np.dtype(dtype).name] = {"wall_s": wall, "audio_s": audio_s,
                                       "audio_s_per_s": audio_s / wall, "walls": walls}
        if dtype == np.int16:
            pcm = out
    for w32, w16 in zip(wavs, pcm):
        if not np.isfinite(w32).all() or w16.dtype != np.int16 or w16.shape != w32.shape:
            fail("tts: a waveform is not finite, or int16 and float32 differ in shape")
        expect = np.round(np.clip(w32, -1.0, 1.0) * 32767.0)
        if np.abs(w16.astype(np.float64) - expect).max() > 1:
            fail("tts: int16 output is not round(clip(float) * 32767) +/- 1")
    print(f"tts align_en_base + tts_en_base on {card}: {len(TTS_TEXTS)} texts, one batch; "
          + "; ".join(f"{k}: synthesize median {v['wall_s'] * 1e3:.2f} ms of {TTS_TIMED_CALLS} "
                      f"warm calls, {v['audio_s']:.2f} s of audio, {v['audio_s_per_s']:.1f} "
                      f"audio s/s" for k, v in timed.items())
          + f"; launches of one call {launches}", flush=True)
    run, stage_ms = tts_stages(pipe, TTS_TEXTS, timed=True)
    print("tts_stages_ms " + json.dumps({"texts": len(TTS_TEXTS), "text_bucket":
                                         int(run["text"].shape[1]), "frame_bucket": run["out_len"],
                                         **stage_ms}), flush=True)
    parity = tts_parity(pipe, pipes["cpu"], TTS_TEXTS[:TTS_PARITY_TEXTS])
    del pipes
    kernel_shapes = {
        "tts_align": check_bilstm(device, len(TTS_TEXTS), int(run["text"].shape[1]),
                                  [int(n) for n in run["text_len"]], hidden=256, input_size=256),
        "tts_audio": check_bilstm(device, len(TTS_TEXTS), run["out_len"],
                                  [int(n) for n in run["aligntext_len"]], hidden=512,
                                  input_size=512),
    }
    return launches, kernel_shapes, {"timed": timed, "stages_ms": stage_ms, "parity": parity}


# TTS training (config/align_en_base.yaml and config/tts_en_base.yaml at full
# width and depth, both at their batch of 128): a voiced corpus of 2-10 s
# clips, 144 of them, so that the 90% train split (130) fills one batch
TTS_TRAIN_CLIPS = 144
TTS_TRAIN_BATCH = 128
TTS_TRAIN_PARITY_ROWS = 8
# the CLI phase's batch_size override: 3 steps an epoch on 130 train clips
TTS_CLI_BATCH = 64
TTS_CLI_EPOCHS = 2
# the ASR model's output frame (mel hop 10 ms, encoder stride 2) and the
# WORLD frame period: the seconds a duration or an f0 frame stands for
ALIGN_FRAME_S, WORLD_FRAME_S = 0.02, 0.01
TTS_TRAIN_STAGE_KEYS = ("upload", "embed_bilstm_fwd", "decoder_fwd", "projection_loss_fwd",
                        "projection_loss_bwd", "decoder_bwd", "bilstm_bwd", "embedding_bwd",
                        "backward_total", "clip_adam")


def voiced_clip(rng, seconds):
    """A 16 kHz int16 clip of ``seconds``: harmonics of an F0 moving in
    90-260 Hz under a syllable-rate envelope, broken by two to four
    unvoiced stretches of noise, over a low noise floor."""
    n = int(seconds * SAMPLE_RATE)
    t = np.arange(n) / SAMPLE_RATE
    f0 = 175.0 + 85.0 * np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t + rng.uniform(0, 2 * np.pi))
    phase = 2 * np.pi * np.cumsum(f0) / SAMPLE_RATE
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 16))
    voiced *= 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(2.0, 5.0) * t)
    gate = np.ones(n)
    for _ in range(int(rng.integers(2, 5))):
        start = int(rng.uniform(0, 0.9) * n)
        gate[start:start + int(rng.uniform(0.1, 0.3) * SAMPLE_RATE)] = 0.0
    noise = rng.standard_normal(n)
    wav = 0.25 * voiced * gate + noise * (0.08 * (1.0 - gate) + 0.005)
    return (np.clip(wav, -1.0, 1.0) * 32767).astype(np.int16)


def write_voiced_corpus(root: str):
    """A dummy_en corpus (the registry's layout) of TTS_TRAIN_CLIPS voiced
    clips of 2-10 s, each with a text of random letters and spaces, about
    14 characters a second; returns (the data directory, the seconds)."""
    from voice100_tpu_torch.dsp.wav import write_wav

    rng = np.random.default_rng(SEED + 20)
    seconds = rng.uniform(2.0, 10.0, size=TTS_TRAIN_CLIPS)
    seconds[0] = 10.0
    data_dir = os.path.join(root, "tts_data")
    wavs = os.path.join(data_dir, "dummy-speech-en", "wavs")
    os.makedirs(wavs)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz  "))
    lines = []
    for i, sec in enumerate(seconds):
        chars = rng.choice(letters, size=min(int(round(sec * 14)), 150))
        chars[0] = chars[-1] = "a"
        lines.append((f"clip{i:04d}", "".join(chars)))
        write_wav(os.path.join(wavs, f"clip{i:04d}.wav"), voiced_clip(rng, sec), SAMPLE_RATE)
    with open(os.path.join(data_dir, "dummy-speech-en", "metadata.csv"), "w") as f:
        f.writelines(f"{c}|{t}|{t}\n" for c, t in lines)
    with open(os.path.join(data_dir, "dummy_en-train.txt"), "w") as f:
        f.writelines(f"{c}|{t}\n" for c, t in lines)
    return data_dir, seconds


def zero_counts(counters):
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0


def read_counts(counters):
    torch.cuda.synchronize()
    return {name: fn.launches for name, fn in counters.items()}


def tts_train_models(device, stat_path):
    """The align and audio models at full width, seeded, on ``device``;
    the audio model with the corpus's statistics."""
    from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
    from voice100_tpu_torch.training import merge_world_stats

    align = TextToAlignText(**ALIGN_EN_BASE, device=device,
                            generator=torch.Generator().manual_seed(SEED + 21))
    audio = AlignTextToAudio(**TTS_EN_BASE, device=device,
                             generator=torch.Generator().manual_seed(SEED + 22))
    return {"align": align, "audio": merge_world_stats(audio, stat_path)}


def tts_train_batches(device, data_dir, cache_dir):
    """One collated train batch of 128 from each real data module, the
    WORLD cache warm: ``{"align": ..., "audio": ...}`` of numpy batches."""
    from voice100_tpu_torch.data import AlignTextDataModule, AudioTextDataModule

    modules = {
        "align": AlignTextDataModule(data_dir=data_dir, dataset="dummy_en",
                                     batch_size=TTS_TRAIN_BATCH),
        "audio": AudioTextDataModule(vocoder="world_mcep", dataset="dummy_en", use_align=True,
                                     data_dir=data_dir, cache_dir=cache_dir,
                                     batch_size=TTS_TRAIN_BATCH, device=device),
    }
    batches = {}
    for name, data in modules.items():
        data.setup("fit")
        batch, n_real = next(data.train_dataloader().iter_with_counts())
        if n_real != TTS_TRAIN_BATCH:
            fail(f"tts train: the {name} data module's first batch has {n_real} real rows")
        batches[name] = batch
    return batches


def batch_audio_seconds(name, batch):
    """The audio seconds a batch stands for: its durations (ASR frames)
    or its f0 frames."""
    if name == "align":
        return float(batch[1][0].sum()) * ALIGN_FRAME_S
    return float(batch[0][1].sum()) * WORLD_FRAME_S


def tts_train_steps(device, card, models, batches):
    """Trainer.train_step 1 + TIMED_STEPS times on each model's batch,
    dropout on, the launch counts set to 0 just before the timed steps and
    read just after (kernel 2 once and kernel 3 twice a layer a step,
    nothing else); then one evaluated batch each (kernel 1 once a layer,
    nothing else). Returns the counts and timings by model."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    counters = cli_counters()
    out = {}
    for name, model in models.items():
        batch = batches[name]
        trainer = Trainer(TrainerConfig(gradient_clip_val=1.0))
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        gen = torch.Generator(device=device).manual_seed(SEED)
        warm = float(trainer.train_step(task, state, batch, gen)["loss"])
        zero_counts(counters)
        losses, step_ms = [], []
        for _ in range(TIMED_STEPS):
            start = time.perf_counter()
            losses.append(float(trainer.train_step(task, state, batch, gen)["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
        launches = read_counts(counters)
        layers = model.lstm.num_layers
        want = dict.fromkeys(counters, 0)
        want.update(bilstm_train_fwd=layers * TIMED_STEPS,
                    bilstm_train_bwd=2 * layers * TIMED_STEPS)
        if launches != want:
            fail(f"tts train {name}: launches over {TIMED_STEPS} steps {launches}, not {want}")
        if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail(f"tts train {name}: the loss is not finite or does not fall: {losses}")
        zero_counts(counters)
        metrics = trainer.evaluate(task, state, [batch])
        eval_launches = read_counts(counters)
        want = dict.fromkeys(counters, 0)
        want["bilstm_recurrence"] = layers
        if eval_launches != want or not all(np.isfinite(list(metrics.values()))):
            fail(f"tts train {name}: an evaluated batch launched {eval_launches}, not {want}, "
                 f"metrics {metrics}")
        median = float(np.median(step_ms))
        audio_s = batch_audio_seconds(name, batch)
        shape = [list(np.shape(a)) for a in batch[-1 if name == "audio" else 0]]
        out[name] = {"median_step_ms": median, "step_ms": step_ms, "audio_s": audio_s,
                     "audio_s_per_s": audio_s / (median * 1e-3), "losses": [warm] + losses,
                     "eval_metrics": metrics, "text_shape": shape,
                     "launches": {k: v for k, v in launches.items() if v},
                     "eval_launches": {k: v for k, v in eval_launches.items() if v}}
        print(f"tts train {name} ({type(model).__name__}, batch {TTS_TRAIN_BATCH}, text "
              f"{shape[0]}, {audio_s:.2f} s of audio), dropout on: loss warm-up {warm:.4f}, then "
              f"{[round(v, 4) for v in losses]}; step median {median:.2f} ms (min "
              f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {audio_s / (median * 1e-3):.1f} "
              f"audio s/s on {card}; launches over {TIMED_STEPS} steps {out[name]['launches']}, "
              f"of one evaluated batch {out[name]['eval_launches']}", flush=True)
        if name == "audio":
            out[name]["stages_ms"] = tts_train_stages(task, state, batch, gen)
    return out


def tts_train_stages(task, state, batch, gen):
    """Card time of each stage of one audio-model step (CUDA events), the
    backward split by part through autograd.grad on a retained graph."""
    from voice100_tpu_torch.models.losses import world_loss_v2
    from voice100_tpu_torch.training.trainer import clip_by_global_norm

    model = state.model.train()
    f0, f0_len, logspc, codeap, text, text_len = task.upload(batch)
    hasf0, hascodeap = (f0 >= 30.0).float(), (codeap < -0.2).float()
    nf0, nspc, ncap = model.norm.normalize(f0, logspc, codeap)
    f, s, c = model.f0_size, model.logspc_size, model.codeap_size

    def embed_bilstm():
        emb = model.embedding(text.long())
        return emb, model.lstm(emb, text_len, gen)

    def projection_loss(d):
        y = model.projection(d)
        values = world_loss_v2(f0_len, y[:, :, 0], y[:, :, f], y[:, :, 2 * f:2 * f + s],
                               y[:, :, 2 * f + s:2 * f + s + c], y[:, :, 2 * f + s + c:],
                               hasf0, nf0, nspc, hascodeap, ncap)
        return model.total_loss(values, model.logspc_weight)

    emb, h = embed_bilstm()
    d = model.decoder(h)
    loss = projection_loss(d)
    g_d, g_h, g_emb = torch.autograd.grad(loss, [d, h, emb], retain_graph=True)
    proj = list(model.projection.parameters())
    parts = {
        "upload": time_ms(lambda: task.upload(batch)),
        "embed_bilstm_fwd": time_ms(embed_bilstm, iters=3),
        "decoder_fwd": time_ms(lambda: model.decoder(h), iters=3),
        "projection_loss_fwd": time_ms(lambda: projection_loss(d)),
        "projection_loss_bwd": time_ms(lambda: torch.autograd.grad(
            loss, [d, *proj], retain_graph=True)),
        "decoder_bwd": time_ms(lambda: torch.autograd.grad(
            d, [h, *model.decoder.parameters()], g_d, retain_graph=True), iters=3),
        "bilstm_bwd": time_ms(lambda: torch.autograd.grad(
            h, [emb, *model.lstm.parameters()], g_h, retain_graph=True), iters=3),
        "embedding_bwd": time_ms(lambda: torch.autograd.grad(
            emb, list(model.embedding.parameters()), g_emb, retain_graph=True)),
        "backward_total": time_ms(lambda: torch.autograd.grad(
            loss, list(model.parameters()), retain_graph=True), iters=3),
    }
    loss.backward()
    parts["clip_adam"] = time_ms(lambda: (clip_by_global_norm(model.parameters(), 1.0),
                                          state.optimizer.step()))
    print("tts_train_stages_ms " + json.dumps({"aligntext": list(text.shape),
                                               "frames": list(f0.shape), **parts}), flush=True)
    return parts


def tts_train_parity(device, batches, stat_path):
    """Three steps of each model from the same weights on the first rows of
    its batch, dropout off, on the card and on the CPU's plain path: the
    losses and the first step's gradients within PARITY_*_TOL."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    out = {}
    for name, cpu_model in tts_train_models("cpu", stat_path).items():
        batch = tuple(tuple(np.asarray(a)[:TTS_TRAIN_PARITY_ROWS] for a in pair)
                      for pair in batches[name])
        results = []
        for model in (copy.deepcopy(cpu_model).to(device), cpu_model):
            trainer = Trainer(TrainerConfig(gradient_clip_val=1.0))
            task = make_task(model)
            state = TrainState(model, task.make_optimizer())
            losses, grads = [], None
            start = time.perf_counter()
            for _ in range(PARITY_STEPS):
                losses.append(float(trainer.train_step(task, state, batch, train=False)["loss"]))
                if grads is None:
                    grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            results.append((losses, grads, time.perf_counter() - start))
        (card_losses, card_grads, card_s), (cpu_losses, cpu_grads, cpu_s) = results
        grad_err = max(((card_grads[n] - g).norm() / g.norm()).item()
                       for n, g in cpu_grads.items())
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
        print(f"tts train parity {name}, card vs CPU plain path ({TTS_TRAIN_PARITY_ROWS} rows, "
              f"{PARITY_STEPS} steps, dropout off): losses card {card_losses}, CPU "
              f"{cpu_losses}, max rel err {loss_err:.3e} (tol {PARITY_LOSS_TOL:.0e}); first-step "
              f"gradients max rel-norm err {grad_err:.3e} over {len(cpu_grads)} tensors (tol "
              f"{PARITY_GRAD_TOL:.0e}); card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
        if not all(np.isfinite(card_losses)) or not loss_err <= PARITY_LOSS_TOL:
            fail(f"tts train parity {name}: card losses {card_losses} vs CPU {cpu_losses}")
        if not grad_err <= PARITY_GRAD_TOL:
            fail(f"tts train parity {name}: first-step gradients differ by {grad_err:.3e}")
        out[name] = {"loss_rel_err": loss_err, "grad_rel_err": grad_err}
    return out


def tts_cli_phase(device, card, workdir, data_dir, cache_dir, stat_path):
    """align_en_base and tts_en_base (dataset dummy_en) through the training
    CLI on the card (training/cli.py ``main``): ``fit`` for TTS_CLI_EPOCHS
    epochs at batch TTS_CLI_BATCH (the audio model with --audio_stat), then
    ``validate`` and ``predict`` on its last.pt; the launch counts set to 0
    just before each subcommand and read just after. Checks the launches,
    the log, validate's loss against the last epoch's and one prediction a
    clip."""
    import yaml
    from voice100_tpu_torch.training.cli import main

    counters = cli_counters()
    n_val = int(TTS_TRAIN_CLIPS * 0.1)
    steps = TTS_CLI_EPOCHS * -(-(TTS_TRAIN_CLIPS - n_val) // TTS_CLI_BATCH)
    val_batches = -(-n_val // TTS_CLI_BATCH)
    all_batches = -(-TTS_TRAIN_CLIPS // TTS_CLI_BATCH)
    out = {}
    for name, config_file, extra in (("align", "config/align_en_base.yaml", []),
                                     ("audio", "config/tts_en_base.yaml",
                                      ["--audio_stat", stat_path])):
        with open(config_file) as f:
            config = yaml.safe_load(f)
        config["data"]["init_args"]["dataset"] = "dummy_en"
        config["trainer"].update(max_epochs=TTS_CLI_EPOCHS, log_every_n_steps=1)
        cfg = os.path.join(workdir, f"{name}_dummy_en.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(config, f)
        ckpt = os.path.join(workdir, f"{name}_fit_ckpt")
        log = os.path.join(workdir, f"{name}_fit_log.jsonl")
        last = os.path.join(ckpt, "last.pt")
        predictions = os.path.join(workdir, f"{name}_predictions.npz")
        common = ["--config", cfg, "--data_dir", data_dir, "--cache_dir", cache_dir,
                  "--checkpoint_dir", ckpt, "--batch_size", str(TTS_CLI_BATCH),
                  "--device", str(device)]
        runs, results = {}, {}
        for sub, more in (("fit", ["--log_path", log, *extra]),
                          ("validate", ["--restore_from", last]),
                          ("predict", ["--restore_from", last, "--output", predictions])):
            zero_counts(counters)
            start = time.perf_counter()
            results[sub] = main([sub, *common, *more])
            runs[sub] = {"wall_s": time.perf_counter() - start,
                         "launches": {k: v for k, v in read_counts(counters).items() if v}}
        layers = 2
        want = {"fit": {"bilstm_train_fwd": layers * steps,
                        "bilstm_train_bwd": 2 * layers * steps,
                        "bilstm_recurrence": layers * val_batches * TTS_CLI_EPOCHS},
                "validate": {"bilstm_recurrence": layers * val_batches},
                "predict": {"bilstm_recurrence": layers * all_batches}}
        for sub, counts in want.items():
            if runs[sub]["launches"] != counts:
                fail(f"tts cli {name} {sub}: launches {runs[sub]['launches']}, not {counts}")
        with open(log) as f:
            records = [json.loads(line) for line in f]
        epochs = [r for r in records if "train_time_s" in r]
        step_losses = [r["train_loss"] for r in records
                       if "train_loss" in r and "train_time_s" not in r]
        if [r.get("event") for r in records if "event" in r] != ["fit_start"] or \
                len(epochs) != TTS_CLI_EPOCHS or len(step_losses) != steps or \
                not np.all(np.isfinite(step_losses + [r["val_loss"] for r in epochs])):
            fail(f"tts cli {name} fit: log events, epochs or losses are wrong: {records}")
        val, last_val = results["validate"]["loss"], epochs[-1]["val_loss"]
        val_err = abs(val - last_val) / abs(last_val)
        if not val_err <= CLI_VAL_REL_TOL:
            fail(f"tts cli {name} validate: val_loss {val} on last.pt, the last epoch logged "
                 f"{last_val}")
        with np.load(predictions, allow_pickle=True) as z:
            entries = {k: len(z[k]) for k in z.files}
        want_keys = ["durations"] if name == "align" else ["codeap", "f0", "logspc"]
        if sorted(entries) != want_keys or set(entries.values()) != {TTS_TRAIN_CLIPS}:
            fail(f"tts cli {name} predict: entries {entries}, not one a clip of "
                 f"{TTS_TRAIN_CLIPS} under {want_keys}")
        print(f"tts cli {name} on {card}: fit {TTS_CLI_EPOCHS} epochs at batch {TTS_CLI_BATCH} "
              f"(override of the config's 128: {steps // TTS_CLI_EPOCHS} steps an epoch) "
              f"{runs['fit']['wall_s']:.3f} s, train time by epoch "
              f"{[r['train_time_s'] for r in epochs]} s, step losses "
              f"{[round(v, 4) for v in step_losses]}; validate on last.pt {val:.6f} against "
              f"the last epoch's {last_val:.6f} (rel err {val_err:.2e}, tol "
              f"{CLI_VAL_REL_TOL:.0e}); predict {entries}; launches "
              f"{ {sub: r['launches'] for sub, r in runs.items()} }", flush=True)
        out[name] = runs
    return out


def check_tts_configs_build(device):
    """Every TTS config of config/ builds its model and data module on the
    card through training/cli.py build_from_config (the weights drawn
    there, the statistics file the config names read by fit)."""
    from voice100_tpu_torch.training.cli import build_from_config, load_config

    names = sorted(f for f in os.listdir("config") if f.startswith(("tts_", "align_")))
    for name in names:
        model, data = build_from_config(load_config(os.path.join("config", name)), {},
                                        device=device)
        if next(model.parameters()).device.type != "cuda" or data.batch_size != TTS_TRAIN_BATCH:
            fail(f"tts config {name}: {type(model).__name__} on "
                 f"{next(model.parameters()).device}, batch {data.batch_size}")
    print(f"tts configs built on the card: {names}", flush=True)
    return names


def shape_line(entry):
    """The numbers of a kernel line of check_lstm_train, for another
    shape's entry under the main line."""
    keys = ("shapes", "smem_bytes", "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "events_launches",
            "device_ms_by_launch", "whole_backward")
    return {k: entry[k] for k in keys if k in entry}


def tts_train_phase(device, card, workdir, align_args):
    """TTS v2 training at align_en_base and tts_en_base width: the voiced
    corpus, its align file through the align CLI with the align phase's
    ASR checkpoint, calc_stat (the cold WORLD analysis, timed), the steps,
    the stages, the card against the CPU, the CLI, and kernels 2 and 3 at
    the batches' shapes."""
    from voice100_tpu_torch.tools.align_text import cli_main as align_main
    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main

    configs = check_tts_configs_build(device)
    data_dir, seconds = write_voiced_corpus(workdir)
    align_main(["--config", align_args["config"], "--checkpoint", align_args["checkpoint"],
                "--data_dir", data_dir, "--cache_dir", os.path.join(workdir, "tts_mel_cache")])
    with open(os.path.join(data_dir, "dummy_en-align-train.txt")) as f:
        if sum(1 for _ in f) != TTS_TRAIN_CLIPS:
            fail("tts train: the align CLI wrote another number of lines than clips")
    cache_dir = os.path.join(workdir, "tts_world_cache")
    stat_path = os.path.join(workdir, "dummy_en-stat.npz")
    start = time.perf_counter()
    stat_main(["--output", stat_path, "--dataset", "dummy_en", "--vocoder", "world_mcep",
               "--data_dir", data_dir, "--cache_dir", cache_dir])
    analysis_s = time.perf_counter() - start
    stats = dict(np.load(stat_path))
    if not all(np.isfinite(v).all() for v in stats.values()) or not 90 < stats["f0_mean"][0] < 260:
        fail(f"tts train: calc_stat gave {stats}")
    print(f"tts train corpus: {TTS_TRAIN_CLIPS} voiced clips, {seconds.sum():.2f} s of audio; "
          f"calc_stat with a cold WORLD cache (host float64 analysis) {analysis_s:.2f} s, "
          f"{seconds.sum() / analysis_s:.1f} audio s/s (host clock, this machine's CPU); f0 "
          f"mean {stats['f0_mean'][0]:.1f} Hz, std {stats['f0_std'][0]:.1f}", flush=True)
    batches = tts_train_batches(device, data_dir, cache_dir)
    steps = tts_train_steps(device, card, tts_train_models(device, stat_path), batches)
    parity = tts_train_parity(device, batches, stat_path)
    cli = tts_cli_phase(device, card, workdir, data_dir, cache_dir, stat_path)
    text, text_len = batches["audio"][1]
    audio_lengths = np.minimum(text_len, 512)
    align_text, align_len = batches["align"][0]
    kernels = {
        "tts_train_audio": check_lstm_train(device, TTS_TRAIN_BATCH, 512, 512, 512,
                                            audio_lengths),
        "tts_train_align": check_lstm_train(device, TTS_TRAIN_BATCH, int(align_text.shape[1]),
                                            256, 256, align_len),
    }
    summary = {"configs_built": configs, "corpus_audio_s": float(seconds.sum()),
               "world_analysis_cold_s": analysis_s,
               "steps": steps, "parity": parity,
               "cli": {n: {s: r["wall_s"] for s, r in runs.items()} for n, runs in cli.items()}}
    by_path = {f"tts_train_{n}": r["launches"] for n, r in steps.items()}
    by_path.update({f"tts_cli_{n}_{s}": r["launches"] for n, runs in cli.items()
                    for s, r in runs.items()})
    return by_path, kernels, summary


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
    serving = [check_melspec(device), check_bilstm(device)]
    training = check_lstm_train(device) + check_ctc(device)
    check_not_resident(device)
    # the align path's shapes: kernel 1 at the config's batch of 64 (eight
    # batch tiles), kernel 8 on one clip at a time; the Viterbi launch below
    lengths = np.random.default_rng(SEED + 7).integers(1, VITERBI_T + 1, size=ALIGN_BATCH)
    lengths[0], lengths[1] = VITERBI_T, 1
    serving[1]["align_batch"] = check_bilstm(device, ALIGN_BATCH, VITERBI_T,
                                             [int(n) for n in lengths])
    # kernels 1 and 2 at asr_en_small's batch of 128 and H=256
    b128 = check_forward_b128(device)
    serving[1]["b128_h256"] = dict(b128, max_abs_err=b128["max_abs_err"]["bilstm_recurrence"])
    training[0]["b128_h256"] = {"shapes": b128["shapes"],
                                "max_abs_err": b128["max_abs_err"]["bilstm_train_fwd"]}
    serving[0]["single_clip_max_abs_err"] = check_melspec_clips(device)
    # each CTC kernel's and the Viterbi launch's step split by cause, and
    # the chain floors; the Viterbi check reads its phases from it
    from voice100_tpu_torch.tools.probe_ctc import probe

    steps = probe()
    print("probe_ctc " + json.dumps(steps), flush=True)
    for entry, key in zip(training[2:], ("alpha", "adjoint")):
        entry["step_us_by_variant"] = steps["us_per_step"][key]
        entry["chain_floor_ms"] = steps["chain_floor_ms"][key]
    aligning = check_viterbi(device, steps["us_per_step"]["viterbi"])
    by_path = {"serve": serve(device, card), "train": train(device, card)}
    train_parity(device)
    with tempfile.TemporaryDirectory() as workdir:
        runs, args, samples = align(device, card, workdir)
        by_path.update({f"align_{run}": r["launches"] for run, r in runs.items()})
        parity = align_parity(device, args, workdir)
        by_path.update({f"cli_{sub}": launches
                        for sub, launches in cli_phase(device, card, workdir, args, samples).items()})
        by_path["tts"], tts_kernel, tts_summary = tts_phase(device, card, workdir)
        tts_train_paths, tts_train_kernels, tts_train_summary = tts_train_phase(
            device, card, workdir, args)
    by_path.update(tts_train_paths)
    serving[1].update(tts_kernel)
    # kernels 2 and 3 at the TTS training batches' shapes
    for name, (fwd, bwd) in tts_train_kernels.items():
        training[0][name] = shape_line(fwd)
        training[1][name] = shape_line(bwd)
    # kernel 1 at the TTS configs' training batch
    serving[1]["b128_h512"] = check_bilstm_b128_h512(device)
    # "launches" counts the path each kernel was ported for (the timed
    # align run for kernels 6 and 7, the phases of one launch); every
    # path's counts stand beside it
    for entries, path in ((serving, "serve"), (training, "train"), (aligning, "align_warm")):
        for entry in entries:
            counter = entry.pop("counter", entry["name"])
            entry["launches"] = by_path[path][counter]
            entry["launches_by_path"] = {p: c[counter] for p, c in by_path.items()
                                         if counter in c}
    for entry in training:
        entry["launches_per_step"] = entry["launches"] / TIMED_STEPS
    print("align_summary " + json.dumps({"runs": runs, "parity": parity}), flush=True)
    print("tts_summary " + json.dumps(tts_summary), flush=True)
    print("tts_train_summary " + json.dumps(tts_train_summary), flush=True)
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from the kernel build to here",
          flush=True)
    print(json.dumps({"kernels": serving + training + aligning}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
