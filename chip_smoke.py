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
16. runs the phone configs end to end (``phone_phase``): writes 96 FLAC
    clips of 2-8 s in the real corpora's layouts (48 LJSpeech at
    22.05 kHz, 40 LibriSpeech train-clean-100 and 8 dev-clean at 16 kHz;
    tests/flac_fixture.py's bit writer, verbatim frames of 4096 samples)
    with English transcripts that need the G2P's number, currency,
    abbreviation and heteronym rules; phonemizes them with the port's
    prepare_dataset (twice: equal files) and times the G2P a text; checks
    that two ``fit`` runs of config/asr_en_phone_base.yaml on the card and
    one on the CPU start from equal weights (its seed_everything); trains
    it through the training CLI (cli_phase: ``fit`` 2 epochs from a cold
    cache on ljspeech,librispeech, 80 train and 8 val clips at batch 64,
    then ``validate``, ``test``, ``predict``; launch counts checked), timing
    the loader's native ``prefetch`` against one batch decode call and the
    per-item decode; aligns the LJSpeech corpus with the checkpoint it
    wrote through the align CLI from the warm cache (align: kernel 1 twice,
    the Viterbi once, the labels against the plain Viterbi), writing
    ljspeech-phone-align-train.txt; serves align_en_phone_base +
    tts_en_phone_base (16 English texts) and align_ja_phone_base +
    tts_ja_phone_base (8 Japanese texts with kanji, kana and numerals)
    through TTSPipeline(use_phone=True) (tts_phase: 4 kernel-1 launches a
    call, 2 warm calls, the stages, the card against the CPU on 2 texts);
    and, where libmp3lame and libmpg123 both load, writes a cv_ja corpus of
    24 MP3 clips, holds load_audio and load_audio_batch to the tones
    written and trains asr_ja_phone_base one epoch on it (else prints
    which library is missing and skips that step alone);
17. holds kernel 1 at the TTS configs' training batch (B=128, T=512,
    H=512, a zero-length row): its shared memory a block, 156,672 B,
    within the 232,448 B opt-in, its outputs against the plain version,
    and its time in turns with cuDNN's packed nn.LSTM, beside its bound;
18. runs the bf16 mixed-precision path (what ``python -m
    voice100_tpu_torch fit --precision 16`` trains with): the bf16 variants
    of kernels 1, 2 and 3 at asr_en_base's (B=64, T=501, H=512),
    tts_en_base's (B=128, T=512, H=512) and align_en_base's (B=128, T=144,
    H=256) shapes against their plain twins on the card (float32 outputs
    within 1e-4; bf16 states and dG within one bf16 step of the twins'
    past the float32 tolerance, the share of elements that differ printed;
    BiLSTMFunction's bf16 gradients, dG through its whole backward, against
    the same products of the twins' dG), each timed in turns with its
    float32 variant and cuDNN's nn.LSTM in bf16 (these checks run right
    after step 5, where torch.profiler still records every launch); then
    (``bf16_phase``) trains each
    of the three configs 1 + 10 steps at float32 and then at bf16 (batch 64
    ASR, the TTS phase's batches of 128), the launch counts set to 0 just
    before the timed steps and read just after (at bf16: kernels 2 and 3's
    bf16 variants 2 and 4 a step, no float32 biLSTM launch); holds 3 bf16
    steps on the card against the CPU's plain path (losses 1e-3, first-step
    gradients 2^-8 relative); and runs asr_en_base through the training CLI
    at ``--precision 16`` on the align corpus (fit 2 epochs, validate,
    test, predict: cli_phase's checks, with the biLSTM counts on the bf16
    variants);
19. after the align phase (``serve_beam``), serves the serve phase's
    model and 16 clips through ASRPipeline with a CTC prefix beam of 8: the
    device beam (every symbol a frame) must equal the host beam on the
    card's own log-probs, and again with both fused with a trigram LM that
    tools/train_lm fits on the align corpus's texts; one device-beam call's
    launches exact (kernel 8 once a batch, kernel 1 once a layer a batch);
    prints each transcribe's wall time against greedy and the batched
    beam's card time on one batch;
20. after ``serve_beam`` (``server_phase``), serves asr_en_base and
    align_en_base + tts_en_base (seeded random weights) through
    voice100_tpu_torch.server.SpeechServer on 127.0.0.1 (port 0, a 10 ms
    batch window) on the card: 16 client threads send, interleaved, the
    serve phase's 16 int16 clips as WAV, a float32 body at 22,050 Hz (the
    server resamples it), WAVs of 60 and 150 s (past the 40 s bucket: they
    stream through StreamingASRSession) and 8 /synthesize texts, each
    request with a timeout; holds every transcript, and the same
    pipeline's direct transcribe([clip]) on the card, to the CPU pipeline
    under the margin rule (some choice of ids within 4e-3 of each frame's
    CPU maximum gives it), checks that the long clips' sessions commit
    every frame, that each WAV has the direct call's sample count, that
    /healthz lists both models, that some micro-batch held more than one
    request, and the exact launches of the run (per streamed window kernel
    8 once and kernel 1 once a layer, the same per ASR device batch, kernel
    1 four times per TTS batch); drives a live session over a 60 s clip in
    0.5 s feeds at its default contexts (launches exact, the transcript a
    chain of prefixes); prints requests a second, latency by endpoint,
    batch sizes, per-feed decode ms and the long-form RTF; then
    (``profile_fit``) trains asr_en_base 2 epochs through the training CLI
    with trainer.profile_dir at batch 32 from the align corpus's warm cache
    (launches exact), checks that the trace is written once and parses as
    JSON, and prints the card's busy share of the traced window where the
    trace holds an event for every launch of the port's kernels in it
    ("not measured" otherwise); kernels 1 and 8 are held to their plain
    versions at a streaming window's B=1 shapes (T'=2001, 640,000 samples)
    after step 7's checks;
21. after the TTS training phase, runs the training data shell
    (``data_shell_phase``): asr_en_base through the training CLI on the
    align corpus at batch 16 from a cold feature cache, with 4 loader
    worker processes, the device feature cache and 4 steps a dispatch, 3
    epochs in one collate bucket (launches exact: kernels 2-5 as in step 9
    and the evaluated batches as in step 13, kernel 8 never in this
    process; the scan_dispatch record printed); the same fit at one step a
    dispatch (losses, chunk means and val losses within 1e-4 relative);
    one dispatched chunk under torch.cuda.set_sync_debug_mode("warn") (its
    synchronising calls counted and located); the cold WORLD analysis of
    48 clips of the TTS corpus at 0 and 4 workers (host seconds, caches
    byte-equal); the pooled log-mel cache against step 13's kernel-8 cache
    (within 1e-3 plus one float16 step);
22. after the TTS training phase, runs the device WORLD analysis
    (``world_device_phase``): calc_stat with VOICE100_TPU_WORLD_BACKEND=
    device at num_workers 0 into a fresh cache, the cold analysis of the
    144 clips timed beside the host analysis of step 15; every entry
    against the host cache under the JAX package's agreement rules for its
    device backend (voicing agreement > 0.9, F0 within 3% where both are
    voiced on 99% of the frames away from voicing boundaries, the
    envelope's median log error < 0.2 over bins within 20 nats of the
    peak); 8 clips on the card
    against the CPU's device backend at tests/test_torch_world_device.py's
    float32 tolerances; the four-pitch reanalysis bars of
    tests/test_world_invariants.py on the card; then the deployment
    surface (``export_phase``): asr_en_base (the align phase's checkpoint),
    align_en_base and tts_en_base (seeded checkpoints) exported by
    ``python -m voice100_tpu_torch.tools.export`` in three processes on
    the card; each .pt2 loaded and run on the card, bit-equal to the
    direct predict call with the same kernel-1 launches, timed against it;
    each .onnx under the port's NumPy runtime within 2e-3 of the card on
    valid frames, timed; a reference-layout .ckpt of the same weights
    through the import CLI, bit-equal on the card; OnnxASR on the serve
    phase's 16 clips under the margin rule of the card's ASRPipeline (a
    clip a batch, in a bucket of its length); the native WORLD synthesis
    of one TTS call's features against the NumPy synthesizer on the
    periodic path (1e-4 of peak); the launch counts set to 0 just before
    the three programs and the card side of OnnxASR run, read just after
    (the ``export`` path); kernel 1 against its plain version at the
    three programs' shapes (B=1: asr T'=256, H=512; align T=128, H=256;
    tts T=128, H=512); then the v1 deployment surface
    (``v1_deploy_phase``): the five v1 models at the train-v1 widths,
    seeded, their BatchNorm statistics moved off 0 and 1, each exported
    by the export CLI in this process on the card (no ``--device``: cuda
    by default), loaded and run bit-equal to the direct call, its .onnx
    under the NumPy runtime within 2e-3 of the card (f0 where the
    voicing logit clears the tolerance), a reference-layout .ckpt
    (``model.`` prefix, ``num_batches_tracked``) through the import CLI
    on the card bit-equal; the launch counts set to 0 just before the
    five programs run, read just after (the ``v1_export`` path: kernel 1
    twice, for ``align_ctc_v1``'s two layers, every other kernel 0);
    kernel 1 at ``align_ctc_v1``'s program shape
    (B=1, T'=256, H=128) is checked early with the other export shapes;
23. after step 13 (``distributed_phase``), trains asr_en_base through
    the training CLI on the align corpus with half of it held out (64
    train clips: one full global batch of 64 an epoch, 3 epochs) from
    step 13's warm cache, in one collate bucket: a plain ``fit`` twice;
    ``fit --distributed`` in a one-rank NCCL group; a plain and a one-rank
    NCCL fit under deterministic algorithms, bit-equal in losses, val
    losses and final weights (without them two plain fits part: the CTC
    vocabulary scatter and cuDNN add with atomics); two ranks on the one
    card over gloo at batch 32 each (NCCL refuses two ranks on one GPU;
    each rank a process, ``chip_smoke.py --dp-rank``), then in the same
    two processes the (1, 2) tensor-parallel fit (``--mesh_model_axis
    2``: each rank keeps its shards of the parameters and Adam moments
    and gathers the weights each step), then both again under
    deterministic algorithms; every fit's launches exact (a tensor-parallel
    rank's as a data-parallel rank's), one gradient all-reduce a step in a
    group, one weight all-gather a step, an epoch's tail and a checkpoint
    at (1, 2), losses within 1e-5 relative and Adam's first moments within
    1e-4 relative L2 of the plain fit's, the weights against the JAX
    test's rtol 2e-5 / atol 2e-6 reported; the (1, 2) fit bit-equal to
    the 2-rank data-parallel fit under deterministic algorithms (losses,
    val losses, last.pt weights, both Adam moments); each rank's bytes of
    parameters and Adam state between steps beside the data-parallel
    rank's (at most 0.51 of them); the gradient all-reduce of a step timed
    over NCCL and gloo, and the (1, 2) weight all-gather over gloo; then
    ASRPipeline (the serve phase's 16 clips) and TTSPipeline (the TTS
    phase's 16 texts) over a mesh of the one device, and ASRPipeline over
    a (1, 2) mesh naming the card twice, bit-equal to the plain calls
    with the same launches;
24. after step 10 (``conformer_phase``), holds kernel 9 (relative-position
    attention, forward and backward) against its plain version at the
    Conformer-CTC cell's batch of 64, 8 heads of 64: T'=432 with the
    cell's lengths and a dropout keep mask, and T'=418 (no multiple of
    the kernel's tiles) ragged down to one frame without one; one forward
    and two backward launches a call, the output and every gradient
    within 2e-5 of its largest element, padded query rows 0; times
    kernel and plain version in turns (event and device time) against
    its bound; then trains ConformerCTC at its published widths through
    Trainer.train_step on one batch of the cell's shape (SpecAugment and
    dropout on, AdamW under Noam from step 10,000): one warm-up step, then
    3 timed steps with the launch counts set to 0 just before and read
    just after (kernel 9's forward once and backward twice a block a
    step, 54 launches; kernels 4 and 5 once a step), the losses finite;
25. prints one JSON line of per-kernel results (the bf16 variants as
    their own lines), then, last, {"ok": true, "device": {...}}.

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

import concurrent.futures
import contextlib
import copy
import functools
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

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
# The v1 model family (ROADMAP item 9) at full width, seeded weights: the
# train-v1 CLIs' defaults (voice100_tpu/tools/train_v1.py), 64 log-mel bins
# and the character vocabulary of 29 (the multi-task model's phone targets:
# the English phone vocabulary of 71); every CLI's batch of 32
V1_ASR = dict(audio_size=64, vocab_size=29, embed_size=512, hidden_size=512)
V1_ALIGN = dict(audio_size=64, vocab_size=29, hidden_size=128, num_layers=2)
V1_TTS_ALIGN = dict(vocab_size=29, hidden_size=512)
V1_TTS_AUDIO = dict(vocab_size=29, hidden_size=512)      # world: 257 spectral bins
V1_TTS_MT = dict(vocab_size=29, target_vocab_size=71, hidden_size=512)
V1_BATCH = 32
# AudioAlignCTC's biLSTM on 10 s clips: 1001 log-mel frames, stride 2
V1_T, V1_H = 501, 128
V1_TIMED_STEPS = 5
# AudioToTextCTC's staircase: a boundary (step 2) inside the 3 parity steps
V1_STEPS_PER_EPOCH = 2
# card vs CPU in evaluation mode: the models' raw outputs (normalized WORLD
# streams, log-durations, logits) absolutely, where the float32 differences
# of nine BatchNorm blocks and two decoders' convolutions gather
V1_PREDICT_TOL = 2e-3
# card vs CPU gradients of a v1 step: within this many times what float32
# costs the model (its CPU float32 gradients against its float64 ones).
# Two float32 paths that sum in other orders (cuDNN's algorithms, the
# CPU's) sit at distances of the same order from float64: on an H100
# 80GB HBM3 (700 W) the card's distance was up to about 3 times the
# CPU's, where the costs ran 2e-4 to 5e-3; a fault moves a gradient by O(1)
V1_CONDITIONING = 10.0
# card vs CPU steps of a v1 model: the first rows of a batch of 32 on both
# sides (a BatchNorm's statistics are the batch's)
V1_PARITY_ROWS = 4
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12  # dense, tensor cores
HBM_BYTES_PER_S = 3.35e12
# kernel and library call timed in turns: rounds, each of `iters` calls
TURN_ROUNDS = 5
# Conformer-CTC Large (benchmark/configs/conformer_ctc_large.json) at the
# batch of its training cell: clips of LibriSpeech train-clean-100's
# lengths cut to 2-16.7 s (80% N(14, 1.6), 20% U(2, 13)), 80 mels at 100
# frames a second in extents of 64 frames, subsampled x4 (T' up to 432),
# 8 heads of 64, 6 target ids a second, a run resumed at the Noam peak
# (step 10,000), no clipping
CONFORMER_BATCH = 64
CONFORMER_MELS = 80
CONFORMER_HEADS = 8
CONFORMER_STEPS = 3
CONFORMER_START_STEP = 10000
# kernel 9 against its plain version, both float32 on the card: max abs
# error over each result's largest element. 64-term dot products and
# softmax rows of up to 432 keys summed in another order (the kernel's
# online softmax, partial sums of the positional gradient); a wrong
# shift, mask or dropout index moves a result by O(1) of its scale.
RELPOS_REL_TOL = 2e-5


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
    """The port's kernels by parts of their names on the card (one of the
    parts split by "|"), each with the wrappers that count its launches
    (kernels 1 and 2 share one template, 1b and 2b another; kernel 9's
    three launches share a prefix)."""
    from voice100_tpu_torch.ops.ctc_cuda import ctc_alpha_adjoint_cuda, ctc_alpha_cuda
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_fwd_cuda)
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda
    from voice100_tpu_torch.ops.relpos_attention_cuda import (relpos_attention_bwd_cuda,
                                                              relpos_attention_fwd_cuda)
    from voice100_tpu_torch.ops.viterbi_cuda import viterbi_align_lattice_cuda

    return {"log_mel_kernel": (log_mel_spectrogram_cuda,),
            "bilstm_persistent_kernel|bilstm_fwd_mma_kernel": (bilstm_cuda,
                                                               bilstm_train_fwd_cuda),
            "lstm_train_bwd_": (bilstm_train_bwd_cuda,),
            "ctc_alpha_kernel": (ctc_alpha_cuda,), "ctc_adjoint_kernel": (ctc_alpha_adjoint_cuda,),
            "viterbi_align_kernel": (viterbi_align_lattice_cuda,),
            "relpos_": (relpos_attention_fwd_cuda, relpos_attention_bwd_cuda)}


def kernel_named(part: str, name: str) -> bool:
    """Whether a card event's kernel name holds one of ``part``'s names
    (a key of :func:`counted_kernels`)."""
    return any(p in name for p in part.split("|"))


def launches_of(wrapper) -> int:
    """A wrapper's launches of all its variants (float32 and, for the
    biLSTM kernels, bf16)."""
    return wrapper.launches + getattr(wrapper, "launches_bf16", 0)


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
    before = {w: launches_of(w) for ws in kernels.values() for w in ws}
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
                    events[part] += kernel_named(part, evt.name)
    except Exception as err:  # the profiler is a measurement aid, not a check
        print(f"torch.profiler failed ({err!r}): device time not measured", flush=True)
        return None, {}, {}
    counts = {part: [events[part], sum(launches_of(w) - before[w] for w in ws)]
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


def enqueue_ms(fn, iters: int = 20) -> float:
    """The host's time a call to enqueue ``iters`` back-to-back calls of
    ``fn`` (before the card has run them)."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - start) / iters * 1e3
    torch.cuda.synchronize()
    return ms


@contextlib.contextmanager
def environ(values):
    """``os.environ`` updated with ``values`` inside, restored after."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


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


def check_melspec(device, batch=BATCH, seconds=10.0):
    """The log-mel kernel against its plain version on ``batch`` clips of
    ``seconds`` (by default one 8 x 10 s serve batch; the streaming
    windows at B=1 and 40 s), timed in turns with torch.stft + mel + log;
    one call must be one launch."""
    from voice100_tpu_torch.ops import melspec
    from voice100_tpu_torch.ops.melspec import log_mel_spectrogram, mel_filterbank
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda

    rng = np.random.default_rng(SEED)
    pcm = np.stack(int16_clips(rng, [seconds] * batch))
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
    print(f"log-mel {batch} x {seconds:g} s ({rows} frames): max_abs_err {err:.3e} (tol {MEL_TOL:.0e}), "
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
        "shapes": f"B={batch}, {seconds:g} s ({wav.shape[1]} samples)",
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
                 input_size=512, plain_iters=3):
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
            # the reference call above warms the plain version up
            plain_ms = time_ms(lambda: bilstm(*params, x, lengths), iters=plain_iters,
                               warmup=min(1, plain_iters - 1))
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
    plain version on the card; timed in turns with cuDNN's packed
    nn.LSTM (which takes no zero-length row: its copy of the lengths
    gives that row one step), beside the bound of the work these lengths
    need."""
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
    library_lengths = torch.from_numpy(np.maximum(lengths_np, 1))
    module = BiLSTM(hidden, hidden, 2, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED + 11))
    gen = torch.Generator(device=device).manual_seed(SEED + 11)
    err, n_bytes, n_ops = 0.0, 0.0, 0.0
    times = {"ms": [], "library_ms": [], "device_ms": [], "library_device_ms": []}
    for layer, (w_ih, w_hh, bias) in enumerate(module.stacked_layers()):
        d_in = w_ih.shape[2]
        x = torch.randn(batch, time_steps, d_in, device=device, generator=gen)
        with torch.no_grad():
            got = bilstm_cuda(w_ih, w_hh, bias, x, lengths)
            ref = bilstm(w_ih, w_hh, bias, x, lengths)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                fail(f"kernel 1 at B={batch}, H={hidden}, layer {layer}: non-finite outputs")
            err = max(err, (got - ref).abs().max().item())
            lstm = torch.nn.LSTM(d_in, hidden, bidirectional=True, batch_first=True,
                                 device=device)
            for suffix in ("", "_reverse"):
                for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                    getattr(lstm, f"{name}_l0{suffix}").copy_(
                        getattr(module, f"{name}_l{layer}{suffix}"))

            def library():
                packed = torch.nn.utils.rnn.pack_padded_sequence(
                    x, library_lengths, batch_first=True, enforce_sorted=False)
                out, _ = lstm(packed)
                return torch.nn.utils.rnn.pad_packed_sequence(
                    out, batch_first=True, total_length=time_steps)[0]

            turns = timed_in_turns({"kernel": lambda: bilstm_cuda(w_ih, w_hh, bias, x, lengths),
                                    "library": library}, iters=2)
        for prefix, side in (("", "kernel"), ("library_", "library")):
            times[prefix + "ms"].append(turns[side]["ms"])
            times[prefix + "device_ms"].append(turns[side]["device_ms"])
        # as check_bilstm counts: x, the weights and the output once; the
        # projections and recurrence of the valid steps only
        n_bytes += (x.numel() + 2 * 4 * hidden * (d_in + hidden + 2) + batch * time_steps
                    * 2 * hidden) * 4 + batch * 4
        n_ops += 2 * 2 * int(lengths_np.sum()) * 4 * hidden * (d_in + hidden)
    bound, bound_by = bound_ms(n_bytes, n_ops)
    # both layers' sums; "not measured" where the profiler missed a layer
    ms, library_ms, device_ms, library_device_ms = (
        None if None in values else sum(values) for values in times.values())
    print(f"biLSTM kernel 1 at B={batch}, T={time_steps}, H={hidden} (the TTS configs' training "
          f"batch; a zero-length row, both layers): {smem} B of shared memory a block (opt-in "
          f"{_SMEM_OPTIN_LIMIT}); max_abs_err {err:.3e} (tol {LSTM_TOL:.0e}); in turns: kernel "
          f"{ms:.3f} ms (device {fmt_ms(device_ms)}), nn.LSTM {library_ms:.3f} ms (device "
          f"{fmt_ms(library_device_ms)}); bound {bound:.4f} ms ({bound_by})", flush=True)
    if not err <= LSTM_TOL:
        fail(f"kernel 1 at B={batch}, H={hidden} disagrees with the plain version: {err:.3e}")
    return {"shapes": f"B={batch}, T={time_steps}, H={hidden}, both layers, a zero-length row",
            "smem_bytes": smem, "max_abs_err": err, "ms": ms, "device_ms": device_ms,
            "library_ms": library_ms, "library_device_ms": library_device_ms,
            "bound_ms": bound, "bound_by": bound_by}


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
    """Kernels 1, 2, 1b, 2b and 3's recurrence are each one cooperative
    grid of 2 H / 8 blocks, one an SM, and 3b's a grid of clusters of them:
    at H=544 (136 blocks) on a card of fewer SMs each wrapper must raise
    before launching anything, with no other path taken. 3b, 1b and 2b also
    raise a ValueError, before loading or launching anything, at one row
    past the batch their shared memory takes (``bwd_cluster_batch_cap``,
    ``fwd_mma_batch_cap``)."""
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_fwd_cuda, bwd_cluster_batch_cap,
                                                  fwd_mma_batch_cap)

    zeros = lambda *shape, dtype=torch.float32: torch.zeros(  # noqa: E731
        *shape, device=device, dtype=dtype)
    bf16 = torch.bfloat16
    hidden, time_steps = 512, 2
    batch = bwd_cluster_batch_cap(hidden) + 1
    before = launches_of(bilstm_train_bwd_cuda)
    try:
        bilstm_train_bwd_cuda(zeros(2, batch, time_steps, 4 * hidden, dtype=bf16),
                              zeros(2, 4 * hidden, hidden),
                              torch.full((batch,), time_steps, device=device),
                              *[zeros(2, batch, time_steps, hidden, dtype=bf16)] * 2,
                              zeros(batch, time_steps, 2 * hidden, dtype=bf16))
        fail(f"kernel 3b ran at batch {batch}, past its shared memory")
    except ValueError as err:
        if launches_of(bilstm_train_bwd_cuda) != before:
            fail("kernel 3b launched before finding its batch does not fit")
        print(f"kernel 3b at B={batch}, H={hidden} raised, launching nothing: {err}", flush=True)
    batch = fwd_mma_batch_cap(hidden) + 1
    full = torch.full((batch,), time_steps, device=device)
    past_cap = {
        "kernel 1b": (bilstm_cuda, lambda: bilstm_cuda(
            zeros(2, 4 * hidden, 8), zeros(2, 4 * hidden, hidden), zeros(2, 4 * hidden),
            zeros(batch, time_steps, 8), full, bf16)),
        "kernel 2b": (bilstm_train_fwd_cuda, lambda: bilstm_train_fwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden, dtype=bf16), zeros(2, 4 * hidden, hidden),
            full)),
    }
    for name, (wrapper, call) in past_cap.items():
        before = launches_of(wrapper)
        try:
            call()
            fail(f"{name} ran at batch {batch}, past its shared memory")
        except ValueError as err:
            if launches_of(wrapper) != before:
                fail(f"{name} launched before finding its batch does not fit")
            print(f"{name} at B={batch}, H={hidden} raised, launching nothing: {err}", flush=True)

    hidden, batch, time_steps = 544, 2, 5
    blocks = 2 * hidden // 8
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms >= blocks:
        print(f"residency checks skipped: {sms} SMs hold {blocks} blocks", flush=True)
        return
    lengths = torch.tensor([5, 3], device=device)
    state = zeros(2, batch, time_steps, hidden)
    state16 = zeros(2, batch, time_steps, hidden, dtype=bf16)
    calls = {
        "kernel 1": (bilstm_cuda, lambda: bilstm_cuda(
            zeros(2, 4 * hidden, 8), zeros(2, 4 * hidden, hidden), zeros(2, 4 * hidden),
            zeros(batch, time_steps, 8), lengths)),
        "kernel 2": (bilstm_train_fwd_cuda, lambda: bilstm_train_fwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden), zeros(2, 4 * hidden, hidden), lengths)),
        "kernel 1b": (bilstm_cuda, lambda: bilstm_cuda(
            zeros(2, 4 * hidden, 8), zeros(2, 4 * hidden, hidden), zeros(2, 4 * hidden),
            zeros(batch, time_steps, 8), lengths, bf16)),
        "kernel 2b": (bilstm_train_fwd_cuda, lambda: bilstm_train_fwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden, dtype=bf16), zeros(2, 4 * hidden, hidden),
            lengths)),
        "kernel 3": (bilstm_train_bwd_cuda, lambda: bilstm_train_bwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden), zeros(2, 4 * hidden, hidden), lengths,
            state, state, zeros(batch, time_steps, 2 * hidden))),
        "kernel 3b": (bilstm_train_bwd_cuda, lambda: bilstm_train_bwd_cuda(
            zeros(2, batch, time_steps, 4 * hidden, dtype=bf16), zeros(2, 4 * hidden, hidden),
            lengths, state16, state16, zeros(batch, time_steps, 2 * hidden, dtype=bf16))),
    }
    for name, (wrapper, call) in calls.items():
        before = launches_of(wrapper)
        try:
            call()
        except RuntimeError as err:
            if launches_of(wrapper) != before:
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


def check_ctc_tol(name, e):
    """Fails where ctc_errors's errors on the batch ``name`` exceed their
    tolerances."""
    if not max(e["alpha"], e["ll"], e["adjoint"]) <= CTC_REL_TOL:
        fail(f"CTC kernels disagree with the plain versions on the {name}: alpha "
             f"{e['alpha']:.3e}, ll {e['ll']:.3e}, adjoint {e['adjoint']:.3e} > "
             f"{CTC_REL_TOL:.0e}")
    if not e["grad"] <= CTC_GRAD_TOL or e["infeasible_grad"] != 0.0:
        fail(f"CTC loss gradient disagrees with the plain version on the {name}: "
             f"{e['grad']:.3e}, infeasible rows {e['infeasible_grad']:.1e}")


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
        check_ctc_tol(name, e)

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
        # the biLSTM through the registered op (the model's path) and
        # through the kernel's wrapper directly, in turns: the op's dispatch
        from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda

        def through_wrapper():
            y = x
            for w_ih, w_hh, bias in model.lstm.stacked_layers():
                y = bilstm_cuda(w_ih, w_hh, bias, y, x_len)
            return y

        turns = {"bilstm_op": lambda: model.lstm(x, x_len), "bilstm_wrapper": through_wrapper}
        samples = {name: [] for name in turns}
        for r in range(TURN_ROUNDS):
            for name in (list(turns) if r % 2 == 0 else list(turns)[::-1]):
                samples[name].append(time_ms(turns[name], iters=5, warmup=1))
        parts.update({f"{name}_median": float(np.median(v)) for name, v in samples.items()})
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


def train_stages(trainer, task, state, batch, gen, tag="train_stages_ms"):
    """Card time of each layer of one training step (CUDA events), the
    backward split by layer through autograd.grad on a retained graph,
    printed under ``tag``."""
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
    print(f"{tag} " + json.dumps({"batch": list(audio.shape), **parts}), flush=True)


def conformer_lengths(rng, batch=CONFORMER_BATCH):
    """Log-mel frames of ``batch`` clips of the Conformer cell's lengths
    (the first at the longest, 16.7 s), their padded extent, its
    subsampled length T' and the clips' seconds."""
    from voice100_tpu_torch.models.conformer_ctc import subsampled_length

    seconds = np.where(rng.random(batch) < 0.8, rng.normal(14.0, 1.6, batch),
                       rng.uniform(2.0, 13.0, batch))
    seconds = np.clip(seconds, 2.0, 16.7)
    seconds[0] = 16.7
    frames = (seconds * SAMPLE_RATE).astype(np.int64) // 160 + 1
    extent = -(-int(frames.max()) // 64) * 64
    return frames, extent, int(subsampled_length(extent)), seconds


def relpos_case(device, batch, time_steps, lengths, drop, seed):
    """Seeded inputs of kernel 9 at ``[batch, time_steps]``, 8 heads of
    64: ``((q, k, v, p, u, v_b), lengths, keep, dout)``, the keep mask
    drawn at 0.1 where ``drop``, ``dout`` zero on padded query rows."""
    from voice100_tpu_torch.ops.relpos_attention import keep_mask

    g = torch.Generator(device=device).manual_seed(seed)
    shape = (batch, time_steps, CONFORMER_HEADS, 64)
    q, k, v = (torch.randn(shape, generator=g, device=device) for _ in range(3))
    p = torch.randn(2 * time_steps - 1, CONFORMER_HEADS, 64, generator=g, device=device)
    u, vb = (torch.randn(CONFORMER_HEADS, 64, generator=g, device=device) * 0.3
             for _ in range(2))
    lengths = torch.as_tensor(lengths, device=device)
    keep = (keep_mask((batch, CONFORMER_HEADS, time_steps, time_steps), 0.1, g, device)
            if drop else None)
    valid = torch.arange(time_steps, device=device)[None, :] < lengths[:, None]
    dout = torch.randn(shape, generator=g, device=device) * valid[:, :, None, None]
    return (q, k, v, p, u, vb), lengths, keep, dout


def relpos_bound_ms(batch, time_steps, lengths):
    """Kernel 9's least time, forward and backward, over the valid pairs:
    9 dot products of 64 a pair and head (forward q.k, q.p, P.v; backward
    dO.v and the products of dV, dK, dQu, dQv, dp); each input read and
    each output written once (q, k, v, out and their gradients over the
    real rows, the projected positions of the longest row and their
    gradient, lse and Delta, the keep mask over the valid pairs, twice)."""
    lengths = np.asarray(lengths, np.float64)
    pairs = CONFORMER_HEADS * float(np.sum(lengths ** 2))
    rows = float(np.sum(lengths)) * CONFORMER_HEADS * 64 * 4
    positions = (2 * float(lengths.max()) - 1) * CONFORMER_HEADS * 64 * 4
    stats = batch * CONFORMER_HEADS * time_steps * 4
    return bound_ms(13 * rows + 3 * positions + 3 * stats + 2 * pairs, 9 * 2 * 64 * pairs)


def check_relpos_attention(device):
    """Kernel 9 (relative-position attention, forward and backward)
    against its plain version at the Conformer cell's batch: at T' = 432
    with the cell's lengths and a keep mask, and at T' = 418 (a 16.7 s
    clip unpadded, no multiple of the kernel's tiles) with ragged rows
    down to one frame and no mask. Each call one forward and two backward
    launches; the output and the six gradients within ``RELPOS_REL_TOL``
    of each result's largest element; padded query rows exactly 0. Times
    forward and backward of the kernel and the plain version in turns at
    the cell's shape (event and device time), and the forwards alone.
    Returns kernel 9's line (its launches from :func:`conformer_phase`)."""
    from voice100_tpu_torch.models.conformer_ctc import subsampled_length
    from voice100_tpu_torch.ops.relpos_attention import relpos_attention_plain
    from voice100_tpu_torch.ops.relpos_attention_cuda import (relpos_attention_bwd_cuda,
                                                              relpos_attention_cuda,
                                                              relpos_attention_fwd_cuda)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products in float32
    frames, _, cell_time, _ = conformer_lengths(np.random.default_rng(SEED + 27))
    cell_lengths = [int(n) for n in subsampled_length(frames)]
    ragged = [418] * 32 + [max(1, 418 - 13 * i) for i in range(32)]
    ragged[-1] = 1
    cases = {"cell": (cell_time, cell_lengths, True), "t418": (418, ragged, False)}
    errs, line = {}, {}
    for n, (name, (time_steps, lengths, drop)) in enumerate(cases.items()):
        inputs, lens, keep, dout = relpos_case(device, CONFORMER_BATCH, time_steps, lengths,
                                               drop, SEED + n)
        rate = 0.1 if drop else 0.0
        ref_leaves = [t.clone().requires_grad_(True) for t in inputs]
        ref = relpos_attention_plain(*ref_leaves, lens, keep, rate)
        ref_grads = torch.autograd.grad(ref, ref_leaves, dout)
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        before = (relpos_attention_fwd_cuda.launches, relpos_attention_bwd_cuda.launches)
        out = relpos_attention_cuda(*leaves, lens, keep, rate)
        grads = torch.autograd.grad(out, leaves, dout)
        torch.cuda.synchronize()
        launched = (relpos_attention_fwd_cuda.launches - before[0],
                    relpos_attention_bwd_cuda.launches - before[1])
        if launched != (1, 2):
            fail(f"kernel 9 ({name}): one call made {launched} forward and backward launches, "
                 f"not (1, 2)")
        padded = torch.arange(time_steps, device=device)[None, :] >= lens[:, None]
        if float((out.detach() * padded[:, :, None, None]).abs().max()) != 0.0:
            fail(f"kernel 9 ({name}): a padded query row attends to something")
        errs[name] = {key: rel_err(a, b) for key, a, b in zip(
            ("out", "dq", "dk", "dv", "dp", "du", "dv_bias"), (out, *grads), (ref, *ref_grads))}
        del ref, ref_grads, out, grads
        if name != "cell":
            continue

        def kernel_call():
            return torch.autograd.grad(relpos_attention_cuda(*leaves, lens, keep, rate), leaves,
                                       dout)

        def plain_call():
            return torch.autograd.grad(relpos_attention_plain(*leaves, lens, keep, rate), leaves,
                                       dout)

        turns = timed_in_turns({"kernel": kernel_call, "plain": plain_call}, iters=10)
        bound, bound_by = relpos_bound_ms(CONFORMER_BATCH, time_steps, lengths)
        line = {
            "ms": turns["kernel"]["ms"], "device_ms": turns["kernel"]["device_ms"],
            "plain_ms": turns["plain"]["ms"], "plain_device_ms": turns["plain"]["device_ms"],
            "fwd_ms": time_ms(lambda: relpos_attention_fwd_cuda(*inputs, lens, keep, rate)),
            "fwd_plain_ms": time_ms(lambda: relpos_attention_plain(*inputs, lens, keep, rate)),
            "bound_ms": bound, "bound_by": bound_by,
            "events_launches": turns["kernel"]["events_launches"],
            "valid_pair_share": float(np.sum(np.square(np.asarray(lengths, np.float64))))
            / (CONFORMER_BATCH * time_steps ** 2)}
    torch.backends.cuda.matmul.allow_tf32 = tf32
    worst = max(max(e.values()) for e in errs.values())
    print(f"kernel 9 (B={CONFORMER_BATCH}, H={CONFORMER_HEADS}, D=64; T'={cell_time} with the "
          f"Conformer cell's lengths and a keep mask, T'=418 ragged without): max error over "
          f"the largest element {worst:.3e} (tol {RELPOS_REL_TOL:.0e}) {json.dumps(errs)}; "
          f"forward and backward at T'={cell_time}: kernel {line['ms']:.4f} ms (device "
          f"{fmt_ms(line['device_ms'])}), plain {line['plain_ms']:.4f} ms (device "
          f"{fmt_ms(line['plain_device_ms'])}), bound {line['bound_ms']:.4f} ms "
          f"({line['bound_by']}); forwards {line['fwd_ms']:.4f} / {line['fwd_plain_ms']:.4f} ms",
          flush=True)
    for name, e in errs.items():
        for key, value in e.items():
            if not value <= RELPOS_REL_TOL:
                fail(f"kernel 9 ({name}): {key} is {value:.3e} of its largest element from the "
                     f"plain version (tol {RELPOS_REL_TOL:.0e})")
    return {"name": "relpos_attention", "route": "cuda",
            "source": "voice100_tpu_torch/csrc/relpos_attention.cu", "replaces": None,
            "launches": None, "max_rel_err": worst, "rel_err": errs, **line,
            "shapes": f"B={CONFORMER_BATCH}, T'={cell_time}, H={CONFORMER_HEADS}, D=64, the "
                      f"Conformer cell's lengths, keep mask at 0.1, forward and backward; plain: "
                      f"materialised scores (float32 cuBLAS), softmax, mask"}


def conformer_phase(device, card):
    """Kernel 9 at the Conformer cell's shapes (:func:`check_relpos_attention`),
    then ConformerCTC at its published widths (121.5 M parameters) trained
    through Trainer.train_step on one batch of the cell's shape (64 clips
    of its lengths, random 80-bin features, SpecAugment and dropout on,
    AdamW under Noam from step 10,000, no clipping): one warm-up step,
    then ``CONFORMER_STEPS`` timed steps with the launch counts set to 0
    just before and read just after (kernel 9's forward once and its
    backward twice a block a step, kernels 4 and 5 once a step); the
    losses must be finite. Returns kernel 9's line with the step's
    launches."""
    from voice100_tpu_torch.models import ConformerCTC
    from voice100_tpu_torch.ops.ctc_cuda import ctc_alpha_adjoint_cuda, ctc_alpha_cuda
    from voice100_tpu_torch.ops.mask import BLANK_AUDIO
    from voice100_tpu_torch.ops.relpos_attention_cuda import (relpos_attention_bwd_cuda,
                                                              relpos_attention_fwd_cuda)
    from voice100_tpu_torch.training import Trainer, TrainerConfig, make_task

    entry = check_relpos_attention(device)
    rng = np.random.default_rng(SEED + 28)
    frames, extent, time_steps, seconds = conformer_lengths(rng)
    target_lengths = np.maximum(np.round(seconds * 6).astype(np.int64), 1)
    targets = rng.integers(1, 129, size=(CONFORMER_BATCH, -(-int(target_lengths.max()) // 16) * 16))
    targets[np.arange(targets.shape[1])[None, :] >= target_lengths[:, None]] = 0
    g = torch.Generator(device=device).manual_seed(SEED)
    mel_len = torch.from_numpy(frames).to(device)
    mel = torch.randn(CONFORMER_BATCH, extent, CONFORMER_MELS, generator=g, device=device) * 2 - 4
    mel = torch.where((torch.arange(extent, device=device)[None, :] < mel_len[:, None])[..., None],
                      mel, BLANK_AUDIO)
    batch = ((mel, mel_len), (torch.from_numpy(targets).to(device),
                              torch.from_numpy(target_lengths).to(device)))
    model = ConformerCTC(device=device, generator=torch.Generator().manual_seed(SEED))
    layers = len(model.layers)
    trainer = Trainer(TrainerConfig(gradient_clip_val=0.0))
    trainer.apply_precision()
    task = make_task(model)
    state = trainer.make_state(task)
    state.step = CONFORMER_START_STEP
    counters = {"relpos_attention_fwd": relpos_attention_fwd_cuda,
                "relpos_attention_bwd": relpos_attention_bwd_cuda,
                "ctc_alpha": ctc_alpha_cuda, "ctc_adjoint": ctc_alpha_adjoint_cuda}
    warm = float(trainer.train_step(task, state, batch, g)["loss"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for fn in counters.values():
        fn.launches = 0
    losses, step_ms = [], []
    for _ in range(CONFORMER_STEPS):
        start = time.perf_counter()
        losses.append(float(trainer.train_step(task, state, batch, g)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(device)
    n_params = sum(p.numel() for p in model.parameters())
    median = float(np.median(step_ms))
    print(f"train conformer_ctc_large ({n_params} parameters): batch {CONFORMER_BATCH} "
          f"({seconds.sum():.2f} s of audio, extent {extent} frames, T'={time_steps}), "
          f"SpecAugment and dropout on, from step {CONFORMER_START_STEP}; loss warm-up "
          f"{warm:.4f}, then {[round(v, 4) for v in losses]}; step median {median:.2f} ms (min "
          f"{min(step_ms):.2f}, max {max(step_ms):.2f}), {seconds.sum() / (median * 1e-3):.1f} "
          f"audio s/s, peak {peak} B allocated on {card}; launches over {CONFORMER_STEPS} "
          f"steps {launches}", flush=True)
    del model, task, state, trainer, batch, mel
    torch.cuda.empty_cache()
    if not all(np.isfinite([warm] + losses)):
        fail(f"train conformer: non-finite loss {[warm] + losses}")
    for name, per_step in (("relpos_attention_fwd", layers), ("relpos_attention_bwd", 2 * layers),
                           ("ctc_alpha", 1), ("ctc_adjoint", 1)):
        want = per_step * CONFORMER_STEPS
        if launches[name] != want:
            fail(f"train conformer: {name} launched {launches[name]} times in "
                 f"{CONFORMER_STEPS} steps, not {want}")
    step_launches = launches["relpos_attention_fwd"] + launches["relpos_attention_bwd"]
    entry.update(launches=step_launches, launches_per_step=step_launches / CONFORMER_STEPS,
                 launches_by_path={"conformer_train": step_launches}, step_ms=median,
                 step_peak_bytes=peak)
    return entry


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


def check_align_lines(path, texts, samples, settings=ASR_EN_BASE["encoder_settings"],
                      n_tokens=len):
    """A line a clip, the clips' texts in order, and counts of
    2 n_tokens(text) + 1 slots summing to each clip's logit length (the
    conv stack ``settings``); returns the lines."""
    from voice100_tpu_torch.models.layers import conv_stack_output_length

    with open(path, encoding="utf-8") as f:
        lines = [line.rstrip("\n").split("|") for line in f]
    if len(lines) != len(texts):
        fail(f"align: {len(lines)} lines for {len(texts)} clips")
    for i, ((text, aligntext, counts), want, n) in enumerate(zip(lines, texts, samples)):
        counts = [int(c) for c in counts.split()]
        frames = conv_stack_output_length(settings, n // 160 + 1)
        if text != want or len(counts) != 2 * n_tokens(text) + 1 or sum(counts) != frames \
                or n_tokens(aligntext) != frames:
            fail(f"align: line {i} has text {text[:20]!r}..., {len(counts)} counts summing to "
                 f"{sum(counts)}, for {n_tokens(want)} tokens and {frames} frames")
    return lines


def align(device, card, workdir, args=None, texts=None, samples=None, runs=("cold", "warm"),
          settings=ASR_EN_BASE, n_tokens=len, name="asr_en_base"):
    """Forced alignment of a corpus through the align CLI on the card
    (by default the 128-clip dummy_en corpus of write_align_corpus, twice:
    a cold feature cache, the log-mel kernel once a clip, then a warm
    one), timed; launch counts set to 0 just before each run and read just
    after. Then each batch's labels against the plain Viterbi on the
    card's own log-probs, and the card time by layer of one batch."""
    from voice100_tpu_torch.tools.align_text import cli_main

    if args is None:
        args, texts, samples = write_align_corpus(workdir)
    argv = [item for key, value in args.items() for item in (f"--{key}", value)]
    audio_sec = sum(samples) / SAMPLE_RATE
    counters = align_counters()
    result = {}
    for run in runs:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        start = time.perf_counter()
        cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        result[run] = {"wall_s": wall, "audio_s_per_s": audio_sec / wall,
                       "launches": {name: fn.launches for name, fn in counters.items()}}
        lines = check_align_lines(args["output"], texts, samples, settings["encoder_settings"],
                                  n_tokens)
    batches = -(-len(texts) // ALIGN_BATCH)
    print(f"align {name}: {len(texts)} clips, {audio_sec:.2f} s of audio, batch "
          f"{ALIGN_BATCH} on {card}: " + "; ".join(
              f"{run} cache {r['wall_s']:.3f} s, {r['audio_s_per_s']:.1f} audio s/s, launches "
              f"{r['launches']}" for run, r in result.items()), flush=True)
    for run, r in result.items():
        got = r["launches"]
        if got["viterbi_align"] != batches:
            fail(f"align ({run}): the Viterbi kernel launched {got}, not once a batch")
        if got["bilstm_recurrence"] != settings["decoder_num_layers"] * batches:
            fail(f"align ({run}): the biLSTM kernel launched {got['bilstm_recurrence']} times, "
                 f"not once a layer a batch")
        if got["log_mel"] != (len(texts) if run == "cold" else 0):
            fail(f"align ({run}): the log-mel kernel launched {got['log_mel']} times, not once "
                 f"a clip with a cold cache and never with a warm one")
    align_batches_vs_plain(device, args, lines)
    return result, args, samples


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


def cli_phase(device, card, workdir, align_args, samples, epochs=CLI_EPOCHS, tag="cli",
              precision=None):
    """A CTC config through the training CLI on the card (training/cli.py
    ``main``, as ``python -m voice100_tpu_torch`` runs it): ``fit`` for
    ``epochs`` epochs on the corpus of ``align_args`` (by default
    asr_en_base on the align corpus) with a cold feature cache, then
    ``validate``, ``test`` and ``predict`` on the ``last.pt`` it wrote; the
    launch counts set to 0 just before each subcommand and read just
    after. ``samples`` are the clips' lengths in the data module's order.
    Checks the log, the checkpoints, the validate loss against the last
    epoch's and the predictions against the card's own greedy decode.
    ``precision`` "16" passes ``--precision 16`` to every subcommand: the
    biLSTM kernels then launch their bf16 variants, counted exactly, and
    their float32 variants never. Returns the launches by subcommand and
    the ``last.pt`` path."""
    import yaml
    from voice100_tpu_torch.training import Trainer, TrainerConfig, load_model_weights
    from voice100_tpu_torch.training.cli import build_from_config, load_config, main

    config = load_config(align_args["config"])
    config_name = os.path.splitext(os.path.basename(align_args["config"]))[0]
    config["trainer"].update(max_epochs=epochs, log_every_n_steps=1)
    cfg = os.path.join(workdir, f"{config_name}_fit.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    ckpt = os.path.join(workdir, f"{tag}_ckpt")
    log = os.path.join(workdir, f"{tag}_log.jsonl")
    cache = os.path.join(workdir, f"{tag}_cache")
    common = ["--config", cfg, "--data_dir", align_args["data_dir"],
              "--cache_dir", cache, "--checkpoint_dir", ckpt,
              "--device", str(device)] + (["--precision", precision] if precision else [])
    last = os.path.join(ckpt, "last.pt")
    predictions = os.path.join(workdir, f"{tag}_predictions.txt")
    counters = {**cli_counters(), **(bf16_counters() if precision else {})}
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
                                             "cache_dir": cache}, device=device)
    data.setup("fit")
    n_train, n_val = len(data.train_ds), len(data.valid_ds)
    train_sec = sum(samples[i] for i in data.train_ds._dataset._indices) / SAMPLE_RATE
    bs, layers = data.batch_size, model.lstm.num_layers
    n_clips = len(samples)
    steps, val_batches = epochs * -(-n_train // bs), -(-n_val // bs)
    all_batches = -(-n_clips // bs)
    # an evaluated batch: kernel 1 twice a layer (the loss and the CER
    # decode are two forwards) and kernel 4 once (the loss)
    evals = val_batches * epochs
    want = {
        "fit": {"log_mel": n_clips, "bilstm_recurrence": 2 * layers * evals,
                "bilstm_train_fwd": layers * steps, "bilstm_train_bwd": 2 * layers * steps,
                "ctc_alpha": steps + evals, "ctc_adjoint": steps, "viterbi_align": 0},
        "validate": {"bilstm_recurrence": 2 * layers * val_batches, "ctc_alpha": val_batches},
        "test": {"bilstm_recurrence": 2 * layers * all_batches, "ctc_alpha": all_batches},
        "predict": {"bilstm_recurrence": layers * all_batches},
    }
    for sub, counts in want.items():
        full = dict.fromkeys(counters, 0)
        # at bf16 the biLSTM kernels' counts move to their bf16 variants
        full.update({f"{k}_bf16" if precision and k.startswith("bilstm") else k: v
                     for k, v in counts.items()})
        if runs[sub]["launches"] != full:
            fail(f"{tag} {sub}: launches {runs[sub]['launches']}, not {full}")

    with open(log) as f:
        records = [json.loads(line) for line in f]
    starts = [r for r in records if r.get("event") == "fit_start"]
    records_by_epoch = [r for r in records if "train_time_s" in r]
    step_losses = [r["train_loss"] for r in records
                   if "train_loss" in r and "train_time_s" not in r]
    # no WER for phone tokenizers: their decoded text has no word boundaries
    keys = ("val_loss", "val_cer") + (() if data.use_phone else ("val_wer",))
    if len(starts) != 1 or len(records_by_epoch) != epochs or not all(
            np.isfinite(r.get(k, np.nan)) for r in records_by_epoch for k in keys):
        fail(f"{tag} fit: log has {len(starts)} fit_start records and epoch records "
             f"{records_by_epoch}")
    per_epoch = steps // epochs
    if len(step_losses) != steps or not np.all(np.isfinite(step_losses)) or not (
            np.mean(step_losses[-per_epoch:]) < np.mean(step_losses[:per_epoch])):
        fail(f"{tag} fit: the train loss is not finite or does not fall: {step_losses}")
    for name in ("best.pt", "last.pt"):
        if not os.path.isfile(os.path.join(ckpt, name)):
            fail(f"{tag} fit: {name} was not written")
    val, last_val = results["validate"], records_by_epoch[-1]["val_loss"]
    val_err = abs(val["loss"] - last_val) / abs(last_val)
    if not val_err <= CLI_VAL_REL_TOL:
        fail(f"{tag} validate: val_loss {val['loss']} on last.pt, the last epoch logged {last_val}")

    load_model_weights(last, model)
    model.eval()
    Trainer(TrainerConfig(precision=precision or "32")).apply_precision()  # as predict ran
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
    if len(lines) != n_clips or lines != want_lines:
        fail(f"{tag} predict: {len(lines)} lines for {n_clips} clips, "
             f"{sum(a == b for a, b in zip(lines, want_lines))} equal to the card's greedy decode")

    fit_s = runs["fit"]["wall_s"]
    print(f"{tag} {config_name} on {card}: fit {epochs} epochs ({n_train} train clips, "
          f"{train_sec:.2f} s of audio, {n_val} val clips, batch {bs}, cold feature cache) "
          f"{fit_s:.3f} s, {fit_s / epochs:.3f} s an epoch by host clock with validation; "
          f"train time by epoch " + ", ".join(
              f"{r['train_time_s']} s ({train_sec / max(r['train_time_s'], 1e-9):.1f} audio s/s)"
              for r in records_by_epoch) + f"; step losses {[round(v, 4) for v in step_losses]}; "
          f"val_loss by epoch {[round(r['val_loss'], 4) for r in records_by_epoch]}",
          flush=True)
    print(f"{tag} validate on last.pt: val_loss {val['loss']:.6f} against the last epoch's "
          f"{last_val:.6f} (rel err {val_err:.2e}, tol {CLI_VAL_REL_TOL:.0e}), val_cer "
          f"{val['cer']:.4f} ({records_by_epoch[-1]['val_cer']:.4f} logged); test "
          f"{results['test']}; predict wrote {len(lines)} lines, all equal to the card's greedy "
          f"decode", flush=True)
    print(f"{tag}_runs " + json.dumps({sub: {"wall_s": r["wall_s"], "launches": r["launches"]}
                                       for sub, r in runs.items()}), flush=True)
    return {sub: r["launches"] for sub, r in runs.items()}, last


TTS_STAGE_KEYS = ("phonemize_tokenize", "align_model", "duration_fetch", "cursor_host",
                  "expansion", "audio_encoder", "decoder_convs", "projection_unnormalize",
                  "mc2sp", "codeap_host", "synthesis", "fetch")


def write_tts_checkpoints(root: str, align=(ALIGN_EN_BASE, "config/align_en_base.yaml"),
                          audio=(TTS_EN_BASE, "config/tts_en_base.yaml")):
    """Seeded full-width align and audio models (``(init args, config)``
    each), the duration bias and the statistics set, saved as port
    checkpoints; returns {name: (config, checkpoint)}."""
    from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    paths = {}
    for i, (name, cls, kwargs, config) in enumerate((
            ("align", TextToAlignText, *align), ("audio", AlignTextToAudio, *audio))):
        model = cls(**kwargs, device="cpu", generator=torch.Generator().manual_seed(SEED + 12 + i))
        with torch.no_grad():
            if name == "align":
                model.dense.bias.copy_(torch.tensor(TTS_DURATION_BIAS))
            else:
                for key, value in TTS_STATS.items():
                    getattr(model.norm, key).copy_(torch.tensor(value))
        ckpt = os.path.join(root, os.path.basename(config).replace(".yaml", "_random.pt"))
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


def tts_phase(device, card, workdir, paths=None, texts=TTS_TEXTS, language="en",
              use_phone=False, label="tts align_en_base + tts_en_base"):
    """TTS serving through TTSPipeline on the card (by default at
    align_en_base and tts_en_base width, characters): launches of one
    call, the wall time of warm calls (float32 and int16), the stages, the
    card against the CPU on the first TTS_PARITY_TEXTS texts, and kernel 1
    at the run's shapes, each model's width."""
    from voice100_tpu_torch.inference import TTSPipeline
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.training.cli import load_model

    if paths is None:
        paths = write_tts_checkpoints(workdir)
    pipes = {dev: TTSPipeline(load_model(*paths["align"], device=dev),
                              load_model(*paths["audio"], device=dev),
                              language=language, use_phone=use_phone, device=dev)
             for dev in (device, "cpu")}
    pipe = pipes[device]
    pipe.synthesize(texts)  # warm-up: constants, cuDNN plans
    torch.cuda.synchronize()
    wrappers = {w for ws in counted_kernels().values() for w in ws}
    for w in wrappers:
        w.launches = 0
    wavs = pipe.synthesize(texts)
    torch.cuda.synchronize()
    launches = {"bilstm_recurrence": bilstm_cuda.launches}
    others = {w.__name__: w.launches for w in wrappers if w is not bilstm_cuda and w.launches}
    # one batch of 16: the align model's two layers, the audio encoder's two
    if launches["bilstm_recurrence"] != 4 or others:
        fail(f"{label}: one synthesize call of one batch launched kernel 1 "
             f"{launches['bilstm_recurrence']} times, not 4, and {others}")
    timed = {}
    for dtype in (np.float32, np.int16):
        walls = []
        for _ in range(TTS_TIMED_CALLS):
            start = time.perf_counter()
            out = pipe.synthesize(texts, output_dtype=dtype)
            walls.append(time.perf_counter() - start)
            # the same texts and noise give the same waveforms, bit for bit
            if dtype == np.float32 and not all(map(np.array_equal, out, wavs)):
                fail(f"{label}: two synthesize calls of the same texts gave different waveforms")
        audio_s = sum(len(w) for w in out) / SAMPLE_RATE
        wall = float(np.median(walls))
        timed[np.dtype(dtype).name] = {"wall_s": wall, "audio_s": audio_s,
                                       "audio_s_per_s": audio_s / wall, "walls": walls}
        if dtype == np.int16:
            pcm = out
    for w32, w16 in zip(wavs, pcm):
        if not np.isfinite(w32).all() or w16.dtype != np.int16 or w16.shape != w32.shape:
            fail(f"{label}: a waveform is not finite, or int16 and float32 differ in shape")
        expect = np.round(np.clip(w32, -1.0, 1.0) * 32767.0)
        if np.abs(w16.astype(np.float64) - expect).max() > 1:
            fail(f"{label}: int16 output is not round(clip(float) * 32767) +/- 1")
    print(f"{label} on {card}: {len(texts)} texts, one batch; "
          + "; ".join(f"{k}: synthesize median {v['wall_s'] * 1e3:.2f} ms of {TTS_TIMED_CALLS} "
                      f"warm calls, {v['audio_s']:.2f} s of audio, {v['audio_s_per_s']:.1f} "
                      f"audio s/s" for k, v in timed.items())
          + f"; launches of one call {launches}", flush=True)
    run, stage_ms = tts_stages(pipe, texts, timed=True)
    print("tts_stages_ms " + json.dumps({"label": label, "texts": len(texts), "text_bucket":
                                         int(run["text"].shape[1]), "frame_bucket": run["out_len"],
                                         **stage_ms}), flush=True)
    parity = tts_parity(pipe, pipes["cpu"], texts[:TTS_PARITY_TEXTS])
    # each model's biLSTM takes its embedding, as wide as its hidden state
    widths = {"align": pipe.align_model.lstm.hidden_size, "audio": pipe.audio_model.lstm.hidden_size}
    del pipes, pipe
    kernel_shapes = {
        "tts_align": check_bilstm(device, len(texts), int(run["text"].shape[1]),
                                  [int(n) for n in run["text_len"]], hidden=widths["align"],
                                  input_size=widths["align"]),
        "tts_audio": check_bilstm(device, len(texts), run["out_len"],
                                  [int(n) for n in run["aligntext_len"]], hidden=widths["audio"],
                                  input_size=widths["audio"]),
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


def tts_train_stages(task, state, batch, gen, tag="tts_train_stages_ms"):
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
    print(f"{tag} " + json.dumps({"aligntext": list(text.shape), "frames": list(f0.shape),
                                  **parts}), flush=True)
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


def tts_corpus(workdir, align_args):
    """The voiced corpus, its align file through the align CLI with the
    align phase's ASR checkpoint, and calc_stat with a cold WORLD cache
    (the host analysis, timed); returns (data directory, cache directory,
    statistics file, clip seconds, analysis seconds)."""
    from voice100_tpu_torch.tools.align_text import cli_main as align_main
    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main

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
    return data_dir, cache_dir, stat_path, seconds, analysis_s


def tts_train_phase(device, card, workdir, align_args):
    """TTS v2 training at align_en_base and tts_en_base width: the voiced
    corpus, its align file through the align CLI with the align phase's
    ASR checkpoint, calc_stat (the cold WORLD analysis, timed), the steps,
    the stages, the card against the CPU, the CLI, and kernels 2 and 3 at
    the batches' shapes."""
    configs = check_tts_configs_build(device)
    data_dir, cache_dir, stat_path, seconds, analysis_s = tts_corpus(workdir, align_args)
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
    return by_path, kernels, summary, {"batches": batches, "stat_path": stat_path}


# The phone configs end to end (prepare -> asr_en_phone_base fit -> align ->
# phone TTS serving) on a synthetic corpus in the real corpora's layouts:
# 96 FLAC clips of 2-8 s, LJSpeech (22.05 kHz) and LibriSpeech (16 kHz),
# with English transcripts that need the G2P's number, currency,
# abbreviation and heteronym rules
PHONE_LJ_CLIPS, PHONE_LIBRI_TRAIN, PHONE_LIBRI_DEV = 48, 40, 8
PHONE_SECONDS = (2.0, 8.0)
PHONE_CLI_EPOCHS = 2
ASR_EN_PHONE_BASE = dict(ASR_EN_BASE, vocab_size=71,
                         encoder_settings=((512, False, 5, 2, 2, False),
                                           (512, False, 5, 1, 2, False)))
ALIGN_EN_PHONE_BASE = dict(ALIGN_EN_BASE, vocab_size=71)
TTS_EN_PHONE_BASE = dict(TTS_EN_BASE, vocab_size=71)
ALIGN_JA_PHONE_BASE = dict(ALIGN_EN_BASE, vocab_size=44, hidden_size=512)
TTS_JA_PHONE_BASE = dict(TTS_EN_BASE, vocab_size=44)
PHONE_FRAGMENTS = [
    "Dr. Smith read 12 books", "they paid $3.50 for the lead pipe", "on St. James Street",
    "Mr. Brown lives at 221 Baker St. with 2 cats", "we must object to the object",
    "the wind was too strong to wind the clock at 7:45", "I will read the record",
    "it was a record year for the firm", "said the 3rd witness", "in 1998 the bass player left",
    "please close the door", "the dove dove into the bushes", "they lead the league by 14 points",
    "Mrs. Jones spent $1,250 on a new desk", "the minute hand moved a minute amount",
    "we live near the live music hall", "the 2nd tear rolled down as she saw the tear",
    "Prof. Lee will present the present on May 4th", "about 60% of the 500 seats were empty",
    "the invalid invoice was marked invalid", "he wound the bandage around the wound",
]
# longest first: the card is held to the CPU on the first TTS_PARITY_TEXTS
PHONE_TTS_TEXTS_EN = [
    "Please close the door, it is close to 5 p.m. and the lead singer is late.",
    "Dr. Brown read the invalid invoice twice before he paid the $99 fee.",
    "Mrs. Jones spent $1,250 on a new desk, and about 60% of it was tax.",
    "In 2024 the team won 14 of 16 games and led the league by 3 points.",
    "The wind was too strong to wind the clock at 7:45 this morning.",
    "He wound the bandage around the wound and read the note again.",
    "The minute hand moved a minute amount; it was 3 minutes to 12.",
    "Prof. Lee will present the present on May 4th, at 10:30 a.m.",
    "We must object to the object, said the 3rd witness in 1998.",
    "I will read the record; it was a record year for the firm.",
    "About 500 people live near the live music hall on 5th Ave.",
    "The 2nd tear rolled down as she saw the tear in her coat.",
    "They paid $3.50 for the lead pipe on St. James Street.",
    "The dove dove into the bushes as the 2 dogs ran past.",
    "Dr. Smith read 12 books.", "Lead the way, Mr. Brown!",
]
PHONE_TTS_TEXTS_JA = [
    "また、東寺のように五大明王と呼ばれる主要な明王の中央に配されることも多い。",
    "ニューイングランド風は牛乳をベースとした白いクリームスープです。",
    "2026年8月18日の午後3時30分です。", "りんごを6個と本を2冊買いました。",
    "100円のパンを4月1日に買った。", "彼は20歳で、弟は8歳です。",
    "今日はとても良い天気ですね。", "東京で3時に会いましょう。",
]
PHONE_MP3_CLIPS = 24
PHONE_MP3_RATE = 24000
# test_native.py's bound between the native and the NumPy resampler
PHONE_RESAMPLE_TOL = 5e-3


@functools.lru_cache(maxsize=None)
def load_test_fixture(name: str):
    """A fixture module of tests/ by path (the FLAC one imports NumPy
    alone, the MP3 one ctypes and NumPy)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join("tests", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def encode_flac_long(pcm, rate: int, block: int = 4096) -> bytes:
    """Mono 16-bit PCM as FLAC: tests/flac_fixture.py's bit writer and
    verbatim subframes, in frames of ``block`` samples with 16-bit block
    sizes and UTF-8 frame numbers (the fixture's own frames hold 256
    samples and number at most 128, about 2 s at 16 kHz). A verbatim
    subframe of 16-bit samples is byte aligned, so NumPy writes it."""
    fixture = load_test_fixture("flac_fixture")
    pcm = np.asarray(pcm, np.int16)
    info = fixture.BitWriter()
    for value, bits in ((1, 1), (0, 7), (34, 24), (block, 16), (block, 16), (0, 24), (0, 24),
                        (rate, 20), (0, 3), (15, 5), (len(pcm), 36)):
        info.write(value, bits)
    for _ in range(16):
        info.write(0, 8)  # md5
    out = [b"fLaC", info.getvalue()]
    for frame, start in enumerate(range(0, len(pcm), block)):
        seg = pcm[start:start + block]
        head = fixture.BitWriter()
        # sync, fixed blocking, 16-bit block size at the end, the stream's
        # rate and sample size, one channel
        for value, bits in ((0b11111111111110, 14), (0, 2), (0b0111, 4), (0, 4), (0, 4),
                            (0, 4)):
            head.write(value, bits)
        if frame < 0x80:
            head.write(frame, 8)
        elif frame < 0x800:
            head.write(0b11000000 | frame >> 6, 8)
            head.write(0x80 | frame & 0x3F, 8)
        else:
            head.write(0b11100000 | frame >> 12, 8)
            head.write(0x80 | frame >> 6 & 0x3F, 8)
            head.write(0x80 | frame & 0x3F, 8)
        head.write(len(seg) - 1, 16)
        head.write(0, 8)  # CRC-8 (the decoder does not verify it)
        head.write(0, 1)
        head.write(1, 6)  # verbatim
        head.write(0, 1)
        out += [head.getvalue(), seg.astype(">i2").tobytes(), b"\0\0"]
    return b"".join(out)


def phone_texts(rng, seconds):
    """An English transcript of about 14 characters a second, joined from
    PHONE_FRAGMENTS."""
    texts = []
    for sec in seconds:
        parts, n = [], 0
        while n < sec * 14 - 10:
            part = PHONE_FRAGMENTS[int(rng.integers(len(PHONE_FRAGMENTS)))]
            parts.append(part)
            n += len(part) + 2
        text = ", ".join(parts)
        texts.append(text[0].upper() + text[1:] + ".")
    return texts


def write_phone_corpus(root: str):
    """The LJSpeech layout (``LJSpeech-1.1/metadata.csv``, 22.05 kHz
    ``wavs/*.flac``) and the LibriSpeech one (16 kHz
    ``train-clean-100/<spk>/<chap>/*.flac`` with ``*.trans.txt``, and
    ``dev-clean``): noise under a slow envelope, as int16 FLAC. Returns
    the data dir and the clips' seconds and texts by corpus."""
    rng = np.random.default_rng(SEED + 20)
    data_dir = os.path.join(root, "phone_data")
    corpora = {}
    lj = os.path.join(data_dir, "LJSpeech-1.1")
    os.makedirs(os.path.join(lj, "wavs"))
    seconds = rng.uniform(*PHONE_SECONDS, size=PHONE_LJ_CLIPS)
    texts = phone_texts(rng, seconds)
    lines = []
    for i, (sec, text) in enumerate(zip(seconds, texts)):
        clipid = f"LJ001-{i + 1:04d}"
        n = int(sec * 22050)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * np.arange(n) / 22050)
        pcm = (rng.standard_normal(n) * 4000 * env).clip(-32768, 32767)
        with open(os.path.join(lj, "wavs", clipid + ".flac"), "wb") as f:
            f.write(encode_flac_long(pcm, 22050))
        lines.append(f"{clipid}|{text}|{text}")
    with open(os.path.join(lj, "metadata.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")
    corpora["ljspeech"] = (seconds, texts)
    for split, count in (("train-clean-100", PHONE_LIBRI_TRAIN), ("dev-clean", PHONE_LIBRI_DEV)):
        seconds = rng.uniform(*PHONE_SECONDS, size=count)
        texts = phone_texts(rng, seconds)
        clips = int16_clips(rng, seconds)
        trans = {}
        for i, (clip, text) in enumerate(zip(clips, texts)):
            speaker, chapter = 19 + i % 4, 198
            folder = os.path.join(data_dir, "LibriSpeech", split, str(speaker), str(chapter))
            os.makedirs(folder, exist_ok=True)
            clipid = f"{speaker}-{chapter}-{i:04d}"
            with open(os.path.join(folder, clipid + ".flac"), "wb") as f:
                f.write(encode_flac_long(clip, SAMPLE_RATE))
            trans.setdefault(folder, []).append(f"{clipid} {text.upper()}")
        for folder, rows in trans.items():
            name = "-".join(folder.split(os.sep)[-2:])
            with open(os.path.join(folder, f"{name}.trans.txt"), "w") as f:
                f.write("\n".join(rows) + "\n")
        corpora[split] = (seconds, texts)
    return data_dir, corpora


def phone_prepare(data_dir):
    """The port's prepare_dataset --use_phone on both corpora, on the card
    run's host, then again with the phonemizer built afresh: the files
    must be equal (host code). Returns the G2P's host milliseconds a text."""
    from voice100_tpu_torch.text import get_phonemizer
    from voice100_tpu_torch.tools.prepare_dataset import cli_main as prepare

    argv = ["--data_dir", data_dir, "--dataset", "ljspeech,librispeech", "--split",
            "train,valid", "--language", "en", "--use_phone"]
    names = [f"{ds}-phone-{split}.txt" for ds in ("ljspeech", "librispeech")
             for split in ("train", "valid")]
    start = time.perf_counter()
    prepare(argv)
    prepare_s = time.perf_counter() - start
    first = {name: open(os.path.join(data_dir, name), "rb").read() for name in names}
    phonemizer = get_phonemizer("en", use_phone=True)
    texts = [line.split("|", 2)[2] for line in open(
        os.path.join(data_dir, "LJSpeech-1.1", "metadata.csv"), encoding="utf-8")]
    start = time.perf_counter()
    for text in texts:
        phonemizer(text.rstrip("\n"))
    g2p_ms = (time.perf_counter() - start) * 1e3 / len(texts)
    prepare(argv)
    for name in names:
        if open(os.path.join(data_dir, name), "rb").read() != first[name]:
            fail(f"phone prepare: {name} differs between two runs of the same input")
    n_lines = {name: blob.count(b"\n") for name, blob in first.items()}
    want = {"ljspeech-phone-train.txt": PHONE_LJ_CLIPS, "ljspeech-phone-valid.txt": PHONE_LJ_CLIPS,
            "librispeech-phone-train.txt": PHONE_LIBRI_TRAIN,
            "librispeech-phone-valid.txt": PHONE_LIBRI_DEV}
    if n_lines != want:
        fail(f"phone prepare: lines {n_lines}, not {want}")
    print(f"phone prepare_dataset (ljspeech,librispeech, train and valid, {sum(want.values())} "
          f"transcripts): {prepare_s:.3f} s; CMU G2P {g2p_ms:.3f} ms a text (host clock, this "
          f"machine's CPU)", flush=True)
    return {"prepare_s": prepare_s, "g2p_ms_per_text": g2p_ms}


def phone_fit_start_weights(device, cfg, data_dir, workdir):
    """The weights ``fit`` starts from, as training/cli.py hands them to
    Trainer.fit, from two runs on the card and one on the CPU (the
    trainer itself stopped there): all equal, the seed repair."""
    from voice100_tpu_torch.training import cli

    real, seen = cli.Trainer.fit, []

    def record(self, model, *args, **kwargs):
        seen.append({k: v.detach().cpu() for k, v in model.state_dict().items()})

    cli.Trainer.fit = record
    try:
        for dev in (device, device, "cpu"):
            cli.main(["fit", "--config", cfg, "--data_dir", data_dir, "--device", str(dev),
                      "--checkpoint_dir", os.path.join(workdir, "phone_seed_ckpt")])
    finally:
        cli.Trainer.fit = real
    same = all(a.keys() == seen[0].keys() and all(torch.equal(a[k], seen[0][k]) for k in a)
               for a in seen[1:])
    if len(seen) != 3 or not same:
        fail("phone fit: two runs of one config did not start from the same weights")
    print(f"phone fit: two runs on the card and one on the CPU start from equal weights "
          f"({sum(v.numel() for v in seen[0].values())} values, seed_everything of the "
          f"config)", flush=True)


def phone_ctc_batch(device, config, data_dir, cache_dir, ckpt):
    """Kernels 4 and 5 against their plain versions on the first training
    batch of the phone fit: its model from ``ckpt`` on its clips (the
    fit's warm cache), so at vocab 71 (which sets the forward kernel's
    chunk of steps and shared-memory ring) with the fit's logit and label
    lengths. Returns each kernel's shapes and max abs error."""
    from voice100_tpu_torch.ops.ctc_cuda import alpha_chunk
    from voice100_tpu_torch.training import load_model_weights
    from voice100_tpu_torch.training.cli import build_from_config

    model, data = build_from_config(config, {"data_dir": data_dir, "cache_dir": cache_dir},
                                    device=device)
    load_model_weights(ckpt, model)
    model.eval()
    data.setup("fit")
    (audio, audio_len), (text, text_len) = next(iter(data.train_dataloader()))
    with torch.no_grad():
        logits, logits_len = model(torch.from_numpy(audio).to(device).float(),
                                   torch.from_numpy(audio_len).to(device))
        log_probs = torch.log_softmax(logits, dim=-1)
    targets, target_lengths = (torch.from_numpy(np.asarray(a)).to(device).long()
                               for a in (text, text_len))
    err, (z, *_) = ctc_errors(log_probs, targets, logits_len, target_lengths)
    check_ctc_tol("phone fit batch", err)
    batch, time_steps, vocab = log_probs.shape
    shapes = (f"the phone fit's first train batch: B={batch}, T={time_steps}, V={vocab} "
              f"(chunk {alpha_chunk(vocab)}), S={z.shape[1]}, logit lengths "
              f"{int(logits_len.min())}-{int(logits_len.max())}, labels "
              f"{int(target_lengths.min())}-{int(target_lengths.max())}")
    print(f"CTC on {shapes}: alpha rel err {err['alpha']:.3e}, ll {err['ll']:.3e}, adjoint "
          f"{err['adjoint']:.3e} (tol {CTC_REL_TOL:.0e}), loss gradient {err['grad']:.3e} (tol "
          f"{CTC_GRAD_TOL:.0e}), infeasible rows {err['infeasible_rows']}", flush=True)
    return {"ctc_alpha": {"shapes": shapes + " forward", "max_abs_err": err["alpha_abs"]},
            "ctc_adjoint": {"shapes": shapes + " backward", "max_abs_err": err["adjoint_abs"]}}


def phone_mp3(device, card, workdir):
    """cv_ja through the MP3 decoder: a CommonVoice-layout corpus written
    with libmp3lame (tests/mp3_fixture.py), the port's Japanese phonemizer
    through prepare_dataset, load_audio and load_audio_batch held to the
    tones written and to each other, then asr_ja_phone_base on it through
    cli_phase. Skipped, with a line that says which library is missing,
    where libmp3lame or libmpg123 is absent. Returns cli_phase's launches
    by subcommand (None when skipped) and the decode times."""
    import yaml
    from voice100_tpu_torch.data.registry import get_dataset
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.native.batch import load_audio_batch
    from voice100_tpu_torch.native.mp3 import mp3_available
    from voice100_tpu_torch.tools.prepare_dataset import cli_main as prepare
    from voice100_tpu_torch.training.cli import load_config

    lame = load_test_fixture("mp3_fixture")
    missing = [name for name, ok in (("libmp3lame", lame.lame_available()),
                                     ("libmpg123", mp3_available())) if not ok]
    if missing:
        print(f"phone mp3: skipped, {' and '.join(missing)} cannot be loaded on this machine",
              flush=True)
        return None, {"skipped": missing}
    rng = np.random.default_rng(SEED + 21)
    data_dir = os.path.join(workdir, "mp3_data")
    root = os.path.join(data_dir, "cv-corpus-12.0-2022-12-07", "ja")
    os.makedirs(os.path.join(root, "clips"))
    rows, written = ["client_id\tpath\tsentence\tup_votes\tdown_votes"], {}
    for i in range(PHONE_MP3_CLIPS):
        name = f"common_voice_ja_{30000000 + i}.mp3"
        n = int(rng.uniform(2.0, 4.0) * PHONE_MP3_RATE)
        tone = float(rng.uniform(200.0, 1000.0))
        wave = (0.4 * np.sin(2 * np.pi * tone * np.arange(n) / PHONE_MP3_RATE)).astype(np.float32)
        path = os.path.join(root, "clips", name)
        lame.write_mp3(path, wave, PHONE_MP3_RATE)
        text = PHONE_TTS_TEXTS_JA[i % len(PHONE_TTS_TEXTS_JA)]
        rows.append(f"speaker{i:02d}\t{name}\t{text}\t2\t0")
        written[path] = (tone, n * SAMPLE_RATE / PHONE_MP3_RATE)
    with open(os.path.join(root, "validated.tsv"), "w", encoding="utf-8") as f:
        f.write("\n".join(rows) + "\n")
    prepare(["--data_dir", data_dir, "--dataset", "cv_ja", "--language", "ja", "--use_phone"])

    # the clips in the data module's order
    items = get_dataset(data_dir, "cv_ja", "train", use_phone=True)
    paths = [items[i][1] for i in range(len(items))]
    start = time.perf_counter()
    singles = [load_audio(path) for path in paths]
    single_s = time.perf_counter() - start
    start = time.perf_counter()
    batch = load_audio_batch(paths, SAMPLE_RATE)
    batch_s = time.perf_counter() - start
    if sorted(paths) != sorted(written):
        fail(f"phone mp3: the data module lists {len(paths)} clips, {len(written)} were written")
    for i, (path, one, many) in enumerate(zip(paths, singles, batch)):
        tone, n = written[path]
        if many is None or abs(len(one) - n) > 0.1 * SAMPLE_RATE or \
                abs(len(many) - len(one)) > 1 or not np.isfinite(one).all():
            fail(f"phone mp3: clip {i} decodes to {len(one)} and "
                 f"{None if many is None else len(many)} samples for {n:.0f}")
        spec = np.abs(np.fft.rfft(one * np.hanning(len(one))))
        peak = np.fft.rfftfreq(len(one), 1.0 / SAMPLE_RATE)[spec.argmax()]
        m = min(len(one), len(many)) - 20
        err = float(np.abs(one[20:m] - many[20:m]).max())
        if abs(peak - tone) > 5.0 or not err <= PHONE_RESAMPLE_TOL:
            fail(f"phone mp3: clip {i} peaks at {peak:.1f} Hz for a {tone:.1f} Hz tone, batch "
                 f"against single decode {err:.2e}")
    print(f"phone mp3 cv_ja on {card}: {PHONE_MP3_CLIPS} clips at {PHONE_MP3_RATE} Hz, decode "
          f"to 16 kHz one by one {single_s:.3f} s, in one batch call {batch_s:.3f} s (host "
          f"clock)", flush=True)
    config = load_config("config/asr_ja_phone_base.yaml")
    config["data"]["init_args"]["dataset"] = "cv_ja"
    cfg = os.path.join(workdir, "asr_ja_phone_base_cv_ja.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    launches, _ = cli_phase(device, card, workdir, {"config": cfg, "data_dir": data_dir},
                            [len(w) for w in batch], epochs=PHONE_CLI_EPOCHS, tag="phone_mp3")
    return launches, {"single_decode_s": single_s, "batch_decode_s": batch_s}


def phone_phase(device, card, workdir):
    """The phone configs end to end on the card: the FLAC corpora, the
    port's prepare_dataset, asr_en_phone_base through the training CLI
    (cli_phase: 2 epochs from a cold cache, then validate, test and
    predict) with the seed repair and the native prefetch timed, kernels
    4 and 5 on its first train batch, the align CLI on the LJSpeech
    corpus with its checkpoint, phone TTS serving for English and
    Japanese (tts_phase, kernel 1 at each run's shapes), and cv_ja
    through the MP3 decoder and cli_phase. Returns the launch counts by
    path, the kernel checks at these paths' shapes by kernel, and a
    summary."""
    import yaml
    from voice100_tpu_torch.data.registry import get_dataset
    from voice100_tpu_torch.data.transforms import EncodedCacheDataset
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.native.batch import load_audio_batch
    from voice100_tpu_torch.text import get_tokenizer

    start = time.perf_counter()
    data_dir, _ = write_phone_corpus(workdir)
    write_s = time.perf_counter() - start
    summary = {"corpus_write_s": write_s, "prepare": phone_prepare(data_dir)}
    config = yaml.safe_load(open("config/asr_en_phone_base.yaml"))
    cfg = os.path.join(workdir, "asr_en_phone_base.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    phone_fit_start_weights(device, cfg, data_dir, workdir)

    # the clips in the data module's order (ljspeech, then librispeech's
    # train split), at 16 kHz as the native batch decode gives them
    items = get_dataset(data_dir, "ljspeech,librispeech", "train", use_phone=True)
    paths = [items[i][1] for i in range(len(items))]
    start = time.perf_counter()
    waves = load_audio_batch(paths, SAMPLE_RATE)
    batch_s = time.perf_counter() - start
    start = time.perf_counter()
    for path in paths:
        load_audio(path, SAMPLE_RATE)
    single_s = time.perf_counter() - start
    samples = [len(w) for w in waves]
    audio_s = sum(samples) / SAMPLE_RATE

    real, spent = EncodedCacheDataset.prefetch, []

    def timed_prefetch(self, indices):
        begin = time.perf_counter()
        real(self, indices)
        spent.append(time.perf_counter() - begin)

    EncodedCacheDataset.prefetch = timed_prefetch
    try:
        cli_launches, ckpt = cli_phase(device, card, workdir, {"config": cfg,
                                                               "data_dir": data_dir},
                                       samples, epochs=PHONE_CLI_EPOCHS, tag="phone_cli")
    finally:
        EncodedCacheDataset.prefetch = real
    summary["decode"] = {"clips": len(paths), "audio_s": audio_s,
                         "loader_prefetch_s": sum(spent), "prefetch_calls": len(spent),
                         "batch_decode_s": batch_s, "per_item_decode_s": single_s}
    print(f"phone decode of {len(paths)} FLAC clips ({audio_s:.2f} s of audio, "
          f"{PHONE_LJ_CLIPS} at 22.05 kHz resampled): the loader's prefetch {sum(spent):.3f} s in {len(spent)} calls over the "
          f"CLI run; one batch call {batch_s:.3f} s; the per-item decode (load_audio) "
          f"{single_s:.3f} s (host clock, this machine's CPU)", flush=True)
    by_path = {f"phone_cli_{sub}": launches for sub, launches in cli_launches.items()}
    kernels = phone_ctc_batch(device, config, data_dir, os.path.join(workdir, "phone_cli_cache"),
                              ckpt)

    # align the LJSpeech corpus with that checkpoint from the fit's warm cache
    tokenizer = get_tokenizer("en", use_phone=True)
    config["data"]["init_args"]["dataset"] = "ljspeech"
    align_cfg = os.path.join(workdir, "asr_en_phone_base_ljspeech.yaml")
    with open(align_cfg, "w") as f:
        yaml.safe_dump(config, f)
    phones = [line.rstrip("\n").split("|", 1)[1] for line in open(
        os.path.join(data_dir, "ljspeech-phone-train.txt"), encoding="utf-8")]
    args = {"config": align_cfg, "checkpoint": ckpt, "data_dir": data_dir,
            "cache_dir": os.path.join(workdir, "phone_cli_cache"),
            "output": os.path.join(data_dir, "ljspeech-phone-align-train.txt"),
            "device": str(device)}
    runs, _, _ = align(device, card, workdir, args,
                       [tokenizer.decode(tokenizer(p)) for p in phones],
                       samples[:PHONE_LJ_CLIPS], runs=("warm",), settings=ASR_EN_PHONE_BASE,
                       n_tokens=lambda text: len(text.split("/")), name="asr_en_phone_base")
    by_path["phone_align"] = runs["warm"]["launches"]
    summary["align"] = runs

    for language, texts, align_spec, audio_spec in (
            ("en", PHONE_TTS_TEXTS_EN, (ALIGN_EN_PHONE_BASE, "config/align_en_phone_base.yaml"),
             (TTS_EN_PHONE_BASE, "config/tts_en_phone_base.yaml")),
            ("ja", PHONE_TTS_TEXTS_JA, (ALIGN_JA_PHONE_BASE, "config/align_ja_phone_base.yaml"),
             (TTS_JA_PHONE_BASE, "config/tts_ja_phone_base.yaml"))):
        paths = write_tts_checkpoints(workdir, align_spec, audio_spec)
        launches, shapes, tts = tts_phase(
            device, card, workdir, paths, texts, language, use_phone=True,
            label=f"phone tts {os.path.basename(align_spec[1])[:-5]} + "
                  f"{os.path.basename(audio_spec[1])[:-5]}")
        by_path[f"phone_tts_{language}"] = launches
        summary[f"tts_{language}"] = tts
        kernels.setdefault("bilstm_recurrence", {}).update(
            {f"phone_{key}_{language}": entry for key, entry in shapes.items()})

    mp3_launches, summary["mp3"] = phone_mp3(device, card, workdir)
    if mp3_launches is not None:
        by_path.update({f"phone_mp3_{sub}": launches for sub, launches in mp3_launches.items()})
    return by_path, kernels, summary


# The bf16 mixed-precision path (training/cli.py --precision 16): the bf16
# variants of kernels 1-3 against their plain twins at the three configs'
# shapes, 1 + 10 train steps of each config at bf16 beside float32, 3 bf16
# steps on the card against the CPU, and the CLI at --precision 16
BF16_SHAPES = {"asr_en_base": (TRAIN_BATCH, 501, 512, 512),
               "tts_en_base": (TTS_TRAIN_BATCH, 512, 512, 512),
               "align_en_base": (TTS_TRAIN_BATCH, 144, 256, 256),
               "align_v1": (V1_BATCH, V1_T, V1_H, V1_H)}
# card against CPU at bf16, 3 steps: the losses as the float32 rule; the
# first step's gradients within one bf16 step relative (2^-8), the size of
# a rounding that lands one step away (the conv weights' gradients are
# bf16 on both sides, and a dG or state value may round the other way)
BF16_PARITY_GRAD_TOL = 2.0 ** -8
BF16_CLI_EPOCHS = 2


class Bf16Count:
    """A wrapper's bf16 launch counter (``launches_bf16``) under the name
    ``launches``, so that the phases' counting helpers read it."""

    def __init__(self, fn):
        self.fn = fn

    @property
    def launches(self):
        return self.fn.launches_bf16

    @launches.setter
    def launches(self, value):
        self.fn.launches_bf16 = value


def bf16_counters():
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_fwd_cuda)

    return {"bilstm_recurrence_bf16": Bf16Count(bilstm_cuda),
            "bilstm_train_fwd_bf16": Bf16Count(bilstm_train_fwd_cuda),
            "bilstm_train_bwd_bf16": Bf16Count(bilstm_train_bwd_cuda)}


def bf16_excess(got, ref, f32_tol: float):
    """How far a bf16 output lies beyond one bf16 step of its twin's: the
    largest ``|got - ref| - ulp(ref)`` (a value rounded from two float32
    values within ``f32_tol`` may land one step apart, so the check is
    ``excess <= f32_tol``), and the share of elements that differ."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    excess = ((got - ref).abs() - ulp).max().item()
    return excess, (got != ref).float().mean().item()


def plain_function_grads(w_ih, w_hh, bias, x, lengths, dout):
    """The gradients of BiLSTMFunction's bf16 mode from its plain parts:
    the plain twins of kernels 2 and 3 in bf16, then the same bf16
    products with float32 results (``lstm_pallas.py:523-528, 560``)."""
    from voice100_tpu_torch.ops.lstm import (bilstm_train_bwd, bilstm_train_fwd, matmul_f32,
                                             project_inputs)

    batch, time_steps, d_in = x.shape
    xg = project_inputs(w_ih, bias, x, torch.bfloat16)
    _, h_prev, c_prev = bilstm_train_fwd(xg, w_hh, lengths)
    dg = bilstm_train_bwd(xg, w_hh, lengths, h_prev, c_prev, dout.bfloat16())
    dg2 = dg.reshape(2, batch * time_steps, -1)
    x2 = x.reshape(1, batch * time_steps, d_in).expand(2, -1, -1)
    return [matmul_f32(dg2.transpose(1, 2), x2),
            matmul_f32(dg2.transpose(1, 2), h_prev.reshape(2, batch * time_steps, -1)),
            dg2.float().sum(dim=1), matmul_f32(dg2, w_ih).sum(dim=0).reshape(x.shape)]


def launches_in_turns(launches, rounds: int = TURN_ROUNDS):
    """CUDA-event ms of one launch of each C entry of ``launches`` ({name:
    (launch, before)}, ``launch()`` returning the entry's status, ``before``
    None or run untimed first), timed in turns: ``rounds`` rounds, the order
    reversed every other round, after one untimed call of each; the median
    per name. The profiler drops cooperative launches' events, so events
    around each launch time them one by one."""
    samples = {name: [] for name in launches}
    order = list(launches)
    for r in range(rounds + 1):
        for name in (order if r % 2 == 0 else order[::-1]):
            launch, before = launches[name]
            if before is not None:
                before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            status = launch()
            end.record()
            end.synchronize()
            if status:
                fail(f"{name} returned CUDA error {status}")
            if r:
                samples[name].append(start.elapsed_time(end))
    return {name: float(np.median(s)) for name, s in samples.items()}


def check_bf16_recurrence(config, w_hh, lengths, xg, h_prev, c_prev, dout):
    """Kernel 3b's recurrence (csrc/bilstm_bwd_cluster.cuh) through the
    library's entries, so that the gate pass drops out of the comparison:
    3b's gate pass writes the float32 gates; its recurrence reads them with
    the bf16 ``c_prev`` and ``dout``; kernel 3's unchanged float32
    recurrence runs on a copy of the same gates with ``c_prev`` and
    ``dout`` widened to float32. 3b's dG must equal the bf16 rounding of
    that float32 dG bit for bit (0 differing elements), and the library's
    cluster size and shared memory must equal ``bwd_cluster_plan``'s. The
    gate pass, the recurrence and the float32 recurrence ("before": the
    design 3b replaced, on the same data) are timed in turns by CUDA events,
    launch by launch."""
    from voice100_tpu_torch.kernels.build import check
    from voice100_tpu_torch.ops.lstm_cuda import _train_lib, bwd_cluster_plan, length_order

    lib = _train_lib()
    _, batch, time_steps, gates4 = xg.shape
    hidden = gates4 // 4
    plan = bwd_cluster_plan(batch, hidden)
    library = {"cluster": lib.lstm_train_bwd_cluster_size(hidden),
               "smem_bytes": lib.lstm_train_bwd_cluster_smem_bytes(batch, hidden)}
    if any(library[k] != plan[k] for k in library):
        fail(f"kernel 3b at {config}: the library launches {library}, the wrapper plans {plan}")
    stream = torch.cuda.current_stream().cuda_stream
    lengths = lengths.to(torch.int32).contiguous()
    order = length_order(lengths)
    gates = torch.empty(xg.shape, device=xg.device)
    xchg = torch.empty(2, 2, batch, gates4, device=xg.device)
    ready = torch.empty(2 * hidden // 8, dtype=torch.int32, device=xg.device)
    dg = torch.empty(xg.shape, device=xg.device, dtype=torch.bfloat16)
    c_wide, dout_wide = c_prev.float(), dout.float()
    size = (batch, time_steps, hidden, stream)

    def gate_pass():
        return lib.lstm_train_bwd_gates_bf16(xg.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(),
                                             h_prev.data_ptr(), gates.data_ptr(), *size)

    def recurrence():
        return lib.lstm_train_bwd_recurrence_bf16(
            w_hh.data_ptr(), lengths.data_ptr(), order.data_ptr(), c_prev.data_ptr(),
            dout.data_ptr(), gates.data_ptr(), xchg.data_ptr(), ready.data_ptr(), dg.data_ptr(),
            *size)

    check(lib, gate_pass(), "lstm_train_bwd_gates_bf16")
    before_dg = gates.clone()

    def before():
        return lib.lstm_train_bwd_recurrence_f32(w_hh.data_ptr(), lengths.data_ptr(),
                                                 c_wide.data_ptr(), dout_wide.data_ptr(),
                                                 before_dg.data_ptr(), *size)

    check(lib, recurrence(), "lstm_train_bwd_recurrence_bf16")
    check(lib, before(), "lstm_train_bwd_recurrence_f32")
    torch.cuda.synchronize()
    differing = int((dg.view(torch.int16)
                     != before_dg.to(torch.bfloat16).view(torch.int16)).sum().item())
    elements = dg.numel()
    ms = launches_in_turns({"gate_pass": (gate_pass, None), "recurrence": (recurrence, None),
                            "before": (before, lambda: before_dg.copy_(gates))})
    del gates, xchg, dg, before_dg, c_wide, dout_wide
    print(f"kernel 3b recurrence at {config} ({plan['blocks']} blocks in clusters of "
          f"{plan['cluster']}, {plan['smem_bytes']} B of shared memory a block): dG differs from "
          f"the bf16 rounding of kernel 3's float32 recurrence in {differing} of {elements} "
          f"elements (must be 0); event ms gate pass {ms['gate_pass']:.4f}, recurrence "
          f"{ms['recurrence']:.4f}, the float32 recurrence before {ms['before']:.4f}",
          flush=True)
    if differing:
        fail(f"kernel 3b at {config}: dG differs from the float32 recurrence's in {differing} "
             "elements")
    return {"gate_pass_ms": ms["gate_pass"], "recurrence_ms": ms["recurrence"],
            "before_recurrence_ms": ms["before"], "cluster_size": plan["cluster"],
            "clusters": plan["clusters"], "smem_bytes": plan["smem_bytes"],
            "dg_bits_differing_from_f32_recurrence": differing}


def check_bf16_forward(config, w_ih, w_hh, bias, x, lengths):
    """Kernels 1b and 2b (csrc/bilstm_fwd_mma.cuh) through the library's
    entries, so that the projection drops out of their times: the
    library's shared memory a block must equal ``fwd_mma_plan``'s; each
    launch's ``out`` on the bf16 ``xg`` of ``bilstm_cuda`` (the float32
    projection rounded to bf16) is held to the plain twin recurrence on
    the same ``xg`` (1b within LSTM_TOL, 2b within LSTM_STATE_TOL and its
    bf16 states within one bf16 step beyond it). Timed in turns, launch by
    launch by CUDA events: 1b, 2b, "before" (the float32 kernels 1 and 2 of
    bilstm_persistent.cuh on the widened ``xg``, the template 1b and 2b ran
    on before) and the projection with its rounding. Returns the numbers
    and the launches' work (bytes, float32-accurate operations)."""
    from voice100_tpu_torch.kernels.build import check
    from voice100_tpu_torch.ops.lstm import bilstm_train_fwd, project_inputs
    from voice100_tpu_torch.ops.lstm_cuda import _lib, _train_lib, fwd_mma_plan, length_order

    bf16 = torch.bfloat16
    lib, train = _lib(), _train_lib()
    xg = project_inputs(w_ih, bias, x).to(bf16).contiguous()
    _, batch, time_steps, gates4 = xg.shape
    hidden = gates4 // 4
    plan = fwd_mma_plan(batch, hidden)
    library = {"bilstm_bf16": lib.bilstm_smem_bytes_bf16(batch, hidden),
               "lstm_train_fwd_bf16": train.lstm_train_fwd_smem_bytes_bf16(batch, hidden)}
    if any(v != plan["smem_bytes"] for v in library.values()):
        fail(f"kernels 1b/2b at {config}: the library's shared memory {library}, the wrapper "
             f"plans {plan}")
    lengths = lengths.to(torch.int32).contiguous()
    order = length_order(lengths)
    wide = xg.float()
    device = xg.device
    xchg = torch.empty(2, 2, plan["exchange_rows"], hidden, device=device)
    ready = torch.empty(2 * hidden // 8, dtype=torch.int32, device=device)
    out = torch.empty(batch, time_steps, 2 * hidden, device=device)
    states = {dtype: [torch.empty(2, batch, time_steps, hidden, device=device, dtype=dtype)
                      for _ in range(2)] for dtype in (bf16, torch.float32)}
    size = (batch, time_steps, hidden, torch.cuda.current_stream().cuda_stream)

    def pointers(src, dtype=None):
        return [src.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), order.data_ptr(),
                xchg.data_ptr(), ready.data_ptr(), out.data_ptr(),
                *[s.data_ptr() for s in states.get(dtype, [])]]

    launches = {"1b": lambda: lib.bilstm_bf16(*pointers(xg), *size),
                "1_f32": lambda: lib.bilstm_f32(*pointers(wide), *size),
                "2b": lambda: train.lstm_train_fwd_bf16(*pointers(xg, bf16), *size),
                "2_f32": lambda: train.lstm_train_fwd_f32(*pointers(wide, torch.float32), *size)}
    r_out, r_h, r_c = bilstm_train_fwd(xg, w_hh, lengths)
    check(lib, launches["1b"](), "bilstm_bf16")
    torch.cuda.synchronize()
    k1_err = (out - r_out).abs().max().item()
    check(train, launches["2b"](), "lstm_train_fwd_bf16")
    torch.cuda.synchronize()
    k2_err = (out - r_out).abs().max().item()
    h16, c16 = states[bf16]
    (h_excess, _), (c_excess, _) = (bf16_excess(h16, r_h, LSTM_STATE_TOL),
                                    bf16_excess(c16, r_c, LSTM_STATE_TOL))
    del r_out, r_h, r_c
    def projection():
        project_inputs(w_ih, bias, x).to(bf16)
        return 0

    ms = launches_in_turns({**{k: (f, None) for k, f in launches.items()},
                            "projection": (projection, None)})
    valid = int(lengths.sum().item())
    n_bytes = (2 * valid * gates4 * 2 + w_hh.numel() * 4 + batch * 4
               + batch * time_steps * 2 * hidden * 4)
    state_bytes = 2 * (2 * batch * time_steps * hidden * 2)
    ops = 2 * valid * 8 * hidden * hidden
    del xchg, out, states, wide, xg
    print(f"kernels 1b/2b launches at {config} ({plan['blocks']} blocks, {plan['smem_bytes']} B "
          f"of shared memory a block): against the twin recurrence on the same bf16 xg, 1b out "
          f"max_abs_err {k1_err:.3e} (tol {LSTM_TOL:.0e}), 2b out {k2_err:.3e}, states beyond one "
          f"bf16 step {h_excess:.3e} / {c_excess:.3e} (tol {LSTM_STATE_TOL:.0e}); event ms in "
          f"turns 1b {ms['1b']:.4f} (before: float32 kernel 1 on the widened xg "
          f"{ms['1_f32']:.4f}), 2b {ms['2b']:.4f} (before: float32 kernel 2 {ms['2_f32']:.4f}), "
          f"the projection and its rounding {ms['projection']:.4f}", flush=True)
    if not (k1_err <= LSTM_TOL and k2_err <= LSTM_STATE_TOL and h_excess <= LSTM_STATE_TOL
            and c_excess <= LSTM_STATE_TOL):
        fail(f"kernels 1b/2b at {config}: the launches disagree with the twin recurrence")
    for key in ("1b", "2b"):
        if ms[key] > ms[key[0] + "_f32"]:
            print(f"note: kernel {key} at {config} took longer than the float32 kernel it "
                  f"replaced in this run ({ms[key]:.4f} > {ms[key[0] + '_f32']:.4f} ms)",
                  flush=True)
    return {"k1": {"launch_ms": ms["1b"], "launch_before_ms": ms["1_f32"],
                   "projection_ms": ms["projection"], "launch_max_abs_err": k1_err,
                   "smem_bytes": plan["smem_bytes"]},
            "k2": {"launch_ms": ms["2b"], "launch_before_ms": ms["2_f32"],
                   "launch_max_abs_err": max(k2_err, h_excess, c_excess),
                   "smem_bytes": plan["smem_bytes"]},
            "work": {"k1": (n_bytes, ops), "k2": (n_bytes + state_bytes, ops)}}


def check_bf16_kernels(device, config, batch, time_steps, hidden, input_size):
    """The bf16 variants of kernels 1, 2 and 3 at one config's shapes
    (one layer, input ``input_size``, seeded ragged lengths with T and 1)
    against their plain twins on the card: the float32 outputs within
    LSTM_TOL / LSTM_STATE_TOL, the bf16 ones (saved states, dG) within one
    bf16 step of the twin's past the float32 tolerance, with the share of
    elements that differ; BiLSTMFunction's bf16 gradients (dG through its
    whole backward) against the same products of the plain twins' dG; 3b's
    recurrence bit for bit against kernel 3's float32 recurrence on the
    same gates (:func:`check_bf16_recurrence`, which also times the gate
    pass, the recurrence and that "before" in turns, launch by launch).
    Each variant timed in turns with its float32 variant and cuDNN's
    nn.LSTM in bf16 (the nearest library call: cuDNN rounds its own gates
    and states, it is not the same function), event and device time, and
    the plain twin; the bounds of this run's lengths."""
    from voice100_tpu_torch.models.layers import BiLSTM
    from voice100_tpu_torch.ops.lstm import (bilstm, bilstm_train_bwd, bilstm_train_fwd,
                                             project_inputs)
    from voice100_tpu_torch.ops.lstm_cuda import (bilstm_cuda, bilstm_train_bwd_cuda,
                                                  bilstm_train_cuda, bilstm_train_fwd_cuda)

    bf16 = torch.bfloat16
    lengths_np = train_lengths(np.random.default_rng(SEED + 30), time_steps, batch)
    lengths = torch.tensor(lengths_np, dtype=torch.int32, device=device)
    cpu_lengths = lengths.cpu()
    valid = int(lengths_np.sum())
    module = BiLSTM(input_size, hidden, 1, device=device)
    module.reset_parameters(torch.Generator().manual_seed(SEED + 30))
    (w_ih, w_hh, bias), = module.stacked_layers()
    gen = torch.Generator(device=device).manual_seed(SEED + 30)
    x = torch.randn(batch, time_steps, input_size, device=device, generator=gen)
    dout = torch.randn(batch, time_steps, 2 * hidden, device=device, generator=gen)
    with torch.no_grad():
        k1 = bilstm_cuda(w_ih, w_hh, bias, x, lengths, bf16)
        k1_err = (k1 - bilstm(w_ih, w_hh, bias, x, lengths, bf16)).abs().max().item()
        xg = project_inputs(w_ih, bias, x, bf16).contiguous()
        xg32 = project_inputs(w_ih, bias, x).contiguous()
        out, h_prev, c_prev = bilstm_train_fwd_cuda(xg, w_hh, lengths)
        r_out, r_h, r_c = bilstm_train_fwd(xg, w_hh, lengths)
        k2_err = (out - r_out).abs().max().item()
        (h_excess, h_share), (c_excess, c_share) = (bf16_excess(h_prev, r_h, LSTM_STATE_TOL),
                                                    bf16_excess(c_prev, r_c, LSTM_STATE_TOL))
        state_err = max((a.float() - b.float()).abs().max().item()
                        for a, b in ((h_prev, r_h), (c_prev, r_c)))
        dout16 = dout.to(bf16)
        dg = bilstm_train_bwd_cuda(xg, w_hh, lengths, r_h, r_c, dout16)
        r_dg = bilstm_train_bwd(xg, w_hh, lengths, r_h, r_c, dout16)
        dg_tol = GRAD_REL_TOL * r_dg.float().abs().max().item()
        dg_excess, dg_share = bf16_excess(dg, r_dg, dg_tol)
        dg_err = (dg.float() - r_dg.float()).abs().max().item()
        torch.cuda.synchronize()
        if not all(torch.isfinite(t.float()).all() for t in (k1, out, h_prev, c_prev, dg)):
            fail(f"bf16 kernels at {config}: non-finite outputs")
        del k1, out, h_prev, c_prev, dg, r_out, r_dg
    leaves = [t.detach().clone().requires_grad_() for t in (w_ih, w_hh, bias, x)]
    (bilstm_train_cuda(*leaves, lengths, bf16) * dout).sum().backward()
    want = plain_function_grads(w_ih, w_hh, bias, x, lengths, dout)
    grad_err = max(rel_err(t.grad, g) for t, g in zip(leaves, want))
    del want
    print(f"bf16 kernels at {config} (B={batch}, T={time_steps}, D={input_size}, H={hidden}, "
          f"{valid} valid rows) against the plain twins on the card: kernel 1 max_abs_err "
          f"{k1_err:.3e} (tol {LSTM_TOL:.0e}); kernel 2 out {k2_err:.3e} (tol "
          f"{LSTM_STATE_TOL:.0e}), bf16 h_prev / c_prev max_abs_err {state_err:.3e}, beyond "
          f"one bf16 step {h_excess:.3e} / "
          f"{c_excess:.3e} (tol {LSTM_STATE_TOL:.0e}), elements that differ {h_share:.3e} / "
          f"{c_share:.3e}; kernel 3 bf16 dG max_abs_err {dg_err:.3e}, beyond one bf16 step "
          f"{dg_excess:.3e} (tol "
          f"{dg_tol:.3e}: {GRAD_REL_TOL:.0e} of max |dG|), elements that differ {dg_share:.3e}; "
          f"BiLSTMFunction bf16 gradients rel err {grad_err:.3e} (tol {GRAD_REL_TOL:.0e})",
          flush=True)
    if not (k1_err <= LSTM_TOL and k2_err <= LSTM_STATE_TOL and h_excess <= LSTM_STATE_TOL
            and c_excess <= LSTM_STATE_TOL and dg_excess <= dg_tol and grad_err <= GRAD_REL_TOL):
        fail(f"bf16 kernels at {config} disagree with their plain twins")
    with torch.no_grad():  # on the twin's states, as the dG check above
        recurrence = check_bf16_recurrence(config, w_hh, lengths, xg, r_h, r_c, dout16)
        del r_h, r_c
        forward = check_bf16_forward(config, w_ih, w_hh, bias, x, lengths)

    lstm = torch.nn.LSTM(input_size, hidden, bidirectional=True, batch_first=True,
                         device=device)
    with torch.no_grad():
        for suffix in ("", "_reverse"):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                getattr(lstm, f"{name}_l0{suffix}").copy_(getattr(module, f"{name}_l0{suffix}"))
    lstm = lstm.to(bf16)
    lstm.flatten_parameters()
    x_lib = x.to(bf16).requires_grad_()

    def library_fwd():
        packed = torch.nn.utils.rnn.pack_padded_sequence(x_lib, cpu_lengths, batch_first=True,
                                                         enforce_sorted=False)
        return torch.nn.utils.rnn.pad_packed_sequence(lstm(packed)[0], batch_first=True,
                                                      total_length=time_steps)[0]

    try:  # the library call is a comparison, not a check
        library_fwd()
        library_error = None
    except RuntimeError as err:
        library_error = repr(err)[:200]
        print(f"cuDNN nn.LSTM in bf16 at {config} failed ({library_error}): library time not "
              f"measured", flush=True)
    with torch.no_grad():
        _, h16, c16 = bilstm_train_fwd_cuda(xg, w_hh, lengths)
        _, h32, c32 = bilstm_train_fwd_cuda(xg32, w_hh, lengths)
        k1_turns = timed_in_turns({
            "kernel": lambda: bilstm_cuda(w_ih, w_hh, bias, x, lengths, bf16),
            "f32": lambda: bilstm_cuda(w_ih, w_hh, bias, x, lengths)}, iters=2)
        k2_turns = timed_in_turns({
            "kernel": lambda: bilstm_train_fwd_cuda(xg, w_hh, lengths),
            "f32": lambda: bilstm_train_fwd_cuda(xg32, w_hh, lengths)}, iters=2)
        k3_turns = timed_in_turns({
            "kernel": lambda: bilstm_train_bwd_cuda(xg, w_hh, lengths, h16, c16, dout16),
            "f32": lambda: bilstm_train_bwd_cuda(xg32, w_hh, lengths, h32, c32, dout)},
            iters=2)
        plain = {"k1": time_ms(lambda: bilstm(w_ih, w_hh, bias, x, lengths, bf16), 1, 1),
                 "k2": time_ms(lambda: bilstm_train_fwd(xg, w_hh, lengths), 1, 1),
                 "k3": time_ms(lambda: bilstm_train_bwd(xg, w_hh, lengths, h16, c16, dout16),
                               1, 1)}
    del h16, c16, h32, c32
    not_measured = {"ms": None, "device_ms": None}
    lib_turns = {"library_fwd": not_measured, "library_bwd": not_measured}
    if library_error is None:
        y = library_fwd()
        lib_inputs = [x_lib, *lstm.parameters()]
        dout_lib = dout.to(bf16)
        lib_turns = timed_in_turns({
            "library_fwd": library_fwd,
            "library_bwd": lambda: torch.autograd.grad(y, lib_inputs, dout_lib,
                                                       retain_graph=True)}, iters=2)
        del y
    # least bytes of each function at these lengths (valid rows only, as
    # the float32 rows count them): kernel 1 as bilstm_cuda (float32 x,
    # weights and out; the projection and recurrence float32); kernel 2
    # reads bf16 xg, writes float32 out and bf16 states; kernel 3 reads bf16
    # xg, states and dout of the valid rows and writes bf16 dG
    w_bytes = w_hh.numel() * 4
    state = batch * time_steps * 2 * hidden             # elements of one [2, B, T, H]
    work = {
        "k1": ((x.numel() + 2 * 4 * hidden * (input_size + hidden + 2) + state) * 4 + batch * 4,
               2 * 2 * valid * 4 * hidden * (input_size + hidden)),
        "k2": (2 * valid * 4 * hidden * 2 + w_bytes + state * 4 + 2 * state * 2,
               2 * valid * 8 * hidden * hidden),
        "k3": (2 * valid * 7 * hidden * 2 + w_bytes + 4 * state * 2,
               2 * valid * 16 * hidden * hidden),
    }
    lines = {}
    # max_abs_err over every output, bf16 ones included (up to a bf16 step
    # of the largest values); beyond_one_bf16_step is what the check holds
    for key, turns, library, err, excess in (
            ("k1", k1_turns, lib_turns["library_fwd"], k1_err, None),
            ("k2", k2_turns, lib_turns["library_fwd"], max(k2_err, state_err),
             max(h_excess, c_excess)),
            ("k3", k3_turns, lib_turns["library_bwd"], dg_err, dg_excess)):
        bound, bound_by = bound_ms(*work[key])
        lines[key] = {"shapes": f"{config}: B={batch}, T={time_steps}, D={input_size}, "
                                f"H={hidden}, {valid} valid rows of {batch * time_steps}",
                      "max_abs_err": err, "beyond_one_bf16_step": excess,
                      "ms": turns["kernel"]["ms"],
                      "device_ms": turns["kernel"]["device_ms"],
                      "f32_ms": turns["f32"]["ms"], "f32_device_ms": turns["f32"]["device_ms"],
                      "plain_ms": plain[key], "bound_ms": bound, "bound_by": bound_by,
                      "library_ms": library["ms"], "library_device_ms": library["device_ms"],
                      "events_launches": turns["kernel"]["events_launches"]}
    # the recurrence launches alone (kernels 1b and 2b, no projection): the
    # bound of their bytes and float32 operations, and the tensor-core bound
    # of the same float32-accurate work (three bf16 products at the dense
    # bf16 rate)
    for key in ("k1", "k2"):
        n_bytes, ops = forward["work"][key]
        bound, bound_by = bound_ms(n_bytes, ops)
        lines[key].update(forward[key], launch_bound_ms=bound, launch_bound_by=bound_by,
                          launch_bound_tc_ms=max(n_bytes / HBM_BYTES_PER_S,
                                                 3 * ops / PEAK_BF16_FLOPS) * 1e3)
    lines["k2"]["state_share_differing"] = [h_share, c_share]
    lines["k3"]["dg_share_differing"] = dg_share
    lines["k3"]["function_grad_rel_err"] = grad_err
    lines["k3"].update(recurrence)
    print(f"bf16_kernels_ms {config} " + json.dumps(
        {k: {n: v for n, v in line.items() if n.endswith("ms") or n.endswith("bound_by")}
         for k, line in lines.items()}), flush=True)
    return lines


def bf16_train(device, card, name, build_model, batch, audio_s):
    """Trainer.train_step 1 + TIMED_STEPS times on ``batch`` at float32,
    then from the same weights at bf16 (the trainer's precision "16": the
    process mode and the bf16 upload of the batch's inputs, as fit runs
    them), dropout and augmentation on; the launch counts set to 0 just
    before the timed steps and read just after: at bf16 kernel 2's bf16
    variant once and kernel 3's twice a layer a step and no float32 biLSTM
    launch, at float32 the reverse. Returns the launches and timings."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task
    from voice100_tpu_torch.training.trainer import _to_bf16

    counters = {**cli_counters(), **bf16_counters()}
    out = {}
    for precision in ("32", "16"):
        model = build_model()
        trainer = Trainer(TrainerConfig(gradient_clip_val=1.0, precision=precision))
        trainer.apply_precision()
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        gen = torch.Generator(device=device).manual_seed(SEED)
        step_batch = task.upload_cast(batch, _to_bf16) if trainer._upload_bf16() else batch
        warm = float(trainer.train_step(task, state, step_batch, gen)["loss"])
        zero_counts(counters)
        losses, step_ms = [], []
        for _ in range(TIMED_STEPS):
            start = time.perf_counter()
            losses.append(float(trainer.train_step(task, state, step_batch, gen)["loss"]))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - start) * 1e3)
        launches = {k: v for k, v in read_counts(counters).items() if v}
        layers = model.lstm.num_layers
        suffix = "_bf16" if precision == "16" else ""
        want = {f"bilstm_train_fwd{suffix}": layers * TIMED_STEPS,
                f"bilstm_train_bwd{suffix}": 2 * layers * TIMED_STEPS}
        if name == "asr_en_base":
            want.update(ctc_alpha=TIMED_STEPS, ctc_adjoint=TIMED_STEPS)
        if launches != want:
            fail(f"bf16 train {name} at precision {precision}: launches over {TIMED_STEPS} "
                 f"steps {launches}, not {want}")
        if not all(np.isfinite(losses)) or not np.mean(losses[-3:]) < np.mean(losses[:3]):
            fail(f"bf16 train {name} at precision {precision}: the loss is not finite or does "
                 f"not fall: {losses}")
        median = float(np.median(step_ms))
        out[precision] = {"median_step_ms": median, "step_ms": step_ms, "audio_s": audio_s,
                          "audio_s_per_s": audio_s / (median * 1e-3),
                          "losses": [warm] + losses, "launches": launches}
        if precision == "16" and name == "asr_en_base":  # the stages of the bf16 steps
            train_stages(trainer, task, state, batch, gen, tag="bf16_train_stages_ms")
        elif precision == "16" and name == "tts_en_base":
            tts_train_stages(task, state, batch, gen, tag="bf16_tts_train_stages_ms")
    f32, b16 = out["32"], out["16"]
    print(f"bf16 train {name} on {card}: step median bf16 {b16['median_step_ms']:.2f} ms "
          f"({b16['audio_s_per_s']:.1f} audio s/s) against float32 "
          f"{f32['median_step_ms']:.2f} ms ({f32['audio_s_per_s']:.1f}), "
          f"{f32['median_step_ms'] / b16['median_step_ms']:.3f}x; losses bf16 "
          f"{[round(v, 4) for v in b16['losses']]}, float32 "
          f"{[round(v, 4) for v in f32['losses']]}; launches over {TIMED_STEPS} steps bf16 "
          f"{b16['launches']}, float32 {f32['launches']}", flush=True)
    return out


def bf16_parity(device, name, build_cpu_model, batch):
    """Three bf16 steps from the same weights on the first rows of
    ``batch``, dropout and augmentation off, on the card and on the CPU's
    plain path (the plain twins in bf16): the losses within
    PARITY_LOSS_TOL, the first step's gradients within
    BF16_PARITY_GRAD_TOL (relative norm)."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task
    from voice100_tpu_torch.training.trainer import _to_bf16

    rows = TTS_TRAIN_PARITY_ROWS if name != "asr_en_base" else PARITY_BATCH
    batch = tuple(tuple(torch.as_tensor(np.asarray(a.cpu() if torch.is_tensor(a) else a))[:rows]
                        for a in pair) for pair in batch)
    cpu_model = build_cpu_model()
    results = []
    for model, where in ((copy.deepcopy(cpu_model).to(device), device), (cpu_model, "cpu")):
        trainer = Trainer(TrainerConfig(gradient_clip_val=1.0, precision="16"))
        trainer.apply_precision()
        task = make_task(model)
        state = TrainState(model, task.make_optimizer())
        side = task.upload_cast(tuple(tuple(t.to(where) for t in pair) for pair in batch),
                                _to_bf16)
        losses, grads = [], None
        start = time.perf_counter()
        for _ in range(PARITY_STEPS):
            losses.append(float(trainer.train_step(task, state, side, train=False)["loss"]))
            if grads is None:
                grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        results.append((losses, grads, time.perf_counter() - start))
    (card_losses, card_grads, card_s), (cpu_losses, cpu_grads, cpu_s) = results
    grad_err = max(((card_grads[n] - g).norm() / g.norm()).item() for n, g in cpu_grads.items())
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
    print(f"bf16 train parity {name}, card vs CPU plain path ({rows} rows, {PARITY_STEPS} "
          f"steps at bf16, dropout and augmentation off): losses card {card_losses}, CPU "
          f"{cpu_losses}, max rel err {loss_err:.3e} (tol {PARITY_LOSS_TOL:.0e}); first-step "
          f"gradients max rel-norm err {grad_err:.3e} over {len(cpu_grads)} tensors (tol "
          f"{BF16_PARITY_GRAD_TOL:.3e}); card {card_s:.2f} s, CPU {cpu_s:.2f} s", flush=True)
    if not all(np.isfinite(card_losses)) or not loss_err <= PARITY_LOSS_TOL:
        fail(f"bf16 train parity {name}: card losses {card_losses} vs CPU {cpu_losses}")
    if not grad_err <= BF16_PARITY_GRAD_TOL:
        fail(f"bf16 train parity {name}: first-step gradients differ by {grad_err:.3e}")
    return {"loss_rel_err": loss_err, "grad_rel_err": grad_err, "card_s": card_s, "cpu_s": cpu_s}


def bf16_phase(device, card, workdir, align_args, samples, tts_data):
    """The bf16 mixed-precision path on the card: each config's train step
    at bf16 beside float32 with its exact launches, 3 bf16 steps card
    against CPU, and asr_en_base through the CLI at --precision 16 (fit
    BF16_CLI_EPOCHS epochs on the align corpus, validate, test, predict;
    the bf16 counters exact, the float32 biLSTM counters 0). Leaves the
    process at float32. Returns the launches by path and a summary."""
    from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, TextToAlignText
    from voice100_tpu_torch.ops.lstm import set_default_compute_dtype
    from voice100_tpu_torch.training import merge_world_stats

    start = time.perf_counter()
    asr_batch, asr_audio_s = train_batch(device)
    tts_batches, stat_path = tts_data["batches"], tts_data["stat_path"]
    make_model = {
        "asr_en_base": lambda where: AudioToAlignText(
            **ASR_EN_BASE, device=where, generator=torch.Generator().manual_seed(SEED + 40)),
        "tts_en_base": lambda where: merge_world_stats(AlignTextToAudio(
            **TTS_EN_BASE, device=where, generator=torch.Generator().manual_seed(SEED + 41)),
            stat_path),
        "align_en_base": lambda where: TextToAlignText(
            **ALIGN_EN_BASE, device=where, generator=torch.Generator().manual_seed(SEED + 42)),
    }
    batches = {"asr_en_base": (asr_batch, asr_audio_s),
               "tts_en_base": (tts_batches["audio"],
                               batch_audio_seconds("audio", tts_batches["audio"])),
               "align_en_base": (tts_batches["align"],
                                 batch_audio_seconds("align", tts_batches["align"]))}
    steps, parity, by_path = {}, {}, {}
    try:
        for name, build in make_model.items():
            batch, audio_s = batches[name]
            steps[name] = bf16_train(device, card, name, lambda: build(device), batch, audio_s)
            by_path[f"bf16_train_{name}"] = steps[name]["16"]["launches"]
            parity[name] = bf16_parity(device, name, lambda: build("cpu"), batch)
        cli_launches, _ = cli_phase(device, card, workdir, align_args, samples,
                                    epochs=BF16_CLI_EPOCHS, tag="bf16_cli", precision="16")
        by_path.update({f"bf16_cli_{sub}": {k: v for k, v in launches.items() if v}
                        for sub, launches in cli_launches.items()})
    finally:
        set_default_compute_dtype(None)
    summary = {"wall_s": time.perf_counter() - start, "parity": parity,
               "steps": {name: {p: {k: r[k] for k in ("median_step_ms", "audio_s",
                                                       "audio_s_per_s")}
                                for p, r in runs.items()} for name, runs in steps.items()}}
    return by_path, summary


def bf16_kernel_lines(kernels, by_path):
    """The kernel lines of the bf16 variants: the numbers at asr_en_base's
    shapes, the other configs' under their names; launches from the
    asr_en_base bf16 train steps (kernels 2 and 3) and the CLI's validate
    at --precision 16 (kernel 1), every path's beside them."""
    entries = []
    for key, name, source, line, counter, path in (
            ("k1", "bilstm_recurrence_bf16", "voice100_tpu_torch/csrc/bilstm_fwd_mma.cuh",
             "voice100_tpu/ops/lstm_pallas.py:41", "bilstm_recurrence_bf16", "bf16_cli_validate"),
            ("k2", "bilstm_train_fwd_bf16", "voice100_tpu_torch/csrc/bilstm_fwd_mma.cuh",
             "voice100_tpu/ops/lstm_pallas.py:232", "bilstm_train_fwd_bf16",
             "bf16_train_asr_en_base"),
            ("k3", "bilstm_train_bwd_bf16", "voice100_tpu_torch/csrc/bilstm_train.cu",
             "voice100_tpu/ops/lstm_pallas.py:267", "bilstm_train_bwd_bf16",
             "bf16_train_asr_en_base")):
        main_line = dict(kernels["asr_en_base"][key])
        entry = {"name": name, "route": "cuda", "source": source, "replaces": line,
                 "launches": by_path[path].get(counter, 0)}
        entry.update(main_line)
        entry["library"] = ("cuDNN nn.LSTM in bf16, packed (the nearest library call, not the "
                            "same function)")
        entry["launches_by_path"] = {p: c[counter] for p, c in by_path.items() if counter in c}
        for config in ("tts_en_base", "align_en_base", "align_v1"):
            entry[config] = kernels[config][key]
        entries.append(entry)
    return entries


# CTC prefix beam search in serving: asr_en_base on the serve phase's clips
BEAM_SIZE = 8


def serve_beam(device, card, workdir, data_dir):
    """The serve phase's model and 16 clips through ASRPipeline with a
    beam of BEAM_SIZE: the device beam (every symbol a frame, topk = V - 1)
    against the host beam on the card's own log-probs, then both fused with
    a trigram LM that tools/train_lm fits on the align corpus's texts; the
    launch counts of one device-beam call set to 0 just before and read
    just after (kernel 8 once a batch, kernel 1 once a layer a batch); the
    wall time of each transcribe against greedy, and the card time of the
    batched beam alone on one batch. Returns the launches and a summary."""
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.ops.ctc_beam_device import ctc_prefix_beam_search_batched
    from voice100_tpu_torch.text.ngram import CharNgramLM
    from voice100_tpu_torch.tools.train_lm import cli_main as train_lm

    model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    clips = int16_clips(rng, rng.uniform(2.0, 10.0, size=16))
    vocab = ASR_EN_BASE["vocab_size"]
    lm_path = os.path.join(workdir, "lm_dummy_en.npz")
    train_lm(["--text", os.path.join(data_dir, "dummy_en-train.txt"), "--language", "en",
              "--output", lm_path])
    lm = CharNgramLM.load(lm_path)
    beam = dict(batch_size=BATCH, device=device, beam_size=BEAM_SIZE)
    pipes = {"greedy": ASRPipeline(model, batch_size=BATCH, device=device),
             "beam_device": ASRPipeline(model, beam_topk=vocab - 1, **beam),
             "beam_device_topk8": ASRPipeline(model, beam_topk=8, **beam),
             "beam_host": ASRPipeline(model, beam_device=False, **beam),
             "lm_device": ASRPipeline(model, beam_topk=vocab - 1, lm=lm_path, **beam),
             "lm_host": ASRPipeline(model, beam_device=False, lm=lm_path, **beam)}
    for name, pipe in pipes.items():  # warm-up: constants, cuDNN plans
        if "host" not in name:
            pipe.transcribe(clips[:BATCH])
    counters = align_counters()
    zero_counts(counters)
    texts = pipes["beam_device"].transcribe(clips)
    launches = {k: v for k, v in read_counts(counters).items() if v}
    n_batches = sum(1 for _ in pipes["greedy"].batches(clips))
    want = {"log_mel": n_batches,
            "bilstm_recurrence": ASR_EN_BASE["decoder_num_layers"] * n_batches}
    if launches != want:
        fail(f"serve beam: launches {launches}, not {want}")
    wall, out = {}, {}
    for name, pipe in pipes.items():
        torch.cuda.synchronize()
        start = time.perf_counter()
        out[name] = pipe.transcribe(clips)
        torch.cuda.synchronize()
        wall[name] = time.perf_counter() - start
    if out["beam_device"] != texts:
        fail("serve beam: two device-beam calls gave different transcripts")
    for dev_name, host_name in (("beam_device", "beam_host"), ("lm_device", "lm_host")):
        same = sum(a == b for a, b in zip(out[dev_name], out[host_name]))
        if same != len(clips):
            fail(f"serve beam: {dev_name} equals {host_name} on {same}/{len(clips)} clips")
    _, wav, lens = next(iter(pipes["greedy"].batches(clips)))
    log_probs, out_len = pipes["greedy"].log_probs(wav, lens)
    table = torch.from_numpy(lm.table).to(device)
    beam_ms = {f"topk{topk}{'_lm' if fused else ''}": time_ms(
        lambda topk=topk, fused=fused: ctc_prefix_beam_search_batched(
            log_probs, out_len, beam_size=BEAM_SIZE, topk=topk,
            lm_table=table if fused else None), iters=3, warmup=1)
        for topk, fused in ((vocab - 1, False), (8, False), (vocab - 1, True))}
    differ = sum(a != b for a, b in zip(out["beam_device"], out["greedy"]))
    audio_sec = sum(len(c) for c in clips) / SAMPLE_RATE
    print(f"serve beam asr_en_base on {card}: {len(clips)} clips, {audio_sec:.2f} s of audio, "
          f"batch {BATCH}, beam {BEAM_SIZE}: device beam (topk {vocab - 1}) equals the host beam "
          f"on all {len(clips)} clips, fused with the trigram LM of tools/train_lm on the "
          f"corpus texts ({lm.vocab_size} symbols) too; {differ} transcripts differ from "
          f"greedy; transcribe wall ms " + json.dumps({k: round(v * 1e3, 2)
                                                       for k, v in wall.items()})
          + f"; batched beam alone on one batch ({tuple(log_probs.shape)}) card ms "
          + json.dumps({k: round(v, 3) for k, v in beam_ms.items()})
          + f"; launches {launches}", flush=True)
    return launches, {"transcribe_wall_s": wall, "beam_batch_ms": beam_ms,
                      "audio_s": audio_sec, "differ_from_greedy": differ}


# Long-form serving: the HTTP daemon on the card under concurrent ASR and
# TTS clients (long clips streamed), a live streaming session, and a fit
# with profile_dir
SERVER_CLIENTS = 16
SERVER_LONG_SECONDS = (60.0, 150.0)  # past the 40 s bucket: streamed
SERVER_RAW_RATE = 22050              # the float32 body's rate, resampled by the server
SERVER_RAW_SECONDS = 6.0
SERVER_TTS_TEXTS = 8
SERVER_TIMEOUT_S = 120.0             # a request's; a timeout fails the phase
STREAM_LIVE_SECONDS = 60.0
STREAM_FEED_SECONDS = 0.5
STREAM_B1_SECONDS = 40.0             # a streaming window at the largest bucket: T' = 2001
PROFILE_FIT_BATCH = 32
PROFILE_FIT_EPOCHS = 2


def near_max_ids(logits, n):
    """The frame-wise argmax of ``logits [T, V]`` over its first ``n``
    frames, and each frame's ids whose logits lie within 2 LOGIT_TOL of
    its maximum: where the card's logits are within LOGIT_TOL of these,
    its argmax is one of them (the serving margin rule)."""
    logits = logits[:n].float()
    near = logits >= logits.max(-1, keepdim=True).values - 2 * LOGIT_TOL
    return logits.argmax(-1).numpy(), [np.flatnonzero(row).tolist() for row in near.numpy()]


def transcript_reachable(choices, text, tokenizer) -> bool:
    """Whether one id a frame, each from that frame's ``choices``, gives
    ``text`` through the tokenizer's decode and CTC merge (a run of one
    character collapses, blanks drop, a transcript of one space reads as
    empty): the margin rule on transcripts."""
    char = [tokenizer.decode([i]) for i in range(tokenizer.vocab_size)]
    for target in [text] + ([" "] if text == "" else []):
        states = {(0, None)}  # (characters of target given, the last frame's character)
        for frame in choices:
            states = {(j + (char[i] != prev and char[i] != char[0]), char[i])
                      for j, prev in states for i in frame
                      if char[i] == prev or char[i] == char[0]
                      or (j < len(target) and target[j] == char[i])}
            if not states:
                break
        if any(j == len(target) for j, _ in states):
            return True
    return False


def streamed_choices(pipe, wav, rows: int = BATCH):
    """Stream ``wav`` through the CPU pipeline ``pipe`` with the contexts
    ASRPipeline.transcribe gives a long clip, and return the transcript
    and, for each committed frame, :func:`near_max_ids`' choices. The
    session commits placeholder ids (a window's index and frame); the
    windows are then decoded ``rows`` at a time (the plain path is
    row-independent) and the placeholders read back."""
    from voice100_tpu_torch.inference import StreamingASRSession
    from voice100_tpu_torch.models.layers import conv_stack_output_length

    windows = []
    stride = 1 << 20  # placeholder id = window * stride + frame

    def record(wav, wav_len):
        n = conv_stack_output_length(pipe.model.encoder_settings, wav_len // 160 + 1)
        windows.append((wav[0], int(wav_len[0]), int(n[0])))
        return (torch.arange(int(n[0]))[None] + (len(windows) - 1) * stride), n

    pipe._greedy = record
    try:
        bucket_sec = pipe.buckets[-1] / pipe.sample_rate
        session = StreamingASRSession(pipe, chunk_sec=bucket_sec / 4,
                                      right_context_sec=bucket_sec / 8,
                                      left_context_sec=bucket_sec / 4)
        for begin in range(0, len(wav), pipe.buckets[0]):
            session.feed(wav[begin:begin + pipe.buckets[0]])
        session.finish()
    finally:
        del pipe._greedy
    decoded = {}
    for length in sorted({len(w) for w, _, _ in windows}):
        same = [i for i, (w, _, _) in enumerate(windows) if len(w) == length]
        for begin in range(0, len(same), rows):
            part = same[begin:begin + rows]
            logits, n = pipe.logits(torch.stack([windows[i][0] for i in part]),
                                    torch.tensor([windows[i][1] for i in part], dtype=torch.int32))
            for row, i in enumerate(part):
                decoded[i] = near_max_ids(logits[row], int(n[row]))
    ids = [int(decoded[p // stride][0][p % stride]) for p in session._committed_ids]
    choices = [decoded[p // stride][1][p % stride] for p in session._committed_ids]
    tok = pipe.tokenizer
    return tok.merge_repeated(tok.decode(ids)), choices


def http_request(port, method, path, body=None, headers=None):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=SERVER_TIMEOUT_S)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


def percentiles(values):
    return {"p50": float(np.percentile(values, 50)), "p95": float(np.percentile(values, 95)),
            "n": len(values)}


def server_requests(device, asr, tts):
    """The phase's requests in the interleaved order the clients send
    them: the serve phase's 16 int16 clips as WAV, one float32 body at
    SERVER_RAW_RATE, the long clips as WAV, SERVER_TTS_TEXTS texts.
    Returns the requests, the waveforms the server decodes from the ASR
    bodies, and the texts."""
    from voice100_tpu_torch.dsp.resample import resample
    from voice100_tpu_torch.dsp.wav import write_wav_bytes

    rng = np.random.default_rng(SEED)
    clips = int16_clips(rng, rng.uniform(2.0, 10.0, size=16))
    rng = np.random.default_rng(SEED + 40)
    raw = (rng.standard_normal(int(SERVER_RAW_SECONDS * SERVER_RAW_RATE)) * 0.1).astype(np.float32)
    longs = int16_clips(rng, SERVER_LONG_SECONDS)
    bodies = ([(write_wav_bytes(c, SAMPLE_RATE), {}) for c in clips]
              + [(raw.tobytes(), {"X-Raw-Sample-Rate": str(SERVER_RAW_RATE)})]
              + [(write_wav_bytes(c, SAMPLE_RATE), {}) for c in longs])
    waves = clips + [resample(raw, SERVER_RAW_RATE, SAMPLE_RATE)] + longs
    texts = TTS_TEXTS[:SERVER_TTS_TEXTS]
    order = list(range(16))
    order[3:3] = [17]       # the 60 s clip early
    order[10:10] = [16, 18]  # the float32 body, then the 150 s clip
    requests = []
    for k, i in enumerate(order):
        requests.append(("/transcribe", i, *bodies[i]))
        if k % 2 == 1 and k // 2 < len(texts):
            requests.append(("/synthesize", k // 2, json.dumps({"text": texts[k // 2]}).encode(),
                             {"Content-Type": "application/json"}))
    return requests, waves, texts


def server_phase(device, card, workdir):
    """SpeechServer on the card (asr_en_base, align_en_base + tts_en_base,
    seeded random weights; 127.0.0.1, port 0, batch_window_ms 10) under
    SERVER_CLIENTS concurrent clients: every transcript held to the same
    pipeline's direct transcribe([clip]) on the card and to the CPU
    pipeline under the margin rule (:func:`transcript_reachable`), the
    long clips' sessions committing every frame, each WAV of the direct
    call's sample count, /healthz, exact launches (per streaming window
    kernel 8 once and kernel 1 twice, per ASR device batch the same, per
    TTS batch kernel 1 four times), a micro-batch of more than one
    request. Then a live session on a STREAM_LIVE_SECONDS clip in
    STREAM_FEED_SECONDS feeds at its default contexts. Returns the launches
    by path and a summary."""
    import concurrent.futures as cf

    from voice100_tpu_torch.dsp.wav import parse_wav
    from voice100_tpu_torch.inference import ASRPipeline, StreamingASRSession, TTSPipeline
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.server import SpeechServer
    from voice100_tpu_torch.training.cli import load_model

    phase_start = time.perf_counter()
    model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    cpu_pipe = ASRPipeline(model, batch_size=BATCH, device="cpu")
    asr = ASRPipeline(copy.deepcopy(model), batch_size=BATCH, device=device)
    paths = write_tts_checkpoints(workdir)
    tts = TTSPipeline(load_model(*paths["align"], device=device),
                      load_model(*paths["audio"], device=device), use_phone=False, device=device)
    requests, waves, texts = server_requests(device, asr, tts)
    tokenizer = asr.tokenizer

    # the direct calls, one request each (they warm the shapes up too), then
    # the long clips timed again
    direct = [asr.transcribe([w])[0] for w in waves]
    tts.synthesize(texts)
    direct_samples = [len(tts.synthesize([t])[0]) for t in texts]
    long_rtf = {}
    for w in waves:
        if len(w) > asr.buckets[-1]:
            torch.cuda.synchronize()
            start = time.perf_counter()
            asr.transcribe([w])
            long_rtf[f"{len(w) / SAMPLE_RATE:g}s"] = len(w) / SAMPLE_RATE / (
                time.perf_counter() - start)

    # the device batches and streamed windows of the run, for its launches
    calls = {"/transcribe": [], "/synthesize": []}
    transcribe, synthesize = asr.transcribe, tts.synthesize
    asr.transcribe = lambda ws: calls["/transcribe"].append([len(w) for w in ws]) or transcribe(ws)
    tts.synthesize = lambda ts: calls["/synthesize"].append(len(ts)) or synthesize(ts)
    server = SpeechServer(asr, tts, host="127.0.0.1", port=0, batch_window_ms=10.0)
    port = server.start()
    wrappers = {w for ws in counted_kernels().values() for w in ws}
    try:
        status, _, body = http_request(port, "GET", "/healthz")
        if status != 200 or json.loads(body) != {"status": "ok", "models": ["asr", "tts"]}:
            fail(f"server: /healthz answered {status} {body!r}")
        streamed_before = len(asr.streamed)

        def send(request):
            path, _, payload, headers = request
            start = time.perf_counter()
            out = http_request(port, "POST", path, payload, headers)
            return out, time.perf_counter() - start

        torch.cuda.synchronize()
        for w in wrappers:
            w.launches = 0
        start = time.perf_counter()
        with cf.ThreadPoolExecutor(SERVER_CLIENTS) as pool:
            futures = [pool.submit(send, r) for r in requests]
            done, _ = cf.wait(futures, timeout=2 * SERVER_TIMEOUT_S)
        wall = time.perf_counter() - start
        torch.cuda.synchronize()
        launches = {w.__name__: w.launches for w in wrappers if w.launches}
        for request, future in zip(requests, futures):
            if future not in done or future.exception() is not None:
                fail(f"server: {request[0]} request {request[1]} did not answer: "
                     f"{future.exception() if future in done else 'timed out'}")
        streamed = list(asr.streamed)[streamed_before:]
        batch_sizes = {"/transcribe": list(server.asr_batcher.batch_sizes),
                       "/synthesize": list(server.tts_batcher.batch_sizes)}
    finally:
        server.stop()
        del asr.transcribe, tts.synthesize
    results = [f.result() for f in futures]

    # the answers
    latency = {"/transcribe": [], "/synthesize": []}
    got_text = {}
    for (path, i, _, _), ((status, ctype, data), seconds) in zip(requests, results):
        latency[path].append(seconds * 1e3)
        if status != 200:
            fail(f"server: {path} request {i} answered {status}: {data[:200]!r}")
        if path == "/transcribe":
            got_text[i] = json.loads(data)["text"]
            continue
        samples, rate = parse_wav(data)
        if ctype != "audio/wav" or rate != SAMPLE_RATE or samples.shape[1] != direct_samples[i]:
            fail(f"server: /synthesize of text {i} gave {samples.shape[1]} samples at {rate} Hz "
                 f"({ctype}), the direct call {direct_samples[i]}")

    # launches: each streamed window and each ASR device batch kernel 8 once
    # and kernel 1 once a layer; each TTS batch kernel 1 once a layer of both
    # models; nothing else
    windows = sum(r["windows"] for r in streamed)
    asr_batches = sum(-(-sum(n <= asr.buckets[-1] for n in call) // BATCH)
                      for call in calls["/transcribe"])
    layers = ASR_EN_BASE["decoder_num_layers"]
    tts_layers = ALIGN_EN_BASE["num_layers"] + TTS_EN_BASE["encoder_num_layers"]
    want = {"log_mel_spectrogram_cuda": windows + asr_batches,
            "bilstm_cuda": layers * (windows + asr_batches)
            + tts_layers * len(calls["/synthesize"])}
    if launches != want:
        fail(f"server: launches {launches}, not {want} ({windows} streamed windows, "
             f"{asr_batches} ASR batches, {len(calls['/synthesize'])} TTS batches)")
    long_lengths = sorted(len(w) for w in waves if len(w) > asr.buckets[-1])
    if sorted(r["samples"] for r in streamed) != long_lengths or any(
            r["committed_frame"] < r["samples"] // 320 for r in streamed):
        fail(f"server: the long clips' sessions {streamed} did not commit every frame of "
             f"{long_lengths} samples")
    if max(batch_sizes["/transcribe"] + batch_sizes["/synthesize"]) < 2:
        fail(f"server: no micro-batch held more than one request: {batch_sizes}")

    # the margin rule against the CPU pipeline (the same weights)
    cpu_start = time.perf_counter()
    cpu_text, choices = {}, {}
    short = [i for i, w in enumerate(waves) if len(w) <= cpu_pipe.buckets[-1]]
    for chunk, wav, lens in cpu_pipe.batches([waves[i] for i in short]):
        logits, n = cpu_pipe.logits(wav, lens)
        for row, j in enumerate(chunk):
            ids, choices[short[j]] = near_max_ids(logits[row], int(n[row]))
            cpu_text[short[j]] = tokenizer.merge_repeated(tokenizer.decode(ids))
    committed = {r["samples"]: r["committed_frame"] for r in streamed}
    for i, w in enumerate(waves):
        if i not in choices:
            cpu_text[i], choices[i] = streamed_choices(cpu_pipe, w)
            if len(choices[i]) != committed[len(w)]:
                fail(f"server: the CPU session of clip {i} committed {len(choices[i])} frames, "
                     f"the card's {committed[len(w)]}")
    cpu_s = time.perf_counter() - cpu_start
    for i in range(len(waves)):
        for name, text in (("server", got_text[i]), ("direct", direct[i])):
            if not transcript_reachable(choices[i], text, tokenizer):
                fail(f"server: the {name} transcript of clip {i} ({len(waves[i])} samples) is "
                     f"not one the CPU logits give under the {2 * LOGIT_TOL:.0e} margin rule: "
                     f"{text!r} against the CPU's {cpu_text[i]!r}")
    ambiguous = sum(sum(len(c) > 1 for c in choices[i]) for i in choices)
    frames = sum(len(choices[i]) for i in choices)
    same = {"server_direct": sum(got_text[i] == direct[i] for i in got_text),
            "server_cpu": sum(got_text[i] == cpu_text[i] for i in got_text)}

    # a live session at its default contexts, fed in STREAM_FEED_SECONDS pieces
    live = int16_clips(np.random.default_rng(SEED + 41), [STREAM_LIVE_SECONDS])[0]
    step = int(STREAM_FEED_SECONDS * SAMPLE_RATE)
    warm = StreamingASRSession(asr)
    for begin in range(0, 6 * step, step):
        warm.feed(live[begin:begin + step])
    session = StreamingASRSession(asr)
    counters = align_counters()
    zero_counts(counters)
    feed_ms, partial = [], ""
    live_start = time.perf_counter()
    for begin in range(0, len(live), step):
        before = session.windows
        start = time.perf_counter()
        text = session.feed(live[begin:begin + step])
        if session.windows > before:
            feed_ms.append((time.perf_counter() - start) * 1e3)
        if not text.startswith(partial):
            fail(f"stream: the transcript {text!r} does not extend {partial!r}")
        partial = text
    final = session.finish()
    live_wall = time.perf_counter() - live_start
    stream_launches = {k: v for k, v in read_counts(counters).items() if v}
    want = {"log_mel": session.windows, "bilstm_recurrence": layers * session.windows}
    if stream_launches != want or not final.startswith(partial):
        fail(f"stream: launches {stream_launches}, not {want}, or a final transcript that does "
             f"not extend the last partial one")
    if session._committed_frame < len(live) // 320:
        fail(f"stream: {session._committed_frame} frames committed of {len(live) // 320}")

    rps = len(requests) / wall
    lat = {path: percentiles(v) for path, v in latency.items()}
    print(f"server on {card}: {len(requests)} requests from {SERVER_CLIENTS} clients "
          f"({len(waves)} /transcribe: 16 WAV clips of 2-10 s, one float32 body at "
          f"{SERVER_RAW_RATE} Hz, WAVs of {SERVER_LONG_SECONDS} s streamed; {len(texts)} "
          f"/synthesize) in {wall:.3f} s, {rps:.2f} requests/s; latency ms "
          + json.dumps({p: {k: round(v, 2) for k, v in q.items()} for p, q in lat.items()})
          + f"; batch sizes {batch_sizes}; launches {launches} ({windows} streamed windows, "
          f"{asr_batches} ASR device batches, {len(calls['/synthesize'])} TTS batches)",
          flush=True)
    print(f"server transcripts on {card}: all {len(waves)} reachable from the CPU logits under "
          f"the {2 * LOGIT_TOL:.0e} margin rule ({ambiguous} of {frames} frames ambiguous), the "
          f"direct calls' too; equal to the direct call's {same['server_direct']}/{len(waves)}, "
          f"to the CPU's {same['server_cpu']}/{len(waves)}; every WAV the direct call's sample "
          f"count; long clips' sessions {streamed}; CPU reference {cpu_s:.2f} s", flush=True)
    print(f"stream on {card}: long-form transcribe RTF "
          + json.dumps({k: round(v, 2) for k, v in long_rtf.items()})
          + f"; a live session, {STREAM_LIVE_SECONDS:g} s in {STREAM_FEED_SECONDS:g} s feeds at "
          f"the default contexts: {session.windows} windows, per-feed decode ms "
          + json.dumps({k: round(v, 3) for k, v in percentiles(feed_ms).items()})
          + f", {live_wall:.3f} s in all; launches {stream_launches}", flush=True)
    summary = {"wall_s": time.perf_counter() - phase_start, "requests": len(requests),
               "requests_per_s": rps, "latency_ms": lat, "batch_sizes": batch_sizes,
               "streamed": streamed, "long_rtf": long_rtf, "feed_decode_ms": percentiles(feed_ms),
               "live_windows": session.windows, "equal": same, "ambiguous_frames": ambiguous,
               "frames": frames, "cpu_reference_s": cpu_s}
    by_path = {"server": {"log_mel": launches.get("log_mel_spectrogram_cuda", 0),
                          "bilstm_recurrence": launches.get("bilstm_cuda", 0)},
               "stream": stream_launches}
    return by_path, summary


def profile_fit(device, card, workdir, align_args):
    """asr_en_base through the training CLI with ``trainer.profile_dir``:
    PROFILE_FIT_EPOCHS epochs of the align corpus at batch
    PROFILE_FIT_BATCH from its warm cache (launches exact, kernel 8
    never). The trace file must exist, parse as JSON (closed) and be
    logged once; where it holds an event for every launch of the port's
    kernels in the traced window, the card's busy share of that window
    (training steps 2-4 and the epoch tail between them) is printed, else
    "not measured". Returns the launches and a summary."""
    import contextlib

    import yaml
    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.training import trainer as trainer_module
    from voice100_tpu_torch.training.cli import load_config, main

    prof_dir = os.path.join(workdir, "profile")
    config = load_config(align_args["config"])
    config["trainer"].update(max_epochs=PROFILE_FIT_EPOCHS, profile_dir=prof_dir)
    cfg = os.path.join(workdir, "profile_fit.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    log = os.path.join(workdir, "profile_log.jsonl")
    kernels = counted_kernels()
    window = {}
    real_trace = trainer_module.trace

    @contextlib.contextmanager
    def counted_trace(log_dir, device=None):
        # the launches of the traced window, by kernel name as on the card
        before = {part: sum(launches_of(w) for w in ws) for part, ws in kernels.items()}
        with real_trace(log_dir, device) as prof:
            yield prof
        window.update({part: sum(launches_of(w) for w in ws) - before[part]
                       for part, ws in kernels.items()})

    counters = cli_counters()
    zero_counts(counters)
    trainer_module.trace = counted_trace
    start = time.perf_counter()
    try:
        main(["fit", "--config", cfg, "--data_dir", align_args["data_dir"],
              "--cache_dir", align_args["cache_dir"], "--batch_size", str(PROFILE_FIT_BATCH),
              "--checkpoint_dir", os.path.join(workdir, "profile_ckpt"), "--log_path", log,
              "--device", str(device)])
    finally:
        trainer_module.trace = real_trace
    wall = time.perf_counter() - start
    launches = read_counts(counters)
    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=align_args["data_dir"],
                               cache_dir=align_args["cache_dir"], batch_size=PROFILE_FIT_BATCH,
                               device=device)
    data.setup("fit")
    layers = ASR_EN_BASE["decoder_num_layers"]
    steps = PROFILE_FIT_EPOCHS * -(-len(data.train_ds) // PROFILE_FIT_BATCH)
    evals = PROFILE_FIT_EPOCHS * -(-len(data.valid_ds) // PROFILE_FIT_BATCH)
    want = {"log_mel": 0, "bilstm_recurrence": 2 * layers * evals, "viterbi_align": 0,
            "bilstm_train_fwd": layers * steps, "bilstm_train_bwd": 2 * layers * steps,
            "ctc_alpha": steps + evals, "ctc_adjoint": steps}
    if launches != want:
        fail(f"profile fit: launches {launches}, not {want}")
    with open(log) as f:
        records = [json.loads(line) for line in f]
    written = [r for r in records if r.get("event") == "profile_written"]
    files = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    if written != [{"event": "profile_written", "dir": prof_dir}] or len(files) != 1 or steps < 5:
        fail(f"profile fit: records {written}, trace files {files} ({steps} steps)")
    path = os.path.join(prof_dir, files[0])
    try:
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    except ValueError as err:
        fail(f"profile fit: the trace {path} is not closed JSON: {err}")
    on_card = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    counted = {part: [sum(kernel_named(part, e["name"]) for e in on_card
                          if e.get("cat") == "kernel"),
                      window.get(part, 0)] for part in kernels}
    counted = {part: c for part, c in counted.items() if any(c)}
    busy = None
    if on_card and all(a == b for a, b in counted.values()):
        begin = min(e["ts"] for e in events)
        end = max(e["ts"] + e.get("dur", 0) for e in events)
        covered, reach = 0.0, begin
        for e in sorted(on_card, key=lambda e: e["ts"]):
            lo, hi = max(e["ts"], reach), e["ts"] + e.get("dur", 0)
            if hi > lo:
                covered, reach = covered + hi - lo, hi
        busy = covered / (end - begin)
    print(f"profile fit on {card}: asr_en_base {PROFILE_FIT_EPOCHS} epochs at batch "
          f"{PROFILE_FIT_BATCH} ({steps} steps) through the CLI with trainer.profile_dir in "
          f"{wall:.2f} s; trace {files[0]} ({os.path.getsize(path)} bytes, closed JSON, "
          f"{len(on_card)} card events); kernel [events, launches] in the traced window "
          f"{counted}; card busy share of the traced window (steps 2-4 and the epoch tail) "
          f"{'not measured' if busy is None else f'{busy:.4f}'}; launches {launches}",
          flush=True)
    return launches, {"wall_s": wall, "trace_bytes": os.path.getsize(path),
                      "events_launches": counted, "busy_share": busy}


# The training data shell: asr_en_base through the training CLI on the
# align corpus with the loader's worker pool, the device feature cache and
# multi-step dispatch
DATA_SHELL_BATCH = 16
DATA_SHELL_WORKERS = 4
DATA_SHELL_STEPS = 4         # steps_per_dispatch
DATA_SHELL_EPOCHS = 3
# one collate bucket for the corpus's clips (<= 10 s) and texts (<= 150
# characters): an epoch's 8 batches form one plan group, so the dispatch
# runs full chunks of DATA_SHELL_STEPS
DATA_SHELL_BUCKETS = {"VOICE100_TPU_TIME_BUCKET": "1024", "VOICE100_TPU_TEXT_BUCKET": "160"}
# a chunked run against a per-step run: the same ops on the same bytes in
# the same order, apart from cuDNN's and cuBLAS's own non-determinism
DATA_SHELL_LOSS_REL_TOL = 1e-4
WORLD_POOL_CLIPS = 48


def data_shell_fit(device, workdir, align_args, tag, steps_per_dispatch):
    """``fit`` of asr_en_base through the training CLI on the align corpus
    from a cold feature cache: DATA_SHELL_WORKERS loader workers, the
    device cache, ``steps_per_dispatch``; the launch counts set to 0 just
    before and read just after. Returns (log records, launches, wall
    seconds, the feature cache's directory)."""
    import yaml
    from voice100_tpu_torch.training.cli import load_config, main

    config = load_config(align_args["config"])
    config["trainer"].update(max_epochs=DATA_SHELL_EPOCHS, log_every_n_steps=1,
                             device_cache=True, steps_per_dispatch=steps_per_dispatch)
    config["data"]["init_args"].update(num_workers=DATA_SHELL_WORKERS,
                                       batch_size=DATA_SHELL_BATCH)
    cfg = os.path.join(workdir, f"{tag}.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)
    cache, log = os.path.join(workdir, f"{tag}_cache"), os.path.join(workdir, f"{tag}.jsonl")
    counters = cli_counters()
    zero_counts(counters)
    start = time.perf_counter()
    main(["fit", "--config", cfg, "--data_dir", align_args["data_dir"], "--cache_dir", cache,
          "--checkpoint_dir", os.path.join(workdir, f"{tag}_ckpt"), "--log_path", log,
          "--device", str(device)])
    launches = read_counts(counters)
    wall = time.perf_counter() - start
    with open(log) as f:
        records = [json.loads(line) for line in f]
    return records, launches, wall, cache


def dispatch_syncs(device, align_args, cache_dir):
    """One chunk of DATA_SHELL_STEPS steps (``Trainer.dispatch_chunk``,
    after a warm-up chunk) under ``torch.cuda.set_sync_debug_mode("warn")``:
    the synchronising calls it made, by the innermost line of the
    repository on their stack, its host enqueue time and its wall time to a
    synchronize. The cache is filled by a one-epoch fit from the warm
    feature cache."""
    import warnings
    from collections import Counter

    from voice100_tpu_torch.data import AudioTextDataModule
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.training import Trainer, TrainerConfig, make_task

    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en",
                               data_dir=align_args["data_dir"], cache_dir=cache_dir,
                               batch_size=DATA_SHELL_BATCH, device=device)
    model = AudioToAlignText(**ASR_EN_BASE, device=device,
                             generator=torch.Generator().manual_seed(SEED + 50))
    trainer = Trainer(TrainerConfig(max_epochs=1, device_cache=True,
                                    steps_per_dispatch=DATA_SHELL_STEPS, log_every_n_steps=100))
    state = trainer.fit(model, data)
    trainer.close()
    cache, loader = trainer.feature_cache, data.train_dataloader()
    loader.set_epoch(1)
    plan = cache.epoch_plan(loader)
    if plan is None or len(plan) != 1:
        fail(f"data shell: the epoch plan of a complete single-bucket cache is {plan}")
    (extents, mat), = plan
    task, k = make_task(model), DATA_SHELL_STEPS
    gen = torch.Generator(device=device).manual_seed(SEED)
    trainer.dispatch_chunk(task, state, gen, cache, extents, mat[:k])  # warm-up
    torch.cuda.synchronize()
    root = os.path.dirname(os.path.abspath(__file__))
    syncs, outside = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        # the innermost line of this repository on the stack names the cause;
        # a warning raised outside dispatch_chunk (the mode switches
        # themselves) is kept apart
        if "synchroniz" in str(message):
            stack = traceback.extract_stack()[:-1]
            ours = [f for f in stack if os.path.abspath(f.filename).startswith(root)
                    and os.path.abspath(f.filename) != os.path.abspath(__file__)]
            where = (f"{os.path.relpath(ours[-1].filename, root)}:{ours[-1].lineno}" if ours
                     else "no line of the package")
            in_chunk = any(f.name == "dispatch_chunk" for f in stack)
            (syncs if in_chunk else outside).append(
                f"{where} (warned at {os.path.basename(filename)}:{lineno}: "
                f"{str(message)[:100]})")

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            start = time.perf_counter()
            metrics = trainer.dispatch_chunk(task, state, gen, cache, extents, mat[-k:])
            enqueue = time.perf_counter() - start
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    losses = metrics["loss"].cpu().numpy()
    if losses.shape != (len(mat[-k:]),) or not np.isfinite(losses).all():
        fail(f"data shell: a dispatched chunk's losses {losses}")
    # whole cached epochs, per step (the prefetcher over the loader, each
    # batch gathered by cache.place) and dispatched, in turns, no logging
    trainer.config.log_every_n_steps = 10 ** 9
    epoch_s = {"per_step": [], "dispatched": []}
    for epoch, how in enumerate(("per_step", "dispatched", "dispatched", "per_step"), start=2):
        loader.set_epoch(epoch)
        torch.cuda.synchronize()
        begin = time.perf_counter()
        if how == "per_step":
            trainer._streamed_epoch(task, state, gen, loader, epoch, cache)
        else:
            trainer._dispatched_epoch(task, state, gen, cache, cache.epoch_plan(loader), epoch)
        torch.cuda.synchronize()
        epoch_s[how].append(time.perf_counter() - begin)
    return {"sync_calls": len(syncs), "sync_sources": dict(Counter(syncs)),
            "warnings_outside_the_chunk": dict(Counter(outside)),
            "cached_epoch_s": epoch_s, "steps_per_epoch": len(mat),
            "chunk_enqueue_ms": enqueue * 1e3, "chunk_wall_ms": wall * 1e3,
            "step_ms": wall * 1e3 / k, "extents": [list(e) for e in extents]}


def world_pool(device, workdir, tts_data_dir):
    """The cold WORLD analysis of WORLD_POOL_CLIPS clips of the TTS corpus
    through the loader at num_workers 0 and DATA_SHELL_WORKERS into two
    fresh caches: host seconds of each (the pool's start included), and
    the caches' files byte for byte."""
    from voice100_tpu_torch.data import AudioTextDataModule, DataLoader, SubsetDataset

    seconds, caches, audio_s = {}, {}, 0.0
    for workers in (0, DATA_SHELL_WORKERS):
        cache = os.path.join(workdir, f"world_pool{workers}_cache")
        os.makedirs(cache)
        data = AudioTextDataModule(vocoder="world_mcep", dataset="dummy_en",
                                   data_dir=tts_data_dir, cache_dir=cache, device=device)
        ds = data._wrap_cache(SubsetDataset(data._get_dataset("train"), range(WORLD_POOL_CLIPS)))
        loader = DataLoader(ds, 8, data.collate_fn, num_workers=workers)
        start = time.perf_counter()
        try:
            frames = sum(int(batch[0][1][:n].sum()) for batch, n in loader.iter_with_counts())
        finally:
            loader.close()
        seconds[workers] = time.perf_counter() - start
        audio_s = frames * 0.01  # WORLD frames of 10 ms
        caches[workers] = cache
    names = [sorted(os.listdir(c)) for c in caches.values()]
    if names[0] != names[1] or len(names[0]) != WORLD_POOL_CLIPS:
        fail(f"data shell: the WORLD caches hold {len(names[0])} and {len(names[1])} files")
    for name in names[0]:
        with open(os.path.join(caches[0], name), "rb") as a, \
                open(os.path.join(caches[DATA_SHELL_WORKERS], name), "rb") as b:
            if a.read() != b.read():
                fail(f"data shell: the pooled WORLD cache entry {name} differs from the "
                     f"thread path's")
    return {"clips": WORLD_POOL_CLIPS, "audio_s": audio_s, "thread_s": seconds[0],
            "pooled_s": seconds[DATA_SHELL_WORKERS], "workers": DATA_SHELL_WORKERS,
            "byte_equal_files": len(names[0])}


def mel_pool_vs_kernel(pool_cache, thread_cache):
    """The pooled (host, plain log-mel) cache against the thread path's
    (kernel 8) cache of the same clips: every value within MEL_TOL plus
    one float16 step at its magnitude. Returns the largest difference."""
    names = sorted(n for n in os.listdir(pool_cache) if n.endswith(".npy"))
    if not names or any(not os.path.exists(os.path.join(thread_cache, n)) for n in names):
        fail(f"data shell: {len(names)} pooled log-mel entries, not all in the thread cache")
    worst = excess = 0.0
    for name in names:
        a = np.load(os.path.join(pool_cache, name)).astype(np.float32)
        b = np.load(os.path.join(thread_cache, name)).astype(np.float32)
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)).astype(np.float16)).astype(np.float32)
        diff = np.abs(a - b)
        worst, excess = max(worst, float(diff.max())), max(excess, float((diff - step).max()))
    if not excess <= MEL_TOL:
        fail(f"data shell: the pooled log-mel cache differs from kernel 8's by {worst:.3e}, "
             f"{excess:.3e} past one float16 step (tol {MEL_TOL:.0e})")
    return {"entries": len(names), "max_abs_diff": worst, "beyond_one_f16_step": excess}


def data_shell_phase(device, card, workdir, align_args, tts_data_dir):
    """The training data shell on the card: asr_en_base through the CLI
    from a cold feature cache with DATA_SHELL_WORKERS loader workers, the
    device cache and DATA_SHELL_STEPS steps a dispatch (launches exact,
    kernel 8 never in this process), against the same fit at one step a
    dispatch (losses within DATA_SHELL_LOSS_REL_TOL); one chunk's
    synchronising calls; the pooled cold WORLD analysis against the thread
    path's (byte-equal caches); the pooled log-mel cache against the
    thread path's kernel-8 cache (``cli_phase``'s). Returns the launches by
    path and a summary."""
    from voice100_tpu_torch.data import AudioTextDataModule

    start = time.perf_counter()
    with environ(DATA_SHELL_BUCKETS):
        runs = {k: data_shell_fit(device, workdir, align_args, f"data_shell_k{k}", k)
                for k in (DATA_SHELL_STEPS, 1)}
        syncs = dispatch_syncs(device, align_args, runs[1][3])
    data = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=align_args["data_dir"],
                               cache_dir=runs[1][3], batch_size=DATA_SHELL_BATCH, device=device)
    data.setup("fit")
    layers = ASR_EN_BASE["decoder_num_layers"]
    per_epoch = -(-len(data.train_ds) // DATA_SHELL_BATCH)
    steps = DATA_SHELL_EPOCHS * per_epoch
    evals = DATA_SHELL_EPOCHS * -(-len(data.valid_ds) // DATA_SHELL_BATCH)
    want = {"log_mel": 0, "bilstm_recurrence": 2 * layers * evals, "viterbi_align": 0,
            "bilstm_train_fwd": layers * steps, "bilstm_train_bwd": 2 * layers * steps,
            "ctc_alpha": steps + evals, "ctc_adjoint": steps}
    for k, (records, launches, _, _) in runs.items():
        if launches != want:
            fail(f"data shell fit (steps_per_dispatch {k}): launches {launches}, not {want}")
    records = {k: r[0] for k, r in runs.items()}
    dispatch = [r for r in records[DATA_SHELL_STEPS] if r.get("event") == "scan_dispatch"]
    want_dispatch = [{"event": "scan_dispatch", "steps_per_dispatch": DATA_SHELL_STEPS,
                      "batches_per_epoch": per_epoch, "buckets": 1, "runs": 1}]
    if dispatch != want_dispatch or any(r.get("event") == "scan_dispatch" for r in records[1]):
        fail(f"data shell: scan_dispatch records {dispatch}, not {want_dispatch}")
    step_recs = {k: [r for r in rs if "train_loss" in r and "train_time_s" not in r]
                 for k, rs in records.items()}
    epoch_recs = {k: [r for r in rs if "train_time_s" in r] for k, rs in records.items()}
    # epoch 0 logs each step; a chunk logs once, at its last step
    want_steps = list(range(1, per_epoch + 1)) + [
        epoch * per_epoch + min(b + DATA_SHELL_STEPS, per_epoch)
        for epoch in range(1, DATA_SHELL_EPOCHS) for b in range(0, per_epoch, DATA_SHELL_STEPS)]
    if [r["step"] for r in step_recs[DATA_SHELL_STEPS]] != want_steps or [
            r["step"] for r in step_recs[1]] != list(range(1, steps + 1)):
        fail(f"data shell: logged steps {[r['step'] for r in step_recs[DATA_SHELL_STEPS]]}")
    per_step = {r["step"]: r["train_loss"] for r in step_recs[1]}
    errs, prev = [], 0
    for r in step_recs[DATA_SHELL_STEPS]:  # a chunk's record: the mean of its steps
        ref = float(np.mean([per_step[s] for s in range(prev + 1, r["step"] + 1)]))
        errs.append(abs(r["train_loss"] - ref) / abs(ref))
        prev = r["step"]
    for a, b in zip(epoch_recs[DATA_SHELL_STEPS], epoch_recs[1]):
        errs += [abs(a[key] - b[key]) / abs(b[key]) for key in ("train_loss", "val_loss")]
    if not all(np.isfinite(per_step[s]) for s in per_step) or not max(errs) <= \
            DATA_SHELL_LOSS_REL_TOL:
        fail(f"data shell: the chunked fit's losses differ from the per-step fit's by "
             f"{max(errs):.3e} relative")
    world = world_pool(device, workdir, tts_data_dir)
    mel = mel_pool_vs_kernel(runs[DATA_SHELL_STEPS][3], os.path.join(workdir, "cli_cache"))
    epoch_s = {k: [r["train_time_s"] for r in rs] for k, rs in epoch_recs.items()}
    print(f"data shell on {card}: asr_en_base fit {DATA_SHELL_EPOCHS} epochs through the CLI, "
          f"{len(data.train_ds)} train clips at batch {DATA_SHELL_BATCH}, {DATA_SHELL_WORKERS} "
          f"loader workers, device cache, cold feature cache: {dispatch[0]}; wall "
          f"{runs[DATA_SHELL_STEPS][2]:.2f} s (steps_per_dispatch {DATA_SHELL_STEPS}) and "
          f"{runs[1][2]:.2f} s (1); train time by epoch {epoch_s[DATA_SHELL_STEPS]} and "
          f"{epoch_s[1]} s; launches {runs[DATA_SHELL_STEPS][1]} (kernel 8 never in this "
          f"process); chunked against per-step losses max rel diff {max(errs):.3e} (tol "
          f"{DATA_SHELL_LOSS_REL_TOL:.0e}, {len(errs)} values)", flush=True)
    print(f"data shell dispatch on {card}: one chunk of {DATA_SHELL_STEPS} steps at extents "
          f"{syncs['extents']}: {syncs['sync_calls']} synchronising calls "
          f"{syncs['sync_sources']} (outside the chunk: "
          f"{syncs['warnings_outside_the_chunk']}); enqueue {syncs['chunk_enqueue_ms']:.2f} ms, "
          f"wall "
          f"{syncs['chunk_wall_ms']:.2f} ms ({syncs['step_ms']:.2f} ms a step); cached epochs of "
          f"{syncs['steps_per_epoch']} steps without logging, in turns: per step "
          f"{[round(v, 4) for v in syncs['cached_epoch_s']['per_step']]} s, dispatched "
          f"{[round(v, 4) for v in syncs['cached_epoch_s']['dispatched']]} s", flush=True)
    print(f"data shell cold WORLD analysis on {card}'s host: {world['clips']} clips "
          f"({world['audio_s']:.2f} s of audio) thread path {world['thread_s']:.2f} s, "
          f"{world['workers']} workers {world['pooled_s']:.2f} s (pool start included); "
          f"{world['byte_equal_files']} cache files byte-equal", flush=True)
    print(f"data shell cold log-mel: the pooled (CPU plain) cache against kernel 8's over "
          f"{mel['entries']} clips: max abs diff {mel['max_abs_diff']:.3e}, beyond one float16 "
          f"step {mel['beyond_one_f16_step']:.3e} (tol {MEL_TOL:.0e})", flush=True)
    summary = {"wall_s": time.perf_counter() - start,
               "fit_wall_s": {k: r[2] for k, r in runs.items()},
               "train_time_s_by_epoch": epoch_s, "loss_max_rel_diff": max(errs),
               "dispatch": syncs, "world": world, "mel": mel}
    return {f"data_shell_fit_k{k}": r[1] for k, r in runs.items()}, summary


# The device WORLD analysis (the JAX package's analysis_backend="jax"):
# the cold analysis of the TTS corpus on the card into a fresh cache; the
# card against the CPU's device backend on WORLD_PARITY_CLIPS clips at the
# float32 tolerances of tests/test_torch_world_device.py; the card against
# the host cache (DIO, float64) under the JAX package's agreement rules for
# its device backend (tests/test_world.py:206-218: voicing agreement over
# 0.9, F0 within 3% where both are voiced, the envelope's median log error
# under 0.2 over bins within 20 nats of the peak). That test holds F0 on
# every frame of a clean pulse train; on this corpus of noisy, gated clips
# the two trackers (YIN on the card, DIO on the host) part by 3-6% on a
# few isolated frames of some clips (at most 0.35% of a clip's frames on
# the CPU's device backend), so the F0 rule here is on the frames away
# from voicing boundaries, as the reanalysis metric guards them
# (test_world_invariants.py:65-72), and allows under 1% of them past 3%;
# and the reanalysis bars (test_world_invariants.py:118-135) on the card
WORLD_PARITY_CLIPS = 8
WORLD_F0_RTOL, WORLD_FEATURE_ATOL, WORLD_CODEAP_DB_ATOL = 1e-4, 1e-3, 0.01
WORLD_VOICING_AGREE, WORLD_F0_REL, WORLD_ENVELOPE_MEDIAN = 0.9, 0.03, 0.2
WORLD_F0_OUTLIER_SHARE = 0.01
REANALYSIS_PITCHES = (110.0, 160.0, 220.0, 320.0)


def world_entries(cache_dir):
    """{entry name: (f0, mcep, codeap)} of a WORLD feature cache."""
    out = {}
    for name in sorted(os.listdir(cache_dir)):
        if name.endswith(".npz"):
            with np.load(os.path.join(cache_dir, name)) as z:
                out[name] = tuple(z[k] for k in z.files)
    return out


def voicing_guard(voiced):
    """Frames away from the edges and from +-3 frames of a voicing
    boundary (test_world_invariants.py:65-72)."""
    guard = np.ones(len(voiced), bool)
    for e in np.flatnonzero(np.diff(voiced.astype(np.int8))):
        guard[max(0, e - 3):e + 4] = False
    guard[:5] = guard[-5:] = False
    return guard


def reanalysis_metrics(pitch, vocoder):
    """test_world_invariants.py's metrics of one pitch: ground-truth
    features (a vibrato F0 with an unvoiced gap, a three-formant envelope)
    synthesized by the port's NumPy synthesizer, analysed by ``vocoder``."""
    from voice100_tpu_torch.dsp.world.codec import decode_aperiodicity
    from voice100_tpu_torch.dsp.world.synthesis_np import synthesize_np

    n_fft, n_frames = 512, int(1.2 * 1000 / 10.0) + 1
    t = np.arange(n_frames) * 0.01
    f0_true = pitch * (1.0 + 0.02 * np.sin(2 * np.pi * 4.0 * t))
    third = n_frames // 3
    f0_true[third:third + third // 2] = 0.0
    freqs = np.arange(n_fft // 2 + 1) * SAMPLE_RATE / n_fft
    env = np.full_like(freqs, 1e-7)
    for k, fc in enumerate((500.0, 1500.0, 2500.0)):
        env = env + (0.5 ** k) * np.exp(-0.5 * ((freqs - fc) / 180.0) ** 2)
    spc_true = np.tile((env / env.max())[None, :], (n_frames, 1))
    ap = decode_aperiodicity(np.where(f0_true > 0, -8.0, -0.01)[:, None], SAMPLE_RATE, n_fft)
    wav = synthesize_np(f0_true, spc_true, ap, fs=SAMPLE_RATE, frame_period=10.0)
    f0_est, logspc_est, _ = vocoder.encode(np.asarray(wav))
    n = min(len(f0_true), len(f0_est))
    f0_true, f0_est = f0_true[:n], f0_est[:n].astype(np.float64)
    voiced = f0_true > 0
    guard = voicing_guard(voiced)
    both = voiced & (f0_est > 0) & guard
    rel = np.abs(f0_est[both] - f0_true[both]) / f0_true[both]
    lo, hi = int(100 * n_fft / SAMPLE_RATE), int(5000 * n_fft / SAMPLE_RATE)
    log_true = np.log(spc_true[:n, lo:hi] + 1e-15)
    log_est = logspc_est[:n, lo:hi].astype(np.float64)
    log_true = log_true - log_true.mean(axis=1, keepdims=True)
    log_est = log_est - log_est.mean(axis=1, keepdims=True)
    db = 20.0 / np.log(10.0)
    floor = log_true.max(axis=1, keepdims=True) - 45.0 / db
    err45 = np.maximum(log_est, floor) - np.maximum(log_true, floor)
    return {"f0_rmse_rel": float(np.sqrt(np.mean(rel ** 2))),
            "voicing_acc": float(np.mean((f0_est > 0)[guard] == voiced[guard])),
            "octave_rate": float(np.mean(rel > 0.2)) if both.any() else 1.0,
            "envelope_rmse_db": float(np.sqrt(np.mean((log_true[both] - log_est[both]) ** 2)) * db),
            "envelope_lsd45_db": float(np.sqrt(np.mean(err45[both] ** 2)) * db),
            "n_voiced": int(both.sum())}


def world_device_phase(device, card, workdir, host_s):
    """The cold device analysis of the TTS corpus through calc_stat at
    num_workers 0 (VOICE100_TPU_WORLD_BACKEND=device) into a fresh cache,
    timed beside the host analysis of the same clips (``host_s``, the TTS
    training phase's calc_stat), and its checks (see the constants)."""
    from voice100_tpu_torch.dsp.audioio import load_audio
    from voice100_tpu_torch.dsp.mcep import create_mc2sp_matrix
    from voice100_tpu_torch.dsp.world import WORLDVocoder
    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main

    data_dir = os.path.join(workdir, "tts_data")
    cache_dir = os.path.join(workdir, "tts_world_cache_device")
    stat_path = os.path.join(workdir, "dummy_en-stat-device.npz")
    saved = os.environ.get("VOICE100_TPU_WORLD_BACKEND")
    os.environ["VOICE100_TPU_WORLD_BACKEND"] = "device"
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        stat_main(["--output", stat_path, "--dataset", "dummy_en", "--vocoder", "world_mcep",
                   "--data_dir", data_dir, "--cache_dir", cache_dir])
        torch.cuda.synchronize()
        device_s = time.perf_counter() - start
    finally:
        if saved is None:
            os.environ.pop("VOICE100_TPU_WORLD_BACKEND")
        else:
            os.environ["VOICE100_TPU_WORLD_BACKEND"] = saved
    stats = dict(np.load(stat_path))
    host_stats = dict(np.load(os.path.join(workdir, "dummy_en-stat.npz")))
    if not all(np.isfinite(v).all() for v in stats.values()) or not 90 < stats["f0_mean"][0] < 260:
        fail(f"world device: calc_stat gave {stats}")
    with open(os.path.join(data_dir, "dummy_en-train.txt")) as f:
        clip_ids = [line.split("|")[0] for line in f]
    audio_s = sum(len(load_audio(os.path.join(data_dir, "dummy-speech-en", "wavs", f"{c}.wav")))
                  for c in clip_ids) / SAMPLE_RATE
    print(f"world device ({card}): the cold device analysis of {len(clip_ids)} clips "
          f"({audio_s:.2f} s of audio) through calc_stat {device_s:.2f} s, "
          f"{audio_s / device_s:.1f} audio s/s; the host analysis of the same clips "
          f"{host_s:.2f} s, {audio_s / host_s:.1f} audio s/s (host clock); f0 mean "
          f"{stats['f0_mean'][0]:.2f} Hz (host {host_stats['f0_mean'][0]:.2f})", flush=True)

    # the card (the device cache) against the host cache, clip by clip
    dev_entries = world_entries(cache_dir)
    host = world_entries(os.path.join(workdir, "tts_world_cache"))
    if sorted(dev_entries) != sorted(host) or len(dev_entries) != len(clip_ids):
        fail(f"world device: {len(dev_entries)} device cache entries, {len(host)} host entries")
    mc2sp = create_mc2sp_matrix(512, 24, 0.410)
    worst = {"voicing_agree": 1.0, "f0_rel": 0.0, "f0_outlier_share": 0.0, "envelope_median": 0.0}
    for name in dev_entries:
        (f0, mcep, codeap), (hf0, hmcep, hcodeap) = dev_entries[name], host[name]
        if f0.shape != hf0.shape or mcep.shape != hmcep.shape or codeap.shape != hcodeap.shape:
            fail(f"world device: entry {name} has other shapes than the host's")
        if not all(np.isfinite(a).all() for a in (f0, mcep, codeap)):
            fail(f"world device: entry {name} is not finite")
        voiced, hvoiced = f0 > 0, hf0 > 0
        both = voiced & hvoiced & voicing_guard(hvoiced)
        rel = np.abs(f0[both] - hf0[both]) / hf0[both]
        logspc, hlogspc = mcep.astype(np.float64) @ mc2sp, hmcep.astype(np.float64) @ mc2sp
        energetic = hlogspc > hlogspc.max() - 20
        worst["voicing_agree"] = min(worst["voicing_agree"], float(np.mean(voiced == hvoiced)))
        worst["f0_rel"] = max(worst["f0_rel"], float(rel.max()) if rel.size else 0.0)
        worst["f0_outlier_share"] = max(worst["f0_outlier_share"],
                                        float(np.mean(rel > WORLD_F0_REL)) if rel.size else 0.0)
        worst["envelope_median"] = max(worst["envelope_median"], float(
            np.median(np.abs(logspc[energetic] - hlogspc[energetic]))))
    print(f"world device vs host cache ({len(dev_entries)} clips): worst voicing agreement "
          f"{worst['voicing_agree']:.4f} (> {WORLD_VOICING_AGREE}), share of guarded F0 frames "
          f"past {WORLD_F0_REL} relative {worst['f0_outlier_share']:.4f} (< "
          f"{WORLD_F0_OUTLIER_SHARE}; largest error {worst['f0_rel']:.4e}), envelope median "
          f"{worst['envelope_median']:.4e} nats (< {WORLD_ENVELOPE_MEDIAN})", flush=True)
    if not (worst["voicing_agree"] > WORLD_VOICING_AGREE
            and worst["f0_outlier_share"] < WORLD_F0_OUTLIER_SHARE
            and worst["envelope_median"] < WORLD_ENVELOPE_MEDIAN):
        fail(f"world device: the card parts from the host analysis beyond the JAX rules: {worst}")

    # the card against the CPU's device backend on the first clips
    on_card = WORLDVocoder(use_mcep=True, analysis_backend="device", device=device)
    cpu = WORLDVocoder(use_mcep=True, analysis_backend="device", device="cpu")
    errs = {"f0_rel": 0.0, "feature": 0.0, "codeap_db": 0.0}
    start = time.perf_counter()
    for clip in clip_ids[:WORLD_PARITY_CLIPS]:
        wav = load_audio(os.path.join(data_dir, "dummy-speech-en", "wavs", f"{clip}.wav"))
        f0, mcep, codeap = on_card.encode(np.asarray(wav, np.float64))
        cf0, cmcep, ccodeap = cpu.encode(np.asarray(wav, np.float64))
        if not np.array_equal(f0 > 0, cf0 > 0):
            fail(f"world device: voicing of {clip} differs between the card and the CPU")
        v = cf0 > 0
        errs["f0_rel"] = max(errs["f0_rel"], float(np.max(np.abs(f0[v] - cf0[v]) / cf0[v],
                                                           initial=0.0)))
        errs["feature"] = max(errs["feature"], float(np.abs(mcep - cmcep).max()))
        errs["codeap_db"] = max(errs["codeap_db"], float(np.abs(codeap - ccodeap).max()))
    cpu_s = time.perf_counter() - start
    print(f"world device card vs CPU device backend ({WORLD_PARITY_CLIPS} clips, CPU "
          f"{cpu_s:.2f} s): F0 {errs['f0_rel']:.3e} relative (tol {WORLD_F0_RTOL:.0e}), mcep "
          f"{errs['feature']:.3e} (tol {WORLD_FEATURE_ATOL:.0e}), codeap {errs['codeap_db']:.3e} "
          f"dB (tol {WORLD_CODEAP_DB_ATOL})", flush=True)
    if not (errs["f0_rel"] <= WORLD_F0_RTOL and errs["feature"] <= WORLD_FEATURE_ATOL
            and errs["codeap_db"] <= WORLD_CODEAP_DB_ATOL):
        fail(f"world device: the card parts from the CPU's device backend: {errs}")

    # the reanalysis bars on the card
    vocoder = WORLDVocoder(analysis_backend="device", device=device)
    bars = {p: reanalysis_metrics(p, vocoder) for p in REANALYSIS_PITCHES}
    print("world device reanalysis " + json.dumps(bars), flush=True)
    for pitch, m in bars.items():
        if not (m["n_voiced"] > 30 and m["f0_rmse_rel"] < 0.01 and m["octave_rate"] < 0.01
                and m["voicing_acc"] > 0.97 and m["envelope_rmse_db"] < 6.0
                and m["envelope_lsd45_db"] < 5.0):
            fail(f"world device: the reanalysis bars fail at {pitch} Hz: {m}")
    return {"clips": len(clip_ids), "audio_s": audio_s, "device_cold_s": device_s,
            "host_cold_s": host_s, "vs_host": worst, "vs_cpu": errs, "cpu_parity_s": cpu_s,
            "reanalysis": bars}


# Deployment: each v2 predict surface exported by the export CLI on the card
# (a torch.export program, its manifest, its .onnx), the program against
# the direct call (bit for bit, the same biLSTM launches), the .onnx under
# the NumPy runtime against the card (EXPORT_ONNX_TOL abs on valid frames),
# a reference-layout .ckpt through the import CLI (bit for bit), OnnxASR on
# the serve clips against the card's ASRPipeline under the margin rule, and
# the native WORLD synthesis against the NumPy one on the periodic path
EXPORT_ONNX_TOL = 2e-3
NATIVE_SYNTHESIS_TOL = 1e-4  # of the waveform's peak (tests/test_native.py:200-202)
EXPORT_LENGTHS = {"asr": 473, "align": 101, "tts": 101, "align_v1": 473}


def export_inputs(kind, model, device):
    """Seeded inputs at the exported static shapes, with a length short of
    the full extent."""
    rng = np.random.default_rng(SEED + 40)
    n = torch.tensor([EXPORT_LENGTHS[kind]], dtype=torch.int32, device=device)
    if kind == "asr":
        x = rng.standard_normal((1, 512, model.audio_size)).astype(np.float32)
    else:
        x = rng.integers(1, model.vocab_size, (1, 128)).astype(np.int32)
    return torch.from_numpy(x).to(device), n


def check_bilstm_export(device):
    """Kernel 1 against its plain version at the exported programs'
    shapes: B=1 at the static extent, the valid length of
    ``export_inputs``; asr T'=256 (H=512, D=512), align T=128 (H=256,
    D=256), tts T=128 (H=512, D=512), align_v1 T'=256 (H=128, D=128)."""
    from voice100_tpu_torch.models.layers import conv_stack_output_length

    settings = ASR_EN_BASE["encoder_settings"]
    shapes = {
        "asr": (conv_stack_output_length(settings, 512),
                conv_stack_output_length(settings, EXPORT_LENGTHS["asr"]),
                ASR_EN_BASE["decoder_hidden_size"], settings[-1][0]),
        "align": (128, EXPORT_LENGTHS["align"], ALIGN_EN_BASE["hidden_size"],
                  ALIGN_EN_BASE["hidden_size"]),
        "tts": (128, EXPORT_LENGTHS["tts"], TTS_EN_BASE["encoder_hidden_size"],
                TTS_EN_BASE["encoder_hidden_size"]),
        # AudioAlignCTC's program: the stride-2 conv halves the 512 frames
        "align_v1": (256, (EXPORT_LENGTHS["align_v1"] + 1) // 2, V1_H, V1_H),
    }
    return {f"export_{kind}": check_bilstm(device, 1, steps, [valid], hidden=hidden,
                                           input_size=d_in, plain_iters=1)
            for kind, (steps, valid, hidden, d_in) in shapes.items()}


def export_phase(device, card, workdir, align_args):
    """The deployment surface on the card (see the constants above); the
    launch counts set to 0 just before the exported programs run and the
    ONNX serving check's card side runs, and read just after."""
    from voice100_tpu_torch.dsp.world.synthesis_np import synthesize_np
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.native.world import synthesize_native
    from voice100_tpu_torch.onnx.runtime import load_model as load_onnx
    from voice100_tpu_torch.onnx.serve import OnnxASR
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.ops.melspec_cuda import log_mel_spectrogram_cuda
    from voice100_tpu_torch.tools.export import load_exported, predict_module
    from voice100_tpu_torch.tools.import_torch import cli_main as import_main
    from voice100_tpu_torch.training.cli import load_model

    root = os.path.join(workdir, "export")
    os.makedirs(root)
    tts = write_tts_checkpoints(root)
    sources = {"asr": (align_args["config"], align_args["checkpoint"]),
               "align": tts["align"], "tts": tts["audio"]}
    start = time.perf_counter()
    procs = {kind: subprocess.Popen(
        [sys.executable, "-m", "voice100_tpu_torch.tools.export", "--config", cfg,
         "--ckpt_path", ckpt, "--output", os.path.join(root, f"{kind}.pt2"),
         "--device", str(device)],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for kind, (cfg, ckpt) in sources.items()}
    for kind, proc in procs.items():
        try:
            out, _ = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs.values():
                p.kill()
            fail(f"export: the export CLI for {kind} did not finish in 600 s")
        if proc.returncode != 0:
            fail(f"export: the export CLI for {kind} exited {proc.returncode}:\n{out[-3000:]}")
    export_s = time.perf_counter() - start

    summary, outputs = {"export_cli_s": export_s}, {}
    for kind, (cfg, ckpt) in sources.items():
        path = os.path.join(root, f"{kind}.pt2")
        with open(path + ".json") as f:
            manifest = json.load(f)
        if (manifest["kind"], manifest["format"], torch.device(manifest["device"]).type) != (
                kind, "torch.export", device.type):
            fail(f"export: the {kind} manifest reads {manifest}")
        model = load_model(cfg, ckpt, device=device)
        args = export_inputs(kind, model, device)
        direct_fn = predict_module(model)
        with torch.inference_mode():
            direct_fn(*args)
            torch.cuda.synchronize()
            before = bilstm_cuda.launches
            direct = direct_fn(*args)
            torch.cuda.synchronize()
            direct_launches = bilstm_cuda.launches - before
        start = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - start
        program(*args)  # warm-up: cuDNN plans
        # the reference layout: the state dict under Lightning's key
        ref_ckpt = os.path.join(root, f"{kind}-reference.ckpt")
        torch.save({"state_dict": {k: v.cpu() for k, v in model.state_dict().items()},
                    "epoch": 0, "global_step": 0}, ref_ckpt)
        imported_ckpt = os.path.join(root, f"{kind}-imported.pt")
        import_main(["--config", cfg, "--ckpt_path", ref_ckpt, "--output", imported_ckpt])
        imported_fn = predict_module(load_model(cfg, imported_ckpt, device=device))
        with torch.inference_mode():
            imported = imported_fn(*args)
        onnx = load_onnx(os.path.splitext(path)[0] + ".onnx")
        start = time.perf_counter()
        onnx_out = onnx(*(t.cpu().numpy() for t in args))
        onnx_ms = (time.perf_counter() - start) * 1e3
        # the program as load_exported runs it (deterministic cuDNN), and
        # its module alone, which the direct call's regular convolutions
        # match; in turns, with the card's time and the host's enqueue time
        # a call (a B=1 call is host-bound where the enqueue is the longer)
        timing = {"direct": lambda: direct_fn(*args), "exported": lambda: program(*args),
                  "exported_module": lambda: program.module(*args)}
        with torch.inference_mode():
            turns = timed_in_turns(timing, iters=10)
            enqueue = {name: enqueue_ms(fn) for name, fn in timing.items()}
        ms = {name: turns[name]["ms"] for name in timing}
        outputs[kind] = (program, args, direct, direct_launches, imported, onnx_out)
        summary[kind] = {"export_load_s": load_s, "exported_ms": ms["exported"],
                         "exported_module_ms": ms["exported_module"],
                         "direct_ms": ms["direct"],
                         "device_ms": {name: turns[name]["device_ms"] for name in timing},
                         "enqueue_ms": enqueue, "onnx_numpy_ms": onnx_ms,
                         "pt2_bytes": os.path.getsize(path),
                         "onnx_bytes": os.path.getsize(os.path.splitext(path)[0] + ".onnx")}

    # the main path: the exported programs, then OnnxASR's card side
    asr_model = load_model(*sources["asr"], device=device)
    rng = np.random.default_rng(SEED)
    clips = int16_clips(rng, rng.uniform(2.0, 10.0, size=16))
    pipes = [ASRPipeline(asr_model, batch_size=1, buckets_sec=(len(c) / SAMPLE_RATE,),
                         device=device) for c in clips]
    for pipe, clip in zip(pipes, clips):
        pipe.transcribe([clip])  # warm-up: constants, cuDNN plans
    torch.cuda.synchronize()
    bilstm_cuda.launches = log_mel_spectrogram_cuda.launches = 0
    exported = {}
    for kind, (program, args, *_rest) in outputs.items():
        before = bilstm_cuda.launches
        exported[kind] = program(*args)
        torch.cuda.synchronize()
        exported[kind] = (exported[kind], bilstm_cuda.launches - before)
    texts = [pipe.transcribe([clip])[0] for pipe, clip in zip(pipes, clips)]
    torch.cuda.synchronize()
    launches = {"log_mel": log_mel_spectrogram_cuda.launches,
                "bilstm_recurrence": bilstm_cuda.launches}
    layers = ASR_EN_BASE["decoder_num_layers"]
    programs = sum(entry[3] for entry in outputs.values())
    if launches != {"log_mel": len(clips), "bilstm_recurrence": programs + layers * len(clips)}:
        fail(f"export: launches {launches}, not the programs' {programs} and {len(clips)} "
             f"clips' worth")

    for kind, (_, args, direct, direct_launches, imported, onnx_out) in outputs.items():
        got, got_launches = exported[kind]
        got, direct, imported = (x if isinstance(x, tuple) else (x,)
                                 for x in (got, direct, imported))
        if got_launches != direct_launches or got_launches < 1:
            fail(f"export: the {kind} program launched kernel 1 {got_launches} times, the "
                 f"direct call {direct_launches}")
        if not all(torch.equal(a, b) for a, b in zip(got, direct)):
            fail(f"export: the {kind} program's outputs are not the direct call's bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(imported, direct)):
            fail(f"export: the imported {kind} checkpoint's outputs are not bit-equal")
        n = int(args[1][0])
        if kind == "asr" and not np.array_equal(onnx_out[1], direct[1].cpu().numpy()):
            fail("export: the asr .onnx gives other logit lengths than the card")
        valid = int(direct[1][0]) if kind == "asr" else n if kind == "align" else 2 * n - 1
        err = max(float(np.abs(np.asarray(o)[:, :valid] - d.cpu().numpy()[:, :valid]).max())
                  for o, d in zip(onnx_out, direct) if d.dim() > 1)
        summary[kind]["onnx_max_abs_err"] = err
        if not err <= EXPORT_ONNX_TOL:
            fail(f"export: the {kind} .onnx under the NumPy runtime is {err:.3e} from the card")

    # OnnxASR on the serve clips against the card under the margin rule
    onnx_asr = OnnxASR(os.path.join(root, "asr.onnx"))
    start = time.perf_counter()
    onnx_texts = [onnx_asr(c.astype(np.float32) / 32768.0) for c in clips]
    onnx_asr_s = time.perf_counter() - start
    exact = 0
    for pipe, clip, text, onnx_text in zip(pipes, clips, texts, onnx_texts):
        (_, wav, lens), = list(pipe.batches([clip]))
        logits, n = pipe.logits(wav, lens)
        _, choices = near_max_ids(logits[0].cpu(), int(n[0]))
        if not transcript_reachable(choices, onnx_text, pipe.tokenizer):
            fail(f"export: OnnxASR's transcript {onnx_text!r} is not within the margin rule of "
                 f"the card's {text!r}")
        exact += onnx_text == text

    # the native WORLD synthesis on one TTS call's features, on the
    # periodic path where both synthesizers run the same operations (the
    # noise path differs by RNG, tests/test_native.py:187-189): the call's
    # envelope and F0, its unvoiced frames at its mean voiced F0,
    # aperiodicity 1e-6
    f0, logspc, _ = (t[0].cpu().numpy().astype(np.float64) for t in exported["tts"][0])
    frames = 2 * EXPORT_LENGTHS["tts"] - 1
    f0, spc = f0[:frames], np.exp(logspc[:frames])
    voiced = f0 > 0
    if not voiced.any():
        fail("export: the TTS call gave no voiced frame")
    f0 = np.where(voiced, f0, f0[voiced].mean())
    ap = np.full_like(spc, 1e-6)
    ref = synthesize_np(f0, spc, ap, fs=SAMPLE_RATE, frame_period=10.0)
    nat = synthesize_native(f0, spc, ap, fs=SAMPLE_RATE, frame_period=10.0)
    native_err = float(np.abs(ref - nat).max() / np.abs(ref).max()) if len(ref) == len(nat) else 1.0
    if not native_err <= NATIVE_SYNTHESIS_TOL:
        fail(f"export: the native synthesis is {native_err:.3e} of peak from the NumPy one")
    summary.update({"onnx_asr_clips": len(clips), "onnx_asr_exact": exact,
                    "onnx_asr_s": onnx_asr_s, "native_synthesis_err": native_err,
                    "voiced_frames": int(voiced.sum())})
    return launches, summary


# The v1 deployment surface: the five v1 models at the train-v1 widths
# (V1_*), exported at the JAX tool's static shapes under its kinds
# (label, the JAX tool's kind, model, inputs, widths)
V1_DEPLOY = (("asr_v1", "asr_v1", "AudioToTextCTC", "asr", V1_ASR),
             ("align_ctc_v1", "align_ctc_v1", "AudioAlignCTC", "align", V1_ALIGN),
             ("ttsalign_v1", "ttsalign_v1", "TextToAlignTextModel", "tts", V1_TTS_ALIGN),
             ("ttsaudio_v1", "ttsaudio_v1", "AlignTextToAudioModel", "tts", V1_TTS_AUDIO),
             ("ttsaudio_mt_v1", "ttsaudio_v1", "AlignTextToAudioMultiTaskModel", "tts",
              V1_TTS_MT))
V1_DEPLOY_TIMED = 10


def v1_deploy_model(i, name, kwargs):
    """A seeded v1 model on the CPU, its BatchNorm running averages moved
    by U(0.1, 0.5) (so that the folded graph and the import read them),
    the acoustic models' WORLD statistics at the scale of real features."""
    from voice100_tpu_torch import models
    from voice100_tpu_torch.models.layers import BatchNorm

    gen = torch.Generator().manual_seed(SEED + 60 + i)
    model = getattr(models, name)(**kwargs, device="cpu", generator=gen)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                for buf in (m.running_mean, m.running_var):
                    buf.add_(torch.rand(buf.shape, generator=gen) * 0.4 + 0.1)
        if hasattr(model, "norm"):
            s = model.logspc_size
            for key, value in (("f0_mean", [150.0]), ("f0_std", [30.0]),
                               ("logspc_mean", [-5.0] * s), ("logspc_std", [2.0] * s),
                               ("codeap_mean", [-0.5]), ("codeap_std", [0.5])):
                getattr(model.norm, key).copy_(torch.tensor(value))
    return model.eval()


def v1_reference_state(model):
    """The model's state in the reference's layout: Lightning's ``model.``
    prefix, and each BatchNorm's ``num_batches_tracked`` as
    ``nn.BatchNorm1d`` keeps it."""
    from voice100_tpu_torch.models.layers import BatchNorm

    state = {f"model.{k}": v.detach().cpu() for k, v in model.state_dict().items()}
    for prefix, m in model.named_modules():
        if isinstance(m, BatchNorm):
            state[f"model.{prefix}.num_batches_tracked"] = torch.tensor(100, dtype=torch.long)
    return state


def v1_deploy_phase(device, card, workdir):
    """The v1 deployment surface and the mel-kernel switch on the card
    (see the module's docstring, step 22). Returns the launches by path
    and a summary."""
    import yaml

    from voice100_tpu_torch.onnx.runtime import load_model as load_onnx
    from voice100_tpu_torch.ops.lstm_cuda import bilstm_cuda
    from voice100_tpu_torch.tools.export import cli_main as export_main
    from voice100_tpu_torch.tools.export import load_exported, predict_module
    from voice100_tpu_torch.tools.import_torch import cli_main as import_main
    from voice100_tpu_torch.training import TrainState, save_checkpoint
    from voice100_tpu_torch.training.cli import load_model

    phase_start = time.perf_counter()
    root = os.path.join(workdir, "export_v1")
    os.makedirs(root)
    counters = cli_counters()
    rng = np.random.default_rng(SEED + 61)
    summary, outputs = {"card": card}, {}
    for i, (kind, jax_kind, name, input_kind, kwargs) in enumerate(V1_DEPLOY):
        model = v1_deploy_model(i, name, kwargs)
        cfg, ckpt = os.path.join(root, f"{kind}.yaml"), os.path.join(root, f"{kind}.pt")
        with open(cfg, "w") as f:
            yaml.safe_dump({"model": {"class_path": f"voice100.models.{name}",
                                      "init_args": kwargs}}, f)
        save_checkpoint(ckpt, TrainState(model, torch.optim.Adam(model.parameters())))
        path = os.path.join(root, f"{kind}.pt2")
        start = time.perf_counter()
        export_main(["--config", cfg, "--ckpt_path", ckpt, "--output", path])  # cuda by default
        export_s = time.perf_counter() - start
        with open(path + ".json") as f:
            manifest = json.load(f)
        if (manifest["kind"], torch.device(manifest["device"]).type) != (jax_kind, "cuda"):
            fail(f"v1 export: the {kind} manifest reads {manifest}")
        model = model.to(device)
        if input_kind == "tts":
            args = (torch.from_numpy(rng.integers(1, kwargs["vocab_size"], (1, 128)).astype(
                np.int32)).to(device),)
        else:
            x = torch.from_numpy(rng.standard_normal((1, 512, kwargs["audio_size"])).astype(
                np.float32)).to(device)
            args = (x, torch.tensor([EXPORT_LENGTHS["align_v1"]], dtype=torch.int32,
                                    device=device)) if input_kind == "align" else (x,)
        direct_fn = predict_module(model)
        with torch.inference_mode():
            direct_fn(*args)
            zero_counts(counters)
            direct = direct_fn(*args)
            direct_launches = read_counts(counters)
            hasf0 = model(*args)[0] if kind.startswith("ttsaudio") else None
        start = time.perf_counter()
        program = load_exported(path)
        load_s = time.perf_counter() - start
        program(*args)  # warm-up: cuDNN plans
        # the reference layout through the import CLI, on cuda by default
        ref_ckpt = os.path.join(root, f"{kind}-reference.ckpt")
        torch.save({"state_dict": v1_reference_state(model), "epoch": 0, "global_step": 0},
                   ref_ckpt)
        imported_ckpt = os.path.join(root, f"{kind}-imported.pt")
        import_main(["--config", cfg, "--ckpt_path", ref_ckpt, "--output", imported_ckpt])
        imported_fn = predict_module(load_model(cfg, imported_ckpt, device=device))
        with torch.inference_mode():
            imported = imported_fn(*args)
        onnx = load_onnx(os.path.splitext(path)[0] + ".onnx")
        np_args = [t.cpu().numpy() for t in args]
        onnx(*np_args)
        start = time.perf_counter()
        onnx_out = onnx(*np_args)
        onnx_ms = (time.perf_counter() - start) * 1e3
        ms = {"direct": [], "exported": []}
        with torch.inference_mode():
            for r in range(2):  # in turns
                for which in (("direct", "exported") if r == 0 else ("exported", "direct")):
                    fn = direct_fn if which == "direct" else program
                    ms[which].append(time_ms(lambda: fn(*args), iters=V1_DEPLOY_TIMED))
        outputs[kind] = (program, args, direct, direct_launches, imported, onnx_out, hasf0)
        summary[kind] = {"params": sum(p.numel() for p in model.parameters()),
                         "export_s": export_s, "load_s": load_s,
                         "direct_ms": float(np.median(ms["direct"])),
                         "exported_ms": float(np.median(ms["exported"])),
                         "onnx_numpy_ms": onnx_ms, "pt2_bytes": os.path.getsize(path),
                         "onnx_bytes": os.path.getsize(os.path.splitext(path)[0] + ".onnx")}

    # the main path: the five exported programs, one call each
    zero_counts(counters)
    for fn in counters.values():
        if hasattr(fn, "launches_bf16"):
            fn.launches_bf16 = 0
    exported = {}
    for kind, (program, args, *_rest) in outputs.items():
        before = bilstm_cuda.launches
        exported[kind] = program(*args)
        torch.cuda.synchronize()
        exported[kind] = (exported[kind], bilstm_cuda.launches - before)
    launches = read_counts(counters)
    bf16 = sum(getattr(fn, "launches_bf16", 0) for fn in counters.values())
    want = dict.fromkeys(counters, 0)
    want["bilstm_recurrence"] = V1_ALIGN["num_layers"]
    if launches != want or bf16:
        fail(f"v1 export: launches {launches} (bf16 {bf16}), not {want}")

    for kind, (_, args, direct, direct_launches, imported, onnx_out, hasf0) in outputs.items():
        got, got_launches = exported[kind]
        per_call = V1_ALIGN["num_layers"] if kind == "align_ctc_v1" else 0
        if got_launches != per_call or direct_launches["bilstm_recurrence"] != per_call:
            fail(f"v1 export: the {kind} program launched kernel 1 {got_launches} times, the "
                 f"direct call {direct_launches['bilstm_recurrence']}, not {per_call}")
        if any(direct_launches[k] for k in direct_launches if k != "bilstm_recurrence"):
            fail(f"v1 export: the direct {kind} call launched {direct_launches}")
        got, direct, imported = (x if isinstance(x, tuple) else (x,)
                                 for x in (got, direct, imported))
        if not all(torch.isfinite(a).all() for a in direct if a.is_floating_point()):
            fail(f"v1 export: the direct {kind} call gave non-finite outputs")
        if len(got) != len(direct) or not all(torch.equal(a, b) for a, b in zip(got, direct)):
            fail(f"v1 export: the {kind} program's outputs are not the direct call's bit for bit")
        if not all(torch.equal(a, b) for a, b in zip(imported, direct)):
            fail(f"v1 export: the imported {kind} checkpoint's outputs are not bit-equal")
        if len(onnx_out) != len(direct):
            fail(f"v1 export: the {kind} .onnx gives {len(onnx_out)} outputs, not {len(direct)}")
        valid = None
        if kind == "align_ctc_v1":
            if not np.array_equal(onnx_out[1], direct[1].cpu().numpy()):
                fail("v1 export: the align_ctc_v1 .onnx gives other logit lengths than the card")
            valid = int(direct[1][0])
        err, gated = 0.0, 0
        for j, (o, d) in enumerate(zip(onnx_out, direct)):
            if d.dim() < 2:
                continue
            diff = np.abs(np.asarray(o)[:, :valid] - d.cpu().numpy()[:, :valid])
            if hasf0 is not None and j == 0:
                # f0 is zero where the voicing logit is below 0: compare it where the
                # logit clears the tolerance
                clear = (hasf0.abs() > EXPORT_ONNX_TOL).cpu().numpy()
                gated = int((~clear).sum())
                diff = diff[clear]
            err = max(err, float(diff.max()))
        summary[kind].update(onnx_max_abs_err=err, f0_frames_gated=gated)
        if not err <= EXPORT_ONNX_TOL:
            fail(f"v1 export: the {kind} .onnx under the NumPy runtime is {err:.3e} from the card")

    paths = {"v1_export": launches}
    summary["wall_s"] = time.perf_counter() - phase_start
    for kind, *_ in V1_DEPLOY:
        r = summary[kind]
        print(f"v1 export {kind} on {card}: export {r['export_s']:.2f} s, load "
              f"{r['load_s']:.3f} s, exported {r['exported_ms']:.4f} ms vs direct "
              f"{r['direct_ms']:.4f} ms a call, ONNX (NumPy) {r['onnx_numpy_ms']:.1f} ms a call, "
              f"max_abs_err {r['onnx_max_abs_err']:.3e}", flush=True)
    print(f"v1 deploy phase on {card}: {summary['wall_s']:.1f} s", flush=True)
    return paths, summary


# Data parallelism (the distributed phase): asr_en_base through the training
# CLI on the align corpus, half of it held out, so that each epoch's 64 train
# clips are one full global batch of 64 (a short last global batch is padded
# by each rank on its own, as in the JAX package, and would differ from one
# process's padding); its warm feature cache
DP_EPOCHS = 3
DP_VALID_RATIO = 0.5
# a fit against the plain fit (two ranks, one rank, the plain fit again):
# step and val losses relatively (the CPU test's bound), and the Adam first
# moments after the last step (the running mean of the all-reduced
# gradients) by relative L2 difference. Two plain fits part by ~1e-6 in
# loss and ~1e-5 in moments (the CTC vocabulary scatter and cuDNN's
# convolution backward add with atomics); a rank's share dropped or
# counted twice, or rows given to the wrong rank, moves the moments by
# O(0.1-1). Adam is scale-free, so the weights alone would not show a
# gradient off by a constant factor.
DP_LOSS_REL_TOL = 1e-5
DP_MOMENT_REL_TOL = 1e-4
# the JAX test's weight bound (tests/test_distributed.py:186), reported:
# at full width two plain fits on the card already part past it on a few
# of the 12M weights (Adam's steps amplify rounding where the first moment
# nearly cancels against the second), so it is not a gate here
DP_WEIGHT_RTOL, DP_WEIGHT_ATOL = 2e-5, 2e-6
DP_RANK_TIMEOUT_S = 400
DP_ALL_REDUCE_ITERS = 20
# tensor parallelism at (1, 2): the share of a data-parallel rank's
# model and Adam bytes that a rank may keep between steps (every
# asr_en_base tensor but the dense layer's 29-wide bias shards in two)
TP_RESIDENT_SHARE = 0.51


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def all_reduce_step_ms(device) -> dict:
    """The gradient all-reduce of one asr_en_base step over the process
    group this process has joined (the flat buffer, the collective, the
    copy back), CUDA-event ms a call, and the buffer's bytes."""
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.parallel import mesh as parallel

    model = AudioToAlignText(**ASR_EN_BASE, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    for p in model.parameters():
        p.grad = torch.randn_like(p)
    n = sum(p.numel() for p in model.parameters())
    ms = time_ms(lambda: parallel.all_reduce_gradients(model.parameters()),
                 iters=DP_ALL_REDUCE_ITERS)
    return {"ms": ms, "bytes": 4 * n, "backend": torch.distributed.get_backend()}


def resident_bytes(state) -> dict:
    """The bytes a train state holds now, counted from its tensors'
    storages, each once: ``model``, every tensor its modules keep (the
    parameters, of which a tensor-parallel rank's sharded ones are freed
    between steps, the buffers, and weights derived from the parameters,
    such as the stacked biLSTM weights evaluation builds), with the
    shards its optimizer steps; ``optimizer``, every tensor of the
    optimizer's state."""
    def tensors(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            for v in x.values():
                yield from tensors(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                yield from tensors(v)

    def nbytes(ts):
        return sum({t.untyped_storage().data_ptr(): t.untyped_storage().nbytes()
                    for t in ts}.values())

    kept = [t for m in state.model.modules() for key, value in vars(m).items()
            if key != "_modules" for t in tensors(value)]
    return {"model": nbytes(kept + list(state.shards.leaves)),
            "optimizer": nbytes(tensors(list(state.optimizer.state.values())))}


def all_gather_step_ms(device) -> dict:
    """The weight all-gather of one asr_en_base step on a (1, 2) mesh of
    the process group this process has joined (``ParamShards.gather``: the
    flat buffer of the shards, the collective, the full tensors rebuilt),
    CUDA-event ms a call, and the bytes of the tensors it rebuilds."""
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.parallel import mesh as parallel

    model = AudioToAlignText(**ASR_EN_BASE, device=device,
                             generator=torch.Generator().manual_seed(SEED))
    shards = parallel.ParamShards(model, parallel.process_mesh(2, device))
    ms = time_ms(shards.gather, iters=DP_ALL_REDUCE_ITERS)
    return {"ms": ms, "bytes": sum(p.numel() * p.element_size()
                                   for p, d in zip(shards.params, shards.dims) if d is not None),
            "backend": torch.distributed.get_backend()}


def dp_rank_child(spec_path: str) -> None:
    """One rank of the two-rank gloo fits (``python3 chip_smoke.py --dp-rank
    SPEC``): the CLI's ``fit`` for each of the spec's ``fits`` in turn
    (each with this rank's arguments, under deterministic algorithms where
    it says so), with its launch and collective counts and what the rank
    keeps between steps (the most :func:`resident_bytes` counts after any
    step);
    then the gradient all-reduce and the (1, 2) weight all-gather of a
    step timed over a second group of the same two ranks; written to the
    spec's ``out``."""
    from voice100_tpu_torch.parallel import mesh as parallel
    from voice100_tpu_torch.training import trainer as trainer_mod
    from voice100_tpu_torch.training.cli import main

    with open(spec_path) as f:
        spec = json.load(f)
    held = {}
    train_step = trainer_mod.Trainer.train_step

    def counted_step(self, task, state, *args, **kwargs):
        out = train_step(self, task, state, *args, **kwargs)
        for key, value in resident_bytes(state).items():
            held[key] = max(held.get(key, 0), value)
        return out

    trainer_mod.Trainer.train_step = counted_step
    counters = cli_counters()
    result = {"fits": {}}
    for fit in spec["fits"]:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        collectives = dict(parallel.collective_counts)
        held.clear()
        start = time.perf_counter()
        with deterministic_algorithms(fit["deterministic"]):
            main(fit["argv"])
            torch.cuda.synchronize()
        result["fits"][fit["name"]] = {
            "wall_s": time.perf_counter() - start,
            "launches": {k: fn.launches for k, fn in counters.items()},
            "collectives": {k: v - collectives[k] for k, v in parallel.collective_counts.items()},
            "resident_bytes": dict(held)}
    trainer_mod.Trainer.train_step = train_step
    device = torch.device(spec["device"])
    parallel.init_distributed(spec["timing_address"], 2, spec["rank"], device=device,
                              backend="gloo")
    try:
        result["all_reduce"] = all_reduce_step_ms(device)
        result["all_gather"] = all_gather_step_ms(device)
    finally:
        parallel.shutdown_distributed()
    with open(spec["out"], "w") as f:
        json.dump(result, f)


def dp_fit(root, name):
    """A distributed-phase fit's results: rank 0's log (steps' and epochs'
    losses, train time by epoch, fit_start) and last.pt's weights and
    Adam first moments (the running mean of the all-reduced gradients)."""
    with open(os.path.join(root, f"{name}.jsonl")) as f:
        records = [json.loads(line) for line in f]
    epochs = [r for r in records if "train_time_s" in r]
    saved = torch.load(os.path.join(root, name, "last.pt"), map_location="cpu",
                       weights_only=True)
    return {"records": records,
            "losses": [r["train_loss"] for r in records
                       if "train_loss" in r and "train_time_s" not in r],
            "val": [r["val_loss"] for r in epochs],
            "train_time_s": [r["train_time_s"] for r in epochs],
            "start": next(r for r in records if r.get("event") == "fit_start"),
            "weights": saved["model"],
            "moments": torch.cat([state["exp_avg"].reshape(-1) for _, state in
                                  sorted(saved["optimizer"]["state"].items())]),
            "second_moments": torch.cat([state["exp_avg_sq"].reshape(-1) for _, state in
                                         sorted(saved["optimizer"]["state"].items())])}


def dp_compare(got, want) -> dict:
    """Two fits' losses (steps' and epochs' val) by the largest relative
    difference; their final weights against rtol DP_WEIGHT_RTOL / atol
    DP_WEIGHT_ATOL (the entries past it, and the largest Adam first moment
    among them beside the median one); their first moments by relative L2
    difference."""
    ours, theirs = got["losses"] + got["val"], want["losses"] + want["val"]
    diff = torch.cat([(got["weights"][k] - w).reshape(-1) for k, w in want["weights"].items()])
    w = torch.cat([w.reshape(-1) for w in want["weights"].values()])
    past = diff.abs() > DP_WEIGHT_ATOL + DP_WEIGHT_RTOL * w.abs()
    m = want["moments"]
    return {"loss_rel_err": max(abs(a - b) / abs(b) for a, b in zip(ours, theirs))
            if len(ours) == len(theirs) else float("inf"),
            "weight_max_abs_err": float(diff.abs().max()),
            "weights_past_bound": int(past.sum()), "weights": int(w.numel()),
            "past_bound_max_abs_moment": float(m[past].abs().max()) if past.any() else None,
            "median_abs_moment": float(m.abs().median()),
            "moment_rel_l2_err": float((got["moments"] - m).norm() / m.norm()),
            "bit_equal": ours == theirs and bool((diff == 0).all())}


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """torch's deterministic algorithms (and cuDNN's) inside, where ``on``."""
    if not on:
        yield
        return
    saved = (torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        with environ({"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}):
            yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[1:]


def dp_mesh_pipelines(device, card, workdir):
    """ASRPipeline and TTSPipeline over a mesh of one device, [cuda:0], at
    the serve and TTS phases' inputs, against the plain pipelines: the
    launches of one call each, and the results bit for bit. ASRPipeline
    also over a (1, 2) mesh naming cuda:0 twice: the model axis adds no
    work and changes nothing."""
    from voice100_tpu_torch.inference import ASRPipeline, TTSPipeline
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.parallel import make_mesh
    from voice100_tpu_torch.training.cli import load_model

    counters = cli_counters()
    card_device = (torch.device("cuda", torch.cuda.current_device()) if device.type == "cuda"
                   else device)
    mesh = make_mesh([card_device])
    mesh12 = make_mesh([card_device, card_device], data=1, model=2)

    def run(pipe, call):
        call(pipe)  # warm-up
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        out = call(pipe)
        torch.cuda.synchronize()
        return out, {k: fn.launches for k, fn in counters.items()}

    model = AudioToAlignText(**ASR_EN_BASE, device="cpu",
                             generator=torch.Generator().manual_seed(SEED))
    rng = np.random.default_rng(SEED)
    clips = int16_clips(rng, rng.uniform(2.0, 10.0, size=16))
    asr = {name: ASRPipeline(copy.deepcopy(model), batch_size=BATCH, **kw)
           for name, kw in (("plain", {"device": device}), ("mesh", {"mesh": mesh}),
                            ("mesh12", {"mesh": mesh12}))}
    results, launches = {}, {}
    for name, pipe in asr.items():
        results[name], launches[f"asr_{name}"] = run(pipe, lambda p: p.transcribe(clips))
    for name in ("mesh", "mesh12"):
        if (results[name] != results["plain"]
                or launches[f"asr_{name}"] != launches["asr_plain"]):
            fail(f"dp mesh: ASRPipeline over {asr[name].mesh} gave other transcripts or "
                 f"launches {launches}")
        for (_, wav, lens) in asr["plain"].batches(clips):
            if not all(torch.equal(a, b) for a, b in zip(asr[name]._decode(wav, lens),
                                                          asr["plain"]._decode(wav, lens))):
                fail(f"dp mesh: ASRPipeline over {asr[name].mesh} is not bit-equal to the "
                     f"plain call")
    paths = write_tts_checkpoints(os.path.join(workdir, "dp_tts"))
    tts = {name: TTSPipeline(load_model(*paths["align"], device=device),
                             load_model(*paths["audio"], device=device), use_phone=False, **kw)
           for name, kw in (("plain", {"device": device}), ("mesh", {"mesh": mesh}))}
    for name, pipe in tts.items():
        results[name], launches[f"tts_{name}"] = run(pipe, lambda p: p.synthesize(TTS_TEXTS))
    if (not all(map(np.array_equal, results["mesh"], results["plain"]))
            or launches["tts_mesh"] != launches["tts_plain"]):
        fail(f"dp mesh: TTSPipeline over [{device}] gave other waveforms or launches {launches}")
    print(f"dp mesh on {card}: ASRPipeline ({len(clips)} clips, batch {BATCH}) and TTSPipeline "
          f"({len(TTS_TEXTS)} texts) "
          f"over a mesh of [{device}], and ASRPipeline over {mesh12}, bit-equal to the plain "
          f"calls; launches {launches}", flush=True)
    return launches


def distributed_phase(device, card, workdir, align_args):
    """Data parallelism on the card (see the constants above), every fit
    in one collate bucket (DATA_SHELL_BUCKETS; ranks whose batches collate
    to other extents stop, as in the JAX trainer): (a) a one-rank NCCL
    group through ``fit --distributed`` against a plain ``fit`` (bit for bit
    under deterministic algorithms, equal launches, one gradient all-reduce
    a step); (b) two ranks on the one card over gloo at batch 32 against
    the plain fit at 64 (NCCL refuses two ranks on one GPU); (c) both
    pipelines over a mesh of one device. Returns the launches by path and a
    summary."""
    with environ(DATA_SHELL_BUCKETS):  # the rank processes inherit it
        return _distributed_phase(device, card, workdir, align_args)


def _distributed_phase(device, card, workdir, align_args):
    import yaml
    from voice100_tpu_torch.parallel import mesh as parallel
    from voice100_tpu_torch.training.cli import build_trainer_config, load_config, main

    root = os.path.join(workdir, "dp")
    os.makedirs(root)
    config = load_config(align_args["config"])
    config["trainer"].update(max_epochs=DP_EPOCHS, log_every_n_steps=1)
    config["data"]["init_args"]["valid_ratio"] = DP_VALID_RATIO
    batch = config["data"]["init_args"]["batch_size"]
    cfg = os.path.join(root, "asr_en_base_dp.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump(config, f)

    def fit_argv(name, extra=()):
        return ["fit", "--config", cfg, "--data_dir", align_args["data_dir"],
                "--cache_dir", os.path.join(workdir, "cli_cache"),
                "--checkpoint_dir", os.path.join(root, name),
                "--log_path", os.path.join(root, f"{name}.jsonl"), "--device", str(device),
                *extra]

    counters = cli_counters()
    runs = {}
    # the plain fit twice, the one-rank NCCL fit, then both again under
    # deterministic algorithms: the CTC backward's vocabulary scatter
    # (scatter_add_) and cuDNN's convolution backward add with atomics, so
    # two plain fits need not agree bit for bit
    for name, distributed, deterministic in (
            ("plain", False, False), ("plain_again", False, False), ("nccl1", True, False),
            ("plain_det", False, True), ("nccl1_det", True, True)):
        extra = ("--distributed", "--coordinator_address", f"localhost:{free_port()}",
                 "--num_processes", "1", "--process_id", "0") if distributed else ()
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        collectives = dict(parallel.collective_counts)
        start = time.perf_counter()
        with deterministic_algorithms(deterministic):
            main(fit_argv(name, extra))
            torch.cuda.synchronize()
        runs[name] = {"wall_s": time.perf_counter() - start,
                      "launches": {k: fn.launches for k, fn in counters.items()},
                      "collectives": {k: v - collectives[k]
                                      for k, v in parallel.collective_counts.items()},
                      **dp_fit(root, name)}
    if parallel.in_process_group():
        fail("dp: the CLI left its process group behind")
    layers = ASR_EN_BASE["decoder_num_layers"]
    steps = evals = DP_EPOCHS  # one train and one val batch of 64 an epoch
    want = {"log_mel": 0, "bilstm_recurrence": 2 * layers * evals, "viterbi_align": 0,
            "bilstm_train_fwd": layers * steps, "bilstm_train_bwd": 2 * layers * steps,
            "ctc_alpha": steps + evals, "ctc_adjoint": steps}
    for name, r in runs.items():
        grads = r["collectives"]["all_reduce_gradients"]
        if r["launches"] != want or grads != (steps if name.startswith("nccl") else 0) or (
                r["start"]["processes"], r["start"]["devices"]) != (1, 1):
            fail(f"dp {name} fit: launches {r['launches']}, collectives {r['collectives']}, "
                 f"fit_start {r['start']}; not {want} and one gradient all-reduce a step in "
                 f"the NCCL group")
    plain = runs["plain"]
    if len(plain["losses"]) != steps or not np.all(np.isfinite(plain["losses"])):
        fail(f"dp plain fit: losses {plain['losses']}")
    det, nccl_det = runs["plain_det"], runs["nccl1_det"]
    if (nccl_det["losses"] != det["losses"] or nccl_det["val"] != det["val"]
            or not all(torch.equal(nccl_det["weights"][k], det["weights"][k])
                       for k in det["weights"])):
        fail(f"dp: under deterministic algorithms the one-rank NCCL fit (losses "
             f"{nccl_det['losses']}, val {nccl_det['val']}) is not bit-equal to the plain fit "
             f"({det['losses']}, val {det['val']})")
    agreement = {name: dp_compare(runs[name], plain)
                 for name in ("plain_again", "nccl1", "plain_det")}
    for name, cmp in agreement.items():
        if not (cmp["loss_rel_err"] <= DP_LOSS_REL_TOL
                and cmp["moment_rel_l2_err"] <= DP_MOMENT_REL_TOL):
            fail(f"dp {name} fit against the plain fit: {cmp}")
    parallel.init_distributed(f"localhost:{free_port()}", 1, 0, device=device)
    try:
        nccl_ms = all_reduce_step_ms(device)
    finally:
        parallel.shutdown_distributed()

    # (b) two ranks on cuda:0 over gloo, batch 32 each: the data-parallel
    # fit, the (1, 2) tensor-parallel fit, then both under deterministic
    # algorithms, one after another in the same two processes
    config["data"]["init_args"]["batch_size"] = batch // 2
    cfg_half = os.path.join(root, "asr_en_base_dp_half.yaml")
    with open(cfg_half, "w") as f:
        yaml.safe_dump(config, f)
    fits = [(name, model_axis, deterministic, free_port())
            for name, model_axis, deterministic in (
                ("gloo2", 1, False), ("tp2", 2, False), ("gloo2_det", 1, True),
                ("tp2_det", 2, True))]
    timing_port = free_port()
    procs, outs = [], []
    for rank in range(2):
        specs = []
        for name, model_axis, deterministic, port in fits:
            argv = fit_argv(name, ("--distributed", "--dist_backend", "gloo",
                                   "--coordinator_address", f"localhost:{port}",
                                   "--num_processes", "2", "--process_id", str(rank),
                                   "--mesh_model_axis", str(model_axis)))
            argv[argv.index(cfg)] = cfg_half
            specs.append({"name": name, "argv": argv, "deterministic": deterministic})
        # each rank on cuda:{rank % device_count}: both on the one card
        rank_device = (f"cuda:{rank % torch.cuda.device_count()}" if device.type == "cuda"
                       else str(device))
        spec = {"fits": specs, "rank": rank, "timing_address": f"localhost:{timing_port}",
                "device": rank_device, "out": os.path.join(root, f"gloo2_rank{rank}.json")}
        path = os.path.join(root, f"gloo2_rank{rank}_spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        outs.append(spec["out"])
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank",
                                       path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    start = time.perf_counter()
    texts = []
    try:
        for p in procs:
            texts.append(p.communicate(timeout=DP_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    gloo_wall = time.perf_counter() - start
    for rank, (p, text) in enumerate(zip(procs, texts)):
        if p.returncode != 0:
            fail(f"dp gloo rank {rank} exited {p.returncode}:\n{text[-6000:]}")
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    two = {name: dp_fit(root, name) for name, *_ in fits}
    # the checkpoints a fit writes: last.pt an epoch, best.pt where the
    # monitored val loss improves, epoch_N.pt every every_n_epochs
    tc = build_trainer_config(config, {})
    if tc.monitor != "val_loss" or not tc.save_last:
        fail(f"dp: the phase counts checkpoints of a val_loss monitor with save_last; the "
             f"config has {tc.monitor}, save_last {tc.save_last}")
    for name, model_axis, _, _ in fits:
        vals = two[name]["val"]
        saves = (DP_EPOCHS + sum(v < min([float("inf")] + vals[:e]) for e, v in enumerate(vals))
                 + sum((e + 1) % tc.every_n_epochs == 0 for e in range(DP_EPOCHS)))
        gathers = steps + DP_EPOCHS + saves if model_axis > 1 else 0
        for rank, r in enumerate(ranks):
            got = r["fits"][name]
            if (got["launches"] != want or got["collectives"]["all_reduce_gradients"] != steps
                    or got["collectives"]["all_gather_params"] != gathers):
                fail(f"dp {name} rank {rank}: launches {got['launches']}, collectives "
                     f"{got['collectives']}, not {want}, one gradient all-reduce a step and "
                     f"{gathers} weight all-gathers (a step, an epoch's tail, a checkpoint)")
        start_record = two[name]["start"]
        if (len(two[name]["losses"]) != steps or (start_record["processes"],
                                                  start_record["devices"]) != (2, 2)
                or start_record["mesh"] != {"data": 2 // model_axis, "model": model_axis}):
            fail(f"dp {name}: losses {two[name]['losses']}, fit_start {start_record}")
    for name in ("gloo2", "tp2"):
        agreement[name] = dp_compare(two[name], plain)
        if not (agreement[name]["loss_rel_err"] <= DP_LOSS_REL_TOL
                and agreement[name]["moment_rel_l2_err"] <= DP_MOMENT_REL_TOL):
            fail(f"dp {name}: losses {two[name]['losses']} / val {two[name]['val']} against one "
                 f"process's {plain['losses']} / {plain['val']}: {agreement[name]}")
    # tensor parallelism: the same gradient, norm and elementwise Adam update
    # as data parallelism over the same two ranks, so bit for bit its run
    # under deterministic algorithms
    tp_det, dp_det = two["tp2_det"], two["gloo2_det"]
    if not (tp_det["losses"] == dp_det["losses"] and tp_det["val"] == dp_det["val"]
            and all(torch.equal(tp_det["weights"][k], dp_det["weights"][k])
                    for k in dp_det["weights"])
            and torch.equal(tp_det["moments"], dp_det["moments"])
            and torch.equal(tp_det["second_moments"], dp_det["second_moments"])):
        fail(f"tp: under deterministic algorithms the (1, 2) fit (losses {tp_det['losses']}, "
             f"val {tp_det['val']}) is not bit-equal to the 2-rank data-parallel fit "
             f"({dp_det['losses']}, val {dp_det['val']}) in losses, weights and Adam moments")
    resident = {name: [r["fits"][name]["resident_bytes"] for r in ranks]
                for name in ("gloo2", "tp2")}
    for rank in range(2):
        dp_bytes, tp_bytes = resident["gloo2"][rank], resident["tp2"][rank]
        if not all(0 < tp_bytes[k] <= TP_RESIDENT_SHARE * dp_bytes[k]
                   for k in ("model", "optimizer")):
            fail(f"tp rank {rank} keeps {tp_bytes} bytes between steps against the data-parallel "
                 f"rank's {dp_bytes}: not the shards alone")

    mesh_launches = dp_mesh_pipelines(device, card, root)
    runs.update(two)
    summary = {
        "card": card, "epochs": DP_EPOCHS, "steps": steps, "global_batch": batch,
        "losses": {name: r["losses"] for name, r in runs.items()},
        "val_losses": {name: r["val"] for name, r in runs.items()},
        "against_plain": agreement,
        "all_reduce_ms_per_step": {"nccl1": nccl_ms, "gloo2": [r["all_reduce"] for r in ranks]},
        "tp2_all_gather_ms_per_step": [r["all_gather"] for r in ranks],
        "resident_bytes_between_steps": resident,
        "train_time_s_by_epoch": {name: r["train_time_s"] for name, r in runs.items()},
        "fit_wall_s": {**{name: r["wall_s"] for name, r in runs.items() if "wall_s" in r},
                       **{f"{name}_ranks": [r["fits"][name]["wall_s"] for r in ranks]
                          for name, *_ in fits},
                       "gloo2_with_start": gloo_wall},
    }
    print(f"dp on {card}: one-rank NCCL fit bit-equal to the plain fit under deterministic "
          f"algorithms ({steps} steps at batch {batch}, losses {det['losses']}); without them, "
          f"against the plain fit: " + ", ".join(
              f"{name} losses within {c['loss_rel_err']:.2e} relative, weights within "
              f"{c['weight_max_abs_err']:.2e} abs ({c['weights_past_bound']} of {c['weights']} "
              f"past rtol {DP_WEIGHT_RTOL:.0e} / atol {DP_WEIGHT_ATOL:.0e}), Adam first moments "
              f"within {c['moment_rel_l2_err']:.2e} relative L2" for name, c in agreement.items())
          + f" (two gloo ranks on {rank_device} at batch {batch // 2}); all-reduce a step NCCL "
          f"{nccl_ms['ms']:.4f} ms, gloo {[round(r['all_reduce']['ms'], 4) for r in ranks]} ms "
          f"({nccl_ms['bytes']} bytes); train time by epoch "
          f"{summary['train_time_s_by_epoch']}", flush=True)
    print(f"tp on {card}: the (1, 2) fit of two gloo ranks on {rank_device} bit-equal to the "
          f"2-rank data-parallel fit under deterministic algorithms (losses {tp_det['losses']}, "
          f"val {tp_det['val']}, last.pt weights and both Adam moments); bytes a rank keeps "
          f"between steps (the most after any step), model / Adam state: " + ", ".join(
              f"rank {i} {resident['tp2'][i]['model']} / {resident['tp2'][i]['optimizer']} "
              f"(data-parallel {resident['gloo2'][i]['model']} / "
              f"{resident['gloo2'][i]['optimizer']})" for i in range(2))
          + "; a step's weight all-gather " + ", ".join(
              f"{r['all_gather']['ms']:.4f} ms" for r in ranks)
          + f" ({ranks[0]['all_gather']['bytes']} bytes rebuilt) beside its gradient all-reduce "
          + ", ".join(f"{r['all_reduce']['ms']:.4f} ms" for r in ranks), flush=True)
    paths = {"dp_plain_fit": runs["plain"]["launches"], "dp_nccl1_fit": runs["nccl1"]["launches"],
             **{f"dp_{name}_rank{i}": r["fits"][name]["launches"]
                for name in ("gloo2", "tp2") for i, r in enumerate(ranks)},
             **{f"dp_mesh_{k}": v for k, v in mesh_launches.items() if "mesh" in k}}
    return paths, summary


# -- the v1 model family (ROADMAP item 9) ------------------------------------


def check_v1_kernels(device):
    """Kernels 1, 2 and 3 at AudioAlignCTC's shapes (B=32, T'=501, H=128,
    input 128, seeded ragged lengths with T' and 1) against their plain
    versions, timed with cuDNN: the cooperative launches at 2 H / 8 = 32
    blocks. Returns the three kernel lines."""
    lengths = train_lengths(np.random.default_rng(SEED + 40), V1_T, V1_BATCH)
    k1 = check_bilstm(device, V1_BATCH, V1_T, [int(n) for n in lengths], hidden=V1_H,
                      input_size=V1_H)
    k2, k3 = check_lstm_train(device, V1_BATCH, V1_T, V1_H, V1_H, lengths)
    return {"bilstm_recurrence": k1, "bilstm_train_fwd": k2, "bilstm_train_bwd": k3}


@contextlib.contextmanager
def v1_no_draws(model):
    """Augmentation and dropout off for a v1 model's card-against-CPU
    steps (the two sides' generators draw other numbers), its BatchNorms
    still on the batch's statistics in training mode."""
    from voice100_tpu_torch.models import align_v1, asr_v1

    saved = [(m, m.draw_augment, m.apply_augment) for m in (asr_v1, align_v1)]
    for m in (asr_v1, align_v1):
        m.draw_augment = lambda *shape: None
        m.apply_augment = lambda audio, audio_len, draws: (audio, audio_len)
    drops = [m for m in model.modules() if isinstance(m, torch.nn.Dropout)]
    rates = [m.p for m in drops]
    lstm = getattr(model, "lstm", None)
    lstm_rate = lstm.dropout if lstm is not None else None
    for m in drops:
        m.p = 0.0
    if lstm is not None:
        lstm.dropout = 0.0
    try:
        yield
    finally:
        for m, draw, apply in saved:
            m.draw_augment, m.apply_augment = draw, apply
        for m, p in zip(drops, rates):
            m.p = p
        if lstm is not None:
            lstm.dropout = lstm_rate


def v1_rows(batch, rows=PARITY_BATCH):
    return tuple(tuple(np.asarray(a)[:rows] for a in group) for group in batch)


def v1_outputs(model, batch):
    """The model's raw outputs in evaluation mode on ``batch``'s inputs:
    logits, log-durations, or the WORLD streams (normalized) and phone
    logits; CPU float32 tensors."""
    from voice100_tpu_torch.training import make_task

    args = make_task(model).upload(batch)
    name = type(model).__name__
    model.eval()
    with torch.no_grad():
        if name == "AudioAlignCTC":
            out = model(args[0], args[1])[:1]
        elif name.startswith("AlignTextToAudio"):
            out = model(args[4])
        else:  # AudioToTextCTC on audio, TextToAlignTextModel on text
            out = (model(args[0]),)
    return [t.float().cpu() for t in out]


def fmt_list(values) -> str:
    return "[" + ", ".join(f"{v:.3e}" for v in values) + "]"


def v1_rel(got, want, scale: float = 0.0) -> float:
    """``||got - want||`` over ``max(||want||, scale)``."""
    return ((got - want).norm() / max(want.norm().item(), scale, 1e-30)).item()


def v1_float64_grads(model, rows):
    """The gradients of a training-mode loss of a float64 copy of
    ``model`` on ``rows`` (augmentation and dropout off), on the CPU,
    clipped as Trainer.train_step clips them (global norm 1.0)."""
    from voice100_tpu_torch.training import make_task
    from voice100_tpu_torch.training.trainer import clip_by_global_norm

    m64 = copy.deepcopy(model).double()
    rows64 = tuple(tuple(a.astype(np.float64) if a.dtype.kind == "f" else a for a in group)
                   for group in rows)
    with v1_no_draws(m64):
        loss, _ = make_task(m64).loss(rows64, train=True)
    loss.backward()
    clip_by_global_norm(m64.parameters(), 1.0)
    return {n: p.grad.detach().float() for n, p in m64.named_parameters()}


def v1_parity(device, name, cpu_model, batch, steps_per_epoch=1):
    """PARITY_STEPS train steps (Trainer.train_step, training mode, the
    BatchNorms on batch statistics) of a v1 model on the first
    V1_PARITY_ROWS rows of ``batch``, augmentation and dropout off, on
    the card and on the CPU's plain path, in lockstep: before each step
    the CPU side takes the card's weights, running averages and Adam
    state, so each step is compared from one state. BatchNorm makes some
    directions of the loss flat (a bias a later BatchNorm absorbs, a scale
    ReLU6 and a depthwise conv carry to the next BatchNorm), their
    gradients are round-off on both sides, and Adam turns those into
    steps of up to lr either way: run free, the two trajectories part,
    though each step agrees. Each step: the loss and the rate; each
    gradient tensor and running average by ``||card - cpu||`` over the
    larger of its norm and 1e-3 of the largest (a flat direction's
    round-off sits under that floor). A model with BatchNorms also takes
    each step in float64 on the CPU from the same state: its gradients'
    bound is the larger of PARITY_GRAD_TOL and V1_CONDITIONING times what
    float32 costs that step (the CPU's float32 gradients against the
    float64 ones; a BatchNorm model at full width loses up to 5e-3
    there), and the card's are held to the float64 ones within the same
    bound. The running averages within PARITY_GRAD_TOL; then the
    evaluation-mode outputs within V1_PREDICT_TOL."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    rows = v1_rows(batch, V1_PARITY_ROWS)
    models = (copy.deepcopy(cpu_model).to(device), cpu_model)
    batchnorm = any("running" in n for n, _ in cpu_model.named_buffers())
    trainers = [Trainer(TrainerConfig(gradient_clip_val=1.0)) for _ in models]
    tasks = [make_task(m) for m in models]
    states = [TrainState(m, t.make_optimizer(steps_per_epoch)) for m, t in zip(models, tasks)]
    seconds = [0.0, 0.0]
    record = {"losses": [], "loss_rel_err": 0.0, "grad_rel_err": 0.0, "stats_rel_err": 0.0,
              "lrs": [], "float32_cost": [], "card_vs_float64": [], "grad_tol": []}
    for _ in range(PARITY_STEPS):
        models[1].load_state_dict(models[0].state_dict())
        states[1].optimizer.load_state_dict(states[0].optimizer.state_dict())
        states[1].step = states[0].step
        g64 = v1_float64_grads(models[1], rows) if batchnorm else None
        sides = []
        for i, (model, trainer, task, state) in enumerate(zip(models, trainers, tasks, states)):
            start = time.perf_counter()
            with v1_no_draws(model):
                loss = float(trainer.train_step(task, state, rows, train=True)["loss"])
            grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
            stats = {n: b.detach().cpu() for n, b in model.named_buffers() if "running" in n}
            seconds[i] += time.perf_counter() - start
            sides.append((loss, grads, stats, state.optimizer.param_groups[0]["lr"]))
        (loss, grads, stats, lr), (cpu_loss, cpu_grads, cpu_stats, cpu_lr) = sides
        top = max(g.norm().item() for g in cpu_grads.values())
        grad_tol, card64 = PARITY_GRAD_TOL, 0.0
        if g64 is not None:
            top64 = max(g.norm().item() for g in g64.values())
            cost = max(v1_rel(cpu_grads[n], g, 1e-3 * top64) for n, g in g64.items())
            card64 = max(v1_rel(grads[n], g, 1e-3 * top64) for n, g in g64.items())
            grad_tol = max(PARITY_GRAD_TOL, V1_CONDITIONING * cost)
            record["float32_cost"].append(cost)
            record["card_vs_float64"].append(card64)
        record["grad_tol"].append(grad_tol)
        top_stats = max((b.norm().item() for b in cpu_stats.values()), default=0.0)
        record["losses"].append([loss, cpu_loss])
        record["lrs"].append(lr)
        record["loss_rel_err"] = max(record["loss_rel_err"], abs(loss - cpu_loss) / abs(cpu_loss))
        grad_err = max(v1_rel(grads[n], g, 1e-3 * top) for n, g in cpu_grads.items())
        record["grad_rel_err"] = max(record["grad_rel_err"], grad_err)
        if not (grad_err <= grad_tol and card64 <= grad_tol):
            fail(f"v1 train parity {name}: step {states[0].step}: gradients differ by "
                 f"{grad_err:.3e} (from float64 {card64:.3e}; tol {grad_tol:.3e})")
        record["stats_rel_err"] = max(record["stats_rel_err"], max(
            (v1_rel(stats[n], b, 1e-3 * top_stats) for n, b in cpu_stats.items()), default=0.0))
        if lr != cpu_lr:
            fail(f"v1 train parity {name}: rates {lr} vs {cpu_lr}")
    models[1].load_state_dict(models[0].state_dict())
    outs = [v1_outputs(m, rows) for m in models]
    record["eval_max_abs_err"] = max((a - b).abs().max().item() for a, b in zip(*outs))
    record["card_s"], record["cpu_s"] = seconds
    print(f"v1 train parity {name}, card vs CPU plain path ({V1_PARITY_ROWS} rows, "
          f"{PARITY_STEPS} steps in lockstep, augmentation and dropout off, BatchNorms on "
          f"batch statistics): losses [card, CPU] {record['losses']}, max rel err "
          f"{record['loss_rel_err']:.3e} (tol {PARITY_LOSS_TOL:.0e}); gradients max rel err "
          f"{record['grad_rel_err']:.3e} over {len(cpu_grads)} tensors (tol by step "
          f"{fmt_list(record['grad_tol'])}; float64 against the CPU's float32 "
          f"{fmt_list(record['float32_cost'])}, the card's "
          f"{fmt_list(record['card_vs_float64'])}), running averages "
          f"{record['stats_rel_err']:.3e} over {len(cpu_stats)} (tol {PARITY_GRAD_TOL:.0e}), "
          f"each over the larger of its norm and "
          f"1e-3 of the largest; rates {record['lrs']}; "
          f"evaluation outputs max_abs_err {record['eval_max_abs_err']:.3e} (tol "
          f"{V1_PREDICT_TOL:.0e}); card {seconds[0]:.2f} s, CPU {seconds[1]:.2f} s", flush=True)
    if not all(np.isfinite(loss) for loss, _ in record["losses"]) or \
            not record["loss_rel_err"] <= PARITY_LOSS_TOL:
        fail(f"v1 train parity {name}: losses [card, CPU] {record['losses']}")
    if not record["stats_rel_err"] <= PARITY_GRAD_TOL:
        fail(f"v1 train parity {name}: running averages differ by "
             f"{record['stats_rel_err']:.3e}")
    if not record["eval_max_abs_err"] <= V1_PREDICT_TOL:
        fail(f"v1 parity {name}: evaluation outputs differ by {record['eval_max_abs_err']:.3e}")
    return record


def v1_steps(device, card, name, model, batch, want, steps_per_epoch=1):
    """1 + V1_TIMED_STEPS train steps of a v1 model on a batch of V1_BATCH,
    augmentation and dropout on, the launch counts set to 0 just before
    the timed steps and read just after, against ``want`` a step."""
    from voice100_tpu_torch.training import Trainer, TrainerConfig, TrainState, make_task

    trainer = Trainer(TrainerConfig(gradient_clip_val=1.0))
    task = make_task(model)
    state = TrainState(model, task.make_optimizer(steps_per_epoch))
    gen = torch.Generator(device=device).manual_seed(SEED)
    placed = tuple(tuple(torch.as_tensor(np.asarray(a)).to(device) for a in group)
                   for group in batch)
    counters = cli_counters()
    trainer.train_step(task, state, placed, gen)  # warm-up
    zero_counts(counters)
    losses, step_ms = [], []
    for _ in range(V1_TIMED_STEPS):
        start = time.perf_counter()
        losses.append(float(trainer.train_step(task, state, placed, gen)["loss"]))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    launches = read_counts(counters)
    expected = {k: want.get(k, 0) * V1_TIMED_STEPS for k in counters}
    median = float(np.median(step_ms))
    print(f"v1 train {name}: batch {V1_BATCH} {[list(np.asarray(a).shape) for a in batch[0]]}, "
          f"augmentation and dropout on; losses {[round(v, 4) for v in losses]}; step median "
          f"{median:.2f} ms (min {min(step_ms):.2f}, max {max(step_ms):.2f}) on {card}; "
          f"launches over {V1_TIMED_STEPS} steps {launches}", flush=True)
    if not all(np.isfinite(losses)):
        fail(f"v1 train {name}: non-finite loss {losses}")
    if launches != expected:
        fail(f"v1 train {name}: launches {launches}, not {expected}")
    return {"step_ms": median, "step_ms_all": step_ms, "losses": losses}, launches


def v1_batch(data, stage="fit"):
    """The first batch of a data module's train (or predict) loader, all
    its rows real."""
    data.setup(stage)
    loader = data.train_dataloader() if stage == "fit" else data.predict_dataloader()
    batch, n_real = next(loader.iter_with_counts())
    if n_real != V1_BATCH:
        fail(f"v1: a {type(data).__name__} batch has {n_real} real rows, not {V1_BATCH}")
    return batch


def v1_best_path(device, model, cpu_model, batch):
    """AudioAlignCTC.ctc_best_path on one predict batch of V1_BATCH on the
    card (kernel 1 once a layer, one Viterbi launch, nothing else), its
    result bit-equal to the plain Viterbi on the card's own log-probs; then
    the first PARITY_BATCH rows on the card and on the CPU: log-probs,
    scores and paths."""
    from voice100_tpu_torch.ops.ctc import ctc_viterbi_align
    from voice100_tpu_torch.tools.align_text import upload_batch

    counters = cli_counters()
    audio, audio_len, text, text_len = upload_batch(batch, device)
    model.eval()
    with torch.inference_mode():
        model.ctc_best_path(audio, audio_len, text, text_len)  # warm-up
        zero_counts(counters)
        res, logits_len = model.ctc_best_path(audio, audio_len, text, text_len)
        launches = read_counts(counters)
        log_probs = torch.log_softmax(model(audio, audio_len)[0], dim=-1)
        ref = ctc_viterbi_align(log_probs, text, logits_len, torch.minimum(logits_len, text_len))
    want = {k: 0 for k in counters}
    want.update(bilstm_recurrence=V1_ALIGN["num_layers"], viterbi_align=1)
    if launches != want:
        fail(f"v1 align ctc_best_path: launches {launches}, not {want}")
    if not (torch.equal(res.labels, ref.labels) and torch.equal(res.path, ref.path)
            and torch.equal(res.score, ref.score)):
        fail("v1 align ctc_best_path: the Viterbi launch differs from the plain Viterbi on the "
             "same log-probs")
    sides = []
    for m, where in ((model, device), (cpu_model.eval(), "cpu")):
        args = upload_batch(v1_rows(batch), where)
        with torch.inference_mode():
            lp = torch.log_softmax(m(args[0], args[1])[0], dim=-1).cpu()
            r, n = m.ctc_best_path(*args)
        sides.append((lp, n.cpu(), r.score.cpu(), r.path.cpu()))
    (lp, n, score, path), (lp_c, n_c, score_c, path_c) = sides
    valid = torch.arange(lp.shape[1])[None, :] < n[:, None]
    lp_err = (lp - lp_c).abs()[valid].max().item()
    score_err = ((score - score_c).abs() / score_c.abs()).max().item()
    agree = (path == path_c)[valid].float().mean().item()
    print(f"v1 align ctc_best_path: batch {V1_BATCH} on the card, launches {launches}, labels, "
          f"paths and scores equal to the plain Viterbi on the card's log-probs; card vs CPU "
          f"({PARITY_BATCH} rows): log-probs max_abs_err {lp_err:.3e} (tol {LOGIT_TOL:.0e}), "
          f"scores max rel err {score_err:.3e} (tol {ALIGN_SCORE_REL_TOL:.0e}), paths equal on "
          f"{agree:.4%} of frames (min {ALIGN_PATH_AGREEMENT:.0%})", flush=True)
    if not (torch.equal(n, n_c) and lp_err <= LOGIT_TOL and score_err <= ALIGN_SCORE_REL_TOL
            and agree >= ALIGN_PATH_AGREEMENT):
        fail(f"v1 align ctc_best_path: card vs CPU log-probs {lp_err:.3e}, scores "
             f"{score_err:.3e}, paths {agree:.4%}")
    return {"log_probs_max_abs_err": lp_err, "score_max_rel_err": score_err,
            "path_agreement": agree}, launches


def write_phone_align(data_dir):
    """The multi-task model's targets beside a corpus's align file: for each
    line of ``dummy_en-align-train.txt``, as many seeded English phones
    (the phone tokenizer's vocabulary, "/"-joined) as the aligned text has
    characters, in ``dummy_en-phone-align-train.txt`` (the content does not
    matter to a training step)."""
    from voice100_tpu_torch.text import get_tokenizer

    phones = [p for p in get_tokenizer("en", True)._vocab if p != "_"]
    rng = np.random.default_rng(SEED + 41)
    out = []
    with open(os.path.join(data_dir, "dummy_en-align-train.txt"), encoding="utf-8") as f:
        for line in f:
            text, aligntext, counts = line.rstrip("\n").split("|")
            out.append(f"{text}|{'/'.join(rng.choice(phones, size=len(aligntext)))}|{counts}\n")
    with open(os.path.join(data_dir, "dummy_en-phone-align-train.txt"), "w",
              encoding="utf-8") as f:
        f.writelines(out)


def v1_config(path, class_path, init_args, data):
    """A unified-CLI config of a v1 model (the train-v1 CLI's settings)."""
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump({"seed_everything": 1234, "trainer": {"max_epochs": 1},
                        "model": {"class_path": f"voice100.models.{class_path}",
                                  "init_args": init_args},
                        "data": data}, f)
    return path


def v1_cli_phase(device, card, workdir, align_args, tts_dir, tts_cache, stat_path, samples):
    """The five train-v1 CLIs, one epoch each at their batch of 32 on the
    corpora on disk (the align corpus for asr and align, the voiced TTS
    corpus for the rest; the feature caches warm); each writes last.pt,
    and the unified CLI's validate on it gives the epoch's val_loss (1e-5
    relative). The align model's last.pt aligns the align corpus through
    the align CLI; the TTS models' predict writes 2 * aligntext_len frames
    a clip. Launch counts set to 0 just before each command, read just
    after."""
    from voice100_tpu_torch.tools import train_v1
    from voice100_tpu_torch.tools.align_text import cli_main as align_main
    from voice100_tpu_torch.training.cli import main as cli

    root = os.path.join(workdir, "v1")
    os.makedirs(root, exist_ok=True)
    mel = {"vocoder": "mel", "dataset": "dummy_en", "language": "en", "batch_size": V1_BATCH}
    world = {"vocoder": "world", "dataset": "dummy_en", "language": "en", "use_align": True,
             "batch_size": V1_BATCH}
    audio_module = "voice100.data_modules.AudioTextDataModule"
    runs = [
        ("asr", train_v1.asr_cli_main, "AudioToTextCTC", V1_ASR, (audio_module, mel),
         align_args, ["--embed_size", str(V1_ASR["embed_size"])]),
        ("align", train_v1.align_cli_main, "AudioAlignCTC", V1_ALIGN, (audio_module, mel),
         align_args, []),
        ("ttsalign", train_v1.ttsalign_cli_main, "TextToAlignTextModel", V1_TTS_ALIGN,
         ("voice100.data_modules.AlignTextDataModule",
          {"dataset": "dummy_en", "language": "en", "batch_size": V1_BATCH}),
         {"data_dir": tts_dir, "cache_dir": tts_cache}, []),
        ("ttsaudio", train_v1.ttsaudio_cli_main, "AlignTextToAudioModel", V1_TTS_AUDIO,
         (audio_module, world), {"data_dir": tts_dir, "cache_dir": tts_cache},
         ["--audio_stat", stat_path]),
        ("ttsaudio-mt", train_v1.ttsaudio_mt_cli_main, "AlignTextToAudioMultiTaskModel",
         V1_TTS_MT, (audio_module, dict(world, use_target=True)),
         {"data_dir": tts_dir, "cache_dir": tts_cache}, ["--audio_stat", stat_path]),
    ]
    counters = cli_counters()
    out, by_path = {}, {}
    for name, fit_main, cls, init_args, (data_cls, data_args), dirs, extra in runs:
        ckpt_dir = os.path.join(root, name)
        argv = ["--dataset", "dummy_en", "--data_dir", dirs["data_dir"], "--cache_dir",
                dirs["cache_dir"], "--batch_size", str(V1_BATCH), "--max_epochs", "1",
                "--hidden_size", str(init_args["hidden_size"]), "--checkpoint_dir", ckpt_dir,
                "--device", str(device), *extra]
        zero_counts(counters)
        start = time.perf_counter()
        fit_main(argv)
        fit_s = time.perf_counter() - start
        fit_launches = read_counts(counters)
        last = os.path.join(ckpt_dir, "last.pt")
        saved = torch.load(last, map_location="cpu", weights_only=True)
        val_loss, steps = float(saved["best_monitor"]), int(saved["step"])
        config = v1_config(os.path.join(root, f"{name}.yaml"), cls, init_args,
                           {"class_path": data_cls, "init_args": data_args})
        common = ["--config", config, "--restore_from", last, "--data_dir", dirs["data_dir"],
                  "--cache_dir", dirs["cache_dir"], "--device", str(device)]
        zero_counts(counters)
        metrics = cli(["validate", *common])
        validate_launches = read_counts(counters)
        err = abs(metrics["loss"] - val_loss) / abs(val_loss)
        layers = V1_ALIGN["num_layers"]
        evals = 1  # the 10% val split of either corpus is one batch of 32
        want_fit = {k: 0 for k in counters}
        want_validate = dict(want_fit)
        if name in ("asr", "align"):
            want_fit.update(ctc_alpha=steps + evals, ctc_adjoint=steps)
            want_validate.update(ctc_alpha=evals)
        if name == "align":
            want_fit.update(bilstm_train_fwd=layers * steps, bilstm_train_bwd=2 * layers * steps,
                            bilstm_recurrence=layers * evals)
            want_validate.update(bilstm_recurrence=layers * evals)
        record = {"fit_s": fit_s, "steps": steps, "val_loss": val_loss,
                  "validate_loss": metrics["loss"], "validate_rel_err": err,
                  "fit_launches": fit_launches, "validate_launches": validate_launches}
        if name == "align":
            out_path = os.path.join(root, "align-v1-align.txt")
            zero_counts(counters)
            align_main(["--config", config, "--checkpoint", last, "--data_dir",
                        dirs["data_dir"], "--cache_dir", dirs["cache_dir"], "--output", out_path,
                        "--device", str(device)])
            record["align_launches"] = read_counts(counters)
            with open(os.path.join(dirs["data_dir"], "dummy_en-train.txt"),
                      encoding="utf-8") as f:
                texts = [line.rstrip("\n").split("|")[1] for line in f]
            batches = -(-len(texts) // V1_BATCH)
            want_align = dict(want_validate, ctc_alpha=0, bilstm_recurrence=layers * batches,
                              viterbi_align=batches)
            check_align_lines(out_path, texts, samples)
            if record["align_launches"] != want_align:
                fail(f"v1 align CLI with AudioAlignCTC: launches {record['align_launches']}, not "
                     f"{want_align}")
            by_path["v1_cli_align_text"] = record["align_launches"]
        if name.startswith("tts"):
            predict_path = os.path.join(root, f"{name}-predict")
            cli(["predict", *common, "--output", predict_path])
            with np.load(predict_path + ".npz", allow_pickle=True) as f:
                rows = {k: f[k] for k in f.files}
            record["predict_rows"] = {k: len(v) for k, v in rows.items()}
            if not all(len(v) == len(rows[next(iter(rows))]) > 0 for v in rows.values()):
                fail(f"v1 {name} predict: rows {record['predict_rows']}")
            if name != "ttsalign":
                record["predict_frames_first"] = int(rows["f0"][0].shape[0])
        print(f"v1 cli {name} on {card}: fit 1 epoch ({steps} steps at batch {V1_BATCH}) "
              f"{fit_s:.2f} s, launches {fit_launches}; validate on last.pt val_loss "
              f"{metrics['loss']:.6f} against the epoch's {val_loss:.6f} (rel err {err:.2e}, "
              f"tol {CLI_VAL_REL_TOL:.0e}), launches {validate_launches}", flush=True)
        if fit_launches != want_fit or validate_launches != want_validate:
            fail(f"v1 cli {name}: launches fit {fit_launches} / validate {validate_launches}, "
                 f"not {want_fit} / {want_validate}")
        if not (np.isfinite(val_loss) and err <= CLI_VAL_REL_TOL):
            fail(f"v1 cli {name}: validate gave {metrics['loss']} against the fit's {val_loss}")
        out[name] = record
        by_path[f"v1_cli_{name}_fit"] = fit_launches
        by_path[f"v1_cli_{name}_validate"] = validate_launches
    return out, by_path


def v1_phase(device, card, workdir, align_args, samples):
    """The v1 family on the card at full width with seeded weights: (b)
    AudioAlignCTC (H=128) and (c) AudioToTextCTC on the align corpus, (d)
    the three v1 TTS models on the voiced TTS corpus, each timed at batch
    32 with exact launches and held 3 steps to the CPU path; (e) the five
    train-v1 CLIs. Kernels 1-3 at H=128 are checked early in the run
    (check_v1_kernels). Returns the launches by path and a summary."""
    from voice100_tpu_torch.data import AlignTextDataModule, AudioTextDataModule
    from voice100_tpu_torch.models import (AlignTextToAudioModel, AlignTextToAudioMultiTaskModel,
                                           AudioAlignCTC, AudioToTextCTC, TextToAlignTextModel)
    from voice100_tpu_torch.training import merge_world_stats

    from voice100_tpu_torch.tools.calc_stat import cli_main as stat_main

    start = time.perf_counter()
    tts_dir = os.path.join(workdir, "tts_data")
    tts_cache = os.path.join(workdir, "tts_world_cache")
    # the v1 acoustic models' "world" vocoder: 257 spectral bins, from the
    # warm (mel-cepstrum) WORLD cache of the TTS training phase
    stat_path = os.path.join(workdir, "dummy_en-world-stat.npz")
    stat_main(["--output", stat_path, "--dataset", "dummy_en", "--vocoder", "world",
               "--data_dir", tts_dir, "--cache_dir", tts_cache, "--device", str(device)])
    write_phone_align(tts_dir)
    mel = AudioTextDataModule(vocoder="mel", dataset="dummy_en", data_dir=align_args["data_dir"],
                              cache_dir=align_args["cache_dir"], batch_size=V1_BATCH,
                              device=device)
    mel_batch = v1_batch(mel)
    predict_batch = v1_batch(mel, "predict")
    text_batch = v1_batch(AlignTextDataModule(data_dir=tts_dir, dataset="dummy_en",
                                              batch_size=V1_BATCH))
    world = dict(vocoder="world", dataset="dummy_en", use_align=True, data_dir=tts_dir,
                 cache_dir=tts_cache, batch_size=V1_BATCH, device=device)
    world_batch = v1_batch(AudioTextDataModule(**world))
    target_batch = v1_batch(AudioTextDataModule(**world, use_target=True))
    layers = V1_ALIGN["num_layers"]
    models = [
        ("align", AudioAlignCTC, V1_ALIGN, mel_batch, 1,
         {"bilstm_train_fwd": layers, "bilstm_train_bwd": 2 * layers, "ctc_alpha": 1,
          "ctc_adjoint": 1}),
        ("asr", AudioToTextCTC, V1_ASR, mel_batch, V1_STEPS_PER_EPOCH,
         {"ctc_alpha": 1, "ctc_adjoint": 1}),
        ("ttsalign", TextToAlignTextModel, V1_TTS_ALIGN, text_batch, 1, {}),
        ("ttsaudio", AlignTextToAudioModel, V1_TTS_AUDIO, world_batch, 1, {}),
        ("ttsaudio_mt", AlignTextToAudioMultiTaskModel, V1_TTS_MT, target_batch, 1, {}),
    ]
    summary, by_path = {"card": card}, {}
    for i, (name, cls, kwargs, batch, spe, want) in enumerate(models):
        cpu_model = cls(**kwargs, device="cpu", generator=torch.Generator().manual_seed(
            SEED + 50 + i))
        if hasattr(cpu_model, "norm"):
            merge_world_stats(cpu_model, stat_path)
        params = sum(p.numel() for p in cpu_model.parameters())
        summary[name] = {"params": params,
                         "parity": v1_parity(device, name, copy.deepcopy(cpu_model), batch, spe)}
        model = copy.deepcopy(cpu_model).to(device)
        summary[name]["steps"], by_path[f"v1_train_{name}"] = v1_steps(
            device, card, name, model, batch, want, spe)
        if name == "align":
            summary[name]["best_path"], by_path["v1_align_best_path"] = v1_best_path(
                device, copy.deepcopy(cpu_model).to(device), cpu_model, predict_batch)
    summary["cli"], cli_paths = v1_cli_phase(device, card, workdir, align_args, tts_dir,
                                             tts_cache, stat_path, samples)
    by_path.update(cli_paths)
    summary["wall_s"] = time.perf_counter() - start
    print(f"v1 phase on {card}: step ms at batch {V1_BATCH} "
          + json.dumps({n: summary[n]["steps"]["step_ms"] for n, *_ in models})
          + f"; {summary['wall_s']:.1f} s", flush=True)
    return by_path, summary


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

    def mark(name):
        """Where the run's wall time goes: each phase's end from the build's start."""
        print(f"phase {name}: done at {time.perf_counter() - start:.1f} s", flush=True)

    def print_build(report):
        for name, info in report.items():
            ptxas = [line.strip() for line in info["log"].splitlines()
                     if "registers" in line or "spill" in line]
            print(f"built {name} in {info['seconds']:.1f} s: " + " | ".join(ptxas), flush=True)

    # the Viterbi source compiles for about two minutes, the other four in
    # seconds: it builds in the background while the checks before the CTC
    # probe run, none of which launches it
    slow_build = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    viterbi_build = slow_build.submit(build.build, ["viterbi"])
    print_build(build.build([name for name in build.KERNELS if name != "viterbi"]))
    print(f"kernel build (all but viterbi): {time.perf_counter() - start:.1f} s", flush=True)

    device = resolve_device("cuda")
    serving = [check_melspec(device), check_bilstm(device)]
    training = check_lstm_train(device) + check_ctc(device)
    check_not_resident(device)
    # the bf16 variants of kernels 1-3 at the bf16 phase's shapes, early in
    # the run: torch.profiler has dropped events of cooperative launches
    # late in long runs
    bf16_kernels = {config: check_bf16_kernels(device, config, *shape)
                    for config, shape in BF16_SHAPES.items()}
    # kernels 1-3 at the v1 aligner's H=128, early for the same reason
    v1_kernels = check_v1_kernels(device)
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
    # a streaming window at the largest bucket: B=1, 640,000 samples, T'=2001
    serving[0]["b1_stream"] = check_melspec(device, 1, STREAM_B1_SECONDS)
    frames = int(STREAM_B1_SECONDS * SAMPLE_RATE) // 320 + 1
    serving[1]["b1_stream"] = check_bilstm(device, 1, frames, [frames], plain_iters=1)
    serving[1].update(check_bilstm_export(device))
    # each CTC kernel's and the Viterbi launch's step split by cause, and
    # the chain floors; the Viterbi check reads its phases from it
    from voice100_tpu_torch.tools.probe_ctc import probe

    print_build(viterbi_build.result())
    slow_build.shutdown()
    print(f"kernel build (viterbi, in the background): done at {time.perf_counter() - start:.1f} s",
          flush=True)
    steps = probe()
    print("probe_ctc " + json.dumps(steps), flush=True)
    for entry, key in zip(training[2:], ("alpha", "adjoint")):
        entry["step_us_by_variant"] = steps["us_per_step"][key]
        entry["chain_floor_ms"] = steps["chain_floor_ms"][key]
    aligning = check_viterbi(device, steps["us_per_step"]["viterbi"])
    mark("kernel checks")
    by_path = {"serve": serve(device, card), "train": train(device, card)}
    train_parity(device)
    mark("serve, train")
    relpos_line = conformer_phase(device, card)
    mark("conformer")
    with tempfile.TemporaryDirectory() as workdir:
        runs, args, samples = align(device, card, workdir)
        by_path.update({f"align_{run}": r["launches"] for run, r in runs.items()})
        mark("align")
        by_path["serve_beam"], beam_summary = serve_beam(device, card, workdir,
                                                         args["data_dir"])
        mark("serve_beam")
        server_paths, server_summary = server_phase(device, card, workdir)
        by_path.update(server_paths)
        by_path["profile_fit"], server_summary["profile_fit"] = profile_fit(device, card, workdir,
                                                                            args)
        mark("server, profile_fit")
        parity = align_parity(device, args, workdir)
        cli_launches, _ = cli_phase(device, card, workdir, args, samples)
        by_path.update({f"cli_{sub}": launches for sub, launches in cli_launches.items()})
        mark("align parity, cli")
        dp_start = time.perf_counter()
        dp_paths, dp_summary = distributed_phase(device, card, workdir, args)
        dp_summary["wall_s"] = time.perf_counter() - dp_start
        by_path.update(dp_paths)
        mark("distributed")
        by_path["tts"], tts_kernel, tts_summary = tts_phase(device, card, workdir)
        mark("tts")
        tts_train_paths, tts_train_kernels, tts_train_summary, tts_data = tts_train_phase(
            device, card, workdir, args)
        new_start = time.perf_counter()
        mark("tts_train")
        world_summary = world_device_phase(device, card, workdir,
                                           tts_train_summary["world_analysis_cold_s"])
        mark("world_device")
        by_path["export"], export_summary = export_phase(device, card, workdir, args)
        mark("export")
        v1_deploy_paths, v1_deploy_summary = v1_deploy_phase(device, card, workdir)
        by_path.update(v1_deploy_paths)
        mark("v1_deploy")
        export_summary["new_phases_wall_s"] = time.perf_counter() - new_start
        shell_paths, shell_summary = data_shell_phase(device, card, workdir, args,
                                                      os.path.join(workdir, "tts_data"))
        mark("data_shell")
        phone_start = time.perf_counter()
        phone_paths, phone_kernels, phone_summary = phone_phase(device, card, workdir)
        phone_summary["wall_s"] = time.perf_counter() - phone_start
        mark("phone")
        # kernel 1 at the TTS configs' training batch
        serving[1]["b128_h512"] = check_bilstm_b128_h512(device)
        bf16_paths, bf16_summary = bf16_phase(device, card, workdir, args, samples, tts_data)
        mark("b128_h512, bf16")
        v1_paths, v1_summary = v1_phase(device, card, workdir, args, samples)
        mark("v1")
    by_path.update(tts_train_paths)
    by_path.update(v1_paths)
    by_path.update(shell_paths)
    by_path.update(phone_paths)
    serving[1].update(tts_kernel)
    # kernel 1 at the phone TTS runs' shapes, kernels 4 and 5 at vocab 71
    serving[1].update(phone_kernels["bilstm_recurrence"])
    for entry in training[2:]:
        entry["phone_v71"] = phone_kernels[entry["name"]]
    # kernels 2 and 3 at the TTS training batches' shapes
    for name, (fwd, bwd) in tts_train_kernels.items():
        training[0][name] = shape_line(fwd)
        training[1][name] = shape_line(bwd)
    # kernels 1-3 at AudioAlignCTC's shapes (H=128)
    serving[1]["align_v1_h128"] = dict(shape_line(v1_kernels["bilstm_recurrence"]),
                                       recurrence_device_ms=v1_kernels["bilstm_recurrence"][
                                           "recurrence_device_ms"])
    training[0]["align_v1_h128"] = shape_line(v1_kernels["bilstm_train_fwd"])
    training[1]["align_v1_h128"] = shape_line(v1_kernels["bilstm_train_bwd"])
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
    by_path.update(bf16_paths)
    bf16_lines = bf16_kernel_lines(bf16_kernels, bf16_paths)
    for entry in bf16_lines[1:]:
        entry["launches_per_step"] = entry["launches"] / TIMED_STEPS
    print("align_summary " + json.dumps({"runs": runs, "parity": parity}), flush=True)
    print("tts_summary " + json.dumps(tts_summary), flush=True)
    print("tts_train_summary " + json.dumps(tts_train_summary), flush=True)
    print(f"phone_summary ({card}) " + json.dumps(phone_summary), flush=True)
    print(f"bf16_summary ({card}) " + json.dumps(bf16_summary), flush=True)
    print(f"serve_beam_summary ({card}) " + json.dumps(beam_summary), flush=True)
    print(f"data_shell_summary ({card}) " + json.dumps(shell_summary), flush=True)
    print(f"server_summary ({card}) " + json.dumps(server_summary), flush=True)
    print(f"world_device_summary ({card}) " + json.dumps(world_summary), flush=True)
    print(f"export_summary ({card}) " + json.dumps(export_summary), flush=True)
    print(f"v1_deploy_summary ({card}) " + json.dumps(v1_deploy_summary), flush=True)
    print(f"dp_summary ({card}) " + json.dumps(dp_summary), flush=True)
    print(f"v1_summary ({card}) " + json.dumps(v1_summary), flush=True)
    print(f"chip_smoke: {time.perf_counter() - start:.1f} s from the kernel build to here",
          flush=True)
    print(json.dumps({"kernels": serving + training + aligning + bf16_lines + [relpos_line]}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-rank"]:  # a rank of the distributed phase's gloo fit
        dp_rank_child(sys.argv[2])
    else:
        main()
