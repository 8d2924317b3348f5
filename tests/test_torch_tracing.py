"""The program's spans and counters (``utils/profiling.py``) on the CPU.

A narrow AudioToAlignText (two conv blocks of 32 channels, a 1-layer
biLSTM with H=16) takes train steps and serves an ``ASRPipeline``:

* with tracing off the table stays as it was, no range is opened and no
  clock read by the profiling module, and a step trains bit for bit as
  the same step under a trace;
* under ``torch.profiler.profile`` a step records ``trainer.train_step``
  once and its three phases once each, within its seconds; the
  prefetcher records ``prefetch.wait`` and charges ``prefetch.prepare``
  once a batch taken; a transcription of two batches records
  ``asr.transcribe`` once and each ``asr.*`` phase once a batch;
* the Chrome trace holds the ``v100.*`` ranges as ``cpu_op``, never as
  ``user_annotation`` (which the card's timeline would copy);
* each traced session reads only its own calls, also while another
  thread runs spans untraced;
* a ``Trainer(profile_dir=...)`` fit's trace holds the trainer's ranges;
* the counter ``asr.staged`` stays absent on the CPU; on a card (tests
  marked ``card``, skipped without one) it takes one a batch, and a
  four-batch transcription uploads from pinned memory with no host sync
  between its first pad and its first fetch, its batches equal to a
  fresh ``np.zeros`` pad.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import json
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voice100_tpu_torch.data.prefetch import DevicePrefetcher
from voice100_tpu_torch.inference import ASRPipeline
from voice100_tpu_torch.models import AudioToAlignText
from voice100_tpu_torch.training import Trainer, TrainerConfig, make_task
from voice100_tpu_torch.utils import profiling

SETTINGS = ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False))
HIDDEN, VOCAB, MELS, BATCH, FRAMES = 16, 29, 64, 4, 40
TRAIN_PHASES = ("trainer.forward", "trainer.backward", "trainer.update")
ASR_PHASES = ("asr.pad", "asr.upload", "asr.dispatch", "asr.fetch", "asr.text")


def _model(seed=0):
    return AudioToAlignText(MELS, VOCAB, SETTINGS, 1, HIDDEN, device="cpu",
                            generator=torch.Generator().manual_seed(seed))


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    audio = rng.normal(-4.0, 2.0, (BATCH, FRAMES, MELS)).astype(np.float32)
    audio_len = np.asarray([FRAMES, 33, 21, 12], np.int32)
    text = rng.integers(1, VOCAB, (BATCH, 7)).astype(np.int32)
    text_len = np.asarray([7, 5, 2, 3], np.int32)
    return tuple(tuple(torch.from_numpy(a) for a in pair)
                 for pair in ((audio, audio_len), (text, text_len)))


class _Run:
    """A trainer, its task and state on a fresh model, and its generator."""

    def __init__(self, seed=0):
        self.trainer = Trainer(TrainerConfig(gradient_clip_val=1.0, seed=7))
        self.task = make_task(_model(seed))
        self.state = self.trainer.make_state(self.task)
        self.generator = torch.Generator().manual_seed(7)

    def step(self, batch=None):
        return self.trainer.train_step(self.task, self.state,
                                       _batch() if batch is None else batch, self.generator)


def _clips(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(-3000, 3000, int(rng.integers(2000, 6000))).astype(np.int16)
            for _ in range(n)]


def _pipeline():
    return ASRPipeline(_model(), batch_size=4, buckets_sec=(0.25, 0.5), device="cpu")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return profiling.table(), prof


def _calls(table, name):
    return table["spans"].get(name, (0, 0.0))[0]


@pytest.fixture(scope="module")
def traced_step():
    run = _Run()
    run.step()  # untraced first: the traced session starts at its first span
    return _traced(run.step)[0]


@pytest.fixture(scope="module")
def traced_transcribe():
    pipe = _pipeline()
    clips = _clips()
    pipe.transcribe(clips)
    return _traced(lambda: pipe.transcribe(clips))[0]


# -- tracing off ---------------------------------------------------------------------

@pytest.mark.parametrize("work", ["train_step", "transcribe", "prefetch"])
def test_untraced_spans_leave_the_table_and_open_no_range(work, monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise AssertionError("a range or a clock read with tracing off")

    with profiling.trace(str(tmp_path), device="cpu"):
        pass  # an empty session
    assert profiling.table() == {"spans": {}, "counters": {}}
    monkeypatch.setattr(profiling, "_Range", refuse)
    monkeypatch.setattr(profiling, "_clock", refuse)
    if work == "train_step":
        _Run().step()
    elif work == "transcribe":
        _pipeline().transcribe(_clips())
    else:
        with DevicePrefetcher([_batch(i) for i in range(3)], device="cpu") as batches:
            assert len(list(batches)) == 3
    profiling.count("allocator.device_alloc", 3)
    profiling.charge("prefetch.prepare", 1.0)
    assert profiling.table() == {"spans": {}, "counters": {}}


def test_a_traced_step_trains_as_the_untraced_one():
    plain, traced = _Run(), _Run()
    losses = [float(plain.step()["loss"]) for _ in range(2)]
    traced_losses = []
    for _ in range(2):
        out = {}
        _traced(lambda: out.update(traced.step()))
        traced_losses.append(float(out["loss"]))
    assert losses == traced_losses
    for (name, a), (_, b) in zip(plain.state.model.named_parameters(),
                                 traced.state.model.named_parameters()):
        assert torch.equal(a, b), name


# -- tracing on ----------------------------------------------------------------------

def test_a_traced_step_records_its_span_once(traced_step):
    calls, seconds = traced_step["spans"]["trainer.train_step"]
    assert calls == 1 and seconds > 0
    assert sum(traced_step["spans"][p][1] for p in TRAIN_PHASES) <= seconds


@pytest.mark.parametrize("phase", TRAIN_PHASES)
def test_each_train_phase_records_once(traced_step, phase):
    calls, seconds = traced_step["spans"][phase]
    assert calls == 1 and seconds > 0


@pytest.mark.parametrize("taken", [1, 3])
def test_the_prefetcher_records_a_wait_and_a_prepare_a_batch(taken):
    batches = DevicePrefetcher([_batch(i) for i in range(4)], device="cpu")
    next(batches)  # untraced
    table, _ = _traced(lambda: [next(batches) for _ in range(taken)])
    batches.close()
    assert _calls(table, "prefetch.wait") == _calls(table, "prefetch.prepare") == taken
    assert table["spans"]["prefetch.prepare"][1] > 0


def test_a_traced_transcription_records_its_span_once(traced_transcribe):
    calls, seconds = traced_transcribe["spans"]["asr.transcribe"]
    assert calls == 1 and seconds > 0
    assert sum(traced_transcribe["spans"][p][1] for p in ASR_PHASES) <= seconds
    # two batches of four at 6,400 samples (longest 4,735 and 5,402, plus
    # the reach, rounded up); no CUDA allocator counter on the CPU
    assert traced_transcribe["counters"] == {"asr.padded_samples": 2 * 4 * 6400,
                                             "asr.clip_samples": sum(map(len, _clips()))}


@pytest.mark.parametrize("phase", ASR_PHASES)
def test_each_pipeline_phase_records_once_a_batch(traced_transcribe, phase):
    assert _calls(traced_transcribe, phase) == 2  # 6 clips, batches of 4


def test_the_chrome_trace_holds_the_spans_as_cpu_ops(tmp_path):
    run, pipe = _Run(), _pipeline()
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        run.step()
        pipe.transcribe(_clips())
    events = json.load(open(prof.trace_path))["traceEvents"]
    ours = [e for e in events if e.get("name", "").startswith(profiling.SPAN_PREFIX)]
    names = {e["name"] for e in ours}
    assert names == {profiling.SPAN_PREFIX + n for n in
                     ("trainer.train_step", *TRAIN_PHASES, "asr.transcribe", *ASR_PHASES)}
    assert {e.get("cat") for e in ours} == {"cpu_op"}
    assert not any(e.get("cat") == "user_annotation" and e["name"].startswith("v100")
                   for e in events)


# -- sessions --------------------------------------------------------------------------

@pytest.mark.parametrize("opener", ["trace", "profiler"])
def test_each_session_reads_only_its_own_calls(opener, tmp_path):
    run = _Run()

    def session(steps):
        if opener == "trace":
            with profiling.trace(str(tmp_path), device="cpu"):
                for _ in range(steps):
                    run.step()
        else:
            run.step()  # untraced between sessions
            _traced(lambda: [run.step() for _ in range(steps)])
        return _calls(profiling.table(), "trainer.train_step")

    assert session(2) == 2
    assert session(1) == 1


def test_an_untraced_thread_leaves_the_traced_session_alone():
    stop = threading.Event()
    run = _Run()

    def untraced():
        while not stop.is_set():
            with profiling.span("other"):
                pass

    worker = threading.Thread(target=untraced)
    run.step()

    def steps():
        worker.start()
        for _ in range(3):
            run.step()

    try:
        table, _ = _traced(steps)
    finally:
        stop.set()
        worker.join()
    assert _calls(table, "trainer.train_step") == 3 and "other" not in table["spans"]


def test_a_counter_on_a_thread_without_spans_joins_the_session(monkeypatch):
    """As kernel 9's backward launches are counted on autograd's thread on a
    card: the count adds to the session and drops none of its spans."""
    run = _Run()
    run.step()

    def steps():
        run.step()
        monkeypatch.setattr(profiling, "_enabled", lambda: True)  # as on autograd's thread
        worker = threading.Thread(target=profiling.count, args=("conformer.attn_launches", 2))
        worker.start()
        worker.join()

    table, _ = _traced(steps)
    assert _calls(table, "trainer.train_step") == 1
    assert table["counters"]["conformer.attn_launches"] == 2


def test_a_profiled_fit_traces_the_trainer_phases(tmp_path):
    from corpus_fixture import make_dummy_corpus
    from test_torch_profiling import _fit, _traces

    corpus = str(tmp_path / "data")
    make_dummy_corpus(corpus, n_clips=8)
    prof = str(tmp_path / "prof")
    _fit(corpus, tmp_path, "profiled", profile_dir=prof)
    (trace,) = _traces(prof)
    ours = [e for e in trace["traceEvents"] if e.get("name", "").startswith("v100.trainer.")]
    assert {e["name"] for e in ours} == {"v100.trainer." + n for n in
                                         ("train_step", "forward", "backward", "update")}
    assert {e["cat"] for e in ours} == {"cpu_op"}
    # steps 3, 4 and 5
    assert sum(e["name"] == "v100.trainer.train_step" for e in ours) == 3
    assert _calls(profiling.table(), "trainer.train_step") == 3
    assert os.path.isdir(prof)


# -- staged batches --------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: batches are staged in pinned memory on CUDA only")
    return torch.device("cuda:0")


def _staged_clips():
    """Four batches of four at buckets of 0.25, 0.5, 1 and 2 s, one a bucket."""
    rng = np.random.default_rng(4)
    sizes = [int(n) for lo in (3000, 6000, 12000, 24000)
             for n in rng.integers(lo, 4 * lo // 3, 4)]
    return [rng.integers(-3000, 3000, n).astype(np.int16) for n in rng.permutation(sizes)]


def _staged_pipeline(device):
    # H=128: kernel 1 takes hidden sizes that are multiples of 32
    model = AudioToAlignText(MELS, VOCAB, SETTINGS, 2, 128, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    return ASRPipeline(model, batch_size=4, buckets_sec=(0.25, 0.5, 1.0, 2.0), device=device)


def test_the_staged_counter_stays_absent_on_the_cpu(traced_transcribe):
    assert "asr.staged" not in traced_transcribe["counters"]


def test_the_pad_counters_take_each_batch_and_its_clips():
    """A traced CPU call over four batches of four: ``asr.padded_samples``
    is the sum of batch size x width over the batches it padded (here
    each its bucket, the cap), and ``asr.clip_samples`` the clips'
    samples."""
    pipe, clips = _staged_pipeline("cpu"), _staged_clips()
    widths = [wav.shape[1] for _, wav, _ in pipe.batches(clips)]
    table, _ = _traced(lambda: pipe.transcribe(clips))
    assert len(widths) == _calls(table, "asr.pad") == 4
    assert table["counters"]["asr.padded_samples"] == pipe.batch_size * sum(widths)
    assert table["counters"]["asr.clip_samples"] == sum(map(len, clips))
    assert widths == pipe.buckets  # each longest clip within the reach of its bucket: capped


@pytest.mark.card
def test_the_staged_counter_takes_one_a_batch_on_cuda(cuda_device):
    pipe, clips = _staged_pipeline(cuda_device), _staged_clips()
    pipe.transcribe(clips)
    table, _ = _traced(lambda: pipe.transcribe(clips))
    assert _calls(table, "asr.pad") == 4
    assert table["counters"]["asr.staged"] == 4


@pytest.mark.card
def test_a_staged_transcription_uploads_pinned_without_a_sync(cuda_device):
    """Under the profiler a warm four-batch call copies no pageable host
    memory and makes no stream or device sync from its first ``asr.pad``
    to its first ``asr.fetch``; its batches on the card equal the fresh
    ``np.zeros`` pad and its transcripts the untraced call's."""
    from torch.autograd import DeviceType

    pipe, clips = _staged_pipeline(cuda_device), _staged_clips()
    want = pipe.transcribe(clips)  # warm: kernels built, pinned blocks cached
    torch.cuda.synchronize(cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        texts = pipe.transcribe(clips)
        torch.cuda.synchronize(cuda_device)
    events = prof.events()
    copies = [e.name for e in events
              if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy HtoD")]
    assert copies and not any("Pageable" in name for name in copies), copies

    def first(name):
        return min(e.time_range.start for e in events if e.name == profiling.SPAN_PREFIX + name)

    start, end = first("asr.pad"), first("asr.fetch")
    syncs = [e.name for e in events if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
             and start <= e.time_range.start < end]
    assert not syncs, syncs
    assert texts == want
    for chunk, wav, lengths in pipe.batches(clips):
        batch = np.zeros((4, wav.shape[1]), np.int16)
        for row, i in enumerate(chunk):
            batch[row, :len(clips[i])] = clips[i]
        np.testing.assert_array_equal(wav.cpu().numpy(), batch)
        np.testing.assert_array_equal(lengths.cpu().numpy(), [len(clips[i]) for i in chunk])
