"""The port's HTTP serving daemon vs the JAX package's (CPU).

The small models of tests/test_server.py, initialised in JAX and carried
across with ``from_jax_variables``; the port's pipelines run on the CPU.

* Each test of tests/test_server.py against the port's server.
* The port's ``SpeechServer`` and the JAX one give the same
  ``/transcribe`` JSON for the same bodies (a WAV of int16 PCM, raw
  float32 PCM at 22,050 Hz that the server resamples, a WAV past the
  largest bucket that streams) and ``/synthesize`` WAVs of the same
  sample count.
* ``python -m voice100_tpu_torch.server`` builds its pipelines from
  configs and port checkpoints on ``--device cpu``, and raises without
  CUDA otherwise.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import concurrent.futures as cf
import http.client
import json

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.dsp.wav import parse_wav, write_wav_bytes
from voice100_tpu_torch.inference import ASRPipeline, TTSPipeline
from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, TextToAlignText
from voice100_tpu_torch.server import MicroBatcher, SpeechServer
from voice100_tpu_torch.tools.weights import from_jax_variables

ASR_SETTINGS = ((16, False, 3, 2, 1, False),)
DECODER = ((16, False, 5, 1, 2, False), (16, True, 5, 2, 2, False))


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp.status, resp.getheader("Content-Type"), data


@pytest.fixture(scope="module")
def weights():
    """The JAX models and variables of tests/test_server.py."""
    from voice100_tpu.models import AlignTextToAudio as JaxAudio
    from voice100_tpu.models import AudioToAlignText as JaxASR
    from voice100_tpu.models import TextToAlignText as JaxAlign

    def init(model, key, *args):
        return jax.tree_util.tree_map(np.asarray, model.init(jax.random.PRNGKey(key), *args))

    asr = JaxASR(audio_size=64, vocab_size=29, encoder_settings=ASR_SETTINGS,
                 decoder_num_layers=1, decoder_hidden_size=16)
    align = JaxAlign(vocab_size=29, num_layers=1, hidden_size=16)
    audio = JaxAudio(vocab_size=29, encoder_num_layers=1, encoder_hidden_size=16,
                     decoder_settings=DECODER)
    text = (jnp.zeros((1, 8), jnp.int32), jnp.asarray([8]))
    return {"asr": (asr, init(asr, 0, jnp.zeros((1, 51, 64)), jnp.asarray([51]))),
            "align": (align, init(align, 0, *text)), "audio": (audio, init(audio, 1, *text))}


def _asr_pipeline(weights, batch_size=1):
    port = AudioToAlignText(64, 29, ASR_SETTINGS, 1, 16, device="cpu")
    port.load_state_dict(from_jax_variables(weights["asr"][1]))
    return ASRPipeline(port, batch_size=batch_size, buckets_sec=(0.5, 1.0), device="cpu")


def _tts_pipeline(weights):
    align = TextToAlignText(29, 1, 16, device="cpu")
    align.load_state_dict(from_jax_variables(weights["align"][1]))
    audio = AlignTextToAudio(29, 25, 1, 1, 16, DECODER, device="cpu")
    audio.load_state_dict(from_jax_variables(weights["audio"][1], DECODER))
    return TTSPipeline(align, audio, language="en", use_phone=False, device="cpu")


def _jax_server(weights):
    from voice100_tpu.inference import ASRPipeline as JaxASRPipeline
    from voice100_tpu.inference import TTSPipeline as JaxTTSPipeline
    from voice100_tpu.server import SpeechServer as JaxServer

    asr = JaxASRPipeline(*weights["asr"], batch_size=1, buckets_sec=(0.5, 1.0))
    tts = JaxTTSPipeline(*weights["align"], *weights["audio"], language="en", use_phone=False)
    return JaxServer(asr, tts, port=0)


# --- tests/test_server.py, against the port -----------------------------------

def test_server_endpoints(weights):
    server = SpeechServer(_asr_pipeline(weights), _tts_pipeline(weights), port=0)
    port = server.start()
    try:
        status, ctype, data = _request(port, "GET", "/healthz")
        assert status == 200
        assert json.loads(data) == {"status": "ok", "models": ["asr", "tts"]}

        rng = np.random.RandomState(0)
        wav = (rng.randn(8000) * 0.1).astype(np.float32)
        status, ctype, data = _request(port, "POST", "/transcribe",
                                       body=write_wav_bytes(wav, 16000))
        assert status == 200, data
        assert isinstance(json.loads(data)["text"], str)

        status, _, data2 = _request(
            port, "POST", "/transcribe",
            body=(rng.randn(12000) * 0.1).astype(np.float32).tobytes(),
            headers={"X-Raw-Sample-Rate": "24000"})
        assert status == 200, data2

        status, ctype, data = _request(port, "POST", "/synthesize",
                                       body=json.dumps({"text": "hello"}).encode(),
                                       headers={"Content-Type": "application/json"})
        assert status == 200 and ctype == "audio/wav"
        samples, rate = parse_wav(data)
        assert rate == 16000 and samples.shape[1] > 100

        # a malformed request is answered with an error; the server stays up
        status, _, data = _request(port, "POST", "/synthesize", body=b"not json")
        assert status == 500
        status, _, _ = _request(port, "GET", "/healthz")
        assert status == 200
    finally:
        server.stop()


def test_parse_wav_keep_int16_matches_float():
    """keep_int16 returns the raw PCM samples; scaled by 1/32768 they are
    the default float parse exactly."""
    rng = np.random.RandomState(3)
    pcm = (rng.randn(2, 500) * 3000).astype(np.int16)
    data = write_wav_bytes(pcm, 16000)
    raw, rate = parse_wav(data, keep_int16=True)
    assert raw.dtype == np.int16 and rate == 16000
    np.testing.assert_array_equal(raw, pcm)
    flt, _ = parse_wav(data)
    np.testing.assert_array_equal(raw.astype(np.float32) / 32768.0, flt)


def test_concurrent_requests_micro_batch(weights):
    """Concurrent clients ride one batched call, and each response equals
    the request's transcript alone."""
    n = 4
    pipeline = _asr_pipeline(weights, batch_size=n)
    rng = np.random.RandomState(7)
    wavs = [(rng.randn(8000) * 0.2).astype(np.float32) for _ in range(n)]
    sequential = [pipeline.transcribe([w])[0] for w in wavs]
    server = SpeechServer(pipeline, None, port=0, batch_window_ms=2000.0)
    port = server.start()
    try:
        _request(port, "POST", "/transcribe", body=write_wav_bytes(wavs[0], 16000))
        server.asr_batcher.batch_sizes.clear()
        with cf.ThreadPoolExecutor(n) as pool:
            results = list(pool.map(
                lambda w: _request(port, "POST", "/transcribe", body=write_wav_bytes(w, 16000)),
                wavs))
        assert all(status == 200 for status, _, _ in results)
        assert [json.loads(data)["text"] for _, _, data in results] == sequential
        assert list(server.asr_batcher.batch_sizes) == [n], server.asr_batcher.batch_sizes
    finally:
        server.stop()


def test_micro_batcher_propagates_errors_and_closes():
    def fn(items):
        if items[0] == "boom":
            raise ValueError("kaput")
        return [x * 2 for x in items]

    b = MicroBatcher(fn, max_batch=4, flush_ms=1.0)
    try:
        assert b.submit(3) == 6
        with pytest.raises(ValueError, match="kaput"):
            b.submit("boom")
    finally:
        b.close()
    with pytest.raises(RuntimeError):
        b.submit(1)


def test_micro_batcher_retries_items_on_batch_failure():
    """A failing co-batched request does not fail its neighbours: the
    batch is retried item by item."""
    calls = []

    def fn(items):
        calls.append(list(items))
        if "boom" in items:
            raise ValueError("kaput")
        return [x * 2 for x in items]

    b = MicroBatcher(fn, max_batch=4, flush_ms=200.0)
    try:
        with cf.ThreadPoolExecutor(3) as pool:
            futs = [pool.submit(b.submit, x) for x in (3, "boom", 5)]
            results = []
            for f in futs:
                try:
                    results.append(f.result())
                except ValueError as e:
                    results.append(e)
        assert results[0] == 6
        assert isinstance(results[1], ValueError)
        assert results[2] == 10
        assert any(len(c) > 1 for c in calls)
    finally:
        b.close()


def test_micro_batcher_batch_sizes_bounded():
    b = MicroBatcher(lambda items: items, max_batch=1, flush_ms=0.0)
    try:
        assert b.batch_sizes.maxlen is not None
        for _ in range(b.batch_sizes.maxlen + 10):
            b.submit(1)
        assert len(b.batch_sizes) == b.batch_sizes.maxlen
    finally:
        b.close()


def test_launch_counts_survive_concurrent_batchers():
    """The ASR and TTS batchers launch kernel 1 from two threads: its
    launch counter loses no increment under frequent thread switches."""
    import sys
    import threading

    from voice100_tpu_torch.ops import lstm_cuda

    def wrapper():
        pass

    wrapper.launches = wrapper.launches_bf16 = 0
    xg = torch.zeros(1)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [lstm_cuda._count(wrapper, xg)
                                                    for _ in range(2000)]) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert (wrapper.launches, wrapper.launches_bf16) == (8 * 2000, 0)


def test_server_without_models_rejects():
    server = SpeechServer(None, None, port=0)
    port = server.start()
    try:
        status, _, data = _request(port, "POST", "/transcribe", body=b"x")
        assert status == 400
        assert "no ASR model" in json.loads(data)["error"]
    finally:
        server.stop()


# --- the port's server against the JAX server ------------------------------------

def test_responses_match_the_jax_server(weights):
    rng = np.random.RandomState(11)
    bodies = [
        ({}, write_wav_bytes((rng.randn(9000) * 3000).astype(np.int16), 16000)),
        ({"X-Raw-Sample-Rate": "22050"}, (rng.randn(15000) * 0.1).astype(np.float32).tobytes()),
        ({}, write_wav_bytes((rng.randn(37000) * 3000).astype(np.int16), 16000)),  # streams
    ]
    texts = ["hello world", "ok"]
    answers = []
    servers = [_jax_server(weights),
               SpeechServer(_asr_pipeline(weights), _tts_pipeline(weights), port=0)]
    for server in servers:
        port = server.start()
        try:
            got = [json.loads(_request(port, "POST", "/transcribe", body=body,
                                       headers=headers)[2]) for headers, body in bodies]
            for text in texts:
                status, ctype, data = _request(port, "POST", "/synthesize",
                                               body=json.dumps({"text": text}).encode())
                assert status == 200 and ctype == "audio/wav"
                samples, rate = parse_wav(data)
                got.append((rate, samples.shape))
            answers.append(got)
        finally:
            server.stop()
    assert answers[1] == answers[0]
    assert all(isinstance(a["text"], str) for a in answers[1][:3])
    assert [r["samples"] for r in servers[1].asr.streamed] == [37000]


def _write_configs(tmp_path, asr, tts):
    from voice100_tpu_torch.training import TrainState, save_checkpoint

    paths = []
    for name, cls, init, model in (
            ("asr", "voice100_tpu.models.AudioToAlignText",
             dict(audio_size=64, vocab_size=29, encoder_settings=[list(s) for s in ASR_SETTINGS],
                  decoder_num_layers=1, decoder_hidden_size=16), asr.model),
            ("align", "voice100_tpu.models.TextToAlignText",
             dict(vocab_size=29, num_layers=1, hidden_size=16), tts.align_model),
            ("audio", "voice100_tpu.models.AlignTextToAudio",
             dict(vocab_size=29, encoder_num_layers=1, encoder_hidden_size=16,
                  decoder_settings=[list(s) for s in DECODER]), tts.audio_model)):
        cfg = tmp_path / f"{name}.yaml"
        cfg.write_text(yaml.safe_dump({"model": {"class_path": cls, "init_args": init}}))
        ckpt = tmp_path / f"{name}.pt"
        save_checkpoint(str(ckpt), TrainState(model, torch.optim.Adam(model.parameters())))
        paths += [f"--{'tts_' if name != 'asr' else ''}{name}_config", str(cfg),
                  f"--{'tts_' if name != 'asr' else ''}{name}_ckpt", str(ckpt)]
    return paths


def test_cli_builds_the_server_on_the_cpu_and_raises_without_cuda(weights, tmp_path):
    from voice100_tpu_torch.server import build_server, cli_main

    asr, tts = _asr_pipeline(weights), _tts_pipeline(weights)
    flags = _write_configs(tmp_path, asr, tts)
    server = build_server(flags + ["--device", "cpu", "--port", "0"])
    port = server.start()
    try:
        status, _, data = _request(port, "GET", "/healthz")
        assert json.loads(data) == {"status": "ok", "models": ["asr", "tts"]}
        wav = write_wav_bytes((np.random.RandomState(1).randn(8000) * 0.1).astype(np.float32),
                              16000)
        direct = json.loads(_request(port, "POST", "/transcribe", body=wav)[2])
        assert direct == {"text": asr.transcribe([parse_wav(wav, keep_int16=True)[0][0]])[0]}
    finally:
        server.stop()
    assert server.asr.device.type == server.tts.device.type == "cpu"
    with pytest.raises(SystemExit, match="all four flags"):
        build_server(flags[:4] + flags[4:6] + ["--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(flags)
