"""The port's CTC prefix beam search and trigram LM fusion vs the JAX
package (CPU).

* ``ops/ctc_beam_device.py`` (batched torch) and ``ops/ctc_beam.py``
  (host) give the JAX decoders' ids on the same seeded log-probs:
  unpruned (``topk = V - 1``, host pruning off) and pruned (``topk = 8``
  against JAX's device decoder), with and without LM fusion; padding
  never changes a decoded sequence (tests/test_beam_device.py,
  tests/test_ctc_beam.py).
* ``CharNgramLM.fit_texts`` tables equal JAX's (rtol 1e-6) and the
  ``.npz`` files load in both packages; ``tools/train_lm`` writes one;
  ``ASRPipeline`` checks the LM's vocabulary, and its device beam equals
  its host beam on the same model outputs.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest

import jax  # kept on the CPU by conftest
import torch

from voice100_tpu_torch.ops.ctc_beam import ctc_prefix_beam_search
from voice100_tpu_torch.ops.ctc_beam_device import ctc_prefix_beam_search_batched

SETTINGS = ((16, False, 3, 2, 1, False),)


def _log_probs(rng, b, t, v, peak=3.0):
    x = rng.randn(b, t, v).astype(np.float32) * peak
    x = x - x.max(axis=-1, keepdims=True)
    return (x - np.log(np.exp(x).sum(axis=-1, keepdims=True))).astype(np.float32)


def _toy_lm(v=6):
    from voice100_tpu_torch.text.ngram import CharNgramLM

    rng = np.random.RandomState(7)
    seqs = [[1, 2, 3], [1, 2, 4]] * 50 + [list(rng.randint(1, v, size=4)) for _ in range(20)]
    return CharNgramLM.fit(seqs, vocab_size=v)


def _rows(ids, n):
    ids, n = np.asarray(ids), np.asarray(n)
    return [list(ids[i, :n[i]]) for i in range(len(n))]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "lm"])
@pytest.mark.parametrize("case", [(12, 24, 6, 8, 3.0), (8, 120, 29, 8, 0.5), (6, 20, 8, 4, 3.0)],
                         ids=["v6", "v29_flat", "v8_k4"])
def test_decoders_equal_jax_unpruned(case, fused):
    """topk = V - 1: every symbol extends; the batched torch decoder, the
    port's host decoder (pruning off) and both JAX decoders agree."""
    from voice100_tpu.ops.ctc_beam import ctc_prefix_beam_search as jax_host
    from voice100_tpu.ops.ctc_beam_device import ctc_prefix_beam_search_batched as jax_device
    from voice100_tpu_torch.text.ngram import CharNgramLM

    b, t, v, beam, peak = case
    rng = np.random.RandomState(b * t + v)
    lp = _log_probs(rng, b, t, v, peak)
    lens = rng.randint(3, t + 1, size=b).astype(np.int32)
    table = None
    if fused:
        table = CharNgramLM.fit([list(rng.randint(1, v, size=6)) for _ in range(40)], v).table
    lm = dict(lm_table=table, lm_weight=0.7, lm_bonus=0.3)
    got = _rows(*ctc_prefix_beam_search_batched(torch.from_numpy(lp), torch.from_numpy(lens),
                                                beam_size=beam, topk=v - 1, **lm))
    want = _rows(*jax_device(lp, lens, beam_size=beam, topk=v - 1, **lm))
    assert got == want
    for i in range(b):
        host = ctc_prefix_beam_search(lp[i, :lens[i]], beam_size=beam, prune_log_prob=-1e9, **lm)
        assert host == got[i] == jax_host(lp[i, :lens[i]], beam_size=beam, prune_log_prob=-1e9,
                                          **lm)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "lm"])
def test_pruned_device_decoder_equals_jax(fused):
    """topk = 8 of 29 symbols: the same pruned candidates as JAX's."""
    from voice100_tpu.ops.ctc_beam_device import ctc_prefix_beam_search_batched as jax_device

    rng = np.random.RandomState(5)
    lp = _log_probs(rng, 8, 150, 29, peak=1.0)
    lens = rng.randint(20, 151, size=8).astype(np.int32)
    lm = dict(lm_table=_toy_lm(29).table if fused else None, lm_weight=0.6, lm_bonus=0.2)
    got = _rows(*ctc_prefix_beam_search_batched(lp, lens, beam_size=8, topk=8, **lm))
    assert got == _rows(*jax_device(lp, lens, beam_size=8, topk=8, **lm))


def test_ties_go_to_the_lower_index():
    """Frames of equal log-probs: the selections keep lax.top_k's order,
    so the decoded ids are JAX's."""
    from voice100_tpu.ops.ctc_beam_device import ctc_prefix_beam_search_batched as jax_device

    lp = np.full((2, 6, 5), np.log(0.2), np.float32)
    lp[1, 3] = np.log([0.1, 0.3, 0.3, 0.15, 0.15])
    lens = np.array([6, 5], np.int32)
    for topk in (2, 4):
        got = _rows(*ctc_prefix_beam_search_batched(lp, lens, beam_size=3, topk=topk))
        assert got == _rows(*jax_device(lp, lens, beam_size=3, topk=topk))


def test_hashes_wrap_like_uint32():
    from voice100_tpu_torch.ops.ctc_beam_device import _mul32

    h = torch.tensor([0, 1, 0xFFFFFFFF, 0x811C9DC5, 123456789], dtype=torch.int64)
    for m in (1000003, 2654435761, 0x9E3779B9):
        want = (np.asarray(h.numpy(), np.uint64) * np.uint64(m)) % (1 << 32)
        np.testing.assert_array_equal(_mul32(h, m).numpy(), want.astype(np.int64))


def test_padding_does_not_change_the_decode():
    rng = np.random.RandomState(1)
    b, t, v = 6, 20, 8
    lp = _log_probs(rng, b, t, v)
    lens = rng.randint(4, t + 1, size=b).astype(np.int32)
    first = _rows(*ctc_prefix_beam_search_batched(lp, lens, beam_size=4))
    padded = np.concatenate([lp, rng.randn(b, 7, v).astype(np.float32)], axis=1)
    padded = np.concatenate([padded, rng.randn(2, t + 7, v).astype(np.float32)], axis=0)
    second = _rows(*ctc_prefix_beam_search_batched(
        padded, np.concatenate([lens, np.array([5, 9], np.int32)]), beam_size=4))
    assert second[:b] == first


def test_certain_sequence_and_split_mass():
    """Near one-hot frames read off the collapsed path; the toy case of
    Hannun et al. where greedy reads blanks but "a" has the most mass."""
    v, t = 5, 12
    path = [1, 1, 0, 2, 2, 3, 0, 0, 3, 4, 4, 0]
    lp = np.full((1, t, v), -20.0, np.float32)
    lp[0, np.arange(t), path] = 0.0
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    assert _rows(*ctc_prefix_beam_search_batched(lp, [t], beam_size=4)) == [[1, 2, 3, 3, 4]]
    probs = np.log(np.array([[[0.4, 0.35, 0.25], [0.4, 0.35, 0.25]]], np.float32))
    assert _rows(*ctc_prefix_beam_search_batched(probs, [2], beam_size=4)) == [[1]]
    assert ctc_prefix_beam_search(np.log([[0.6, 0.4], [0.6, 0.4]]), beam_size=4) == [1]


def test_lm_fusion_disambiguates():
    lm = _toy_lm()
    lp = np.full((1, 6, 6), -12.0, np.float32)
    for i, s in enumerate([1, 0, 2, 0, 5, 5]):
        lp[0, i, s] = 0.0
    lp[0, 4, 3] = lp[0, 5, 3] = -0.35
    lp = lp - np.log(np.exp(lp).sum(-1, keepdims=True))
    assert _rows(*ctc_prefix_beam_search_batched(lp, [6], beam_size=4)) == [[1, 2, 5]]
    assert _rows(*ctc_prefix_beam_search_batched(lp, [6], beam_size=4, lm_table=lm.table,
                                                 lm_weight=1.5)) == [[1, 2, 3]]


def test_ngram_tables_equal_jax_and_files_cross_load(tmp_path):
    from voice100_tpu.text import get_tokenizer as jax_tokenizer
    from voice100_tpu.text.ngram import CharNgramLM as JaxLM
    from voice100_tpu_torch.text import get_tokenizer
    from voice100_tpu_torch.text.ngram import CharNgramLM

    texts = ["hello world", "the quick brown fox", "hello again", "a b c d e", "jumps"] * 3
    lm = CharNgramLM.fit_texts(texts, get_tokenizer("en", False))
    want = JaxLM.fit_texts(texts, jax_tokenizer("en", False))
    np.testing.assert_allclose(lm.table, want.table, rtol=1e-6)
    assert lm.vocab_size == 29 and lm.table[:, :, 0].max() == -np.inf
    p = np.exp(lm.table)
    np.testing.assert_allclose(p.sum(axis=-1), 1.0, atol=1e-5)
    ids = get_tokenizer("en", False)("hello")
    assert lm.score(ids) == pytest.approx(want.score(ids), rel=1e-6)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    lm.save(ours)
    want.save(theirs)
    np.testing.assert_array_equal(JaxLM.load(ours).table, lm.table)
    np.testing.assert_array_equal(CharNgramLM.load(theirs).table, want.table)
    with pytest.raises(ValueError, match="no training tokens"):
        CharNgramLM.fit([[]], vocab_size=5)


def test_train_lm_cli(tmp_path):
    from voice100_tpu.tools.train_lm import cli_main as jax_cli
    from voice100_tpu_torch.text import get_tokenizer
    from voice100_tpu_torch.text.ngram import CharNgramLM
    from voice100_tpu_torch.tools.train_lm import cli_main

    text = tmp_path / "dummy_en-train.txt"
    text.write_text("clip1|hello world\nclip2|the quick brown fox\nclip3|hello again\n",
                    encoding="utf-8")
    out, ref = str(tmp_path / "lm.npz"), str(tmp_path / "ref.npz")
    cli_main(["--text", str(text), "--language", "en", "--output", out])
    jax_cli(["--text", str(text), "--language", "en", "--output", ref])
    lm = CharNgramLM.load(out)
    np.testing.assert_allclose(lm.table, CharNgramLM.load(ref).table, rtol=1e-6)
    h, e, l_, z = (int(get_tokenizer("en", False)(c)[0]) for c in "helz")
    assert lm.table[h, e, l_] > lm.table[h, e, z]


def _pipelines(lm=None, **kwargs):
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText

    model = AudioToAlignText(64, 29, SETTINGS, 1, 16, device="cpu",
                             generator=torch.Generator().manual_seed(3))
    args = dict(batch_size=4, buckets_sec=(0.5, 1.0, 2.0), beam_size=6, beam_topk=28, lm=lm,
                device="cpu", **kwargs)
    return (ASRPipeline(model, **args), ASRPipeline(model, beam_device=False, **args),
            ASRPipeline(model, batch_size=4, buckets_sec=(0.5, 1.0, 2.0), device="cpu"))


@pytest.mark.parametrize("pcm16", [False, True])
def test_pipeline_device_beam_equals_host_beam(pcm16):
    rng = np.random.RandomState(2)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (5000, 9000, 16000, 12000, 7000)]
    if pcm16:
        wavs = [(w * 32767).astype(np.int16) for w in wavs]
    device, host, greedy = _pipelines()
    got = device.transcribe(wavs)
    assert got == host.transcribe(wavs)
    assert len(got) == 5 and all(isinstance(t, str) for t in got)
    assert len(greedy.transcribe(wavs)) == 5


def test_device_beam_equals_host_beam_on_a_flat_distribution():
    """A random-weight model's clip of 8 s (noise under a slow envelope):
    its log-probs are flat (no frame below -3.7), and two prefixes of the
    beam lie within float32 rounding of each other at frame 113. The
    device beam's float64 sums rank them as the host decoder does."""
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText

    model = AudioToAlignText(64, 29, ((32, False, 5, 2, 2, False), (32, False, 5, 1, 2, False)),
                             2, 32, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    seconds = rng.uniform(2.0, 10.0, size=16)
    clips = []
    for sec in seconds[:7]:  # the seventh clip, drawn as the card check draws its clips
        n = int(sec * 16000)
        env = 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.5, 3.0) * np.arange(n) / 16000)
        clips.append((rng.standard_normal(n) * 4000 * env).clip(-32768, 32767).astype(np.int16))
    pipe = ASRPipeline(model, batch_size=1, device="cpu")
    _, wav, lens = next(pipe.batches(clips[6:]))
    lp, n = pipe.log_probs(wav, lens)
    lp = lp[0, :n[0]]
    assert lp.min() > -4.0
    got = _rows(*ctc_prefix_beam_search_batched(lp[None], n, beam_size=8, topk=28))[0]
    assert got == ctc_prefix_beam_search(lp.numpy(), beam_size=8, prune_log_prob=-1e9)


def test_pipeline_lm_fusion_device_equals_host(tmp_path):
    from voice100_tpu_torch.text.ngram import CharNgramLM

    rng = np.random.RandomState(11)
    lm = CharNgramLM.fit([list(rng.randint(1, 29, size=12)) for _ in range(40)], vocab_size=29)
    path = str(tmp_path / "lm.npz")
    lm.save(path)
    wavs = [rng.randn(n).astype(np.float32) * 0.1 for n in (6000, 14000)]
    for source in (lm, path, lm.table):
        device, host, _ = _pipelines(lm=source, lm_weight=0.6, lm_bonus=0.2)
        np.testing.assert_array_equal(device.lm_table, lm.table)
        assert device.transcribe(wavs) == host.transcribe(wavs)


def test_pipeline_rejects_an_lm_of_another_vocabulary():
    with pytest.raises(ValueError, match="LM vocab 44 != tokenizer vocab 29"):
        _pipelines(lm=np.zeros((44, 44, 44), np.float32))
