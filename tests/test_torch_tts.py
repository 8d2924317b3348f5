"""Port TTS v2 models vs the JAX package (CPU).

Narrow models (H 16-32, one or two layers) are initialised in JAX,
carried across with ``from_jax_variables`` and run by both packages; the
JAX biLSTM runs its scan on the CPU. Tolerances, each with its reason:

* conv blocks, the transposed block and WORLDNorm: 1e-5 abs (float32
  sums of a few hundred terms in another order, ~1e-7 measured);
* ``TextToAlignText.predict``: rtol 1e-5 on ``exp(y) - 1``; the
  log-durations ``y`` themselves to 1e-5 abs;
* ``AlignTextToAudio.predict``: 1e-4 abs on each stream (the statistics
  scale the unit-variance outputs by up to 30);
* weights JAX -> port -> JAX and the duration expansion given the same
  durations: bit for bit. The expansion's lengths come from a float32
  total whose summation order XLA picks, so the drawn durations are
  multiples of 1/64 there, whose sums are exact in any order; on the
  seeded float case the test names any row whose total lies within a
  float32 rounding of an integer.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp
import torch

from voice100_tpu_torch.models import AlignTextToAudio, TextToAlignText
from voice100_tpu_torch.models.layers import ConvStack, WORLDNorm
from voice100_tpu_torch.ops.duration import aligntext_length, expand_alignment_batch
from voice100_tpu_torch.tools.weights import _stack_from_jax, from_jax_variables, to_jax_variables

VOCAB = 29
DECODER = ((32, False, 3, 1, 1, False), (32, True, 5, 2, 2, False), (16, False, 3, 1, 1, True))
STATS = {"f0_mean": [150.0], "f0_std": [30.0], "logspc_mean": np.linspace(-6, 0.5, 25),
         "logspc_std": np.linspace(0.2, 1.5, 25), "codeap_mean": [-20.0], "codeap_std": [6.0]}


def _tree_equal(a, b):
    flat_a = jax.tree_util.tree_leaves_with_path(a)
    flat_b = jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, x), (_, y) in zip(flat_a, flat_b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.fixture(scope="module")
def align_pair():
    from voice100_tpu.models import TextToAlignText as JaxAlign

    model = JaxAlign(vocab_size=VOCAB, num_layers=2, hidden_size=32)
    variables = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32),
                           jnp.asarray([8]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    port = TextToAlignText(VOCAB, num_layers=2, hidden_size=32, device="cpu").eval()
    port.load_state_dict(from_jax_variables(variables), strict=True)
    return model, variables, port


@pytest.fixture(scope="module")
def audio_pair():
    from voice100_tpu.models import AlignTextToAudio as JaxAudio

    model = JaxAudio(vocab_size=VOCAB, logspc_size=25, codeap_size=1, encoder_num_layers=2,
                     encoder_hidden_size=16, decoder_settings=DECODER)
    variables = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32),
                           jnp.asarray([8]))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["world_norm"]["norm"] = {k: np.asarray(v, np.float32) for k, v in STATS.items()}
    port = AlignTextToAudio(VOCAB, 25, 1, 2, 16, DECODER, device="cpu").eval()
    port.load_state_dict(from_jax_variables(variables, DECODER), strict=True)
    return model, variables, port


@pytest.mark.parametrize("settings_", [
    ((8, True, 5, 2, 2, False),),
    ((16, False, 3, 1, 1, False), (8, True, 4, 3, 0, True), (8, False, 5, 1, 2, False)),
    ((8, True, 3, 1, 1, True), (8, True, 5, 2, 1, False)),
], ids=["transposed", "conv_transposed_conv", "two_transposed"])
def test_conv_stack_with_transposed_blocks_matches_jax(settings_):
    from voice100_tpu.models.layers import ConvStack as JaxStack

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 13, 12)).astype(np.float32)
    stack = JaxStack(settings=settings_)
    variables = stack.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(stack.apply(variables, jnp.asarray(x)))
    port = ConvStack(12, settings_, device="cpu")
    state = _stack_from_jax(variables["params"], "s", [s[1] for s in settings_])
    port.load_state_dict({k[2:]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_world_norm_matches_jax():
    from voice100_tpu.models.layers import WORLDNorm as JaxNorm

    rng = np.random.default_rng(1)
    f0 = rng.standard_normal((2, 7)).astype(np.float32) * 50 + 120
    sp = rng.standard_normal((2, 7, 25)).astype(np.float32)
    ap = rng.standard_normal((2, 7, 1)).astype(np.float32)
    jax_norm = JaxNorm(25, 1)
    stats = {"world_norm": {k: np.asarray(v, np.float32) for k, v in STATS.items()}}
    port = WORLDNorm(25, 1, device="cpu")
    for k, v in STATS.items():
        getattr(port, k).copy_(torch.tensor(np.asarray(v, np.float32)))
    for method in ("normalize", "unnormalize"):
        want = jax_norm.apply(stats, jnp.asarray(f0), jnp.asarray(sp), jnp.asarray(ap),
                              method=getattr(JaxNorm, method))
        got = getattr(port, method)(torch.from_numpy(f0), torch.from_numpy(sp),
                                    torch.from_numpy(ap))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
    assert [n for n, _ in port.named_buffers()] == list(STATS)


def test_weights_round_trip_exactly(align_pair, audio_pair):
    for (_, variables, port), settings_ in ((align_pair, None), (audio_pair, DECODER)):
        state = from_jax_variables(variables, settings_)
        assert state.keys() == port.state_dict().keys()
        _tree_equal(to_jax_variables(state, settings_), variables)
        again = from_jax_variables(to_jax_variables(state, settings_), settings_)
        for k in state:
            torch.testing.assert_close(again[k], state[k], rtol=0, atol=0)
    # the reference's names: decoder.{i}, and world_norm as norm.* buffers
    state = audio_pair[2].state_dict()
    assert state["decoder.1.conv.weight"].shape == (32, 32, 5)  # [in, out, k]
    assert {f"norm.{n}" for n in STATS} <= state.keys()
    with pytest.raises(ValueError, match="settings"):
        from_jax_variables(audio_pair[1])


def test_transposed_kernel_is_the_reference_flip(audio_pair):
    """The port's ConvTranspose1d weight is the reference torch layout, so
    the JAX importer's flip (``import_torch.py:73-76``) takes it back."""
    from voice100_tpu.tools.import_torch import convert_tts_v2

    model, variables, port = audio_pair
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    _tree_equal(convert_tts_v2(state, model), variables)


def test_align_predict_matches_jax(align_pair):
    from voice100_tpu.models import TextToAlignText as JaxAlign

    model, variables, port = align_pair
    rng = np.random.default_rng(2)
    text = rng.integers(1, VOCAB, (3, 24)).astype(np.int32)
    text_len = np.asarray([24, 11, 1], np.int32)
    want_y = np.asarray(model.apply(variables, jnp.asarray(text), jnp.asarray(text_len)))
    want = np.asarray(model.apply(variables, jnp.asarray(text), jnp.asarray(text_len),
                                  method=JaxAlign.predict))
    with torch.no_grad():
        got_y = port(torch.from_numpy(text), torch.from_numpy(text_len)).numpy()
    got = port.predict(torch.from_numpy(text), torch.from_numpy(text_len)).numpy()
    np.testing.assert_allclose(got_y, want_y, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_audio_predict_matches_jax(audio_pair):
    from voice100_tpu.models import AlignTextToAudio as JaxAudio

    model, variables, port = audio_pair
    rng = np.random.default_rng(3)
    aligntext = rng.integers(0, VOCAB, (3, 40)).astype(np.int32)
    lengths = np.asarray([40, 23, 1], np.int32)
    want = model.apply(variables, jnp.asarray(aligntext), jnp.asarray(lengths),
                       method=JaxAudio.predict)
    got = port.predict(torch.from_numpy(aligntext), torch.from_numpy(lengths))
    for name, g, w in zip(("f0", "mcep", "codeap"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4, err_msg=name)
    assert (got[0] == 0).any() and (got[0] > 0).any()  # the gate both ways
    raw = port(torch.from_numpy(aligntext), torch.from_numpy(lengths))
    raw_want = model.apply(variables, jnp.asarray(aligntext), jnp.asarray(lengths))
    for g, w in zip(raw, raw_want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.output_length(torch.from_numpy(lengths)).numpy(),
                                  np.asarray(model.output_length(jnp.asarray(lengths))))


def _expand_both(text, align, text_len, out_len, head=5, tail=5):
    from voice100_tpu.ops import duration

    jax_expand = jax.jit(duration.expand_alignment_batch, static_argnums=(3, 4, 5))
    want_ids, want_len = jax_expand(jnp.asarray(text), jnp.asarray(align),
                                    jnp.asarray(text_len), out_len, head=head, tail=tail)
    ids, lengths = expand_alignment_batch(torch.from_numpy(text), align,
                                          torch.from_numpy(text_len), out_len, head, tail)
    assert ids.dtype == torch.int32 and lengths.dtype == torch.int32
    return (ids.numpy(), lengths.numpy()), (np.asarray(want_ids), np.asarray(want_len))


@settings(max_examples=30, deadline=None, database=None)
@given(data=st.data(), batch=st.sampled_from([1, 3]), length=st.sampled_from([1, 24]),
       out_len=st.sampled_from([7, 160]), head=st.sampled_from([0, 5]))
def test_expansion_is_bit_equal_to_jax(data, batch, length, out_len, head):
    """Dyadic durations (multiples of 1/64, negative ones included) make
    every float32 sum exact, so cursor values land exactly on integers
    (floor's ties) and the lengths' totals do not depend on the order."""
    align = np.asarray(data.draw(st.lists(st.integers(-64, 64 * 12), min_size=batch * length * 2,
                                          max_size=batch * length * 2)),
                       np.float32).reshape(batch, length, 2) / 64
    text = np.asarray(data.draw(st.lists(st.integers(1, VOCAB - 1), min_size=batch * length,
                                         max_size=batch * length)), np.int32).reshape(batch,
                                                                                      length)
    text_len = np.asarray(data.draw(st.lists(st.integers(1, length), min_size=batch,
                                             max_size=batch)), np.int32)
    (ids, lengths), (want_ids, want_len) = _expand_both(text, align, text_len, out_len, head)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(lengths, want_len)


@pytest.mark.parametrize("case", ["float", "negative", "text_len_1", "capped"])
def test_expansion_edge_cases_match_jax(case):
    rng = np.random.default_rng(4)
    batch, length, out_len = 5, 30, 400
    y = rng.normal(0.8, 0.9, (batch, length, 2))
    if case == "negative":
        y = rng.normal(-0.2, 1.0, (batch, length, 2))  # exp(y) - 1 < 0 for y < 0
    align = (np.exp(y) - 1).astype(np.float32)
    text = rng.integers(1, VOCAB, (batch, length)).astype(np.int32)
    text_len = rng.integers(1, length + 1, batch).astype(np.int32)
    if case == "text_len_1":
        text_len[:] = 1
    if case == "capped":
        out_len = 20
    (ids, lengths), (want_ids, want_len) = _expand_both(text, align, text_len, out_len)
    if case == "negative":
        assert (align < 0).mean() > 0.3
    if case == "capped":
        assert (want_len == out_len).all()
    np.testing.assert_array_equal(ids, want_ids)
    # a length truncates a float32 total whose summation order XLA picks:
    # name any row whose total lies within a rounding of an integer
    mask = np.arange(length)[None, :] < text_len[:, None]
    total = (align.astype(np.float64) * mask[:, :, None]).sum((1, 2)) - align[:, 0, 0]
    ties = np.nonzero(np.abs(total - np.round(total)) < 1e-5 * np.maximum(1, np.abs(total)))[0]
    keep = np.setdiff1d(np.arange(batch), ties)
    np.testing.assert_array_equal(lengths[keep], want_len[keep], err_msg=f"tie rows {ties}")
    assert (np.abs(lengths[ties].astype(int) - want_len[ties]) <= 1).all()
    for b in keep:
        from voice100_tpu.ops.duration import aligntext_length as jax_length

        n = int(text_len[b])
        if case != "capped":
            assert aligntext_length(align[b, :n]) == int(jax_length(jnp.asarray(align[b, :n])))


def test_align_method_expands_by_the_models_durations(align_pair):
    from voice100_tpu.models import TextToAlignText as JaxAlign

    model, variables, port = align_pair
    rng = np.random.default_rng(5)
    text = rng.integers(1, VOCAB, (2, 16)).astype(np.int32)
    text_len = np.asarray([16, 9], np.int32)
    durations = port.predict(torch.from_numpy(text), torch.from_numpy(text_len))
    want = model.apply(variables, jnp.asarray(text), jnp.asarray(durations.numpy()),
                       jnp.asarray(text_len), 64, method=JaxAlign.align)
    got = port.align(torch.from_numpy(text), durations, torch.from_numpy(text_len), 64)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_merge_world_stats_matches_jax(tmp_path, audio_pair, kind):
    from voice100_tpu.training.checkpoint import merge_world_stats as jax_merge
    from voice100_tpu_torch.training import merge_world_stats

    stats = {k: (np.asarray(v, np.float32) + 1.5) for k, v in STATS.items()}
    del stats["codeap_std"]  # a key the file lacks keeps its value
    path = str(tmp_path / f"stat.{kind}")
    if kind == "npz":
        np.savez(path, **stats)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in stats.items()}, path)
    _, variables, port = audio_pair
    want = jax_merge(jax.tree_util.tree_map(np.array, variables), path)["world_norm"]["norm"]
    model = AlignTextToAudio(VOCAB, 25, 1, 2, 16, DECODER, device="cpu")
    model.load_state_dict(port.state_dict())
    assert merge_world_stats(model, path) is model
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(model.norm, k).numpy(), v)
    assert merge_world_stats(TextToAlignText(VOCAB, 1, 32, device="cpu"), path) is not None
