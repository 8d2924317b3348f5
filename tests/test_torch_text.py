"""The port's text front end vs the JAX package's (CPU).

``voice100_tpu_torch/text/`` holds copies of the JAX package's G2P
(``g2p.py``, ``lts_rules.py``, ``heteronyms.py``) and Japanese reader
(``japanese/``). These are deterministic string functions, so every
output is held with ``==``:

* ``G2P`` and ``CMUPhonemizer`` on every string that tests/test_g2p.py
  and tests/test_heteronyms.py use (read from their source), the rule
  engine alone on every word of the embedded lexicon, and the
  ``lexicon_path`` hook on a small CMUdict file;
* ``JapanesePhonemizer`` in both ``use_phone`` modes on every
  ``GOLD_SENTENCES`` entry of tests/test_japanese_gold.py and every
  other string of that file (its numbers and counters);
* a hypothesis property: random mixed ASCII, digit, kana and kanji
  strings through all four ``get_phonemizer`` combinations;
* importing ``voice100_tpu_torch.text`` loads neither the letter-to-sound
  rules nor the heteronym table (they load at the first word that needs
  them, as in the JAX package).
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import ast
import os
import subprocess
import sys

import pytest
from hypothesis import given, settings, strategies as st

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, "tests")


def _strings(name):
    """Every string constant of a test file of the JAX package, in order,
    without duplicates or docstring-length prose."""
    tree = ast.parse(open(os.path.join(TESTS, name), encoding="utf-8").read())
    seen = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            text = node.value
            if text.strip() and len(text) <= 400 and "\n" not in text.strip() and text not in seen:
                seen.append(text)
    return seen


@pytest.fixture(scope="module")
def g2ps():
    from voice100_tpu.text.g2p import G2P as JaxG2P
    from voice100_tpu_torch.text.g2p import G2P

    return G2P(), JaxG2P()


@pytest.mark.parametrize("source", ["test_g2p.py", "test_heteronyms.py"])
def test_g2p_and_cmu_phonemizer_match_jax_on_the_test_strings(g2ps, source):
    from voice100_tpu.text.phonemizers import CMUPhonemizer as JaxCMU
    from voice100_tpu_torch.text import CMUPhonemizer

    port, ref = g2ps
    strings = _strings(source)
    assert len(strings) > 50
    words = sorted({w for s in strings for w in s.lower().split() if w.isalpha()})
    port_cmu, jax_cmu = CMUPhonemizer(), JaxCMU()
    for text in strings:
        assert port(text) == ref(text), text
        assert port_cmu(text) == jax_cmu(text), text
    for word in words:
        assert port._word_phones(word) == ref._word_phones(word), word


def test_rule_engine_matches_jax_on_the_lexicon():
    """The letter-to-sound rules alone (no lexicon) on every word of the
    embedded lexicon, as test_g2p.py's accuracy floors read them."""
    from voice100_tpu.text.g2p import G2P as JaxG2P, _LEXICON as JAX_LEXICON
    from voice100_tpu_torch.text.g2p import G2P, _LEXICON

    assert _LEXICON == JAX_LEXICON
    engines = []
    for cls in (G2P, JaxG2P):
        engine = cls.__new__(cls)
        engine._lexicon = {}
        engine._g2p_en = None
        engines.append(engine)
    port, ref = engines
    for word in JAX_LEXICON:
        assert port._word_phones(word) == ref._word_phones(word), word


def test_tables_equal_jax():
    from voice100_tpu.text import heteronyms as jax_heteronyms, lts_rules as jax_rules
    from voice100_tpu_torch.text import heteronyms, lts_rules

    assert lts_rules.RULES == jax_rules.RULES
    names = [n for n in dir(jax_heteronyms) if n.isupper()]
    assert names
    for name in names:
        assert getattr(heteronyms, name) == getattr(jax_heteronyms, name), name


def test_lexicon_path_hook_matches_jax(tmp_path):
    from voice100_tpu.text.phonemizers import CMUPhonemizer as JaxCMU
    from voice100_tpu_torch.text import CMUPhonemizer

    path = tmp_path / "cmudict.txt"
    path.write_text(";;; comment\nZORBLATT  Z AO1 R B L AE0 T\nZORBLATT(1)  Z ER0 B L AE1 T\n"
                    "READ  R EH1 D\nQUIXOTIC  K W IH0 K S AA1 T IH0 K\n")
    port, ref = CMUPhonemizer(lexicon_path=str(path)), JaxCMU(lexicon_path=str(path))
    for text in ("The zorblatt was quixotic.", "I read it; zorblatt!", "Quixotic 12 zorblatts"):
        assert port(text) == ref(text), text
    assert port("zorblatt") == "Z/AO1/R/B/L/AE0/T"


@pytest.fixture(scope="module")
def ja_strings():
    import test_japanese_gold

    gold = [text for text, _ in test_japanese_gold.GOLD_SENTENCES]
    others = [s for s in _strings("test_japanese_gold.py") if s not in gold]
    return gold, others


@pytest.mark.parametrize("use_phone", [True, False], ids=["phone", "romaji"])
def test_japanese_phonemizer_matches_jax(ja_strings, use_phone):
    from voice100_tpu.text.japanese import JapanesePhonemizer as JaxJapanese
    from voice100_tpu_torch.text.japanese import JapanesePhonemizer

    gold, others = ja_strings
    assert len(gold) > 100 and any(ch.isdigit() for s in others for ch in s)
    port, ref = JapanesePhonemizer(use_phone=use_phone), JaxJapanese(use_phone=use_phone)
    for text in gold + others:
        assert port(text) == ref(text), text


def test_japanese_readings_and_numbers_match_jax(ja_strings):
    """The reader's katakana and the number reader behind the phonemizer."""
    from voice100_tpu.text.japanese.numbers import read_number as jax_read_number
    from voice100_tpu.text.japanese.yomi import text2kata as jax_text2kata
    from voice100_tpu_torch.text.japanese.numbers import read_number
    from voice100_tpu_torch.text.japanese.yomi import text2kata

    gold, others = ja_strings
    for text in gold + others:
        assert text2kata(text) == jax_text2kata(text), text
    for n in list(range(0, 130)) + [999, 1000, 3600, 8000, 10000, 65536, 123456789, 10**9]:
        assert read_number(str(n)) == jax_read_number(str(n)), n
    assert read_number("09012345678") == jax_read_number("09012345678")


MIXED = st.text(
    alphabet=st.sampled_from(
        list("abcXYZ .,!?'-$%0123456789") + list("あいうえおかきくけこゃゅょっんー")
        + list("アイウエオヴヵヶ・") + list("日本語漢字東京時分円人本龍鷹") + list("０１２「」、。々")),
    max_size=30)


@pytest.mark.parametrize("language,use_phone",
                         [("en", True), ("en", False), ("ja", True), ("ja", False)])
def test_get_phonemizer_matches_jax_on_random_mixed_text(language, use_phone):
    from voice100_tpu.text import get_phonemizer as jax_get_phonemizer
    from voice100_tpu_torch.text import get_phonemizer

    port = get_phonemizer(language, use_phone)
    ref = jax_get_phonemizer(language, use_phone)
    assert type(port).__name__ == type(ref).__name__

    @settings(max_examples=150, deadline=None, derandomize=True)
    @given(MIXED)
    def check(text):
        assert port(text) == ref(text)

    check()


def test_importing_the_text_package_leaves_the_large_tables_unloaded():
    code = ("import sys\n"
            "import voice100_tpu_torch.text as text\n"
            "loaded = [m for m in ('voice100_tpu_torch.text.lts_rules',\n"
            "          'voice100_tpu_torch.text.heteronyms') if m in sys.modules]\n"
            "assert not loaded, loaded\n"
            "text.get_phonemizer('en', True)('Zorblatt read the record.')\n"
            "assert 'voice100_tpu_torch.text.lts_rules' in sys.modules\n"
            "assert 'voice100_tpu_torch.text.heteronyms' in sys.modules\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": ROOT}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
