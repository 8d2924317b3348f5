"""The port's prepare_dataset vs the JAX package's (CPU).

Both tools write ``{ds}-[phone-]{split}.txt`` into ``--data_dir``; the
port's files must be byte-equal to JAX's on a dummy_en and a dummy_ja
corpus in both modes, on FLAC corpora in the LJSpeech and LibriSpeech
layouts (train and valid splits), and on a kokoro corpus, whose phone
transcripts pass through. The kokoro branch's three ``ValueError``\\ s
(a split other than train, no ``--use_phone``, a language other than
ja) are raised by both with the same text.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os
import shutil

import pytest

from corpus_fixture import make_dummy_corpus
from test_torch_native import write_flac_corpora


def _run(data_dir, argv):
    """Both tools on copies of one corpus: ``{name: (port bytes, jax bytes)}``."""
    from voice100_tpu.tools.prepare_dataset import cli_main as jax_main
    from voice100_tpu_torch.tools.prepare_dataset import cli_main

    dirs = {}
    for side, main in (("port", cli_main), ("jax", jax_main)):
        dirs[side] = f"{data_dir}-{side}"
        shutil.copytree(data_dir, dirs[side])
        # the corpus fixtures write transcript files of their own
        for name in os.listdir(dirs[side]):
            if name.endswith(".txt"):
                os.remove(os.path.join(dirs[side], name))
        before = set(os.listdir(dirs[side]))
        main(["--data_dir", dirs[side], *argv])
        dirs[side + "_new"] = sorted(set(os.listdir(dirs[side])) - before)
    assert dirs["port_new"] == dirs["jax_new"] and dirs["port_new"]
    return {name: tuple(open(os.path.join(dirs[side], name), "rb").read()
                        for side in ("port", "jax")) for name in dirs["port_new"]}


@pytest.mark.parametrize("language", ["en", "ja"])
@pytest.mark.parametrize("use_phone", [True, False], ids=["phone", "char"])
def test_dummy_corpus_files_equal_jax(tmp_path, language, use_phone):
    data_dir = str(tmp_path / "data")
    make_dummy_corpus(data_dir, language=language, n_clips=6)
    files = _run(data_dir, ["--dataset", f"dummy_{language}", "--language", language]
                 + (["--use_phone"] if use_phone else []))
    want = f"dummy_{language}-{'phone-' if use_phone else ''}train.txt"
    assert list(files) == [want]
    port, ref = files[want]
    assert port == ref and port.count(b"\n") == 6


def test_flac_corpora_files_equal_jax(tmp_path):
    data_dir = str(tmp_path / "data")
    texts = write_flac_corpora(data_dir)
    files = _run(data_dir, ["--dataset", "ljspeech,librispeech", "--split", "train,valid",
                            "--language", "en", "--use_phone"])
    assert sorted(files) == ["librispeech-phone-train.txt", "librispeech-phone-valid.txt",
                             "ljspeech-phone-train.txt", "ljspeech-phone-valid.txt"]
    for port, ref in files.values():
        assert port == ref
    lines = files["ljspeech-phone-train.txt"][0].decode().splitlines()
    assert len(lines) == len(texts["ljspeech"]) and lines[0].startswith("LJ001-0001|D/AA1/K/T/ER0")
    assert files["librispeech-phone-valid.txt"][0].count(b"\n") == len(texts["librispeech_dev"])


def _kokoro(data_dir):
    root = os.path.join(data_dir, "kokoro-speech-v1_2-small")
    os.makedirs(root)
    with open(os.path.join(root, "metadata.csv"), "w", encoding="utf-8") as f:
        f.write("meian_0000|今日は晴れです。|ky o u w a h a r e d e s u .\n"
                "meian_0001|東京へ行く。|t o u ky o u e i k u .\n")


def test_kokoro_passes_phone_transcripts_through_as_jax(tmp_path):
    data_dir = str(tmp_path / "data")
    _kokoro(data_dir)
    files = _run(data_dir, ["--dataset", "kokoro_small", "--language", "ja", "--use_phone"])
    port, ref = files["kokoro_small-phone-train.txt"]
    assert port == ref
    assert port.decode().splitlines()[1] == "meian_0001|t o u ky o u e i k u ."


@pytest.mark.parametrize("argv,match", [
    (["--split", "valid", "--language", "ja", "--use_phone"], "no 'valid' split"),
    (["--language", "ja"], "pass --use_phone"),
    (["--language", "en", "--use_phone"], "Japanese corpus"),
], ids=["split", "use_phone", "language"])
def test_kokoro_value_errors_match_jax(tmp_path, argv, match):
    from voice100_tpu.tools.prepare_dataset import cli_main as jax_main
    from voice100_tpu_torch.tools.prepare_dataset import cli_main

    data_dir = str(tmp_path / "data")
    _kokoro(data_dir)
    messages = []
    for main in (cli_main, jax_main):
        with pytest.raises(ValueError, match=match) as err:
            main(["--data_dir", data_dir, "--dataset", "kokoro_small", *argv])
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_module_runs_as_a_script(tmp_path):
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    data_dir = str(tmp_path / "data")
    make_dummy_corpus(data_dir, n_clips=3)
    out = subprocess.run([sys.executable, "-m", "voice100_tpu_torch.tools.prepare_dataset",
                          "--data_dir", data_dir, "--dataset", "dummy_en", "--language", "en",
                          "--use_phone"], cwd=root, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": root}, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "[prepare-dataset] wrote" in out.stdout
    assert os.path.exists(os.path.join(data_dir, "dummy_en-phone-train.txt"))
