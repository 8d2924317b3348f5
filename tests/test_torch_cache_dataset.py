"""The port's ``tools/cache_dataset`` vs the JAX tool (CPU).

Both tools warm a feature cache over one dummy_en corpus, each into a
directory of its own: the same entries by name; the WORLD entries
byte-equal (the host analysis is a copy of the JAX package's); the
float16 log-mel entries equal, or one float16 step apart where the two
float32 features, within the 1e-4 of tests/test_torch_data.py, round to
neighbouring values.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import os

import numpy as np
import pytest

from corpus_fixture import make_dummy_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    data_dir = str(tmp_path_factory.mktemp("cache_data"))
    make_dummy_corpus(data_dir, n_clips=4)
    return data_dir


def _warm(cli, corpus, cache_dir, vocoder, extra=()):
    cli(["--vocoder", vocoder, "--dataset", "dummy_en", "--data_dir", corpus,
         "--cache_dir", cache_dir, "--batch_size", "2", *extra])
    return sorted(os.listdir(cache_dir))


@pytest.mark.parametrize("vocoder", ["world", "mel"])
def test_cache_dataset_writes_the_jax_tools_entries(corpus, tmp_path, vocoder, capsys):
    from voice100_tpu.tools.cache_dataset import cli_main as jax_cli
    from voice100_tpu_torch.tools.cache_dataset import cli_main

    got_dir, want_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    got = _warm(cli_main, corpus, got_dir, vocoder, ["--device", "cpu"])
    want = _warm(jax_cli, corpus, want_dir, vocoder)
    assert got == want and len(got) == 4
    assert "[cache-dataset] warmed cache over 2 batches" in capsys.readouterr().out
    for name in got:
        a, b = (open(os.path.join(d, name), "rb").read() for d in (got_dir, want_dir))
        if vocoder == "world":
            assert a == b, name
            continue
        a, b = (np.load(os.path.join(d, name)) for d in (got_dir, want_dir))
        assert a.dtype == b.dtype == np.float16 and a.shape == b.shape
        step = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        np.testing.assert_array_less(np.abs(a.astype(np.float32) - b.astype(np.float32)),
                                     step.astype(np.float32) * 1.0001)
