"""The reference against the port's CPU path at tiny sizes, through whole
runs of each cell, and the faults a cell can have coming out as not
correct: the harness's look for a card skipped, the timed path broken
underneath."""

import numpy as np
import pytest
import torch

from bench_tiny import OVERRIDES
from yardstick import faults, harness, spec

CELLS = list(OVERRIDES)
BENCH = spec.load_json(spec.REPO_ROOT / "BENCHMARK.json")


def run(cell, seed, seconds, **kwargs):
    """One run of ``cell``, a candidate cell too (the served cell)."""
    return harness.run_cell(cell, seed, seconds, False, bench=spec.with_cell(BENCH, cell),
                            **kwargs)


@pytest.mark.parametrize("cell", CELLS)
def test_port_cpu_path_agrees_with_the_reference(cell):
    out = run(cell, 2**31 + 11, 0.4, device="cpu", overrides=OVERRIDES[cell])
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    for name, check in out["checks"].items():
        assert check["value"] <= check["limit"], name


FAULTS = [
    ("asr_en_base.train_librispeech", "unchanged_state"),
    ("asr_en_base.train_librispeech", "half_batch"),
    ("tts_en_base.train_ljspeech", "unchanged_state"),
    ("tts_en_base.train_ljspeech", "half_batch"),
    ("asr_en_base.transcribe_bulk", "altered_token"),
    ("asr_en_base.serve_poisson", "altered_token"),
]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    out = run(cell, 5, 0.4, device="cpu", overrides=OVERRIDES[cell],
              hooks={"program": faults.FAULTS[fault]})
    assert not out["correct"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_stand_in_is_judged_in_the_programs_place(cell):
    """A hook that returns a precision puts the reference, computed in it,
    where the harness reads the program's outputs: the float32 reference
    against itself reads nought on every compared number."""
    out = run(cell, 9, 0.4, device="cpu", overrides=OVERRIDES[cell],
              hooks={"program": lambda **_: "float32"})
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values()), out["checks"]


def test_reference_forward_equals_the_port_model():
    """The plain reference's logits equal the port's CPU forward on the same
    weights and the same padded batch."""
    from voice100_tpu_torch.models import AudioToAlignText
    from reference.asr_v2 import ASRReference
    from yardstick import synth

    args = {**spec.load_json(spec.BENCH_DIR / "configs" / "asr_en_base.json")["init_args"],
            **OVERRIDES["asr_en_base.train_librispeech"]["config"]["init_args"]}
    model = AudioToAlignText(**args, device="cpu")
    weights = synth.fill_weights(model, 3)
    model.eval()
    x = torch.randn(3, 64, 64) - 4.0
    lengths = torch.tensor([64, 40, 9])
    with torch.no_grad():
        got, got_len = model(x, lengths)
        ref, ref_len = ASRReference(args, weights).forward(x, lengths)
    assert torch.equal(got_len, ref_len)
    assert float((got - ref).abs().max()) < 1e-5


def test_seeds_give_the_same_sizes_in_another_order():
    from yardstick import synth

    mix = spec.load_json(spec.BENCH_DIR / "traffic" / "train_librispeech.json")
    a = synth.pool_seconds(mix, 256)
    b = synth.pool_seconds(mix, 256)
    assert np.array_equal(a, b)
    assert 2.0 <= a.min() and a.max() <= 24.5 and 11.5 < a.mean() < 14.0


CONTROL_SIZES = {
    "asr_en_base.train_librispeech": {"traffic": {"batch_size": 16, "pool": 64}},
    "tts_en_base.train_ljspeech": {"traffic": {"batch_size": 32, "pool": 128}},
    "asr_en_base.transcribe_bulk": {"traffic": {"clips_per_call": 64, "variants": 2}},
    "asr_en_base.serve_poisson": {"traffic": {"pool": 64, "warm_s": 1.0}},
}


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_in_tf32_fails_the_limits(cell, cuda_device):
    """The control (the reference in TF32 in the program's place) comes out
    as not correct through the harness's own comparison on three seeds, at
    a test's size, while the program on the card comes out as correct."""
    for seed in (1, 2, 3):
        out = run(cell, seed, 2.0, device=cuda_device, overrides=CONTROL_SIZES[cell])
        assert out["correct"], out["checks"]
        out = run(cell, seed, 2.0, device=cuda_device, overrides=CONTROL_SIZES[cell],
                  hooks={"program": faults.FAULTS["control_tf32"]})
        assert not out["correct"], out["checks"]
        assert any(c["value"] > c["limit"] for c in out["checks"].values()), out["checks"]
