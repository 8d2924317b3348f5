"""Rules the PyTorch port keeps (CPU).

* it imports neither jax nor anything of voice100_tpu (checked in a
  subprocess: this pytest process has jax loaded by conftest);
* its entry points run on CUDA unless asked for the CPU, and raise when
  CUDA is absent instead of running on the CPU;
* chip_smoke.py drives asr_en_base at the width config/asr_en_base.yaml
  gives, and fails (printing no result) without a card or without the
  package beside it.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "voice100_tpu_torch"
FORBIDDEN_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|flax|voice100_tpu)(\.|\s|$)", re.M)


def _env():
    return {**os.environ, "PYTHONPATH": str(ROOT)}


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import voice100_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'voice100_tpu')]\n"
        "assert len(names) >= 12, names\n"
        "assert {'voice100_tpu_torch.__main__', 'voice100_tpu_torch.ops.metrics',\n"
        "        'voice100_tpu_torch.training.cli', 'voice100_tpu_torch.models.losses',\n"
        "        'voice100_tpu_torch.dsp.world.dio', 'voice100_tpu_torch.dsp.world.cheaptrick',\n"
        "        'voice100_tpu_torch.dsp.world.aperiodicity', 'voice100_tpu_torch.dsp.world.backend',\n"
        "        'voice100_tpu_torch.tools.calc_stat'} <= set(names), names\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_have_no_jax_imports(path):
    assert not FORBIDDEN_IMPORT.search(path.read_text()), path


def test_entry_points_default_to_cuda_and_raise_without_it():
    from voice100_tpu_torch.data import AudioTextDataModule, MelSpectrogramAudioTransform
    from voice100_tpu_torch.device import resolve_device
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText
    from voice100_tpu_torch.models.layers import BiLSTM, ConvStack
    from voice100_tpu_torch.ops import viterbi_cuda
    from voice100_tpu_torch.tools.align_text import cli_main, run_align

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    settings = ((8, False, 3, 2, 1, False),)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioToAlignText(64, 29, settings, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        BiLSTM(8, 8, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ConvStack(64, settings)
    model = AudioToAlignText(64, 29, settings, 1, 8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ASRPipeline(model)
    assert ASRPipeline(model, device="cpu").device.type == "cpu"
    # the align slice: the data module's log-mel transform, the align tool
    with pytest.raises(RuntimeError, match="CUDA"):
        AudioTextDataModule(vocoder="mel")
    with pytest.raises(RuntimeError, match="CUDA"):
        MelSpectrogramAudioTransform()
    data = AudioTextDataModule(vocoder="mel", device="cpu")
    assert data.audio_transform.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        run_align(model, data, os.devnull)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(["--config", str(ROOT / "config" / "asr_en_base.yaml"), "--checkpoint", "none"])
    # TTS training's data path: the WORLD data module and calc_stat (the
    # analysis runs on the host; the vocoder decodes on the device)
    from voice100_tpu_torch.tools.calc_stat import cli_main as calc_stat_main

    with pytest.raises(RuntimeError, match="CUDA"):
        AudioTextDataModule(vocoder="world_mcep")
    with pytest.raises(RuntimeError, match="CUDA"):
        calc_stat_main(["--output", os.devnull, "--vocoder", "world_mcep"])
    assert AudioTextDataModule(vocoder="world_mcep", device="cpu").audio_size == 27
    # the Viterbi kernel's wrapper takes the device of its tensors: the plain
    # twins on the CPU, without a launch; another device raises
    lp = torch.log_softmax(torch.randn(2, 9, 29), dim=-1)
    args = (torch.tensor([[3, 4], [5, 0]]), torch.tensor([9, 7]), torch.tensor([2, 1]))
    launches = viterbi_cuda.viterbi_align_lattice_cuda.launches
    res = viterbi_cuda.ctc_viterbi_align_cuda(lp, *args)
    assert (res.path.device.type == "cpu"
            and viterbi_cuda.viterbi_align_lattice_cuda.launches == launches)
    with pytest.raises(ValueError, match="device"):
        viterbi_cuda.ctc_viterbi_align_cuda(lp.to("meta"), *args)


def test_chip_smoke_drives_asr_en_base_at_full_width():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    init = yaml.safe_load((ROOT / "config" / "asr_en_base.yaml").read_text())["model"]["init_args"]
    want = {k: init[k] for k in ("audio_size", "vocab_size", "decoder_num_layers",
                                 "decoder_hidden_size")}
    want["encoder_settings"] = tuple(tuple(s) for s in init["encoder_settings"])
    assert chip_smoke.ASR_EN_BASE == want


@pytest.mark.parametrize("alone", [False, True], ids=["no_cuda", "script_alone"])
def test_chip_smoke_fails_without_card_or_package(tmp_path, alone):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cwd = ROOT
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
