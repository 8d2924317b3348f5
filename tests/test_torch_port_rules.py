"""Rules the PyTorch port keeps (CPU).

* it imports neither jax nor anything of voice100_tpu (checked in a
  subprocess: this pytest process has jax loaded by conftest);
* its entry points run on CUDA unless asked for the CPU, and raise when
  CUDA is absent instead of running on the CPU;
* chip_smoke.py drives asr_en_base at the width config/asr_en_base.yaml
  gives, and fails (printing no result) without a card or without the
  package beside it;
* the public surface: every module of voice100_tpu/ has a port module at
  the same path, and each of its public names (``__all__`` and the
  top-level defs and classes, read from the source as text) exists there,
  or stands in :data:`SURFACE_ALLOWLIST` with its port counterpart or the
  reason it has none (TPU/JAX only): nothing is left to port.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import ast
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
        "        'voice100_tpu_torch.tools.calc_stat', 'voice100_tpu_torch.data.pack',\n"
        "        'voice100_tpu_torch.data.prefetch', 'voice100_tpu_torch.data.device_cache',\n"
        "        'voice100_tpu_torch.ops.ctc_beam', 'voice100_tpu_torch.ops.ctc_beam_device',\n"
        "        'voice100_tpu_torch.text.ngram', 'voice100_tpu_torch.tools.train_lm',\n"
        "        'voice100_tpu_torch.server', 'voice100_tpu_torch.utils.profiling',\n"
        "        'voice100_tpu_torch.tools.cache_dataset',\n"
        "        'voice100_tpu_torch.dsp.world.dio_device', 'voice100_tpu_torch.dsp.world.synthesis_np',\n"
        "        'voice100_tpu_torch.native.world', 'voice100_tpu_torch.onnx.schema',\n"
        "        'voice100_tpu_torch.onnx.builder', 'voice100_tpu_torch.onnx.runtime',\n"
        "        'voice100_tpu_torch.onnx.export', 'voice100_tpu_torch.onnx.serve',\n"
        "        'voice100_tpu_torch.tools.export', 'voice100_tpu_torch.tools.import_torch',\n"
        "        'voice100_tpu_torch.parallel', 'voice100_tpu_torch.parallel.mesh',\n"
        "        'voice100_tpu_torch.models.asr_v1', 'voice100_tpu_torch.models.align_v1',\n"
        "        'voice100_tpu_torch.models.tts_v1', 'voice100_tpu_torch.tools.train_v1',\n"
        "        } <= set(names), names\n"
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


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    from voice100_tpu_torch.data import AudioTextDataModule, MelSpectrogramAudioTransform
    from voice100_tpu_torch.device import resolve_device
    from voice100_tpu_torch.inference import ASRPipeline
    from voice100_tpu_torch.models import AudioToAlignText, ConformerCTC
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
        ConformerCTC(n_layers=1)
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
    # serving and the tools of the long-form slice: the server's CLI, the
    # cache warmer and the profiler's trace
    from voice100_tpu_torch.server import cli_main as serve_main
    from voice100_tpu_torch.tools.cache_dataset import cli_main as cache_main
    from voice100_tpu_torch.utils.profiling import trace

    with pytest.raises(RuntimeError, match="CUDA"):
        serve_main(["--asr_config", str(ROOT / "config" / "asr_en_base.yaml"),
                    "--asr_ckpt", "none"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cache_main(["--vocoder", "mel"])
    with pytest.raises(RuntimeError, match="CUDA"):
        with trace(os.devnull):
            pass
    with trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(2).sum()
    assert prof.trace_path and os.path.exists(prof.trace_path)
    # data parallelism: a rank of --distributed, a mesh's default devices
    from voice100_tpu_torch.parallel import make_mesh
    from voice100_tpu_torch.training.cli import main as fit_main

    with pytest.raises(RuntimeError, match="CUDA"):
        fit_main(["fit", "--config", str(ROOT / "config" / "asr_en_base.yaml"), "--distributed",
                  "--coordinator_address", "localhost:1", "--num_processes", "1",
                  "--process_id", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    # the v1 family: each model and each train-v1 CLI
    from voice100_tpu_torch import models
    from voice100_tpu_torch.tools import train_v1

    for cls, args in ((models.AudioToTextCTC, (64, 29)), (models.AudioAlignCTC, (64, 29)),
                      (models.TextToAlignTextModel, (29,)), (models.AlignTextToAudioModel, (29,)),
                      (models.AlignTextToAudioMultiTaskModel, (29, 71))):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(*args, hidden_size=8)
        assert next(cls(*args, hidden_size=8, device="cpu").parameters()).device.type == "cpu"
    for main in (train_v1.asr_cli_main, train_v1.align_cli_main, train_v1.ttsaudio_cli_main,
                 train_v1.ttsaudio_mt_cli_main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--data_dir", str(tmp_path), "--hidden_size", "8"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_v1.ttsalign_cli_main(["--data_dir", str(tmp_path), "--hidden_size", "8"])


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


# JAX modules without a port module: the Pallas kernels (ported as CUDA,
# csrc/), the device F0 of dio_jax.py (dsp/world/dio_device.py) and the
# generated protobuf module (onnx/schema.py builds its classes in code)
NO_PORT_MODULE = {
    "ops/lstm_pallas.py": "TPU/JAX only: kernels 1-3 are csrc/bilstm*.cu, ops/lstm_cuda.py",
    "ops/ctc_pallas.py": "TPU/JAX only: kernels 4-7 are csrc/ctc.cu, csrc/viterbi.cu",
    "ops/melspec_pallas.py": "TPU/JAX only: kernel 8 is csrc/melspec.cu, ops/melspec_cuda.py",
    "dsp/world/dio_jax.py": "port: dsp/world/dio_device.py",
    "onnx/voice100_onnx_pb2.py": "port: onnx/schema.py (descriptor built in code)",
}
# (JAX module, public name) -> the port's counterpart ("port: ...") or why
# it has none ("TPU/JAX only: ...")
SURFACE_ALLOWLIST = {
    ("dsp/world/__init__.py", "synthesize"): "port: dsp/world/synthesis.py synthesize_batch",
    ("dsp/world/__init__.py", "synthesize_fn"): "port: dsp/world/synthesis.py synthesize_batch",
    ("dsp/world/synthesis.py", "synthesize"): "port: synthesize_batch",
    ("dsp/world/synthesis.py", "synthesize_fn"): "port: synthesize_batch",
    ("onnx/schema.py", "OnnxSchemaUnavailable"):
        "TPU/JAX only: protoc fallback; the port builds its classes in code",
    ("ops/__init__.py", "log_mel_spectrogram"): "port: ops/melspec.py",
    ("ops/__init__.py", "MelSpectrogram"):
        "port: ops/melspec_cuda.py log_mel_spectrogram_cuda / ops/melspec.py log_mel_spectrogram",
    ("ops/__init__.py", "MELSPEC_DIM"): "port: ops/melspec.py",
    ("ops/__init__.py", "LOG_OFFSET"): "port: ops/melspec.py",
    ("ops/__init__.py", "sequence_mask"): "port: ops/mask.py",
    ("ops/__init__.py", "ctc_loss"): "port: ops/ctc.py, ops/ctc_cuda.py ctc_loss_cuda",
    ("ops/__init__.py", "ctc_viterbi_align"): "port: ops/ctc.py, ops/viterbi_cuda.py",
    ("ops/__init__.py", "ViterbiResult"): "port: ops/ctc.py",
    ("ops/__init__.py", "batch_spectrogram_augment"):
        "port: ops/augment.py draw_augment + apply_augment",
    ("ops/__init__.py", "BLANK_AUDIO"): "port: ops/mask.py",
    ("ops/__init__.py", "expand_alignment"): "port: ops/duration.py expand_alignment_batch",
    ("ops/__init__.py", "expand_alignment_batch"): "port: ops/duration.py",
    ("ops/augment.py", "batch_spectrogram_augment"): "port: draw_augment + apply_augment",
    ("ops/duration.py", "expand_alignment"): "port: expand_alignment_batch",
    ("ops/melspec.py", "MelSpectrogram"):
        "port: ops/melspec_cuda.py log_mel_spectrogram_cuda / log_mel_spectrogram",
    ("ops/ctc.py", "last_kernel_mode"): "TPU/JAX only: the Pallas/scan switch",
    ("ops/lstm.py", "last_kernel_mode"): "TPU/JAX only: the Pallas/scan switch",
    ("ops/lstm.py", "init_lstm_params"): "port: models/layers.py BiLSTM",
    ("ops/lstm.py", "multilayer_bilstm"): "port: models/layers.py BiLSTM",
    ("parallel/__init__.py", "batch_sharding"): "TPU/JAX only: GSPMD sharding",
    ("parallel/__init__.py", "replicated"): "TPU/JAX only: GSPMD sharding",
    ("parallel/mesh.py", "batch_sharding"): "TPU/JAX only: GSPMD sharding",
    ("parallel/mesh.py", "replicated"): "TPU/JAX only: GSPMD sharding",
    ("parallel/mesh.py", "replicate_tree"): "port: replicate",
    ("parallel/mesh.py", "kernel_sharding"): "TPU/JAX only: shard_map of the Pallas kernels",
    ("parallel/mesh.py", "active_kernel_mesh"): "TPU/JAX only: shard_map of the Pallas kernels",
    ("parallel/mesh.py", "kernel_batch_axes"): "TPU/JAX only: shard_map of the Pallas kernels",
    ("parallel/mesh.py", "kernel_batch_divisor"): "TPU/JAX only: shard_map of the Pallas kernels",
    ("parallel/mesh.py", "pallas_interpret"): "TPU/JAX only: the Pallas interpret switch",
    ("parallel/mesh.py", "data_shard_map"): "TPU/JAX only: shard_map",
    ("tools/import_torch.py", "convert_asr_v2"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_align_v2"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_tts_v2"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_asr_v1"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_align_v1"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_ttsalign_v1"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_ttsaudio_v1"): "port: convert_state_dict",
    ("tools/import_torch.py", "convert_ttsaudio_mt_v1"): "port: convert_state_dict",
    ("training/__init__.py", "load_variables"): "port: training/checkpoint.py load_model_weights",
    ("training/checkpoint.py", "load_variables"): "port: load_model_weights",
    ("training/tasks.py", "upcast_float_inputs"): "port: tasks._upcast",
}


def _public_names(tree) -> list:
    """``__all__`` and the top-level defs and classes not named with ``_``."""
    names = []
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__"
                                                for t in node.targets):
            names = list(ast.literal_eval(node.value))
    return names + [n.name for n in tree.body
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))
                    and not n.name.startswith("_") and n.name not in names]


def _defined_names(tree) -> set:
    """Every name a module binds at its top level (defs, classes,
    assignments, imports)."""
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            out.update(n.id for t in targets for n in ast.walk(t) if isinstance(n, ast.Name))
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0] for a in node.names)
    return out


def test_public_surface_audit():
    jax_root = ROOT / "voice100_tpu"
    missing, used = [], set()
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        port = PACKAGE / rel
        if rel in NO_PORT_MODULE:
            assert not port.exists(), f"{rel} has a port module now: drop it from NO_PORT_MODULE"
            continue
        assert port.exists(), f"voice100_tpu/{rel} has no port module voice100_tpu_torch/{rel}"
        have = _defined_names(ast.parse(port.read_text()))
        for name in _public_names(ast.parse(path.read_text())):
            if (rel, name) in SURFACE_ALLOWLIST:
                assert name not in have, f"{rel} {name} is ported now: drop its allowlist entry"
                used.add((rel, name))
            elif name not in have:
                missing.append(f"{rel}: {name}")
    assert not missing, missing
    assert set(SURFACE_ALLOWLIST) == used, set(SURFACE_ALLOWLIST) - used
    reasons = list(SURFACE_ALLOWLIST.values()) + list(NO_PORT_MODULE.values())
    # every name has its counterpart or is the TPU's own: nothing is left to port
    assert all(r.startswith(("port: ", "TPU/JAX only: ")) for r in reasons)
