"""Tensor-parallel placement of the port against the JAX package (CPU).

``make_mesh`` and ``fit_mesh_for_batch`` with a ``model`` axis,
``infer_param_spec`` and ``shard_params`` are held to the JAX functions
over the eight virtual CPU devices of ``tests/conftest.py``, on every case
of ``tests/test_multichip.py:258-330``: the same mesh shapes and warnings,
the same errors (``ValueError`` where JAX asserts), the same spec (as a
tuple) for each case of the policy and for every leaf of the JAX
``_small_model`` tree on a ``(4, 2)`` mesh; a tensor's chunks concatenate
back to it. A single process asked for ``mesh_model_axis`` > 1 stops
before any step, as the JAX mesh's assertion does on one device; the
flag and the config key reach ``TrainerConfig``. Serving pipelines over a
``(2, 2)`` mesh are the ``(2, 1)`` mesh's, bit for bit: the model axis
adds no work. Multi-rank training is in
``tests/test_torch_tensor_parallel_ranks.py``.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import logging

import numpy as np
import pytest
import torch

import jax

from voice100_tpu_torch.parallel import mesh as parallel

CPUS = ["cpu"] * 8
PORT_LOGGER, JAX_LOGGER = "voice100_tpu_torch.parallel.mesh", "voice100_tpu.parallel.mesh"


class Leaf:
    """A leaf that has a shape and nothing else (``test_multichip.py:268``)."""

    def __init__(self, shape):
        self.shape = shape
        self.ndim = len(shape)


@pytest.mark.parametrize("data,model,want", [
    (4, 2, {"data": 4, "model": 2}), (None, 2, {"data": 4, "model": 2}),
    (2, 4, {"data": 2, "model": 4}), (None, 8, {"data": 1, "model": 8}),
    (1, 8, {"data": 1, "model": 8}),
])
def test_make_mesh_with_a_model_axis_matches_jax(data, model, want):
    from voice100_tpu.parallel.mesh import make_mesh as jax_make_mesh

    mesh = parallel.make_mesh(CPUS, data=data, model=model)
    assert mesh.shape == dict(jax_make_mesh(jax.devices(), data=data, model=model).shape) == want
    # row-major: the data axis's devices are the first of each row
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = parallel.make_mesh(devices, data=data, model=model)
    assert mesh.data_devices == devices[::want["model"]]
    assert [list(row) for row in mesh.devices] == [
        devices[i * want["model"]:(i + 1) * want["model"]] for i in range(want["data"])]


@pytest.mark.parametrize("data,model,match", [
    (3, 2, "a 3x2 mesh needs 6 devices, got 8"),
    (None, 3, "a mesh with model=3 needs a multiple of 3 devices, got 8"),
    (4, 4, "a 4x4 mesh needs 16 devices, got 8"),
])
def test_make_mesh_errors_where_jax_asserts(data, model, match):
    from voice100_tpu.parallel.mesh import make_mesh as jax_make_mesh

    with pytest.raises(AssertionError):
        jax_make_mesh(jax.devices(), data=data, model=model)
    with pytest.raises(ValueError, match=match):
        parallel.make_mesh(CPUS, data=data, model=model)


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


@pytest.mark.parametrize("batch_size", list(range(1, 21)) + [64, 128])
def test_fit_mesh_for_batch_with_a_model_axis_matches_jax(batch_size, caplog):
    from voice100_tpu.parallel.mesh import fit_mesh_for_batch as jax_fit

    with caplog.at_level(logging.WARNING):
        want = jax_fit(batch_size, model=2)
        got = parallel.fit_mesh_for_batch(batch_size, model=2, devices=CPUS)
    assert got.shape == dict(want.shape) and got.shape["model"] == 2
    assert got.size == want.size
    assert _warnings(caplog, PORT_LOGGER) == _warnings(caplog, JAX_LOGGER)


@pytest.mark.parametrize("shape,model,want", [
    ((1024, 256), 2, ("model", None)),   # LSTM gate matrix [4H, D]: the big axis
    ((256,), 2, ("model",)),             # a bias of min_size: sharded
    ((64,), 2, ()),                      # a small bias: replicated
    ((), 2, ()),                         # a scalar
    ((3, 3), 2, ()),
    ((257, 254), 2, ()),                 # no axis both divisible and >= min_size
    ((1024, 256), 1, ()),                # model=1: everything replicated
    ((512, 512, 5), 2, (None, "model", None)),  # a tie goes to the later axis
    ((5, 512, 1024), 4, (None, None, "model")),
    ((29, 1024), 2, (None, "model")),    # the port's dense [out, in]
    ((512, 128), 2, ("model", None)),
    ((768, 512), 8, ("model", None)),
])
def test_infer_param_spec_matches_jax(shape, model, want):
    from voice100_tpu.parallel.mesh import infer_param_spec as jax_spec, make_mesh as jax_mesh

    jax_got = jax_spec(Leaf(shape), jax_mesh(jax.devices(), model=model))
    got = parallel.infer_param_spec(Leaf(shape), parallel.make_mesh(CPUS, model=model))
    assert got == tuple(jax_got) == want
    assert parallel.infer_param_spec(torch.zeros(shape), parallel.make_mesh(CPUS,
                                                                            model=model)) == want


def test_every_leaf_of_the_jax_small_model_gets_the_jax_spec():
    """``tests/test_multichip.py:35-46`` at H=64: the LSTM gate matrices
    (4H = 256 rows) are the leaves the policy shards."""
    from test_multichip import _batch, _small_model
    from voice100_tpu.parallel.mesh import infer_param_spec as jax_spec, make_mesh as jax_mesh
    from voice100_tpu.training.tasks import make_task

    variables = make_task(_small_model()).init(jax.random.PRNGKey(0), _batch())
    leaves = jax.tree_util.tree_leaves_with_path(variables["params"])
    mesh, port_mesh = jax_mesh(jax.devices(), data=4, model=2), parallel.make_mesh(CPUS, 4, 2)
    specs = {jax.tree_util.keystr(path): parallel.infer_param_spec(np.asarray(leaf), port_mesh)
             for path, leaf in leaves}
    assert specs == {jax.tree_util.keystr(path): tuple(jax_spec(leaf, mesh))
                     for path, leaf in leaves}
    assert sum(1 for s in specs.values() if "model" in s) >= 8


@pytest.mark.parametrize("model", [2, 4])
def test_shard_params_chunks_concatenate_back(model):
    from voice100_tpu.parallel.mesh import infer_param_spec as jax_spec, make_mesh as jax_mesh

    rng = np.random.default_rng(model)
    params = {"kernel": rng.standard_normal((512, 128)).astype(np.float32),
              "conv": [torch.from_numpy(rng.standard_normal((512, 512, 5)).astype(np.float32)),
                       torch.zeros(16)],
              "bias": rng.standard_normal(16).astype(np.float32)}
    mesh = parallel.make_mesh(CPUS, model=model)
    shards = [parallel.shard_params(params, mesh, model_index=k) for k in range(model)]
    # replicated leaves come back as they are; sharded ones as contiguous chunks
    assert all(s["bias"] is params["bias"] and s["conv"][1] is params["conv"][1] for s in shards)
    for key, full, dim in (("kernel", params["kernel"], 0), ("conv", params["conv"][0], 1)):
        parts = [s[key] if key == "kernel" else s[key][0] for s in shards]
        assert all(p.shape[dim] == full.shape[dim] // model for p in parts)
        if isinstance(full, torch.Tensor):
            assert all(p.is_contiguous() for p in parts)
            assert torch.equal(torch.cat(parts, dim=dim), full)
        else:
            assert all(p.flags["C_CONTIGUOUS"] for p in parts)
            np.testing.assert_array_equal(np.concatenate(parts, axis=dim), full)
        assert tuple(jax_spec(Leaf(full.shape), jax_mesh(jax.devices(), model=model)))[dim] \
            == "model"
    # the default index is this process's: rank 0 of no group keeps chunk 0
    np.testing.assert_array_equal(parallel.shard_params(params, mesh)["kernel"],
                                  shards[0]["kernel"])


# --- the trainer's mesh ----------------------------------------------------

@pytest.mark.parametrize("model_axis", [2, 8])
def test_a_single_process_with_a_model_axis_stops_before_any_step(tmp_path, model_axis):
    from test_torch_cli import tiny_config
    from voice100_tpu_torch.training import trainer as trainer_mod
    from voice100_tpu_torch.training.cli import cli_main

    steps = []
    original = trainer_mod.Trainer.train_step
    trainer_mod.Trainer.train_step = lambda *a, **k: steps.append(1) or original(*a, **k)
    try:
        for flags, trainer_keys in ((["--mesh_model_axis", str(model_axis)], {}),
                                    ([], {"mesh_model_axis": model_axis})):
            cfg = tiny_config(tmp_path / "tiny.yaml", **trainer_keys)
            with pytest.raises(ValueError, match=f"mesh_model_axis={model_axis} needs a "
                                                 f"multiple of {model_axis} processes.*got 1"):
                cli_main(["fit", "--config", cfg, "--device", "cpu",
                          "--checkpoint_dir", str(tmp_path / "ck")] + flags)
    finally:
        trainer_mod.Trainer.train_step = original
    assert not steps and not (tmp_path / "ck").exists()


@pytest.mark.parametrize("flags,trainer_keys,want", [
    ([], {}, 1), (["--mesh_model_axis", "2"], {}, 2), ([], {"mesh_model_axis": 4}, 4),
    (["--mesh_model_axis", "2"], {"mesh_model_axis": 4}, 4),  # the key over the flag
])
def test_mesh_model_axis_reaches_the_trainer_config(tmp_path, flags, trainer_keys, want):
    from test_torch_cli import tiny_config
    from voice100_tpu.training.cli import build_from_config as jax_build
    from voice100_tpu_torch.training.cli import _parser, build_trainer_config, load_config

    args = _parser().parse_args(["fit", "--config", "c.yaml"] + flags)
    config = load_config(tiny_config(tmp_path / "tiny.yaml", **trainer_keys))
    overrides = {"mesh_model_axis": args.mesh_model_axis}
    assert build_trainer_config(config, overrides).mesh_model_axis == want
    assert jax_build(config, overrides)[2].mesh_model_axis == want


# --- serving on a mesh with a model axis -----------------------------------

def test_pipelines_on_a_2x2_mesh_equal_the_2x1_mesh():
    """The JAX pipelines replicate the variables and split rows over
    ``data`` (``voice100_tpu/inference.py:114-126, 455-464``): the
    ``model`` axis's devices add no work and change no output."""
    from voice100_tpu_torch.inference import ASRPipeline, TTSPipeline
    from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, TextToAlignText

    meshes = {"2x2": parallel.make_mesh(["cpu"] * 4, data=2, model=2),
              "2x1": parallel.make_mesh(["cpu"] * 2, data=2)}
    assert meshes["2x2"].data_devices == meshes["2x1"].data_devices
    rng = np.random.default_rng(3)
    clips = [(rng.standard_normal(n) * 0.3).astype(np.float32)
             for n in (4000, 9000, 2500, 7000, 6100)]
    asr = AudioToAlignText(64, 29, ((16, False, 5, 2, 2, False),), 1, 16, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    got = {}
    for name, mesh in meshes.items():
        pipe = ASRPipeline(asr, mesh=mesh, batch_size=4, buckets_sec=(0.5, 1.0))
        got[name] = [pipe._decode(wav, lens) for (_, wav, lens) in pipe.batches(clips)]
        got[name + "_text"] = pipe.transcribe(clips)
    assert got["2x2_text"] == got["2x1_text"]
    for a, b in zip(got["2x2"], got["2x1"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))

    align = TextToAlignText(29, 1, 16, device="cpu", generator=torch.Generator().manual_seed(1))
    audio = AlignTextToAudio(29, 25, 1, 1, 16, ((16, False, 3, 1, 1, False),
                                                (16, True, 5, 2, 2, False)),
                             device="cpu", generator=torch.Generator().manual_seed(2))
    texts = ["hello world", "ok", "the quick brown fox"]
    waves = {name: TTSPipeline(align, audio, use_phone=False, mesh=mesh, text_buckets=(32, 64),
                               frame_buckets=(128, 256)).synthesize(
        texts, noise=torch.Generator().manual_seed(3)) for name, mesh in meshes.items()}
    assert len(waves["2x2"]) == 3 and all(map(np.array_equal, waves["2x2"], waves["2x1"]))
