"""The port's ``parallel/mesh.py`` against the JAX package's (CPU).

``pad_batch_to_multiple`` is NumPy on both sides and is held to the JAX
function on the same batches. ``fit_mesh_for_batch`` and ``make_mesh``
over eight CPU devices are held to the JAX functions over the eight
virtual devices of ``tests/conftest.py`` (``tests/test_multichip.py:
258-330``): the same ``data`` axis for every batch size and the same
warnings (``model > 1`` and parameter placement are held to JAX in
``tests/test_torch_tensor_parallel.py``). ``shard_batch`` splits a batch into
contiguous shards that concatenate back to it; ``replicate`` copies a
module onto each device of the data axis; outside a process group the
global-batch helpers change nothing.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import logging

import numpy as np
import pytest
import torch

import jax

from voice100_tpu_torch.parallel import mesh as parallel

CPUS = ["cpu"] * 8


def _batch(rows, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal((rows, 5, 3)).astype(np.float32),
             rng.integers(1, 5, rows).astype(np.int32)),
            {"text": rng.integers(0, 29, (rows, 4)).astype(np.int32)})


@pytest.mark.parametrize("rows,multiple", [(3, 2), (4, 2), (5, 4), (1, 8), (8, 8), (9, 8)])
def test_pad_batch_to_multiple_matches_jax(rows, multiple):
    from voice100_tpu.parallel.mesh import pad_batch_to_multiple as jax_pad

    batch = _batch(rows)
    want, want_n = jax_pad(batch, multiple)
    got, got_n = parallel.pad_batch_to_multiple(batch, multiple)
    assert got_n == want_n == rows
    for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.shape[0] % multiple == 0
    tensors = jax.tree_util.tree_map(torch.from_numpy, batch)
    padded, n = parallel.pad_batch_to_multiple(tensors, multiple)
    for g, w in zip(jax.tree_util.tree_leaves(padded), jax.tree_util.tree_leaves(want)):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _warnings(caplog, logger):
    return [r.getMessage() for r in caplog.records if r.name == logger]


@pytest.mark.parametrize("batch_size", list(range(1, 21)) + [64, 128])
def test_fit_mesh_for_batch_matches_jax(batch_size, caplog):
    from voice100_tpu.parallel.mesh import fit_mesh_for_batch as jax_fit

    assert len(jax.devices()) == len(CPUS)
    with caplog.at_level(logging.WARNING):
        want = jax_fit(batch_size)
        got = parallel.fit_mesh_for_batch(batch_size, devices=CPUS)
    assert got.shape == want.shape
    assert got.size == want.size
    assert _warnings(caplog, "voice100_tpu_torch.parallel.mesh") == _warnings(
        caplog, "voice100_tpu.parallel.mesh")


def test_fit_mesh_for_batch_cases_of_the_jax_tests(caplog):
    """``tests/test_multichip.py:258-330``, model=1."""
    assert parallel.fit_mesh_for_batch(16, devices=CPUS).shape["data"] == 8
    assert parallel.fit_mesh_for_batch(4, devices=CPUS).shape["data"] == 4
    with caplog.at_level(logging.WARNING, logger="voice100_tpu_torch.parallel.mesh"):
        assert parallel.fit_mesh_for_batch(6, devices=CPUS).shape["data"] == 6
    assert any("idle" in m for m in _warnings(caplog, "voice100_tpu_torch.parallel.mesh"))
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="voice100_tpu_torch.parallel.mesh"):
        assert parallel.fit_mesh_for_batch(9, devices=CPUS).shape["data"] == 5
    assert any("padded" in m for m in _warnings(caplog, "voice100_tpu_torch.parallel.mesh"))


def test_make_mesh_shapes():
    from voice100_tpu.parallel.mesh import make_mesh as jax_make_mesh

    for data in (None, 8):
        mesh = parallel.make_mesh(CPUS, data=data)
        assert mesh.shape == jax_make_mesh(jax.devices(), data=data).shape == {"data": 8,
                                                                               "model": 1}
        assert mesh.size == 8 and mesh.data_devices == [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="a 3x1 mesh needs 3 devices, got 8"):
        parallel.make_mesh(CPUS, data=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            parallel.make_mesh()


@pytest.mark.parametrize("devices", [2, 4])
def test_shard_batch_round_trips(devices):
    mesh = parallel.make_mesh(["cpu"] * devices)
    batch = _batch(8, seed=devices)
    shards = parallel.shard_batch(batch, mesh)
    assert len(shards) == devices
    for leaves in zip(*(jax.tree_util.tree_leaves(s) for s in shards)):
        assert {leaf.shape[0] for leaf in leaves} == {8 // devices}
    for i, want in enumerate(jax.tree_util.tree_leaves(batch)):
        got = torch.cat([jax.tree_util.tree_leaves(s)[i] for s in shards])
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="7 rows do not split over the mesh data axis"):
        parallel.shard_batch(_batch(7), mesh)
    padded, n = parallel.pad_batch_to_multiple(_batch(7), devices)
    assert n == 7 and len(parallel.shard_batch(padded, mesh)) == devices


def test_replicate_copies_a_module_onto_each_device():
    module = torch.nn.Linear(3, 2)
    one, again = parallel.replicate(module, parallel.make_mesh(["cpu", "cpu"]))
    assert one is again is module
    if torch.cuda.is_available():
        first, second = parallel.replicate(module, parallel.make_mesh(["cpu", "cuda:0"]))
        assert first is module and second is not module
        assert torch.equal(second.weight.cpu(), module.weight)


def test_without_a_process_group_nothing_changes():
    assert (parallel.process_index(), parallel.process_count()) == (0, 1)
    assert not parallel.mesh_spans_processes() and not parallel.in_process_group()
    x = torch.arange(24.0).reshape(4, 3, 2)
    with parallel.global_batch():
        assert not parallel.global_batch_active()
        assert parallel.global_sum(x) is x
        assert torch.equal(parallel.roll_rows(x), torch.roll(x, -1, 0))
        g1, g2 = torch.Generator().manual_seed(1), torch.Generator().manual_seed(1)
        assert torch.equal(parallel.own_rows_of_draw(
            lambda shape: torch.rand(shape, generator=g1), x.shape), torch.rand(x.shape,
                                                                                generator=g2))
    parallel.barrier()
    parallel.shutdown_distributed()
    with pytest.raises(ValueError, match="go together"):
        parallel.init_distributed("localhost:1", None, 0, device="cpu")
