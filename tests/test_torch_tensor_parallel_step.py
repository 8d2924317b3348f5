"""One tensor-parallel step of the port against the JAX package (CPU).

The JAX ``_small_model`` (``tests/test_multichip.py:35-46``, H=64, so the
4H = 256 gate matrices and biases shard), carried across with
``tools/weights.py``, takes one step on gloo ranks at ``(1, 2)`` and
``(2, 2)`` against the JAX step on a ``(4, 2)`` mesh (clip 1.0, Adam 1e-3,
``:63-112``; augmentation and dropout off on both sides, since the port
cannot draw JAX's): the loss before and after within the JAX test's atol
2e-5, the gathered weights within rtol 2e-5 / atol 2e-6 where Adam's step
is well conditioned (see ``ADAM_WELL_CONDITIONED``). Between steps each
rank holds its shards alone: the module's sharded tensors are freed,
Adam's moments have the shards' shapes, and the weights an evaluation
stacked from the gathered parameters are gone. Ranks are
``tests/torch_dist_worker.py`` subprocesses at one torch thread each.
"""

import torch_threads  # noqa: F401  (first: torch's CPU threads a worker)

import numpy as np
import pytest
import torch

from test_torch_tensor_parallel_ranks import _assert_ok, _run_ranks, _worker_argvs

import jax
import jax.numpy as jnp

W_RTOL, W_ATOL = 2e-5, 2e-6
LOSS_ATOL = 2e-5  # tests/test_multichip.py:155
# Adam's first step moves a weight by lr * g / (|g| + eps): where the
# clipped gradient is not well above eps (1e-8), float32 round-off of
# ~1e-10 in g moves the step by up to lr * 1e-10 / eps = 1e-5, on any
# layout. Such weights are held to the port-vs-JAX weight bound of
# tests/test_torch_train.py (PARAM_ATOL), every other weight to W_RTOL /
# W_ATOL.
ADAM_WELL_CONDITIONED = 1e-6


@pytest.fixture(scope="module")
def jax_tp_step():
    """``tests/test_multichip.py:63-112`` on a (4, 2) mesh, with
    ``train=False`` (the port cannot draw JAX's augmentation and dropout):
    the initial variables, the batch, the loss before and after one step
    of clip 1.0 + Adam 1e-3, and the parameters after it."""
    import optax

    from test_multichip import _batch, _small_model
    from voice100_tpu.parallel.mesh import make_mesh, shard_batch, shard_params
    from voice100_tpu.training.tasks import make_task

    mesh = make_mesh(jax.devices(), data=4, model=2)
    task = make_task(_small_model())
    batch = _batch()
    variables = dict(task.init(jax.random.PRNGKey(0), batch))
    initial = jax.tree_util.tree_map(np.asarray, variables)
    params = shard_params(variables.pop("params"), mesh)
    optimizer = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    opt_state = optimizer.init(params)

    def loss_fn(p, b):
        return task.loss(p, variables, b, jax.random.PRNGKey(1), train=False)[0]

    @jax.jit
    def step(params, opt_state, b):
        loss, grads = jax.value_and_grad(loss_fn)(params, b)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        clipped = jax.tree_util.tree_map(
            lambda g: g * jnp.minimum(1.0, 1.0 / optax.global_norm(grads)), grads)
        return optax.apply_updates(params, updates), opt_state, loss, clipped

    sharded = shard_batch(batch, mesh)
    params, _, before, grads = step(params, opt_state, sharded)
    after = jax.jit(loss_fn)(params, sharded)
    return (initial, batch, float(before), float(after),
            *(jax.tree_util.tree_map(np.asarray, t) for t in (params, grads)))


@pytest.mark.parametrize("data,model", [(1, 2), (2, 2)])
def test_one_step_matches_the_jax_4x2_mesh_step(tmp_path, jax_tp_step, data, model):
    from voice100_tpu_torch.tools.weights import from_jax_variables, to_jax_variables

    from test_torch_train import PARAM_ATOL

    initial, batch, before, after, want_params, grads = jax_tp_step
    torch.save(from_jax_variables(initial), tmp_path / "init.pt")
    torch.save({"train": [batch]}, tmp_path / "batch.pt")
    world = data * model
    results = _run_ranks({"tp": _worker_argvs(tmp_path, "tp", world, lambda rank: {
        "mode": "steps", "model": "asr", "batches": str(tmp_path / "batch.pt"),
        "weights": str(tmp_path / "init.pt"), "out": str(tmp_path / "out.pt"),
        "loss_after": True, "config": {"mesh_model_axis": model, "gradient_clip_val": 1.0},
        "model_args": {"audio_size": 64, "vocab_size": 29,
                       "encoder_settings": [[64, False, 3, 2, 1, False]],
                       "decoder_num_layers": 2, "decoder_hidden_size": 64}})})
    _assert_ok(results)
    out = torch.load(tmp_path / "out.pt", weights_only=False)
    np.testing.assert_allclose(out["losses"], [before], rtol=0, atol=LOSS_ATOL)
    np.testing.assert_allclose(out["loss_after"], after, rtol=0, atol=LOSS_ATOL)
    assert out["loss_after"] < out["losses"][0]
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_variables(out["model"])["params"]))
    grads = dict(jax.tree_util.tree_leaves_with_path(grads))
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        well = np.abs(grads[path]) >= ADAM_WELL_CONDITIONED
        assert well.mean() > 0.95, jax.tree_util.keystr(path)
        np.testing.assert_allclose(got[path][well], want[well], rtol=W_RTOL, atol=W_ATOL,
                                   err_msg=jax.tree_util.keystr(path))
        np.testing.assert_allclose(got[path], want, rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))

    # between steps every rank holds its shards alone
    full = {k: tuple(v.shape) for k, v in out["model"].items()}
    for rank in range(world):
        held = torch.load(tmp_path / f"out.pt.rank{rank}", weights_only=False)
        shapes = list(full.values())
        dims = held["dims"]
        assert sum(d is not None for d in dims) == 16  # the gate matrices and biases
        for step in held["held"]:
            for shape, leaf, adam, nbytes, dim in zip(shapes, step["leaves"], step["adam"],
                                                      step["module_bytes"], dims):
                if dim is None:
                    assert leaf == shape and adam == shape and nbytes > 0
                else:
                    half = tuple(s // model if d == dim else s for d, s in enumerate(shape))
                    assert leaf == half and adam == half and nbytes == 0


def test_between_steps_a_rank_keeps_no_weights_stacked_for_evaluation(tmp_path):
    """An evaluation between steps stacks the gathered biLSTM weights
    (``BiLSTM.stacked_layers``); the next step's release drops them with
    the module's sharded tensors, so what a rank keeps between steps stays
    its shards."""
    from test_multichip import _batch

    torch.save({"train": [_batch()] * 3}, tmp_path / "batch.pt")
    _assert_ok(_run_ranks({"tp": _worker_argvs(tmp_path, "tp", 2, lambda rank: {
        "mode": "steps", "model": "asr", "batches": str(tmp_path / "batch.pt"),
        "out": str(tmp_path / "out.pt"), "evaluate_between": True,
        "config": {"mesh_model_axis": 2, "gradient_clip_val": 1.0},
        "model_args": {"audio_size": 64, "vocab_size": 29,
                       "encoder_settings": [[64, False, 3, 2, 1, False]],
                       "decoder_num_layers": 2, "decoder_hidden_size": 64}})}))
    for rank in range(2):
        held = torch.load(tmp_path / f"out.pt.rank{rank}", weights_only=False)
        steps = held["held"]
        assert len(steps) == 3 and steps[0]["derived_before_step"] is None
        # 2 layers x 2 directions x 4H x (D + H + 1) floats: 4H = 256, D = 64 then 128
        assert all(s["derived_before_step"] == 4 * 2 * 256 * ((64 + 64 + 1) + (128 + 64 + 1))
                   for s in steps[1:])
        for step in steps:
            assert step["derived_bytes"] == 0
            assert all(nbytes == 0 for nbytes, dim in zip(step["module_bytes"], held["dims"])
                       if dim is not None)
