"""One rank of a data-parallel run of the port, for tests/test_torch_distributed.py.

``python tests/torch_dist_worker.py SPEC.json`` joins a gloo group on the
CPU (``coordinator``, ``world``, ``rank`` of the spec), builds a small
model, takes its contiguous rows of each global batch in ``batches`` (a
``torch.save`` file of ``{"train": [...], "val": [...]}`` collated NumPy
batches) and either fits it (``mode: fit``: ``Trainer.fit`` with the
spec's ``TrainerConfig`` fields, log and checkpoints included) or takes
one optimizer step a train batch with augmentation and dropout off
(``mode: steps``), writing the global batch's losses and the final
weights to ``out``; with ``loss_after`` also the global batch's loss of
the last train batch after the steps. A ``config`` with
``mesh_model_axis`` above 1 makes the ranks a tensor-parallel mesh; in
``steps`` mode each rank then also writes (to ``out.rank{r}``) what it
holds between steps: its shards' shapes, the storage bytes of the
module's tensors and of weights derived from them, and the shapes of its
Adam state. ``evaluate_between`` evaluates on each train batch after the
first before its step (building the derived weights), and ``frozen``
names parameters that get no gradient, so that Adam keeps no state for
them. :func:`run` without ``world`` is the same run in one process, over
the whole global batches. Imports neither jax nor the JAX package, so a
rank starts in a few seconds.
"""

import json
import sys

import numpy as np
import torch

from voice100_tpu_torch.models import AlignTextToAudio, AudioToAlignText, AudioToTextCTC
from voice100_tpu_torch.parallel import mesh as parallel
from voice100_tpu_torch.training import Trainer, TrainerConfig, make_task

MODELS = {"asr": AudioToAlignText, "tts": AlignTextToAudio, "asr_v1": AudioToTextCTC}


def _tensors(batch):
    return tuple(tuple(torch.from_numpy(np.array(a)) for a in pair) for pair in batch)


def _rows(batch, rank, world):
    """This rank's contiguous rows of a global batch."""
    n = batch[0][0].shape[0] // world
    return tuple(tuple(a[rank * n:(rank + 1) * n] for a in pair) for pair in batch)


def build_model(spec):
    model = MODELS[spec["model"]](**spec["model_args"], device="cpu",
                                  generator=torch.Generator().manual_seed(spec.get("seed", 0)))
    if spec.get("weights"):
        model.load_state_dict(torch.load(spec["weights"], weights_only=True))
    for name, value in (spec.get("norm") or {}).items():
        getattr(model.norm, name).copy_(torch.tensor(value, dtype=torch.float32))
    return model


def _derived_bytes(model):
    """The storage bytes of the tensors ``model``'s modules keep beside
    their parameters and buffers (weights derived from the parameters,
    such as a biLSTM's stacked weights)."""
    kept = {}
    for module in model.modules():
        for key, value in vars(module).items():
            if key in ("_parameters", "_buffers", "_modules"):
                continue
            stack = [value]
            while stack:
                x = stack.pop()
                if isinstance(x, torch.Tensor):
                    kept[x.untyped_storage().data_ptr()] = x.untyped_storage().nbytes()
                elif isinstance(x, dict):
                    stack.extend(x.values())
                elif isinstance(x, (list, tuple)):
                    stack.extend(x)
    return sum(kept.values())


def run(spec):
    world = spec.get("world")
    if world:
        parallel.init_distributed(spec["coordinator"], world, spec["rank"], device="cpu")
    rank, world = parallel.process_index(), parallel.process_count()
    try:
        data = torch.load(spec["batches"], weights_only=False)
        train = [_tensors(_rows(b, rank, world)) for b in data["train"]]
        val = [_tensors(_rows(b, rank, world)) for b in data.get("val", [])]
        model = build_model(spec)
        for name in spec.get("frozen", []):
            model.get_parameter(name).requires_grad_(False)
        trainer = Trainer(TrainerConfig(**spec.get("config", {})))
        if spec["mode"] == "fit":
            try:
                trainer.fit(model, train, val or None, restore_from=spec.get("restore_from"))
            finally:
                trainer.close()
            return
        task = make_task(model)
        state = trainer.make_state(task)
        tensor_parallel = bool(state.shards.sharded)
        losses, held = [], []
        for i, batch in enumerate(train):
            built = None
            if i and spec.get("evaluate_between"):
                trainer.evaluate(task, state, [batch])
                built = _derived_bytes(model)
            loss = trainer.train_step(task, state, batch, None, train=False)["loss"]
            if world > 1:
                loss = parallel.all_reduce_(loss.clone())
            losses.append(float(loss))
            if tensor_parallel:
                held.append({
                    "leaves": [tuple(t.shape) for t in state.shards.leaves],
                    "module_bytes": [p.untyped_storage().nbytes() for p in model.parameters()],
                    "derived_bytes": _derived_bytes(model), "derived_before_step": built,
                    "adam": [tuple(state.optimizer.state[leaf]["exp_avg"].shape)
                             if leaf in state.optimizer.state else None
                             for leaf in state.shards.leaves]})
        out = {"losses": losses}
        if spec.get("loss_after"):
            out["loss_after"] = trainer.evaluate(task, state, train[-1:])["loss"]
        if tensor_parallel:
            state.shards.ensure_full()
            torch.save({"held": held, "dims": state.shards.dims}, f"{spec['out']}.rank{rank}")
        if rank == 0:
            torch.save({**out, "model": model.state_dict()}, spec["out"])
    finally:
        parallel.shutdown_distributed()


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        run(json.load(f))
