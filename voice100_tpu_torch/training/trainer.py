"""Training loop: train steps, gradient clipping, checkpoints, metric logs.

Port of ``voice100_tpu/training/trainer.py`` for one device: Adam from
the task, gradient clipping by global norm, a JSON log record at the
start of a fit, every ``log_every_n_steps`` steps and at each epoch's
end, the validation loss (and CER and WER for CTC models),
best/last/periodic checkpoints, the WORLD identity-statistics warning,
and a graceful stop (SIGTERM, SIGINT or :meth:`Trainer.request_stop`).

:meth:`Trainer.fit` takes a data module, as the JAX trainer does: it
calls ``setup("fit")``, trains over the train loader (its prefetch
thread) and validates over the val loader. It also takes iterables of
collated batches, the port's ``DataLoader`` among them. Either way the
loader's epoch is set before each epoch (``set_epoch``), and evaluation
cuts the rows that ``pad_to_full`` repeats (``iter_with_counts``).

The step is ``step_body`` of the JAX trainer (``trainer.py:161-177``):
the loss, its gradients, ``clip_by_global_norm`` then the task's
optimizer (Adam, or AdamW for ``AudioToTextCTC``), as ``optax.chain``
runs them, at the learning rate of the task's schedule at the state's
step (the epoch record's ``lr`` is the schedule at the epoch's end, as
in ``trainer.py:763-765``). A v1 model's BatchNorm running averages move
on train steps only (the per-step path and the dispatched chunks);
evaluation reads them. The clip follows optax's rule, not
``torch.nn.utils.clip_grad_norm_``'s: gradients are scaled by
``max / norm`` only when ``norm >= max`` (torch adds 1e-6 to the norm
and scales whenever ``norm > max``).

The trainer runs on the model's device and never moves it: a model
built for ``cuda`` on a machine without CUDA has raised already
(:func:`voice100_tpu_torch.device.resolve_device`).

``precision`` is ``"32"`` (the default) or bf16 mixed precision under
any of the JAX trainer's aliases ``"16"``, ``"bf16"``, ``"bfloat16"``,
``"16-mixed"`` (``voice100_tpu/training/trainer.py:54-75, 239-250``);
anything else raises.
:meth:`Trainer.fit` sets the process compute dtype from it
(``ops.lstm.set_default_compute_dtype``: bf16 conv blocks and the bf16
variants of the biLSTM kernels, float32 master weights and optimizer),
and resets it to float32 for a float32 fit. ``upload_dtype`` rounds each
train batch's float32 input leaves to bf16 on the host (``"auto"``: when
the precision is bf16); validation batches upload as collated.

Train batches reach the device through
:class:`voice100_tpu_torch.data.prefetch.DevicePrefetcher`
(``voice100_tpu/training/trainer.py:441-551``): on a background thread
each batch takes the bf16 upload cast where it applies, then one packed
copy (``data/pack.py``), on a side stream, while the step before it runs.

``device_cache`` keeps every collated train row on the model's device
(:class:`voice100_tpu_torch.data.device_cache.DeviceFeatureCache`, at
most ``device_cache_max_bytes``): the prefetcher hands the loader's
``(indices, batch)`` pairs to ``cache.place``, which uploads and scatters
rows it has not cached yet and gathers the others. It needs a loader
(``iter_with_indices``); a plain iterable of batches raises. The store
holds what the bf16 upload cast made. With ``steps_per_dispatch`` k > 1,
an epoch that begins with every row cached runs the groups of
``cache.epoch_plan`` in chunks of k steps (``trainer.py:553-748``): one
upload of the chunk's index matrix, each step's batch gathered on the
device at its group's extents, the k steps enqueued back to back with
their metrics stacked on the device and fetched once a chunk; the log
follows the JAX trainer's (a record when a chunk crosses a multiple of
``log_every_n_steps``, with the chunk's mean), and a stop request is
checked once a chunk. The warm epoch, an incomplete cache and ragged
batches take the per-step path. The steps draw augmentation and dropout
from the trainer's generator in step order, so a chunked run equals a
per-step run over the same batches (the plan keeps the epoch's order).

``profile_dir`` records a ``torch.profiler`` trace of the training
steps 2-4 (:func:`voice100_tpu_torch.utils.profiling.trace`, a Chrome
trace in that directory; ``trainer.py:690-726``) and logs ``{"event":
"profile_written", "dir": ...}``; a stop request mid-trace closes and
writes it. Under any trace, :meth:`Trainer.train_step` marks its phases
(:func:`voice100_tpu_torch.utils.profiling.span`): ``trainer.train_step``
over the call, ``trainer.forward`` (augmentation, forward, loss),
``trainer.backward`` and ``trainer.update`` (the gradient all-reduce,
the clip, the shard moves and the optimizer), with the caching
allocator's device allocations and frees across the step. A profiled fit takes the per-step path, whatever
``steps_per_dispatch`` says (``trainer.py:623``).

Data parallelism is one process a device, joined by ``torch.distributed``
(``parallel/mesh.py``; the CLI's ``--distributed``): each rank holds a
replica of the model and its loaders read its contiguous rows of each
global batch of ``batch_size * process_count`` rows
(``voice100_tpu/training/trainer.py:253-264``). A rank's step runs inside
:func:`voice100_tpu_torch.parallel.mesh.global_batch` (losses over the
global batch's denominators, draws for the global batch's shape), then
sums the gradients over the ranks in one flat all-reduce, then clips and
steps Adam on the same gradients as every other rank. Metrics are summed
over the ranks before they are logged; ``evaluate`` and the validation
CER/WER sum over every rank's real rows. The first train batch's shapes
are checked across ranks (one all-gather of a digest) and later batches
against it (``trainer.py:460-500``). Only rank 0 writes the log file and
checkpoints (``training/checkpoint.py``), every rank restores the same
``restore_from``, and a run of more than one process streams its batches:
the device cache is off, with the JAX trainer's warning record
(``trainer.py:560-575``), so ``steps_per_dispatch`` takes the per-step
path.

``mesh_model_axis`` m > 1 is tensor parallelism over the same ranks
(``voice100_tpu/training/trainer.py:253-321``): the run's mesh is
``(process_count / m, m)`` (``parallel.process_mesh``; m must divide the
world size, and a single process with m > 1 raises before any step, as
the JAX mesh's assertion does on one device). Each rank keeps its
``model``-axis shards of the parameters (``parallel.ParamShards``) as the
tensors Adam steps, so the moments exist for the shards alone. A step
all-gathers the full weights into the module, runs the forward and
backward on the rank's rows inside ``global_batch`` as above, sums the
gradients over every rank, clips the full gradient, steps Adam on the
rank's slices of it and frees the module's sharded tensors again. The
gradient, its norm and Adam's elementwise update are the numbers of a
data-parallel run of the same world size, so the two train bit for bit
alike. The epoch's tail gathers the weights once for validation and the
caller (``fit`` returns a module holding the full weights), and each
checkpoint gathers the shards and moments to full shape
(``training/checkpoint.py``). ``collective_counts["all_gather_params"]``:
one a step, one an epoch's tail, one a checkpoint written (and one when a
stop request ends the fit).
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch

from ..data.device_cache import DeviceFeatureCache
from ..data.pack import device_put_packed, tree_flatten
from ..data.prefetch import DevicePrefetcher
from ..ops.lstm import set_default_compute_dtype
from ..ops.metrics import error_rate
from ..parallel import mesh as parallel
from ..utils.profiling import span, trace
from .checkpoint import TrainState, restore_checkpoint, save_checkpoint
from .tasks import Task, make_task

__all__ = ["Trainer", "TrainerConfig", "TrainState", "clip_by_global_norm"]

# the JAX trainer's names of its two precisions
# (voice100_tpu/training/trainer.py:243, 431-440)
BF16_PRECISIONS = ("16", "bf16", "bfloat16", "16-mixed")
PRECISIONS = ("32",) + BF16_PRECISIONS
# the JAX trainer's words (voice100_tpu/training/trainer.py:293-297, 567-572, 479-499)
IDENTITY_STATS_WARNING = ("WORLD norm stats are identity; run tools.calc_stat and pass "
                          "--audio_stat, or the f0 stream will dominate the TTS loss")
MULTIPROCESS_CACHE_WARNING = ("device_cache disabled: multi-process runs stream batches "
                              "(per-host cache states would diverge)")
_PIN_BUCKET = ("pin one collate bucket (set VOICE100_TPU_TIME_BUCKET/TEXT_BUCKET above the "
               "corpus max) so every {} pads to the same static extents")


@dataclass
class TrainerConfig:
    max_epochs: int = 1
    gradient_clip_val: float = 1.0
    checkpoint_dir: Optional[str] = None
    monitor: str = "val_loss"
    every_n_epochs: int = 10
    save_last: bool = True
    log_every_n_steps: int = 10
    seed: int = 1234
    # the size of the mesh's model axis over the ranks: tensor parallelism
    # for m > 1 (m must divide the process count)
    mesh_model_axis: int = 1
    log_path: Optional[str] = None
    # "32", or bf16 mixed precision under any of BF16_PRECISIONS
    precision: str = "32"
    # host->device dtype of a train batch's float32 input leaves: "auto"
    # (bf16 when the precision is), "bfloat16"/"bf16"/"16", or any other
    # value for float32; targets always upload as collated
    upload_dtype: str = "auto"
    # keep every collated train row on the model's device (at most
    # device_cache_max_bytes) and gather later epochs there
    device_cache: bool = False
    device_cache_max_bytes: int = 8 * 1024**3
    # with device_cache: once every row is cached, run this many steps a
    # dispatch over the epoch plan's index matrices
    steps_per_dispatch: int = 1
    # record a torch.profiler trace of training steps 2..4 into this dir
    profile_dir: Optional[str] = None


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients of ``params`` in place by ``max_norm / norm``
    when their global norm reaches ``max_norm`` (``optax.clip_by_global_norm``);
    returns the norm before clipping. Stays on the device."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)
    return norm


def _iter_counted(batches):
    """``(batch, n_real)`` pairs: the loader's own counts where it has
    them, else every row of each batch."""
    if hasattr(batches, "iter_with_counts"):
        yield from batches.iter_with_counts()
    else:
        for batch in batches:
            yield batch, int(batch[0][0].shape[0])


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _to_bf16(a):
    """A float32 leaf (numpy or tensor) rounded to bf16, where it lies;
    any other leaf as it is."""
    if isinstance(a, np.ndarray) and a.dtype == np.float32:
        return torch.from_numpy(a).to(torch.bfloat16)
    if isinstance(a, torch.Tensor) and a.dtype == torch.float32:
        return a.to(torch.bfloat16)
    return a


class Trainer:
    def __init__(self, config: TrainerConfig) -> None:
        if str(config.precision) not in PRECISIONS:
            raise ValueError(f"precision {config.precision!r}: '32' or bf16 mixed precision "
                             f"({', '.join(repr(p) for p in BF16_PRECISIONS)})")
        self.config = config
        self.feature_cache: Optional[DeviceFeatureCache] = None
        self._stop_requested = False
        self._trace: Optional[contextlib.ExitStack] = None  # the profile in flight
        self._log_file = None
        self._batch_shapes = None  # a multi-process run's first train batch's shapes
        if config.log_path and parallel.process_index() == 0:
            # one writer: every rank is given the same log_path
            os.makedirs(os.path.dirname(config.log_path) or ".", exist_ok=True)
            self._log_file = open(config.log_path, "a")

    def close(self) -> None:
        if self._log_file is not None:
            self._log_file.close()
            self._log_file = None

    def _log(self, record: Dict[str, Any]) -> None:
        msg = " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                       for k, v in record.items())
        tag = (f"[trainer p{parallel.process_index()}]" if parallel.process_count() > 1
               else "[trainer]")
        print(f"{tag} {msg}", flush=True)
        if self._log_file:
            self._log_file.write(json.dumps(record) + "\n")
            self._log_file.flush()

    def _global_metrics(self, metrics):
        """A step's metrics of the global batch: the ranks' shares summed
        (one all-reduce) where there is more than one rank; ``metrics``
        elsewhere."""
        if metrics is None or parallel.process_count() == 1:
            return metrics
        names = list(metrics)
        summed = parallel.all_reduce_(torch.stack([metrics[k].float() for k in names]))
        return dict(zip(names, summed))

    def _check_batch_shapes(self, batch) -> None:
        """Every rank's train batches collate to one shape, so that each
        rank's rows are a share of one global batch: the first batch's
        shapes are compared across ranks (an all-gather of a digest), later
        batches with the first (``voice100_tpu/training/trainer.py:460-500``)."""
        shapes = tuple(tuple(t.shape) for pair in batch for t in pair)
        if self._batch_shapes is None:
            digests = parallel.all_gather_digest(hash(shapes) & 0x7FFFFFFF)
            if len(set(digests)) > 1:
                raise RuntimeError("multi-process batch shapes differ across hosts; "
                                   + _PIN_BUCKET.format("host"))
            self._batch_shapes = shapes
        elif shapes != self._batch_shapes:
            raise RuntimeError(f"multi-process batch shapes drifted ({shapes} vs "
                               f"{self._batch_shapes}); " + _PIN_BUCKET.format("batch"))

    def _bf16(self) -> bool:
        return str(self.config.precision) in BF16_PRECISIONS

    def process_mesh(self, model) -> parallel.Mesh:
        """The run's mesh for ``model``'s device (``parallel.process_mesh``:
        ``ValueError`` where ``mesh_model_axis`` does not divide the
        process count)."""
        return parallel.process_mesh(int(self.config.mesh_model_axis),
                                     next(model.parameters()).device)

    def make_state(self, task: Task, steps_per_epoch: int = 1,
                   mesh: Optional[parallel.Mesh] = None) -> TrainState:
        """A fresh train state of ``task``'s model on ``mesh`` (default
        :meth:`process_mesh`), its optimizer over this rank's
        ``parallel.ParamShards`` leaves, which the state keeps: the
        model's parameters where the ``model`` axis is 1, its shards of
        the large ones otherwise."""
        mesh = mesh or self.process_mesh(task.model)
        shards = parallel.ParamShards(task.model, mesh)
        return TrainState(task.model, task.make_optimizer(steps_per_epoch, shards.leaves),
                          shards=shards)

    def apply_precision(self) -> None:
        """Set the process compute dtype from ``precision``: bf16, or back
        to float32, so that an earlier bf16 run of this process does not
        leak into a float32 one."""
        set_default_compute_dtype(torch.bfloat16 if self._bf16() else None)

    def _upload_bf16(self) -> bool:
        """Whether train batches upload their float32 inputs as bf16
        (``voice100_tpu/training/trainer.py:431-440``)."""
        mode = str(self.config.upload_dtype)
        if mode in ("bfloat16", "bf16", "16"):
            return True
        return mode == "auto" and self._bf16()

    def request_stop(self) -> None:
        """The programmatic SIGTERM: stop after the current step, saving
        the ``last`` checkpoint. Armed before :meth:`fit`, it stops after
        the first step."""
        self._stop_requested = True

    def _install_stop_handlers(self):
        """SIGTERM and SIGINT (preemption, ^C) request a stop; a second
        signal raises ``KeyboardInterrupt``, so a hung step can still be
        interrupted. Only the main thread can install handlers; returns
        the ones it replaced."""
        if threading.current_thread() is not threading.main_thread():
            return []

        def on_signal(signum, frame):
            if self._stop_requested:
                raise KeyboardInterrupt
            self._log({"event": "stop_requested", "signal": int(signum)})
            self._stop_requested = True

        installed = []
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                installed.append((sig, signal.signal(sig, on_signal)))
            except (ValueError, OSError):
                pass
        return installed

    def train_step(self, task: Task, state: TrainState, batch,
                   generator: Optional[torch.Generator] = None, train: bool = True):
        """One optimizer step on ``batch``; returns the metrics as device
        tensors. ``train=False`` runs it without augmentation and dropout
        (the JAX ``task.loss(..., train=False)``). In a process group the
        batch is this rank's share of the global batch, the gradients are
        summed over the ranks before the clip, and the metrics are this
        rank's shares (:meth:`_global_metrics` sums them). On a
        tensor-parallel mesh the full weights are gathered first, and Adam
        steps the shards' slices of the clipped gradient."""
        with span("trainer.train_step", device=state.model):
            state.optimizer.zero_grad(set_to_none=True)
            state.shards.gather()
            if task.lr_schedule is not None:
                # the schedule at the state's step, so a restored state resumes
                # at its rate (optax evaluates it at the update count)
                for group in state.optimizer.param_groups:
                    group["lr"] = task.lr_schedule(state.step)
            grouped = parallel.in_process_group()
            with span("trainer.forward"), parallel.global_batch(grouped):
                loss, metrics = task.loss(batch, train, generator)
            with span("trainer.backward"):
                loss.backward()
            with span("trainer.update"):
                if grouped:
                    # the ranks' gradients of their shares of the global loss, summed
                    parallel.all_reduce_gradients(state.model.parameters())
                if self.config.gradient_clip_val and self.config.gradient_clip_val > 0:
                    clip_by_global_norm(state.model.parameters(), self.config.gradient_clip_val)
                state.shards.grads_to_leaves()
                state.optimizer.step()
                state.shards.release()
            state.step += 1
            return {k: v.detach() for k, v in metrics.items()}

    @torch.no_grad()
    def evaluate(self, task: Task, state: TrainState, batches: Iterable) -> Dict[str, float]:
        """Metrics over ``batches``, each batch weighted by its real rows,
        so the result does not depend on ``pad_to_full``: a loader with
        ``iter_with_counts`` says how many leading rows of each batch are
        real, and the repeated rows after them are cut before the loss
        (``voice100_tpu/training/trainer.py:807-849`` on one process).
        Other iterables count every row. In a process group each rank's
        batch is its share of a global batch: a batch's metrics and real
        rows are summed over the ranks, so every rank returns the metrics
        one process would over the global batches' real rows. A
        tensor-parallel ``state`` gathers its weights first where they are
        released."""
        if state is not None:
            state.shards.ensure_full()
        totals: Dict[str, float] = {}
        count = 0
        grouped = parallel.process_count() > 1
        for batch, n_real in _iter_counted(batches):
            if n_real < int(batch[0][0].shape[0]):
                batch = tuple(tuple(t[:n_real] for t in pair) for pair in batch)
            with parallel.global_batch(grouped):
                _, metrics = task.loss(batch, train=False)
            if grouped:
                # the global batch's metrics and real rows: the ranks' shares summed
                names = list(metrics)
                summed = parallel.all_reduce_(torch.stack(
                    [metrics[k].detach().float() for k in names]
                    + [metrics[names[0]].new_full((), float(n_real))]))
                metrics, n_real = dict(zip(names, summed[:-1])), int(summed[-1])
            for k, v in metrics.items():
                totals[k] = totals.get(k, 0.0) + float(v) * n_real
            count += n_real
        return {k: v / max(count, 1) for k, v in totals.items()}

    @torch.no_grad()
    def _val_cer(self, model, datamodule, batches) -> Optional[Dict[str, float]]:
        """Greedy-decode character (and word) error rates over
        ``batches`` (``voice100_tpu/training/trainer.py:852-937`` on one
        process): ``greedy_decode`` -> ``tokenizer.decode`` ->
        ``merge_repeated`` against each real row's decoded text. WER only
        where decoded text has word boundaries (char tokenizers: the
        phone tokenizers join with a ``_separator``). None without the
        data module's tokenizer. In a process group the edit and length
        counts are summed over the ranks' rows
        (``trainer.py:924-929``)."""
        tokenizer = getattr(datamodule, "text_transform", None)
        if tokenizer is None or not hasattr(type(model), "greedy_decode"):
            return None
        task = make_task(model)
        model.eval()
        word_level = not hasattr(tokenizer, "_separator")
        edits = total = w_edits = w_total = 0
        for batch, n_real in _iter_counted(batches):
            audio, audio_len, _, _ = task.upload(batch)
            ids, out_len = (_host(t) for t in model.greedy_decode(audio, audio_len))
            text, text_len = (_host(t) for t in batch[1])
            refs = [tokenizer.decode(text[i, :int(text_len[i])]) for i in range(n_real)]
            hyps = [tokenizer.merge_repeated(tokenizer.decode(ids[i, :int(out_len[i])]))
                    for i in range(n_real)]
            e, t = error_rate(refs, hyps)
            edits, total = edits + e, total + t
            if word_level:
                e, t = error_rate([r.split() for r in refs], [h.split() for h in hyps])
                w_edits, w_total = w_edits + e, w_total + t
        if parallel.process_count() > 1:
            device = next(model.parameters()).device
            sums = parallel.all_reduce_(torch.tensor([edits, total, w_edits, w_total],
                                                     dtype=torch.int64, device=device))
            edits, total, w_edits, w_total = (int(x) for x in sums.cpu())
        rates = {"cer": edits / max(total, 1)}
        if word_level:
            rates["wer"] = w_edits / max(w_total, 1)
        return rates

    def run_eval(self, model, datamodule, state: Optional[TrainState] = None,
                 stage: str = "test") -> Dict[str, float]:
        """Loss, CER and WER of ``state``'s model (default ``model``) over
        a stage of ``datamodule``: ``"test"`` its test split, any other
        stage the val split of ``setup(stage)`` (the reference's
        ``voice100 validate`` and ``test``; ``trainer.py:948-968``, which
        the JAX CLI follows with ``_val_cer``)."""
        model = state.model if state is not None else model
        datamodule.setup(stage)
        loader = datamodule.test_dataloader() if stage == "test" else datamodule.val_dataloader()
        metrics = self.evaluate(make_task(model), state, loader)
        metrics.update(self._val_cer(model, datamodule, loader) or {})
        return metrics

    def fit(self, model, data, val_batches: Optional[Iterable] = None,
            restore_from: Optional[str] = None) -> TrainState:
        """Train ``model`` for ``max_epochs``; ``restore_from`` resumes
        from a checkpoint (the epoch it saved, from that epoch's start).

        ``data`` is a data module (``setup("fit")``, then its train and
        val loaders; ``voice100_tpu/training/trainer.py:233-370``), or a
        sized iterable of collated batches in the model's task layout
        (``training/tasks.py``) that can be iterated once an epoch (a
        list, or a re-iterable loader) with ``val_batches`` beside it.

        A model with WORLD statistics (``norm``) that are still the
        identity after any restore logs the JAX trainer's warning record
        first: calc_stat was never run.

        On a stop request the current step finishes, ``{"event":
        "stopped"}`` is logged, ``last.pt`` saved and the state returned."""
        cfg = self.config
        mesh = self.process_mesh(model)  # before the data: a bad model axis stops here
        self.apply_precision()
        datamodule = None
        if hasattr(data, "setup") and hasattr(data, "train_dataloader"):
            if val_batches is not None:
                raise TypeError("fit on a data module takes its val loader; pass restore_from "
                                "by keyword")
            datamodule = data
            datamodule.setup("fit")
            train_batches, val_batches = data.train_dataloader(), data.val_dataloader()
        else:
            train_batches = data
        if cfg.device_cache and not hasattr(train_batches, "iter_with_indices"):
            raise TypeError("device_cache needs a loader (its iter_with_indices gives the rows' "
                            "dataset indices the cache keys on), not a plain iterable of batches")
        task = make_task(model)
        # a rank's loader length: the global batches of an epoch
        # (voice100_tpu/training/trainer.py:269-270)
        state = self.make_state(task, len(train_batches), mesh)
        if restore_from:
            state = restore_checkpoint(restore_from, state)
        device = next(model.parameters()).device
        norm = getattr(model, "norm", None)
        if norm is not None and float((norm.f0_std - 1.0).abs().max()) < 1e-6:
            # identity statistics mean calc_stat never ran: the raw f0
            # stream (hundreds of Hz) then dominates the WORLD loss
            self._log({"event": "warning", "message": IDENTITY_STATS_WARNING})
        processes = parallel.process_count()
        # one device a process: the run's devices are its processes
        self._log({"event": "fit_start", "params": sum(p.numel() for p in model.parameters()),
                   "steps_per_epoch": len(train_batches), "device": str(device),
                   "devices": processes, "processes": processes,
                   "mesh": {"data": processes // int(cfg.mesh_model_axis),
                            "model": int(cfg.mesh_model_axis)},
                   "upload": "bf16" if self._upload_bf16() else "f32"})
        cache = None
        self._batch_shapes = None
        if cfg.device_cache and processes > 1:
            # each rank sees other rows of the corpus, so the ranks' caches
            # would fill (and engage the dispatch) at different steps
            self._log({"event": "warning", "message": MULTIPROCESS_CACHE_WARNING})
        elif cfg.device_cache:
            cache = DeviceFeatureCache(len(train_batches.dataset),
                                       max_bytes=cfg.device_cache_max_bytes,
                                       pad_values=getattr(train_batches.collate_fn, "pad_values",
                                                          None),
                                       var_specs=getattr(train_batches.collate_fn, "var_specs",
                                                         None),
                                       device=device)
            self._log({"event": "device_cache", "items": cache.n_items})
        self.feature_cache = cache  # the last fit's device cache, for inspection
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
        installed = self._install_stop_handlers()
        try:
            return self._fit_loop(task, state, generator, train_batches, val_batches, datamodule,
                                  cache)
        finally:
            self._close_trace()
            # a reused Trainer must not stop at once on its next fit (a
            # request armed before fit still stops that fit)
            self._stop_requested = False
            for sig, old in installed:
                signal.signal(sig, old)
            if datamodule is not None:  # fit made these loaders: end their worker pools
                for loader in (train_batches, val_batches):
                    if hasattr(loader, "close"):
                        loader.close()

    def _fit_loop(self, task, state, generator, train_batches, val_batches, datamodule, cache):
        cfg = self.config
        k = int(cfg.steps_per_dispatch)
        dispatch_logged = False
        for epoch in range(state.epoch, cfg.max_epochs):
            if hasattr(train_batches, "set_epoch"):
                train_batches.set_epoch(epoch)
            start = time.time()
            plan = None
            if cache is not None and k > 1 and not cfg.profile_dir:
                plan = cache.epoch_plan(train_batches)
            if plan is None:
                running, stopped = self._streamed_epoch(task, state, generator, train_batches,
                                                        epoch, cache)
            else:
                if not dispatch_logged:
                    dispatch_logged = True
                    self._log({"event": "scan_dispatch", "steps_per_dispatch": k,
                               "batches_per_epoch": sum(len(mat) for _, mat in plan),
                               "buckets": len({key for key, _ in plan}), "runs": len(plan)})
                running, stopped = self._dispatched_epoch(task, state, generator, cache, plan,
                                                          epoch)
            if stopped:
                self._log({"event": "stopped", "epoch": epoch, "step": state.step})
                state.epoch = epoch  # a resume re-runs this epoch
                state.shards.ensure_full()
                if cfg.checkpoint_dir and cfg.save_last:
                    save_checkpoint(os.path.join(cfg.checkpoint_dir, "last.pt"), state)
                return state
            self._epoch_tail(task, state, epoch, start, running, val_batches, datamodule)
        return state

    def _prefetcher(self, task, batches, cache) -> DevicePrefetcher:
        """The train batches on the model's device, two ahead: the bf16
        upload cast where it applies, then one packed copy, or the cache's
        ``place`` of the loader's ``(indices, batch)`` pairs."""
        device = next(task.model.parameters()).device
        upload_bf16 = self._upload_bf16()

        def prepare(batch):
            return task.upload_cast(batch, _to_bf16) if upload_bf16 else batch

        if cache is None:
            return DevicePrefetcher(batches, size=2, device=device,
                                    place=lambda batch: device_put_packed(prepare(batch), device))
        return DevicePrefetcher(batches.iter_with_indices(), size=2, device=device,
                                place=lambda pair: cache.place(pair[0], prepare(pair[1])))

    def _streamed_epoch(self, task, state, generator, train_batches, epoch, cache):
        """One epoch a step at a time; returns ``(last metrics, stopped)``."""
        cfg = self.config
        running = None
        batches = self._prefetcher(task, train_batches, cache)
        try:
            for batch in batches:
                if cfg.profile_dir and state.step == 2 and self._trace is None:
                    self._trace = contextlib.ExitStack()
                    self._trace.enter_context(trace(cfg.profile_dir,
                                                    next(task.model.parameters()).device))
                if parallel.process_count() > 1:
                    self._check_batch_shapes(batch)
                running = self.train_step(task, state, batch, generator)
                if self._stop_requested:
                    self._close_trace()
                    return running, True
                if self._trace is not None and state.step == 5:
                    self._close_trace()
                    self._log({"event": "profile_written", "dir": cfg.profile_dir})
                if state.step % cfg.log_every_n_steps == 0:
                    self._log({"epoch": epoch, "step": state.step,
                               **{f"train_{k}": float(v)
                                  for k, v in self._global_metrics(running).items()}})
        finally:
            batches.close()  # ends the loader's threads when the loop leaves early
        return running, False

    def _close_trace(self) -> None:
        """End the profile in flight, if any: the trace file is written."""
        if self._trace is not None:
            self._trace.close()
            self._trace = None

    def _dispatched_epoch(self, task, state, generator, cache, plan, epoch):
        """One epoch from the device cache in chunks of
        ``steps_per_dispatch`` steps over ``plan``; returns ``(last
        metrics, stopped)``."""
        cfg = self.config
        k = int(cfg.steps_per_dispatch)
        running = None
        if cache.device.type == "cuda":
            # the store was filled on the prefetcher's side stream: its memory
            # must not be reused while this stream's gathers read it
            stream = torch.cuda.current_stream(cache.device)
            for leaf in tree_flatten(cache.store)[0]:
                leaf.record_stream(stream)
        for extents, mat in plan:
            for begin in range(0, len(mat), k):
                chunk = mat[begin:begin + k]
                metrics = {name: v.cpu().numpy() for name, v in
                           self.dispatch_chunk(task, state, generator, cache, extents,
                                               chunk).items()}  # the one fetch a chunk
                before = state.step - len(chunk)
                if before // cfg.log_every_n_steps != state.step // cfg.log_every_n_steps:
                    self._log({"epoch": epoch, "step": state.step,
                               **{f"train_{name}": float(np.mean(v))
                                  for name, v in metrics.items()}})
                running = {name: v[-1] for name, v in metrics.items()}
                if self._stop_requested:
                    return running, True
        return running, False

    def dispatch_chunk(self, task, state, generator, cache, extents, chunk):
        """``len(chunk)`` train steps enqueued back to back: one upload of
        the ``[k, B]`` index matrix ``chunk``, each step's batch gathered
        from the cache's store at ``extents``. Returns the metrics stacked
        ``[k]`` on the device; nothing here waits for the device."""
        idx = torch.from_numpy(np.ascontiguousarray(chunk, np.int64))
        if cache.device.type == "cuda":
            idx = idx.pin_memory()
        idx = idx.to(cache.device, non_blocking=True)
        store = cache.store
        steps = [self.train_step(task, state, cache.gather_rows(store, idx[j], extents), generator)
                 for j in range(len(chunk))]
        return {name: torch.stack([m[name] for m in steps]) for name in steps[0]}

    def _epoch_tail(self, task, state, epoch, start, running, val_batches, datamodule) -> None:
        """The epoch record, validation and checkpoints, on the full
        weights (a tensor-parallel state gathers them here)."""
        cfg = self.config
        state.shards.ensure_full()
        record = {"epoch": epoch, "step": state.step,
                  "train_time_s": round(time.time() - start, 2),
                  "lr": float(task.lr_schedule(state.step))}
        if running is not None:
            record["train_loss"] = float(self._global_metrics(running)["loss"])
        val_metrics = {}
        if val_batches is not None and len(val_batches) > 0:
            val_metrics = self.evaluate(task, state, val_batches)
            val_metrics.update(self._val_cer(state.model, datamodule, val_batches) or {})
            record.update({f"val_{k}": v for k, v in val_metrics.items()})
        self._log(record)
        if cfg.monitor == "val_loss":
            monitor = val_metrics.get("loss")
        else:
            monitor = record.get("train_loss")
        state.epoch = epoch + 1
        if cfg.checkpoint_dir:
            if monitor is not None and monitor < state.best_monitor:
                state.best_monitor = monitor
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "best.pt"), state)
            if cfg.save_last:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, "last.pt"), state)
            if (epoch + 1) % cfg.every_n_epochs == 0:
                save_checkpoint(os.path.join(cfg.checkpoint_dir, f"epoch_{epoch + 1}.pt"), state)
