"""Model export for serving: a ``torch.export`` program, a manifest, an ``.onnx``.

Port of ``voice100_tpu/tools/export.py``. The JAX package serializes each
predict surface as StableHLO through ``jax.export``; the port writes the
same surfaces, at the same static example shapes, as a ``torch.export``
program (``torch.export.save``, a ``.pt2``), with a JSON manifest beside
it (``<output>.json``: the JAX tool's kind, the format, the input shapes
and dtypes, the calling convention and the device it was traced on) and
the ``.onnx`` of :mod:`voice100_tpu_torch.onnx.export`:

  asr:   (audio [1, 512, A] f32, audio_len [1] i32) -> (logits, logits_len)
  align: (text [1, 128] i32, text_len [1] i32)      -> durations
  tts:   (aligntext [1, 128] i32, aligntext_len [1] i32)
         -> (f0, logspc, codeap), mc2sp folded for a 25-wide mcep head

and the v1 models' (``voice100_tpu/tools/export.py:45-74``), in eval mode
(the BatchNorms on their running statistics), no mc2sp folded:

  asr_v1:       (audio [1, 512, A] f32)                  -> logits
  align_ctc_v1: (audio [1, 512, A] f32, audio_len [1] i32) -> (logits, logits_len)
  ttsalign_v1:  (text [1, 128] i32)       -> the forward's log-duration pairs
  ttsaudio_v1:  (aligntext [1, 128] i32)  -> (f0, logspc, codeap), and the
                phone logits for the multi-task model

The program holds kernel 1 as one ``voice100_torch::bilstm_infer`` node a
layer (:func:`voice100_tpu_torch.ops.lstm_cuda.bilstm_infer`; the v2
models and ``AudioAlignCTC``), so a program traced on the card launches
the kernel as the direct call does; :func:`load_exported` registers the
op before it loads a file. Unlike the JAX tool, a failed ``.onnx`` is not
caught: it fails the export.

  python -m voice100_tpu_torch.tools.export --config C --ckpt_path K.pt \\
      [--output out.pt2] [--device cpu]
"""

from __future__ import annotations

import contextlib
import json
import os
from argparse import ArgumentParser

import numpy as np
import torch

__all__ = ["export_model", "load_exported", "predict_module", "example_inputs", "cli_main",
           "EXPORT_FORMAT"]

EXPORT_FORMAT = "torch.export"
CALLING_CONVENTION = ("voice100_tpu_torch.tools.export.load_exported(path)(*args): "
                      "torch.export.load(path).module()(*args) under torch.no_grad() with "
                      "deterministic cuDNN, once voice100_tpu_torch.ops.lstm_cuda is imported")


class _Predict(torch.nn.Module):
    """A model's predict surface as one ``forward`` (``_predict_fn`` of the
    JAX tool): the ASR forward, the align model's ``predict`` or the TTS
    model's ``predict`` with mc2sp folded; for the v1 models the forward
    (``asr_v1``, ``align_ctc_v1``, ``ttsalign_v1``) or ``predict``
    (``ttsaudio_v1``). Each kind takes its own number of inputs."""

    def __init__(self, model: torch.nn.Module, kind: str) -> None:
        super().__init__()
        self.model, self.kind = model, kind
        mc2sp = None
        if kind == "tts" and model.logspc_size == 25:
            from ..dsp.mcep import create_mc2sp_matrix

            mc2sp = torch.from_numpy(create_mc2sp_matrix(512, 24, 0.410).astype(np.float32))
            mc2sp = mc2sp.to(next(model.parameters()).device)
        self.register_buffer("mc2sp", mc2sp)

    def forward(self, *args: torch.Tensor):
        if self.kind in ("asr", "asr_v1", "align_ctc_v1", "ttsalign_v1"):
            return self.model(*args)
        # the models' predict bodies, without their inference_mode wrapper
        predict = type(self.model).predict.__wrapped__
        if self.kind in ("align", "ttsaudio_v1"):
            return predict(self.model, *args)
        f0, feat, codeap = predict(self.model, *args)
        logspc = feat @ self.mc2sp if self.mc2sp is not None else feat
        return f0, logspc, codeap


class _StackedBiLSTM(torch.nn.Module):
    """A :class:`~voice100_tpu_torch.models.layers.BiLSTM`'s inference
    path on its weights stacked once, held as buffers: the program holds
    each weight once, in the layout kernel 1 takes, and stacks nothing a
    call."""

    def __init__(self, lstm) -> None:
        super().__init__()
        self.num_layers = lstm.num_layers
        for i, (w_ih, w_hh, bias) in enumerate(lstm.stacked_layers()):
            self.register_buffer(f"w_ih_l{i}", w_ih)
            self.register_buffer(f"w_hh_l{i}", w_hh)
            self.register_buffer(f"bias_l{i}", bias)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, generator=None) -> torch.Tensor:
        from ..ops.lstm import default_compute_dtype
        from ..ops.lstm_cuda import bilstm_infer

        compute_dtype = default_compute_dtype()
        for i in range(self.num_layers):
            x = bilstm_infer(getattr(self, f"w_ih_l{i}"), getattr(self, f"w_hh_l{i}"),
                             getattr(self, f"bias_l{i}"), x, lengths, compute_dtype)
        return x


@contextlib.contextmanager
def _stacked_lstms(model: torch.nn.Module):
    """``model`` with each biLSTM replaced by its :class:`_StackedBiLSTM`
    inside the block, and put back after it."""
    from ..models.layers import BiLSTM

    swapped = [(parent, name, child) for parent in model.modules()
               for name, child in parent.named_children() if isinstance(child, BiLSTM)]
    for parent, name, child in swapped:
        setattr(parent, name, _StackedBiLSTM(child))
    try:
        yield model
    finally:
        for parent, name, child in swapped:
            setattr(parent, name, child)


def _kind(model) -> str:
    """The JAX tool's name of ``model``'s surface."""
    from ..models import (AlignTextToAudio, AlignTextToAudioModel, AudioAlignCTC,
                          AudioToAlignText, AudioToTextCTC, TextToAlignText,
                          TextToAlignTextModel)

    # AlignTextToAudioMultiTaskModel is an AlignTextToAudioModel: the same kind
    for cls, kind in ((AudioToAlignText, "asr"), (TextToAlignText, "align"),
                      (AlignTextToAudio, "tts"), (AudioToTextCTC, "asr_v1"),
                      (AudioAlignCTC, "align_ctc_v1"), (TextToAlignTextModel, "ttsalign_v1"),
                      (AlignTextToAudioModel, "ttsaudio_v1")):
        if isinstance(model, cls):
            return kind
    raise ValueError(f"Cannot export {type(model).__name__}")


def example_inputs(model, device=None):
    """The static example inputs of a model's surface (the JAX tool's):
    ``[1, 512, A]`` features and ``[512]`` for ASR and ``align_ctc_v1``,
    the features alone for ``asr_v1``; ``[1, 128]`` ids and ``[128]`` for
    align and TTS, the ids alone for the v1 TTS models."""
    device = device if device is not None else next(model.parameters()).device
    kind = _kind(model)
    if kind in ("asr", "asr_v1", "align_ctc_v1"):
        x = torch.zeros(1, 512, model.audio_size, dtype=torch.float32, device=device)
        n = torch.tensor([512], dtype=torch.int32, device=device)
    else:
        x = torch.zeros(1, 128, dtype=torch.int32, device=device)
        n = torch.tensor([128], dtype=torch.int32, device=device)
    return (x,) if kind in ("asr_v1", "ttsalign_v1", "ttsaudio_v1") else (x, n)


def predict_module(model) -> torch.nn.Module:
    """The eval-mode predict surface of ``model`` that :func:`export_model`
    traces; calling it is the direct predict call."""
    return _Predict(model, _kind(model)).eval()


def export_model(model, output_path: str) -> str:
    """Trace ``model``'s predict surface on its device with ``torch.export``
    at the static example shapes and save it to ``output_path`` (a
    ``.pt2``), with ``<output_path>.json`` and the ``.onnx`` beside it;
    returns ``output_path``. The model's weights are traced frozen (no
    gradient), as the predict call runs them, the biLSTM's stacked once
    (:class:`_StackedBiLSTM`)."""
    surface = predict_module(model)
    example = example_inputs(model)
    flags = [p.requires_grad for p in model.parameters()]
    try:
        model.requires_grad_(False)
        with _stacked_lstms(model):
            program = torch.export.export(surface, example)
    finally:
        for p, flag in zip(model.parameters(), flags):
            p.requires_grad_(flag)
    torch.export.save(program, output_path)
    manifest = {
        "kind": surface.kind,
        "format": EXPORT_FORMAT,
        "input_shapes": [list(t.shape) for t in example],
        "input_dtypes": [str(t.dtype).replace("torch.", "") for t in example],
        "calling_convention": CALLING_CONVENTION,
        "device": str(example[0].device),
    }
    with open(output_path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)
    from ..onnx.export import export_onnx

    onnx_path = os.path.splitext(output_path)[0] + ".onnx"
    export_onnx(model, onnx_path)
    print(f"[export] wrote {onnx_path}")
    return output_path


class ExportedPredict:
    """A loaded program: ``program`` (the ``ExportedProgram``) and a call
    that runs it without autograd and with deterministic cuDNN (the
    transposed convolution of the TTS decoder runs so in the models; a
    program cannot hold the switch), safe from several threads at once
    (:func:`voice100_tpu_torch.models.layers.deterministic_cudnn`)."""

    def __init__(self, program) -> None:
        self.program = program
        self.module = program.module()

    def __call__(self, *args):
        from ..models.layers import deterministic_cudnn

        with deterministic_cudnn(), torch.no_grad():
            return self.module(*args)


def load_exported(path: str) -> ExportedPredict:
    """Load a ``.pt2`` that :func:`export_model` wrote (registering the
    biLSTM op first); the program runs on the device it was traced on."""
    from ..ops import lstm_cuda  # noqa: F401  (registers voice100_torch::bilstm_infer)

    return ExportedPredict(torch.export.load(path))


def cli_main(argv=None) -> None:
    from ..training.cli import load_model

    parser = ArgumentParser(description="Export a port checkpoint's predict surface.")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt_path", required=True)
    parser.add_argument("--output", default=None)
    parser.add_argument("--device", default=None,
                        help="device to trace on (default cuda, which raises without CUDA)")
    args = parser.parse_args(argv)

    model = load_model(args.config, args.ckpt_path, device=args.device)
    output = args.output or (os.path.splitext(os.path.basename(args.config))[0] + ".pt2")
    export_model(model, output)
    print(f"[export] wrote {output}")


if __name__ == "__main__":
    cli_main()
