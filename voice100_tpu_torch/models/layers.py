"""Shared building blocks: conv blocks, the masked biLSTM, WORLDNorm, and
the v1 family's flax-exact BatchNorm and dropout.

Port of ``voice100_tpu/models/layers.py``. Modules take and return
batch-major ``[B, T, C]`` tensors, as the JAX modules do, and keep the
parameter names of the torch reference (``encoder.{i}.conv.weight``,
``decoder.{i}.layer_norm.{weight,bias}``,
``lstm.{weight,bias}_{ih,hh}_l{k}[_reverse]``, ``norm.f0_mean``), so
state dicts carry across (``tools/weights.py``).
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.lstm import default_compute_dtype, stack_directions
from ..ops.lstm_cuda import bilstm_infer, bilstm_train_cuda
from ..parallel.mesh import global_sum_autograd, own_rows_of_draw

__all__ = [
    "ConvSetting",
    "ConvLayerBlock",
    "ConvTransposeLayerBlock",
    "ConvStack",
    "conv_stack_output_length",
    "BiLSTM",
    "WORLDNorm",
    "BatchNorm",
    "dropout",
    "reset_conv",
    "uniform_",
    "deterministic_cudnn",
]

# (out_channels, transpose, kernel_size, stride, padding, bias), as in
# config/asr_en_base.yaml:16-28
ConvSetting = Tuple[int, bool, int, int, int, bool]


@torch.no_grad()
def uniform_(param: torch.Tensor, bound: float,
             generator: Optional[torch.Generator] = None) -> None:
    """Fill ``param`` from U(-bound, bound), drawn on the CPU from
    ``generator`` so a seed gives the same weights on any device."""
    values = torch.empty(param.shape, dtype=param.dtype).uniform_(-bound, bound, generator=generator)
    param.copy_(values)


def reset_conv(conv: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """torch's default bound ``1/sqrt(fan_in)`` for a Conv1d or a
    ConvTranspose1d (whose fan-in is ``out/groups * k``), drawn from
    ``generator`` on the CPU."""
    if isinstance(conv, nn.ConvTranspose1d):
        fan_in = conv.out_channels // conv.groups * conv.kernel_size[0]
    else:
        fan_in = conv.in_channels // conv.groups * conv.kernel_size[0]
    bound = 1.0 / math.sqrt(fan_in)
    uniform_(conv.weight, bound, generator)
    if conv.bias is not None:
        uniform_(conv.bias, bound, generator)


class ConvLayerBlock(nn.Module):
    """Conv1d + channel LayerNorm (eps 1e-5) + exact GELU on ``[B, T, C]``.

    Under the bf16 mode (``ops.lstm.default_compute_dtype``) the conv runs
    in bf16 as flax's ``nn.Conv(dtype=bfloat16)`` does
    (``voice100_tpu/models/layers.py:56-81``): input, weight and bias cast
    to bf16, the convolution's result rounded to bf16 and the bias added
    in bf16, then widened to float32 for the LayerNorm and GELU."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, bias: bool, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.conv = nn.Conv1d(in_channels, out_channels, kernel_size, stride=stride,
                              padding=padding, bias=bias, device=device)
        self.layer_norm = nn.LayerNorm(out_channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if default_compute_dtype() == torch.bfloat16:
            conv, bf16 = self.conv, torch.bfloat16
            x = F.conv1d(x.transpose(1, 2).to(bf16), conv.weight.to(bf16), None, conv.stride,
                         conv.padding)
            if conv.bias is not None:
                x = x + conv.bias.to(bf16)[:, None]
            x = x.float().transpose(1, 2)
        else:
            x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(self.layer_norm(x))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default conv bound 1/sqrt(fan_in); LayerNorm at 1, 0."""
        bound = 1.0 / math.sqrt(self.conv.in_channels * self.conv.kernel_size[0])
        uniform_(self.conv.weight, bound, generator)
        if self.conv.bias is not None:
            uniform_(self.conv.bias, bound, generator)
        self.layer_norm.reset_parameters()


class ConvTransposeLayerBlock(nn.Module):
    """ConvTranspose1d + channel LayerNorm (eps 1e-5) + exact GELU on
    ``[B, T, C]`` (``voice100_tpu/models/layers.py:84-120``); length
    ``(T - 1) * stride - 2 * padding + kernel_size``. The weight is
    torch's ``[in, out, k]``; the JAX kernel is the same taps flipped in
    time (``tools/weights.py``). Float32 under the bf16 mode too, as in
    JAX (``layers.py:103-105``)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int, bias: bool, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.conv = nn.ConvTranspose1d(in_channels, out_channels, kernel_size, stride=stride,
                                       padding=padding, bias=bias, device=device)
        self.layer_norm = nn.LayerNorm(out_channels, eps=1e-5, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # cuDNN runs a transposed conv as a convolution's input gradient,
        # whose fastest algorithms add with atomics: two calls could differ
        # in the last bits, and a vocoder pulse downstream move by a sample.
        # The JAX block is deterministic, so this one asks for a
        # deterministic algorithm.
        with deterministic_cudnn():
            x = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return F.gelu(self.layer_norm(x))

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch's default bound 1/sqrt(fan_in), fan_in = out * k for a
        transposed weight; LayerNorm at 1, 0."""
        bound = 1.0 / math.sqrt(self.conv.out_channels * self.conv.kernel_size[0])
        uniform_(self.conv.weight, bound, generator)
        if self.conv.bias is not None:
            uniform_(self.conv.bias, bound, generator)
        self.layer_norm.reset_parameters()


_DETERMINISTIC_LOCK = threading.Lock()
_deterministic_users = 0
_deterministic_saved = False


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms for the calls inside. The switch
    (``torch.backends.cudnn.deterministic``) is one for the process: it is
    set when the first of overlapping users enters and restored when the
    last leaves, so calls from several threads (the server's batchers)
    neither race on it nor leave it set."""
    global _deterministic_users, _deterministic_saved
    with _DETERMINISTIC_LOCK:
        if _deterministic_users == 0:
            _deterministic_saved = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = True
        _deterministic_users += 1
    try:
        yield
    finally:
        with _DETERMINISTIC_LOCK:
            _deterministic_users -= 1
            if _deterministic_users == 0:
                torch.backends.cudnn.deterministic = _deterministic_saved


class ConvStack(nn.Sequential):
    """Conv and transposed conv blocks built from settings tuples."""

    def __init__(self, in_channels: int, settings: Sequence[ConvSetting], device=None) -> None:
        device = resolve_device(device)
        blocks = []
        for out_ch, transpose, kernel, stride, padding, bias in settings:
            cls = ConvTransposeLayerBlock if transpose else ConvLayerBlock
            blocks.append(cls(in_channels, out_ch, kernel, stride, padding, bias, device=device))
            in_channels = out_ch
        super().__init__(*blocks)


def conv_stack_output_length(settings: Sequence[ConvSetting], length):
    """Time-axis length through a ConvStack (torch length rule); ints,
    arrays or tensors."""
    for _, transpose, kernel, stride, padding, _ in settings:
        if transpose:
            length = (length - 1) * stride - 2 * padding + kernel
        else:
            length = (length + 2 * padding - kernel) // stride + 1
    return length


class BiLSTM(nn.Module):
    """Stacked bidirectional LSTM over padded sequences with lengths.

    Parameters follow ``torch.nn.LSTM``'s names and layout. When no
    gradient is needed (``torch.no_grad``, ``inference_mode``, or no
    parameter or input that requires one), each layer runs the inference
    kernel through the op :func:`voice100_tpu_torch.ops.lstm_cuda.bilstm_infer`
    (``voice100_torch::bilstm_infer``, which ``torch.export`` keeps as one
    node) on weights stacked once and cached. Otherwise it runs the training pair
    through :func:`voice100_tpu_torch.ops.lstm_cuda.bilstm_train_cuda`,
    on weights stacked from the parameters in each call so that the
    gradients reach them. Either way CUDA tensors take the kernels and
    CPU tensors the plain loops. Under the bf16 mode
    (``ops.lstm.default_compute_dtype``, read at each call) both run
    their bf16 variants, as the JAX Pallas path does under the knob.

    In training mode, ``dropout`` (0.2, torch convention) zeroes each
    output of every layer but the last with that probability and scales
    the rest by ``1 / (1 - dropout)`` (``voice100_tpu/ops/lstm.py:343-347``),
    drawing from ``generator`` (the default generator if None).
    """

    def __init__(self, input_size: int, hidden_size: int, num_layers: int,
                 dropout: float = 0.2, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.dropout = dropout
        for layer in range(num_layers):
            d_in = input_size if layer == 0 else 2 * hidden_size
            for suffix in ("", "_reverse"):
                for name, shape in (
                    ("weight_ih", (4 * hidden_size, d_in)),
                    ("weight_hh", (4 * hidden_size, hidden_size)),
                    ("bias_ih", (4 * hidden_size,)),
                    ("bias_hh", (4 * hidden_size,)),
                ):
                    self.register_parameter(
                        f"{name}_l{layer}{suffix}",
                        nn.Parameter(torch.empty(shape, device=device)),
                    )
        self._stacked_key = None
        self._stacked = []
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """torch.nn.LSTM's init: U(-1/sqrt(H), 1/sqrt(H)) for every tensor."""
        bound = 1.0 / math.sqrt(self.hidden_size)
        for param in self.parameters():
            uniform_(param, bound, generator)

    def _stack(self):
        return [
            stack_directions({
                direction: {
                    ours: getattr(self, f"{theirs}_l{layer}{suffix}")
                    for ours, theirs in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                                         ("b_ih", "bias_ih"), ("b_hh", "bias_hh"))
                }
                for direction, suffix in (("fwd", ""), ("bwd", "_reverse"))
            })
            for layer in range(self.num_layers)
        ]

    def stacked_layers(self):
        """Per layer ``(w_ih [2, 4H, D], w_hh [2, 4H, H], bias [2, 4H])``
        as :func:`voice100_tpu_torch.ops.lstm.stack_directions` gives them,
        detached from autograd. Built once and rebuilt only after a
        parameter changes: in place (a state-dict load, an optimizer
        step), or by a move to another device."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._stacked_key:
            with torch.no_grad():
                self._stacked = self._stack()
            self._stacked_key = key
        return self._stacked

    def clear_stacked(self) -> None:
        """Drop the weights :meth:`stacked_layers` built (the next call
        builds them again): a trainer frees them once a step has made
        them stale."""
        self._stacked, self._stacked_key = [], None

    def forward(self, x: torch.Tensor, lengths: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``[B, T, D] -> [B, T, 2H]``, zero past each length."""
        needs_grad = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        if needs_grad:
            layers, layer_fn = self._stack(), bilstm_train_cuda
        else:
            layers, layer_fn = self.stacked_layers(), bilstm_infer
        compute_dtype = default_compute_dtype()
        for i, (w_ih, w_hh, bias) in enumerate(layers):
            x = layer_fn(w_ih, w_hh, bias, x, lengths, compute_dtype)
            if i < self.num_layers - 1:
                x = dropout(x, self.dropout, self.training, generator)
        return x


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``nn.Dropout``: in training, each element zeroed with
    probability ``p`` and the rest scaled by ``1 / (1 - p)``, the mask
    drawn from ``generator`` (the default generator if None); ``x`` as it
    is otherwise. A rank of a data-parallel run draws the global batch's
    mask and keeps its own rows."""
    if not training or p <= 0.0:
        return x
    keep = own_rows_of_draw(lambda shape: x.new_empty(shape).bernoulli_(
        1.0 - p, generator=generator), x.shape)
    return torch.where(keep.bool(), x / (1.0 - p), 0.0)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis 1 of ``[B, C, T]`` with flax's
    semantics (``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5)``,
    ``voice100_tpu/models/asr_v1.py:46-50``), which ``nn.BatchNorm1d``
    does not have:

    * the batch variance is ``E[x^2] - E[x]^2`` clipped at 0 (flax's
      ``use_fast_variance``), over every ``[B, T]`` position, padding
      included, as in the JAX package and the reference;
    * the running averages take the biased batch variance, ``ra = 0.9 ra
      + 0.1 batch`` (``momentum`` is flax's: the share kept);
    * ``y = (x - mean) * (weight * rsqrt(var + eps)) + bias``.

    In training mode it normalizes by the batch's statistics and updates
    the running averages (buffers, so checkpoints carry them); in
    evaluation mode it normalizes by the running averages. Inside
    :func:`voice100_tpu_torch.parallel.mesh.global_batch` the count, sum
    and sum of squares are summed over the ranks with autograd through
    the collective, so every rank normalizes by the global batch's
    statistics, as XLA reduces them over the global array, and every rank
    keeps the same running averages. With one process that is this
    process's arithmetic. Parameter and buffer names are torch's
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, num_features: int, momentum: float = 0.9, eps: float = 1e-5,
                 device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            c = x.shape[1]
            count = x.new_full((1,), float(x.numel() // c))
            stats = global_sum_autograd(torch.cat([x.sum(dim=(0, 2)), (x * x).sum(dim=(0, 2)),
                                                   count]))
            mean, mean2 = stats[:c] / stats[-1], stats[c:2 * c] / stats[-1]
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                keep = self.momentum
                self.running_mean.copy_(keep * self.running_mean + (1.0 - keep) * mean)
                self.running_var.copy_(keep * self.running_var + (1.0 - keep) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean[:, None]) * mul[:, None] + self.bias[:, None]


class WORLDNorm(nn.Module):
    """Frozen per-feature mean and std of the WORLD streams
    (``voice100_tpu/models/layers.py:216-261``), as six buffers
    ``{f0,logspc,codeap}_{mean,std}`` (zeros and ones until a stat file is
    loaded, ``training.checkpoint.merge_world_stats``)."""

    def __init__(self, logspc_size: int, codeap_size: int, device=None) -> None:
        super().__init__()
        device = resolve_device(device)
        for stream, size in (("f0", 1), ("logspc", logspc_size), ("codeap", codeap_size)):
            self.register_buffer(f"{stream}_mean", torch.zeros(size, device=device))
            self.register_buffer(f"{stream}_std", torch.ones(size, device=device))

    def normalize(self, f0, logspc, codeap):
        return ((f0 - self.f0_mean) / self.f0_std,
                (logspc - self.logspc_mean) / self.logspc_std,
                (codeap - self.codeap_mean) / self.codeap_std)

    def unnormalize(self, f0, logspc, codeap):
        return (self.f0_std * f0 + self.f0_mean,
                self.logspc_std * logspc + self.logspc_mean,
                self.codeap_std * codeap + self.codeap_mean)

    def forward(self, f0, logspc, codeap):
        return self.normalize(f0, logspc, codeap)
