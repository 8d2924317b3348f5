"""Where the time of the biLSTM train backward's recurrence goes.

    python -m voice100_tpu_torch.tools.probe_bilstm_bwd

Needs a CUDA card and nvcc (``$CUDA_HOME``, default ``/usr/local/cuda``).
Builds variants of ``csrc/bilstm_train.cu`` into a temporary directory,
each with one part of ``lstm_train_bwd_recurrence_kernel``'s step cut out,
and times the recurrence launch of each with CUDA events at the train
shapes (B=64, T=501, H=512; seeded ragged lengths with 1 and T, then all
T), the gates of the gate pass as input. The variants compute wrong dG
and exist only to be timed:

* ``full``: the kernel as committed;
* ``no_l2_prefetch``: without the prefetch of the next step's inputs;
* ``no_dh_compute``: the dh product streams dG but does no arithmetic;
* ``no_dg_stream``: the dh product computes on stale shared memory,
  reading no dG from L2;
* ``no_dh_product``: the dG phase and the grid sync only;
* ``sync_only``: the grid sync only.

Prints one line a variant and a JSON object ``{"card", "shape",
"us_per_step": {variant: {"ragged", "all_t"}}}``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..kernels.build import CSRC, NVCC_FLAGS, _nvcc

# text anchors in the recurrence kernel, each cut by a replacement
_DG_PHASE = "for (int p = tid; p < batch * REC_UNITS; p += REC_THREADS) {"
_DH_PRODUCT = "for (int b0 = 0; b0 < batch; b0 += REC_BT) {"
_PREFETCH = "    if (s > 0) {\n      const int tn"
_COMPUTE = "for (int kq = 0; kq < REC_Q; kq += 4) {"
_STREAM = "cp_async16(dst + r * REC_Q_PAD + col, dg + row * gates4 + chunk * REC_Q + col, live);"


def _variants(src: str):
    for anchor in (_DG_PHASE, _DH_PRODUCT, _PREFETCH, _COMPUTE, _STREAM):
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in bilstm_train.cu: {anchor!r}")
    no_dg = src.replace(_DG_PHASE, _DG_PHASE.replace("p < batch", "p < 0"))
    no_dh = src.replace(_DH_PRODUCT, _DH_PRODUCT.replace("b0 < batch", "b0 < 0"))
    return {
        "full": src,
        "no_l2_prefetch": src.replace(_PREFETCH, _PREFETCH.replace("s > 0", "false")),
        "no_dh_compute": src.replace(_COMPUTE, _COMPUTE.replace("kq < REC_Q", "kq < 0")),
        "no_dg_stream": src.replace(_STREAM, "(void)dst; (void)row; (void)col; (void)live;"),
        "no_dh_product": no_dh,
        "sync_only": no_dg.replace(_DH_PRODUCT, _DH_PRODUCT.replace("b0 < batch", "b0 < 0")),
    }


def _build(workdir: Path):
    src = (CSRC / "bilstm_train.cu").read_text()
    procs = {}
    for name, text in _variants(src).items():
        (workdir / f"{name}.cu").write_text(text)
        cmd = [_nvcc(), *[f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")],
               "-o", str(workdir / f"{name}.so"), str(workdir / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(workdir / f"{name}.so"))
        lib.error_string.restype = ctypes.c_char_p
        for fn in (lib.lstm_train_bwd_gates_f32, lib.lstm_train_bwd_recurrence_f32):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        libs[name] = lib
    return libs


def _time_recurrence(lib, inputs, lengths, reps: int = 5) -> float:
    """Median ms of one recurrence launch, dg reset to the gates first."""
    xg, w_hh, h_prev, c_prev, dout = inputs
    batch, time, hidden = xg.shape[1], xg.shape[2], w_hh.shape[2]
    lens = torch.tensor(lengths, dtype=torch.int32, device=xg.device)
    stream = torch.cuda.current_stream().cuda_stream
    dg = torch.empty_like(xg)
    status = lib.lstm_train_bwd_gates_f32(xg.data_ptr(), w_hh.data_ptr(), lens.data_ptr(),
                                          h_prev.data_ptr(), dg.data_ptr(), batch, time,
                                          hidden, stream)
    gates = dg.clone()
    times = []
    for _ in range(reps):
        dg.copy_(gates)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        status = status or lib.lstm_train_bwd_recurrence_f32(
            w_hh.data_ptr(), lens.data_ptr(), c_prev.data_ptr(), dout.data_ptr(),
            dg.data_ptr(), batch, time, hidden, stream)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    if status:
        raise RuntimeError(f"launch failed: {lib.error_string(status)}")
    return float(np.median(times))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_bilstm_bwd: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    batch, time, hidden = 64, 501, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    inputs = (randn(2, batch, time, 4 * hidden), randn(2, 4 * hidden, hidden) / hidden ** 0.5,
              randn(2, batch, time, hidden) * 0.5, randn(2, batch, time, hidden),
              randn(batch, time, 2 * hidden))
    ragged = np.random.default_rng(1).integers(1, time + 1, size=batch)
    ragged[0], ragged[1] = time, 1
    result = {"card": card, "shape": f"B={batch}, T={time}, H={hidden}", "us_per_step": {}}
    with tempfile.TemporaryDirectory() as workdir:
        for name, lib in _build(Path(workdir)).items():
            us = {key: _time_recurrence(lib, inputs, lengths.tolist()) * 1e3 / time
                  for key, lengths in (("ragged", ragged), ("all_t", np.full(batch, time)))}
            result["us_per_step"][name] = us
            print(f"{name}: {us['ragged']:.2f} us a step (ragged lengths), "
                  f"{us['all_t']:.2f} (all T)", flush=True)
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
