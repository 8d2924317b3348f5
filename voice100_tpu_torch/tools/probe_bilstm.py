"""Where the time of the biLSTM recurrences' steps goes.

    python -m voice100_tpu_torch.tools.probe_bilstm

Needs a CUDA card and nvcc (``$CUDA_HOME``, default ``/usr/local/cuda``).
Builds variants of the two persistent recurrences into a temporary
directory, each with one part of the step cut out, and times one launch
of each with CUDA events. The variants other than ``full`` compute wrong
outputs and exist only to be timed.

The forward (``csrc/bilstm_persistent.cuh``, as ``csrc/bilstm.cu`` builds
it: kernels 1 and 2 share it) at asr_en_base's serve and align shapes
(H=512: B=8, T=501 with the serve check's ragged lengths; B=64, T=512
with seeded ragged lengths with 1 and T, then all T):

* ``full``: the kernel as committed;
* ``no_l2_prefetch``: without the L2 prefetch of the next step's xg;
* ``no_h_compute``: the product streams h but does no arithmetic;
* ``no_h_stream``: the product computes on stale shared memory, reading
  no h from L2;
* ``no_product``: no product at all (the cell update on xg alone);
* ``no_barrier``: the blocks of a direction do not wait for each other;
* ``barrier_only``: the barrier, the valid-row count and the L2 prefetch
  only: no product, no cell update, no frozen rows.

The train backward's recurrence (``lstm_train_bwd_recurrence_kernel`` of
``csrc/bilstm_train.cu``, kernel 3) at the train shapes (B=64, T=501,
H=512; seeded ragged lengths with 1 and T, then all T), the gates of the
gate pass as input:

* ``full``; ``no_l2_prefetch``: without the prefetch of the next step's
  inputs;
* ``no_dh_compute``: the dh product streams dG but does no arithmetic;
* ``no_dg_stream``: the dh product computes on stale shared memory,
  reading no dG from L2;
* ``no_dh_product``: the dG phase and the grid sync only;
* ``sync_only``: the grid sync only.

Kernel 3b's recurrence, the bf16 variant's (``csrc/bilstm_bwd_cluster.cuh``,
clusters sharing each step's dG), at the bf16 ``asr_en_base`` (B=64,
T=501) and ``tts_en_base`` (B=128, T=512) shapes, H=512, seeded ragged
lengths with 1 and T, the bf16 gate pass's gates as input:

* ``full``; ``no_sharing``: clusters of one block, each block fetching
  every chunk of dG from L2 itself;
* ``cluster_scope_release``: a warp releases its slot with a release at
  cluster scope, not block scope;
* ``no_l2_prefetch``: without the prefetch of the next step's inputs;
* ``no_dh_compute``: the dh product streams dG but does no arithmetic;
* ``no_dh_product``: the dG phase and the barrier only;
* ``barrier_only``: the barrier and the valid-row count only;
* ``f32_before``: kernel 3's float32 recurrence on the same gates, with
  ``c_prev`` and ``dout`` widened (the design this one replaced).

It also prints how many clusters of 1, 2, 4, 8 and 16 blocks of that
recurrence the card holds resident at once at each shape
(``max_active_clusters``), which sets its cluster size.

Kernels 1b and 2b, the bf16 forward (``csrc/bilstm_fwd_mma.cuh``, the
product on tensor cores), as 2b (``lstm_train_fwd_bf16``) at the bf16
``asr_en_base`` (B=64, T=501, H=512), ``tts_en_base`` (B=128, T=512),
``align_en_base`` (B=128, T=144, H=256) and ``align_v1`` (B=32, T=501,
H=128) shapes, seeded ragged lengths with 1 and T:

* ``full``; ``barrier_only``: the barrier, the valid-row count and the
  L2 prefetch only: no product, no cell update, no frozen rows;
* ``no_product``: the cell update on xg alone (no h read, no mma);
* ``no_stream``: the mma on registers, reading no h from L2;
* ``no_split``: a warp always takes an m tile's whole K, however few
  tiles are live;
* ``no_l2_prefetch``: without the L2 prefetch of the next step's xg;
* ``f32_before``: kernel 2's float32 recurrence (``bilstm_persistent.cuh``)
  on the widened ``xg``.

Prints one line a variant and a JSON object ``{"card", "forward":
{"shapes", "us_per_step": {variant: {shape: us}}}, "backward": {...},
"backward_cluster": {...}, "forward_mma": {...}}``.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..kernels.build import CSRC, NVCC_FLAGS, _nvcc
from ..ops.lstm_cuda import length_order

_P, _I = ctypes.c_void_p, ctypes.c_int
HEADER = "bilstm_persistent.cuh"

# text anchors in the persistent forward kernel, each cut by a replacement
_STREAM = "cp_async16(dst + r * KC_PAD + col,"
_COMPUTE = "for (int kq = 0; kq < KC; kq += 4) {"
_LIVE = "const int live = max(0, min(nb, n_live - b0));"
_CELLS = "if (p >= nb * UNITS) continue;"
_FROZEN = "for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {"
_PREFETCH = "if (s + 1 < time) {"
_BARRIER = "if (b0 == 0 && s > 0) {"

# text anchors in the backward recurrence kernel
_DG_PHASE = "for (int p = tid; p < batch * REC_UNITS; p += REC_THREADS) {"
_DH_PRODUCT = "for (int b0 = 0; b0 < batch; b0 += REC_BT) {"
_BWD_PREFETCH = "    if (s > 0) {\n      const int tn"
_DH_COMPUTE = "for (int kq = 0; kq < REC_Q; kq += 4) {"
_DG_STREAM = "cp_async16(dst + r * REC_Q_PAD + col, ex + row * ex_stride + chunk * REC_Q + col, live);"


# text anchors in kernel 3b's cluster recurrence
CLUSTER_HEADER = "bilstm_bwd_cluster.cuh"
_C_SIZE = "return per_direction <= 60 ? (per_direction % 8 == 0 ? 8 : 4) : 2;"
_C_PREFETCH = "if (len_s[pos] <= tn) continue;"
_C_COMPUTE = "for (int kq = 0; kq < Q; kq += 4) {"
_C_STREAMED = "const int streamed = n;"
_C_DG = "for (int p0 = tid; p0 < n * UNITS; p0 += CELLS * THREADS) {"
_C_FROZEN = "for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {"
_C_ARRIVE = "mbarrier.arrive.shared::cluster.b64 _, [remote];"


# text anchors in the bf16 forward (kernels 1b and 2b)
MMA_HEADER = "bilstm_fwd_mma.cuh"
_M_LOAD = ("        a[i][0] = __ldcg(src + (k0 + i) * EXCHANGE_WORDS);\n"
           "        a[i][1] = __ldcg(src + (k0 + i) * EXCHANGE_WORDS + 1);")
_M_P_TILES = "const int p_tiles = (n_live + TILE_M - 1) / TILE_M;"
_M_N_TILES = "const int n_tiles = (n + TILE_M - 1) / TILE_M;"
_M_FROZEN = "for (int p = tid; p < (batch - n) * UNITS; p += THREADS) {"
_M_SPLIT = "while (live > 0 && live << (log_split + 1) <= WARPS"
_M_PREFETCH = "if (len_s[r] <= tn) continue;"


def _check_anchors(src: str, anchors, where: str) -> None:
    for anchor in anchors:
        if src.count(anchor) != 1:
            raise RuntimeError(f"probe anchor not found once in {where}: {anchor!r}")


def forward_variants(src: str):
    """Variants of ``bilstm_persistent.cuh``'s text, by name."""
    _check_anchors(src, (_STREAM, _COMPUTE, _LIVE, _CELLS, _FROZEN, _PREFETCH, _BARRIER), HEADER)
    no_product = src.replace(_LIVE, "const int live = 0;")
    return {
        "full": src,
        "no_l2_prefetch": src.replace(_PREFETCH, "if (false) {"),
        "no_h_compute": src.replace(_COMPUTE, _COMPUTE.replace("kq < KC", "kq < 0")),
        "no_h_stream": src.replace(_STREAM, "if (false) " + _STREAM),
        "no_product": no_product,
        "no_barrier": src.replace(_BARRIER, "if (false) {"),
        "barrier_only": no_product.replace(_CELLS, "continue;")
                                  .replace(_FROZEN, _FROZEN.replace("p < (batch", "p < 0 * (batch")),
    }


def backward_variants(src: str):
    """Variants of ``bilstm_train.cu``'s text, by name."""
    _check_anchors(src, (_DG_PHASE, _DH_PRODUCT, _BWD_PREFETCH, _DH_COMPUTE, _DG_STREAM),
                   "bilstm_train.cu")
    no_dh = src.replace(_DH_PRODUCT, _DH_PRODUCT.replace("b0 < batch", "b0 < 0"))
    return {
        "full": src,
        "no_l2_prefetch": src.replace(_BWD_PREFETCH, _BWD_PREFETCH.replace("s > 0", "false")),
        "no_dh_compute": src.replace(_DH_COMPUTE, _DH_COMPUTE.replace("kq < REC_Q", "kq < 0")),
        "no_dg_stream": src.replace(_DG_STREAM, "(void)dst; (void)row; (void)col; (void)live;"),
        "no_dh_product": no_dh,
        "sync_only": no_dh.replace(_DG_PHASE, _DG_PHASE.replace("p < batch", "p < 0")),
    }


def backward_cluster_variants(src: str):
    """Variants of ``bilstm_bwd_cluster.cuh``'s text, by name."""
    _check_anchors(src, (_C_SIZE, _C_PREFETCH, _C_COMPUTE, _C_STREAMED, _C_DG, _C_FROZEN,
                         _C_ARRIVE), CLUSTER_HEADER)
    no_product = src.replace(_C_STREAMED, "const int streamed = 0;")
    return {
        "full": src,
        "no_sharing": src.replace(_C_SIZE, "return 1;"),
        "cluster_scope_release": src.replace(
            _C_ARRIVE, _C_ARRIVE.replace("arrive.shared", "arrive.release.cluster.shared")),
        "no_l2_prefetch": src.replace(_C_PREFETCH, "continue;"),
        "no_dh_compute": src.replace(_C_COMPUTE, _C_COMPUTE.replace("kq < Q", "kq < 0")),
        "no_dh_product": no_product,
        "barrier_only": no_product.replace(_C_DG, _C_DG.replace("p0 < n * UNITS", "p0 < 0"))
                                  .replace(_C_FROZEN, _C_FROZEN.replace("p < (batch - n) * UNITS",
                                                                        "p < 0")),
    }


def forward_mma_variants(src: str):
    """Variants of ``bilstm_fwd_mma.cuh``'s text, by name."""
    _check_anchors(src, (_M_LOAD, _M_P_TILES, _M_N_TILES, _M_FROZEN, _M_SPLIT, _M_PREFETCH),
                   MMA_HEADER)
    no_product = src.replace(_M_P_TILES, "const int p_tiles = 0;")
    return {
        "full": src,
        "barrier_only": no_product.replace(_M_N_TILES, "const int n_tiles = 0;").replace(
            _M_FROZEN, _M_FROZEN.replace("p < (batch", "p < 0 * (batch")),
        "no_product": no_product,
        "no_stream": src.replace(
            _M_LOAD, "        a[i][0] = a[i][1] = make_uint4(k0 + i, 0u, 0u, 0u);"),
        "no_split": src.replace(_M_SPLIT, _M_SPLIT.replace("live > 0", "false")),
        "no_l2_prefetch": src.replace(_M_PREFETCH, "continue;"),
    }


def _build(workdir: Path, source: str, edited: str, variants):
    """Each variant's text in place of ``csrc/<edited>``, ``csrc/<source>``
    compiled against it into ``<workdir>/<variant>/lib.so``, all nvcc runs
    started together. Returns ``{variant: ctypes.CDLL}``."""
    procs = {}
    for name, text in variants.items():
        src_dir = workdir / name
        shutil.copytree(CSRC, src_dir)
        (src_dir / edited).write_text(text)
        cmd = [_nvcc(), *[f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")],
               "-o", str(src_dir / "lib.so"), str(src_dir / source)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(workdir / name / "lib.so"))
        lib.error_string.argtypes = [_I]
        lib.error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def _time(lib, launch, reps: int = 5, before=None) -> float:
    """Median ms of ``launch()`` after one untimed call; ``before()`` runs
    untimed ahead of each."""
    times = []
    for rep in range(reps + 1):
        if before is not None:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        status = launch()
        end.record()
        end.synchronize()
        if status:
            raise RuntimeError(f"launch failed: {lib.error_string(status).decode()}")
        if rep:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def _ragged(batch: int, time: int) -> list:
    lengths = np.random.default_rng(1).integers(1, time + 1, size=batch)
    lengths[0], lengths[1] = time, 1
    return lengths.tolist()


def probe_forward(workdir: Path):
    hidden = 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    w_hh = torch.randn(2, 4 * hidden, hidden, device="cuda", generator=gen) / hidden ** 0.5
    shapes = {
        "serve_b8": (8, 501, [501, 463, 420, 377, 250, 128, 17, 1]),
        "align_b64": (64, 512, _ragged(64, 512)),
        "all_t_b64": (64, 512, [512] * 64),
    }
    stream = torch.cuda.current_stream().cuda_stream
    cases = {}
    for key, (batch, time, lengths) in shapes.items():
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        cases[key] = (torch.randn(2, batch, time, 4 * hidden, device="cuda", generator=gen), lens,
                      length_order(lens), torch.zeros(2, 2, batch, hidden, device="cuda"),
                      torch.empty(2 * hidden // 8, dtype=torch.int32, device="cuda"),
                      torch.empty(batch, time, 2 * hidden, device="cuda"))
    result = {"shapes": f"H={hidden}: " + "; ".join(
        f"{key} B={b}, T={t}" for key, (b, t, _) in shapes.items()), "us_per_step": {}}
    variants = forward_variants((CSRC / HEADER).read_text())
    for name, lib in _build(workdir / "forward", "bilstm.cu", HEADER, variants).items():
        lib.bilstm_f32.argtypes = [_P] * 7 + [_I] * 3 + [_P]
        lib.bilstm_f32.restype = _I
        us = {}
        for key, (xg, lens, order, xchg, ready, out) in cases.items():
            _, batch, time, _ = xg.shape
            us[key] = _time(lib, lambda: lib.bilstm_f32(
                xg.data_ptr(), w_hh.data_ptr(), lens.data_ptr(), order.data_ptr(),
                xchg.data_ptr(), ready.data_ptr(), out.data_ptr(), batch, time, hidden,
                stream)) * 1e3 / time
        result["us_per_step"][name] = us
        print(f"forward {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
              + " us a step", flush=True)
    return result


def probe_backward(workdir: Path):
    batch, time, hidden = 64, 501, 512
    gen = torch.Generator(device="cuda").manual_seed(0)
    randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
    xg, w_hh = randn(2, batch, time, 4 * hidden), randn(2, 4 * hidden, hidden) / hidden ** 0.5
    h_prev, c_prev = randn(2, batch, time, hidden) * 0.5, randn(2, batch, time, hidden)
    dout = randn(batch, time, 2 * hidden)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"shapes": f"B={batch}, T={time}, H={hidden}", "us_per_step": {}}
    variants = backward_variants((CSRC / "bilstm_train.cu").read_text())
    for name, lib in _build(workdir / "backward", "bilstm_train.cu", "bilstm_train.cu",
                            variants).items():
        for fn in (lib.lstm_train_bwd_gates_f32, lib.lstm_train_bwd_recurrence_f32):
            fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
            fn.restype = _I
        us = {}
        for key, lengths in (("ragged", _ragged(batch, time)), ("all_t", [time] * batch)):
            lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
            dg = torch.empty_like(xg)
            status = lib.lstm_train_bwd_gates_f32(xg.data_ptr(), w_hh.data_ptr(), lens.data_ptr(),
                                                  h_prev.data_ptr(), dg.data_ptr(), batch, time,
                                                  hidden, stream)
            if status:
                raise RuntimeError(f"gate pass failed: {lib.error_string(status).decode()}")
            gates = dg.clone()
            us[key] = _time(lib, lambda: lib.lstm_train_bwd_recurrence_f32(
                w_hh.data_ptr(), lens.data_ptr(), c_prev.data_ptr(), dout.data_ptr(),
                dg.data_ptr(), batch, time, hidden, stream),
                before=lambda: dg.copy_(gates)) * 1e3 / time
        result["us_per_step"][name] = us
        print(f"backward {name}: {us['ragged']:.2f} us a step (ragged lengths), "
              f"{us['all_t']:.2f} (all T)", flush=True)
    return result


def probe_backward_cluster(workdir: Path):
    hidden = 512
    shapes = {"asr_en_base": (64, 501), "tts_en_base": (128, 512)}
    stream = torch.cuda.current_stream().cuda_stream
    variants = backward_cluster_variants((CSRC / CLUSTER_HEADER).read_text())
    libs = _build(workdir / "backward_cluster", "bilstm_train.cu", CLUSTER_HEADER, variants)
    for lib in libs.values():
        lib.lstm_train_bwd_gates_bf16.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.lstm_train_bwd_recurrence_f32.argtypes = [_P] * 5 + [_I] * 3 + [_P]
        lib.lstm_train_bwd_recurrence_bf16.argtypes = [_P] * 9 + [_I] * 3 + [_P]
        for fn in (lib.lstm_train_bwd_gates_bf16, lib.lstm_train_bwd_recurrence_f32,
                   lib.lstm_train_bwd_recurrence_bf16):
            fn.restype = _I
    result = {"shapes": f"H={hidden}, bf16: " + "; ".join(
        f"{key} B={b}, T={t}" for key, (b, t) in shapes.items()),
        "us_per_step": {name: {} for name in [*libs, "f32_before"]},
        "max_active_clusters": {}}
    full = libs["full"]
    full.lstm_train_bwd_cluster_occupancy.argtypes = [_I] * 3
    full.lstm_train_bwd_cluster_occupancy.restype = _I
    for key, (batch, _) in shapes.items():
        result["max_active_clusters"][key] = {
            c: full.lstm_train_bwd_cluster_occupancy(batch, hidden, c) for c in (1, 2, 4, 8, 16)}
    print(f"backward_cluster max active clusters by size: {result['max_active_clusters']}",
          flush=True)
    for key, (batch, time) in shapes.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        randn = lambda *shape: torch.randn(*shape, device="cuda", generator=gen)  # noqa: E731
        bf16 = torch.bfloat16
        xg = randn(2, batch, time, 4 * hidden).to(bf16)
        w_hh = randn(2, 4 * hidden, hidden) / hidden ** 0.5
        h_prev = (randn(2, batch, time, hidden) * 0.5).to(bf16)
        c_prev = randn(2, batch, time, hidden).to(bf16)
        dout = randn(batch, time, 2 * hidden).to(bf16)
        lens = torch.tensor(_ragged(batch, time), dtype=torch.int32, device="cuda")
        order = length_order(lens)
        gates = torch.empty(2, batch, time, 4 * hidden, device="cuda")
        status = full.lstm_train_bwd_gates_bf16(xg.data_ptr(), w_hh.data_ptr(), lens.data_ptr(),
                                                h_prev.data_ptr(), gates.data_ptr(), batch, time,
                                                hidden, stream)
        if status:
            raise RuntimeError(f"gate pass failed: {full.error_string(status).decode()}")
        del xg, h_prev
        xchg = torch.empty(2, 2, batch, 4 * hidden, device="cuda")
        ready = torch.empty(2 * hidden // 8, dtype=torch.int32, device="cuda")
        dg = torch.empty(2, batch, time, 4 * hidden, device="cuda", dtype=bf16)
        pointers = [t.data_ptr() for t in (w_hh, lens, order, c_prev, dout, gates, xchg, ready,
                                            dg)]
        for name, lib in libs.items():
            launch = lib.lstm_train_bwd_recurrence_bf16
            result["us_per_step"][name][key] = _time(
                lib, lambda: launch(*pointers, batch, time, hidden, stream)) * 1e3 / time
        del xchg, dg
        c32, d32, dg32 = c_prev.float(), dout.float(), torch.empty_like(gates)
        before = full.lstm_train_bwd_recurrence_f32
        result["us_per_step"]["f32_before"][key] = _time(full, lambda: before(
            w_hh.data_ptr(), lens.data_ptr(), c32.data_ptr(), d32.data_ptr(), dg32.data_ptr(),
            batch, time, hidden, stream), before=lambda: dg32.copy_(gates)) * 1e3 / time
        del gates, c32, d32, dg32
        torch.cuda.empty_cache()
    for name, us in result["us_per_step"].items():
        print(f"backward_cluster {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
              + " us a step", flush=True)
    return result


def probe_forward_mma(workdir: Path):
    shapes = {"asr_en_base": (64, 501, 512), "tts_en_base": (128, 512, 512),
              "align_en_base": (128, 144, 256), "align_v1": (32, 501, 128)}
    stream = torch.cuda.current_stream().cuda_stream
    variants = forward_mma_variants((CSRC / MMA_HEADER).read_text())
    libs = _build(workdir / "forward_mma", "bilstm_train.cu", MMA_HEADER, variants)
    for lib in libs.values():
        for fn in (lib.lstm_train_fwd_bf16, lib.lstm_train_fwd_f32):
            fn.argtypes = [_P] * 9 + [_I] * 3 + [_P]
            fn.restype = _I
    result = {"shapes": "bf16: " + "; ".join(f"{key} B={b}, T={t}, H={h}"
                                             for key, (b, t, h) in shapes.items()),
              "us_per_step": {name: {} for name in [*libs, "f32_before"]}}
    for key, (batch, time, hidden) in shapes.items():
        gen = torch.Generator(device="cuda").manual_seed(0)
        xg16 = (torch.randn(2, batch, time, 4 * hidden, device="cuda", generator=gen)
                * 0.5).to(torch.bfloat16)
        wide = xg16.float()
        w_hh = (torch.rand(2, 4 * hidden, hidden, device="cuda", generator=gen) * 2 - 1) \
            / hidden ** 0.5
        lens = torch.tensor(_ragged(batch, time), dtype=torch.int32, device="cuda")
        order = length_order(lens)
        rows = -(-batch // 16) * 16
        xchg = torch.empty(2, 2, rows, hidden, device="cuda")
        ready = torch.empty(2 * hidden // 8, dtype=torch.int32, device="cuda")
        out = torch.empty(batch, time, 2 * hidden, device="cuda")
        states16 = [torch.empty(2, batch, time, hidden, device="cuda", dtype=torch.bfloat16)
                    for _ in range(2)]
        states32 = [torch.empty(2, batch, time, hidden, device="cuda") for _ in range(2)]
        common = [w_hh, lens, order, xchg, ready, out]
        for name, lib in libs.items():
            pointers = [t.data_ptr() for t in (xg16, *common, *states16)]
            launch = lib.lstm_train_fwd_bf16
            result["us_per_step"][name][key] = _time(
                lib, lambda: launch(*pointers, batch, time, hidden, stream)) * 1e3 / time
        full = libs["full"]
        pointers = [t.data_ptr() for t in (wide, *common, *states32)]
        result["us_per_step"]["f32_before"][key] = _time(full, lambda: full.lstm_train_fwd_f32(
            *pointers, batch, time, hidden, stream)) * 1e3 / time
        del xg16, wide, xchg, out, states16, states32
        torch.cuda.empty_cache()
    for name, us in result["us_per_step"].items():
        print(f"forward_mma {name}: " + ", ".join(f"{k} {v:.2f}" for k, v in us.items())
              + " us a step", flush=True)
    return result


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_bilstm: CUDA is not available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as workdir:
        result = {"card": card, "forward": probe_forward(Path(workdir)),
                  "backward": probe_backward(Path(workdir)),
                  "backward_cluster": probe_backward_cluster(Path(workdir)),
                  "forward_mma": probe_forward_mma(Path(workdir))}
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
