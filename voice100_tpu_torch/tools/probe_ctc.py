"""Where the time of the CTC lattice kernels' steps goes.

    python -m voice100_tpu_torch.tools.probe_ctc

Needs a CUDA card and nvcc (``$CUDA_HOME``, default ``/usr/local/cuda``).
Builds variants of ``csrc/ctc.cu`` and ``csrc/viterbi.cu`` into a temporary
directory, each with one part of the step cut out, and times one launch of
each with CUDA events (median of 5). The variants other than ``full``
compute wrong outputs and exist only to be timed. ``chip_smoke.py`` runs
it after its CTC check and before its Viterbi check, which reports the
Viterbi launch's phases from it.

The CTC loss kernels at the train shape (B=64, T=501, V=29, 140 labels:
S=281; every row the full T, so every block walks every step):

* alpha forward (kernel 4): ``full``; ``no_emission_load`` (no cp.async
  of the ``log_probs`` chunks); ``no_barrier``; ``no_arithmetic`` (a neighbour plus
  the emission in place of the log-sum-exp); ``no_store`` (alpha is not
  written to device memory); ``chain_floor`` (all three cut: the
  neighbour read, the store to shared memory and the barrier);
* adjoint (kernel 5): ``full``; ``no_alpha_stream`` (no cp.async of the
  alpha rows); ``no_barrier``; ``no_arithmetic`` (neither pre nor the
  weights computed: the three-FMA chain alone, and the stream); ``no_store``;
  ``chain_floor`` (stream, arithmetic and store cut).

The Viterbi launch (kernels 6 and 7, ``csrc/viterbi.cu``) at the align
check's shape (B=64, T=512, V=29, 160 labels: S=321, every row the full
T): ``full``; ``no_backtrace`` (the walk cut: the forward phase, the
final state and the zero fill); ``no_forward`` (the time loop cut: the
backtrace phase, walking the moves a ``full`` launch left in the same
buffer); ``no_emission_stage`` (no cp.async of the ``log_probs``
chunks); ``no_move_store`` (zeros stored in place of the packed moves of
the whole chunks, so the moves are not computed there); ``walk_only``
(``no_forward`` without the loads of the packed rows: the walk over
shared memory); ``chain_floor`` (the neighbour exchange and the max
only: no emissions, no moves, no backtrace); and ``full_<n>_warps``, the
kernel launched with n warps a sample in place of the layout's (fewer or
more states a lane): 1 and 2 warps with the ``full`` build, 8 with a build
whose ``MAX_WARPS`` admits them.

``chain_floor`` times ``T`` is the least time each kernel's dependent
chain of steps can take as written (for the Viterbi, its forward's).
Prints one line a variant and a JSON object ``{"card", "shapes",
"us_per_step": {kernel: {variant: us}}, "chain_floor_ms": {kernel:
ms}}``.
"""

from __future__ import annotations

import json
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from ..kernels.build import CSRC
from .probe_bilstm import _I, _P, _build, _check_anchors, _time

# text anchors in ctc.cu's forward, each cut by a replacement
_EMIT = "cp_async4(buf + i, src + i);"
_STEP_BARRIER = "__syncthreads();                            // the step barrier"
_LSE = "v = lse3(prev[s], prev[s - 1], sk[j] ? prev[s - 2] : NEG) + e[zs[j]];"
_ALPHA_STORE = "out[s] = v;"
# ... and in its adjoint
_STREAM = "if (s < S) cp_async4(slot + s, ab + r * row + s);"
_ITER_BARRIER = "__syncthreads();                            // the iteration barrier"
_WEIGHTS = "if (t >= 2 && t <= len) {"
_PRE = "if (t >= 3) {"
_GRAD_STORE = "out[s] = (t > 1 || s < 2) ? ge[j] : 0.f;"
# ... and in viterbi.cu
_VIT_STAGE = "cp_async4(dst + i, src + i);"
_VIT_LOOP = "for (int c = 0; 1 + c * CH < len; ++c) {"
_VIT_EMIT = "out = valid ? best + e : NEG;"
_VIT_MOVE = "make_uint4(words[4 * q], words[4 * q + 1], words[4 * q + 2], words[4 * q + 3]);"
_BT_FETCH = "for (int q = 0; q < CH / 4; ++q) pre[q] = src[q];"
_BT_WALK = "int cb = len >= 2 ? (len - 2) / CH : -1;"
_MAX_WARPS = "constexpr int MAX_WARPS = 6;"

def ctc_variants(src: str):
    """Variants of ``ctc.cu``'s text, by name, for both kernels: the
    forward's cuts leave the adjoint whole, and the other way round."""
    _check_anchors(src, (_EMIT, _STEP_BARRIER, _LSE, _ALPHA_STORE, _STREAM, _ITER_BARRIER,
                         _WEIGHTS, _PRE, _GRAD_STORE), "ctc.cu")
    no_emit = src.replace(_EMIT, ";")
    no_stream = src.replace(_STREAM, _STREAM.replace("if (s < S)", "if (false)"))
    no_weights = no_stream.replace(_WEIGHTS, "if (false) {").replace(_PRE, "if (false) {")
    return {
        "full": src,
        "alpha_no_emission_load": no_emit,
        "alpha_no_barrier": src.replace(_STEP_BARRIER, ""),
        "alpha_no_arithmetic": src.replace(_LSE, "v = prev[s - 1] + e[zs[j]];"),
        "alpha_no_store": src.replace(_ALPHA_STORE, ""),
        "alpha_chain_floor": no_emit.replace(_LSE, "v = prev[s - 1];").replace(_ALPHA_STORE, ""),
        "adjoint_no_alpha_stream": no_stream,
        "adjoint_no_barrier": src.replace(_ITER_BARRIER, ""),
        "adjoint_no_arithmetic": src.replace(_WEIGHTS, "if (false) {").replace(_PRE, "if (false) {"),
        "adjoint_no_store": src.replace(_GRAD_STORE, ""),
        "adjoint_chain_floor": no_weights.replace(_GRAD_STORE, ""),
    }


def viterbi_variants(src: str):
    """Variants of ``viterbi.cu``'s text, by name."""
    _check_anchors(src, (_VIT_STAGE, _VIT_LOOP, _VIT_EMIT, _VIT_MOVE, _BT_FETCH, _BT_WALK,
                         _MAX_WARPS), "viterbi.cu")
    no_forward = src.replace(_VIT_LOOP, _VIT_LOOP.replace("< len", "< 1"))
    return {
        "full": src,
        "no_backtrace": src.replace(_BT_WALK, "int cb = -1;"),
        "no_forward": no_forward,
        "no_emission_stage": src.replace(_VIT_STAGE, ";"),
        "no_move_store": src.replace(_VIT_MOVE, "make_uint4(0u, 0u, 0u, 0u);"),
        "walk_only": no_forward.replace(_BT_FETCH, "for (int q = 0; q < CH / 4; ++q) "
                                                   "pre[q] = make_uint4(0u, 0u, 0u, 0u);"),
        "chain_floor": src.replace(_VIT_STAGE, ";").replace(_VIT_EMIT, "out = best;")
                          .replace(_VIT_MOVE, "make_uint4(0u, 0u, 0u, 0u);")
                          .replace(_BT_WALK, "int cb = -1;"),
        "full_8_warps": src.replace(_MAX_WARPS, "constexpr int MAX_WARPS = 8;"),
    }

def _lattice_inputs(batch: int, time: int, vocab: int, labels: int, seed: int):
    """Seeded log-probs [B, T, V], labels [B, labels] with no two equal
    neighbours (every row can align), the lattice constants and lengths,
    all on the card."""
    from ..ops.ctc import ctc_prep

    rng = np.random.default_rng(seed)
    logits = torch.from_numpy(rng.standard_normal((batch, time, vocab)).astype(np.float32) * 2)
    targets = rng.integers(1, vocab, size=(batch, labels))
    for i in range(1, labels):
        same = targets[:, i] == targets[:, i - 1]
        targets[same, i] = targets[same, i] % (vocab - 1) + 1
    lp = torch.log_softmax(logits, dim=-1).cuda()
    tgt = torch.from_numpy(targets).cuda()
    tl = torch.full((batch,), labels, dtype=torch.int64, device="cuda")
    il = torch.full((batch,), time, dtype=torch.int32, device="cuda")
    z, can_skip, valid = ctc_prep(tgt, tl)
    return lp, tl, il, z.int().contiguous(), can_skip.int().contiguous(), valid.int().contiguous()


def _report(kernel: str, us: dict) -> None:
    print(f"{kernel}: " + ", ".join(f"{k} {v:.3f}" for k, v in us.items()) + " us a step",
          flush=True)


def probe_ctc(workdir: Path):
    from ..ops.ctc import ll_from_alpha

    batch, time, vocab, labels = 64, 501, 29, 140
    lp, tl, il, z, skip, valid = _lattice_inputs(batch, time, vocab, labels, seed=0)
    s_len = z.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    alpha = torch.empty(time, batch, s_len, device="cuda")
    grad = torch.empty_like(alpha)
    libs = _build(workdir / "ctc", "ctc.cu", "ctc.cu", ctc_variants((CSRC / "ctc.cu").read_text()))
    for lib in libs.values():
        lib.ctc_alpha_f32.argtypes = [_P] * 6 + [_I] * 4 + [_P]
        lib.ctc_alpha_f32.restype = _I
        lib.ctc_adjoint_f32.argtypes = [_P] * 6 + [_I] * 3 + [_P]
        lib.ctc_adjoint_f32.restype = _I

    def run_alpha(lib):
        return lib.ctc_alpha_f32(lp.data_ptr(), z.data_ptr(), skip.data_ptr(), valid.data_ptr(),
                                 il.data_ptr(), alpha.data_ptr(), batch, time, vocab, s_len, stream)

    full = libs["full"]
    run_alpha(full)
    # the seed the loss gives: dLL/d alpha[T-1] on the two end states
    ll, a_last, a_prev = ll_from_alpha(alpha[-1], tl)
    end = 2 * tl
    g_seed = torch.zeros(batch, s_len, device="cuda")
    g_seed.scatter_add_(1, end[:, None], torch.exp(a_last - ll)[:, None])
    g_seed.scatter_add_(1, (end - 1)[:, None], torch.exp(a_prev - ll)[:, None])
    alpha_in = alpha.clone()

    def run_adjoint(lib):
        return lib.ctc_adjoint_f32(alpha_in.data_ptr(), g_seed.data_ptr(), skip.data_ptr(),
                                   valid.data_ptr(), il.data_ptr(), grad.data_ptr(), batch, time,
                                   s_len, stream)

    result = {}
    for kernel, run in (("alpha", run_alpha), ("adjoint", run_adjoint)):
        us = {name.removeprefix(f"{kernel}_"): _time(lib, lambda: run(lib)) * 1e3 / time
              for name, lib in libs.items() if name == "full" or name.startswith(f"{kernel}_")}
        result[kernel] = us
        _report(kernel, us)
    shapes = f"CTC B={batch}, T={time}, V={vocab}, S={s_len}, every row T"
    return result, shapes


# the Viterbi launch's inputs: batch, steps, classes and labels of every row
VITERBI_SHAPE = (64, 512, 29, 160)


def probe_viterbi(workdir: Path):
    from ..ops.viterbi_cuda import CHUNK, viterbi_launch_smem, viterbi_layout

    batch, time, vocab, labels = VITERBI_SHAPE
    lp, tl, il, z, _, valid = _lattice_inputs(batch, time, vocab, labels, seed=1)
    s_len = z.shape[1]
    lay = viterbi_layout(s_len)
    stream = torch.cuda.current_stream().cuda_stream
    tl32 = tl.int().contiguous()
    score = torch.empty(batch, device="cuda")
    path = torch.empty(batch, time, dtype=torch.int32, device="cuda")
    labels_out = torch.empty_like(path)
    last = torch.empty(batch, s_len, device="cuda")
    packed = {}
    libs = _build(workdir / "viterbi", "viterbi.cu", "viterbi.cu",
                  viterbi_variants((CSRC / "viterbi.cu").read_text()))
    for lib in libs.values():
        lib.viterbi_align_f32.argtypes = [_P] * 10 + [_I] * 8 + [_P]
        lib.viterbi_align_f32.restype = _I

    def run(lib, warps=lay.warps):
        k = max(2, -(-s_len // (32 * warps)))
        if warps not in packed:
            packed[warps] = torch.empty(batch, -(-(time - 1) // CHUNK), 32 * warps, CHUNK,
                                        dtype=torch.int32, device="cuda")
        ring, smem = viterbi_launch_smem(s_len, vocab, warps)
        return lib.viterbi_align_f32(
            lp.data_ptr(), z.data_ptr(), valid.data_ptr(), il.data_ptr(), tl32.data_ptr(),
            score.data_ptr(), path.data_ptr(), labels_out.data_ptr(), packed[warps].data_ptr(),
            last.data_ptr(), batch, time, vocab, s_len, k, warps, int(ring), smem, stream)

    # no_forward and walk_only walk the moves this launch leaves in `packed`
    _time(libs["full"], lambda: run(libs["full"]))
    us = {name: _time(lib, lambda: run(lib, 8 if name == "full_8_warps" else lay.warps)) * 1e3
          / time for name, lib in libs.items()}
    # the full build with fewer warps a sample
    for warps in (1, 2):
        us[f"full_{warps}_warps"] = _time(libs["full"],
                                          lambda: run(libs["full"], warps)) * 1e3 / time
    _report("viterbi", us)
    return {"viterbi": us}, (f"Viterbi B={batch}, T={time}, V={vocab}, S={s_len} (k={lay.k}, "
                             f"{lay.warps} warps a sample), every row T")

def probe() -> dict:
    """Build and time every variant; the result as ``main`` prints it."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as workdir:
        ctc, ctc_shapes = probe_ctc(Path(workdir))
        viterbi, viterbi_shapes = probe_viterbi(Path(workdir))
    us = {**ctc, **viterbi}
    steps = {"alpha": 501, "adjoint": 501, "viterbi": 512}
    return {"card": card, "shapes": f"{ctc_shapes}; {viterbi_shapes}", "us_per_step": us,
            "chain_floor_ms": {k: v["chain_floor"] * steps[k] * 1e-3 for k, v in us.items()}}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("probe_ctc: CUDA is not available")
    print(json.dumps(probe()), flush=True)


if __name__ == "__main__":
    main()
