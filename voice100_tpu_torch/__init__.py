"""voice100_tpu_torch: the PyTorch/CUDA port of voice100_tpu for NVIDIA Hopper.

A second package beside the JAX one, ported slice by slice and held
against it in the tests (same inputs, same weights, stated tolerances).
Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path
becomes a CUDA C++ kernel written for ``sm_90a`` (``csrc/``), built with
``nvcc`` at first use (``kernels/build.py``) and bound with ``ctypes``.
Each kernel keeps a plain PyTorch version beside it, which its wrapper
runs for tensors on the CPU.

This package imports neither ``jax`` nor anything of ``voice100_tpu``:
what it needs from there is copied (``text/`` with the G2P and the
Japanese reader and the n-gram LM, ``dsp/``, ``native/`` with its C++
audio decoders, ``data/datasets.py``, ``data/registry.py``,
``tools/prepare_dataset.py``, ``tools/train_lm.py``, ``ops/ctc_beam.py``,
``onnx/``, ``dsp/world/synthesis_np.py``)
or rebuilt (the DFT and mel constants in ``ops/melspec.py``).

Ported so far: ASR v2 serving (``inference.ASRPipeline`` ->
``models.AudioToAlignText.greedy_decode``), with the fused log-mel and
the biLSTM inference recurrence as hand-written kernels; ASR v2
training (``training.Trainer`` -> ``models.AudioToAlignText.compute_loss``:
augmentation, model, CTC loss, backward, gradient clip, Adam), with the
biLSTM train forward and backward (``csrc/bilstm_train.cu``) and the CTC
lattice forward and adjoint (``csrc/ctc.cu``) as hand-written kernels;
ASR v2 forced alignment (``tools.align_text`` ->
``models.AudioToAlignText.ctc_best_path``) over the mel data path
(``data/``), with the CTC Viterbi forward and backtrace
(``csrc/viterbi.cu``) as hand-written kernels; and TTS v2 serving
(``inference.TTSPipeline``, ``tools.update_samples`` ->
``models.TextToAlignText`` and ``models.AlignTextToAudio``, the duration
expansion and batched WORLD synthesis in ``dsp/world/``), whose biLSTMs
run the inference kernel; TTS v2 training of both models; and the real
corpus front end: FLAC and MP3 decoding (``native/``, built with g++ at
first use), English and Japanese phonemization, ``tools.prepare_dataset``;
the training data shell (the loader's worker pool, packed uploads, device
prefetch, the device feature cache and multi-step dispatch); and CTC
prefix beam search with trigram LM fusion (``ops/ctc_beam_device.py``,
``ops/ctc_beam.py``, ``text/ngram.py``); long-form streaming and the HTTP
server; the device WORLD analysis (``dsp/world/dio_device.py`` and the
device backends of CheapTrick and the band aperiodicity); and the
deployment surface: ``tools.export`` (a ``torch.export`` program holding
kernel 1 as the op ``voice100_torch::bilstm_infer``, and an ``.onnx``),
``onnx/`` (the emitter on protobuf classes built without ``protoc``, the NumPy
runtime, ``OnnxASR``/``OnnxTTS``), ``native/world.cpp`` and
``tools.import_torch``; and data parallelism (``parallel``): training one
process a device over ``torch.distributed`` (the CLI's ``--distributed``),
each rank launching the same kernels on its rows of every global batch,
and the serving pipelines over a mesh of devices.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
see :func:`voice100_tpu_torch.device.resolve_device`.
"""

__version__ = "0.1.0"
