"""Hand-written Hopper kernels for the quantization hot spots, each beside
its plain PyTorch version (``*_plain``) and a launch counter on its
wrapper (``*_cuda.launches``):

  fused_ln_quant — ``rms_quantize``: RMSNorm + int8 emit (paper Fig. 4).
  peg_quant      — ``peg_quantize``: per-group int8 emit (eq. 5).
  int8_matmul    — ``int8_matmul`` (eq. 3) and ``int8_matmul_peg``
                   (eq. 4 -> 5), both with the fused deployment epilogue.
  int8_attend_decode  — one decode step of attention over an int8 KV
                   cache, with the softmax sites in-kernel.
  paged_attend_decode — its twins over block-paged caches:
                   ``paged_int8_attend_decode`` and the f32/bf16
                   ``paged_attend_decode``.

``ops`` dispatches by device (CPU tensor -> plain version, CUDA tensor ->
kernel); ``ref`` holds the dequantize-then-compute oracles. The CUDA
sources are in ``repro_torch/csrc`` and are built on first use
(``_build``)."""
