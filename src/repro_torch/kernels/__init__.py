"""Hand-written Hopper kernels for the quantization hot spots — one for
every Pallas entry point of ``repro.kernels`` — each beside its plain
PyTorch version (``*_plain``) and a launch counter on its wrapper
(``*_cuda.launches``; the 4-bit variants count in ``launches_w4`` /
``launches_kv4``):

  fused_ln_quant — ``rms_quantize`` / ``ln_quantize``: RMSNorm / LayerNorm
                   + int8 emit (paper Fig. 4), and their fake-quant twins
                   ``rms_fake_quant`` / ``ln_fake_quant``.
  peg_quant      — ``peg_quantize``: per-group int8 emit (eq. 5), and
                   ``peg_fake_quant``.
  int8_matmul    — ``int8_matmul`` (eq. 3) and ``int8_matmul_peg``
                   (eq. 4 -> 5), both with the fused deployment epilogue
                   and 8- or 4-bit (nibble-packed) weights.
  int8_attend_decode  — one decode step of attention over an int8 or
                   nibble-packed int4 KV cache, with the softmax sites
                   in-kernel.
  paged_attend_decode — its twins over block-paged caches:
                   ``paged_int8_attend_decode`` (8 or 4 bits) and the
                   f32/bf16 ``paged_attend_decode``.
  nibble         — the int4 layouts (split-half for caches, pairwise rows
                   for weights).

``ops`` dispatches by device (CPU tensor -> plain version, CUDA tensor ->
kernel); ``ref`` holds the dequantize-then-compute oracles. The CUDA
sources are in ``repro_torch/csrc`` and are built on first use
(``_build``)."""
