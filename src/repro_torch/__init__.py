"""PyTorch + CUDA port of the ``repro`` package for one NVIDIA Hopper GPU.

The package mirrors ``src/repro`` (kernels, core, configs, models, runtime,
launch) and imports neither JAX nor the reference package. Each Pallas
kernel on the ported path is a hand-written CUDA kernel in ``csrc/`` with a
plain PyTorch version beside it (``kernels/``). Entry points run on the GPU
unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device  # noqa: F401
