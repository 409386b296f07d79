"""PEG-int8 gradient compression, its single-device part (port of
``repro.core.grad_compression``).

Gradients, like transformer activations, have per-channel dynamic-range
structure, so each gradient tensor is quantized to int8 with per-group
scales (the PEG scheme along the flattened tensor) before a cross-pod
exchange, with an error-feedback accumulator (Seide et al. 2014) that
compensates the quantization noise on the next step instead of biasing the
update. The exchange itself (``compressed_psum``,
``make_crosspod_allreduce``) needs a collective and waits for multi-device
training (ROADMAP Queue 1 item 6).

The group scale is ``amax / 127.0`` as the reference computes it eagerly
(a true division).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.optim.tree import tree_map


def _groups(x: torch.Tensor, group_size: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return F.pad(flat, (0, (-flat.numel()) % group_size)).reshape(
        -1, group_size)


def _group_scales(x: torch.Tensor, group_size: int) -> torch.Tensor:
    return torch.amax(torch.abs(_groups(x, group_size)), dim=1) / 127.0


def quantize_grad(g: torch.Tensor, group_size: int = 256
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization with per-group scales along the
    flattened ``g``. Returns (q (G, group_size) int8, scales (G,) f32)."""
    scales = torch.clamp_min(_group_scales(g, group_size),
                             torch.finfo(torch.float32).tiny)
    q = torch.clamp(torch.round(_groups(g, group_size) / scales[:, None]),
                    -127, 127).to(torch.int8)
    return q, scales


def dequantize_grad(q: torch.Tensor, scales: torch.Tensor, shape,
                    dtype) -> torch.Tensor:
    flat = (q.float() * scales[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape).to(dtype)


def init_error_feedback(grads, n_pod: int = 1):
    """Per-pod error-feedback buffers: leaves (n_pod, *grad_shape) f32."""
    return tree_map(lambda g: torch.zeros((n_pod,) + tuple(g.shape),
                                          dtype=torch.float32,
                                          device=g.device), grads)
