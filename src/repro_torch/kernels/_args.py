"""Argument checks shared by the kernel wrappers (device, dtype, shape,
contiguity) — raised in Python before any pointer reaches a kernel."""
from __future__ import annotations

import torch


def f32(v, device, n=None, what="operand") -> torch.Tensor:
    """A float32 vector on ``device`` (scales and zero-points are runtime
    tensors; Python numbers are moved to the device here)."""
    t = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    if n is not None and t.numel() != n:
        raise ValueError(f"{what}: expected {n} values, got {t.numel()}")
    return t.contiguous()


def on_cuda(*tensors) -> None:
    for t in tensors:
        if t is not None and t.device.type != "cuda":
            raise ValueError(f"CUDA kernel got a tensor on {t.device}")


def ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def device_kind(t: torch.Tensor) -> str:
    """'cpu' -> plain version, 'cuda' -> kernel; anything else raises."""
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {t.device}")
    return kind


def expand_groups(v, d, device=None) -> torch.Tensor:
    """(G,) per-group vector -> (1, d) per-column row (contiguous groups)."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return v.repeat_interleave(d // v.shape[0])[None, :]
