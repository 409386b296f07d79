"""Int4 <-> packed-int8 nibble layouts of the 4-bit deploy path (port of
``repro.kernels.nibble``). Two int4 values share one int8 byte, halving the
bytes of the KV cache and of packed weight payloads. Nibbles hold two's
complement int4 in [-8, 7] (``_sext4`` re-extends the sign), so both the
symmetric [-7, 7] weight grid and the shifted asymmetric cache grid fit.

* **split-half** (:func:`pack_nibbles` / :func:`unpack_nibbles`): along an
  axis of length ``n``, byte ``j`` holds value ``j`` in its low nibble and
  value ``j + ceil(n/2)`` in its high nibble; odd ``n`` pads the last high
  nibble with 0. The KV cache packs its head_dim axis this way, so one
  32-bit word of a packed row carries columns 4i..4i+3 and
  hd/2+4i..hd/2+4i+3 (what the decode kernels unpack).
* **pairwise rows** (:func:`pack_rows` / :func:`unpack_rows`): packed row
  ``r`` of a (K, N) weight holds rows ``2r`` (low) and ``2r + 1`` (high), so
  packed rows [a, b) are exactly rows [2a, 2b) and even K tiles and PEG
  groups never split a byte. K must be even.
"""
from __future__ import annotations

import torch


def _sext4(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend the low nibble of an int32 tensor to [-8, 7]."""
    return ((v & 15) ^ 8) - 8


def _pack_pair(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Two tensors of int4-range values -> one int8 byte tensor."""
    b = (lo.to(torch.int32) & 15) | ((hi.to(torch.int32) & 15) << 4)
    return torch.where(b >= 128, b - 256, b).to(torch.int8)


def packed_len(n: int) -> int:
    """Packed length of an ``n``-value int4 axis."""
    return -(-n // 2)


def pack_nibbles(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Split-half pack: int4-range values with ``n`` along ``axis`` ->
    int8 with ``ceil(n/2)`` along ``axis``."""
    axis = axis % x.dim()
    n = x.shape[axis]
    half = packed_len(n)
    if 2 * half != n:
        pad = [0, 0] * (x.dim() - 1 - axis) + [0, 2 * half - n]
        x = torch.nn.functional.pad(x, pad)
    lo, hi = x.narrow(axis, 0, half), x.narrow(axis, half, half)
    return _pack_pair(lo, hi)


def unpack_nibbles(packed: torch.Tensor, n: int,
                   axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_nibbles`: int8 values of the original length
    ``n`` along ``axis``."""
    b = packed.to(torch.int32)
    out = torch.cat([_sext4(b), _sext4(b >> 4)], dim=axis).to(torch.int8)
    axis = axis % out.dim()
    return out.narrow(axis, 0, n) if out.shape[axis] != n else out


def pack_rows(w: torch.Tensor) -> torch.Tensor:
    """Pairwise-row pack of a (K, N) int4-range weight into (K/2, N)."""
    k = w.shape[0]
    if k % 2:
        raise ValueError(f"pack_rows needs even K, got {k}")
    return _pack_pair(w[0::2], w[1::2])


def unpack_rows(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_rows`: (K/2, N) packed -> (K, N) int8."""
    b = packed.to(torch.int32)
    k2, n = b.shape
    return torch.stack([_sext4(b), _sext4(b >> 4)], dim=1).reshape(
        2 * k2, n).to(torch.int8)
