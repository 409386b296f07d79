"""Modality front-end stubs (port of ``repro.models.frontends``): the
transformer backbone is specified, the audio / vision front end supplies
precomputed frame / patch embeddings. These helpers draw deterministic
stand-ins for smoke runs and examples from an explicit
``torch.Generator``; production inputs arrive as (B, N, d_model) tensors.
``jax.random`` draws cannot be reproduced here, so parity tests carry the
reference's embeddings across as numpy."""
from __future__ import annotations

import torch


def _synth(gen: torch.Generator, batch: int, n: int, d_model: int, dtype):
    return (torch.randn((batch, n, d_model), generator=gen,
                        device=gen.device) * 0.02).to(dtype)


def synth_patch_embeddings(gen: torch.Generator, batch: int, num_tokens: int,
                           d_model: int, dtype=torch.bfloat16):
    """Stand-in for a CLIP vision tower's output (phi-3-vision), on the
    generator's device."""
    return _synth(gen, batch, num_tokens, d_model, dtype)


def synth_frame_embeddings(gen: torch.Generator, batch: int, num_frames: int,
                           d_model: int, dtype=torch.bfloat16):
    """Stand-in for a speech feature encoder's output (seamless-m4t), on
    the generator's device."""
    return _synth(gen, batch, num_frames, d_model, dtype)
