"""Architecture config schema + registry (port of ``repro.configs.base``).

The port keeps its own ``ModelConfig`` — same fields, same ``reduced()`` —
because the reference module imports JAX. Every architecture of the
reference is registered, in its order: the attention decoders, the
recurrent families, the encoder-decoder seamless-m4t-medium, the
vision-language phi3-vision-4p2b and bert-base.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.moe import MoEConfig

# the reference's input shapes (``repro.configs.base.SHAPES``)
SHAPES: Dict[str, dict] = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | hybrid | ssm | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # attention variants
    window: Optional[int] = None             # sliding-window size (all layers)
    attn_logit_softcap: Optional[float] = None
    final_logit_softcap: Optional[float] = None
    rope_theta: Optional[float] = 10000.0
    norm: str = "rmsnorm"                    # rmsnorm | layernorm
    act: str = "silu"
    ffn_type: str = "glu"                    # glu | mlp
    post_norm: bool = False                  # gemma-2 sandwich norms
    qk_norm: bool = False                    # qwen3
    embed_scale: bool = False                # gemma: x *= sqrt(d)
    tie_embeddings: bool = True
    # block pattern, repeated; tail appended at the end.
    # entries: "attn" | "local_attn" | "rec" | "rwkv"
    block_pattern: Tuple[str, ...] = ("attn",)
    tail_pattern: Tuple[str, ...] = ()
    local_window: int = 4096                 # window for "local_attn" blocks
    d_rnn: Optional[int] = None              # RG-LRU width
    rwkv_head_size: int = 64
    moe: Optional[MoEConfig] = None
    encoder_layers: int = 0
    frontend: Optional[str] = None           # audio | vision
    num_frontend_tokens: int = 0
    max_seq_len: int = 1 << 20
    sub_quadratic: bool = False
    skip_decode: bool = False
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def layer_plan(self) -> Tuple[str, ...]:
        """Full per-layer block-type sequence of length num_layers."""
        n = self.num_layers - len(self.tail_pattern)
        reps, rem = divmod(n, len(self.block_pattern))
        if rem:
            raise ValueError(f"{self.name}: {n} layers not divisible by "
                             f"pattern {self.block_pattern}")
        return self.block_pattern * reps + self.tail_pattern

    @property
    def n_super(self) -> int:
        return (self.num_layers - len(self.tail_pattern)) // \
            len(self.block_pattern)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        pat = len(self.block_pattern)
        tail = len(self.tail_pattern)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, num_experts=4,
                                      top_k=min(self.moe.top_k, 2), d_ff=64,
                                      capacity_factor=4.0)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=2 * pat + tail,
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab_size=128,
            d_rnn=64 if self.d_rnn else None,
            rwkv_head_size=16,
            window=min(self.window, 16) if self.window else None,
            local_window=16,
            encoder_layers=2 if self.encoder_layers else 0,
            num_frontend_tokens=8 if self.frontend else 0,
            max_seq_len=256,
            moe=moe,
        )


_REGISTRY = ["h2o_danube3_4b", "internlm2_20b", "gemma2_2b", "granite_20b",
             "qwen3_moe_235b", "grok1_314b", "recurrentgemma_2b",
             "rwkv6_1p6b", "seamless_m4t_medium", "phi3_vision_4p2b",
             "bert_base"]
ARCH_IDS = [m.replace("_", "-") for m in _REGISTRY]


def get_config(arch_id: str) -> ModelConfig:
    mod_name = arch_id.replace("-", "_")
    if mod_name not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}").CONFIG
