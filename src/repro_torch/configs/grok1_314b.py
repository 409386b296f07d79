"""grok-1-314b [moe] — 8 experts top-2, attention/output logit soft-capping.
[hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,                   # per-expert hidden
    vocab_size=131072,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=32768, activation="gelu",
                  norm_topk=False),
    attn_logit_softcap=30.0,
    final_logit_softcap=30.0,
    embed_scale=True,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="gelu",
    ffn_type="glu",
    tie_embeddings=True,
    sub_quadratic=False,
    source="hf:xai-org/grok-1; unverified",
)
