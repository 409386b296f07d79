"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.models.moe import MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,                    # per-expert hidden
    vocab_size=151936,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536, norm_topk=True),
    qk_norm=True,
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    ffn_type="glu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="hf:Qwen/Qwen3-30B-A3B; hf",
)
