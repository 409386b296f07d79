"""h2o-danube-3-4b [dense] — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    num_heads=32,
    num_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    window=4096,                  # mistral-style SWA -> bounded KV cache
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    ffn_type="glu",
    tie_embeddings=True,
    sub_quadratic=True,           # SWA bounds decode state: runs long_500k
    source="arXiv:2401.16818; unverified",
)
