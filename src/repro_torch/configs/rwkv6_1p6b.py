"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,                 # wkv heads = d_model / rwkv_head_size
    num_kv_heads=32,              # unused (attention-free)
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv_head_size=64,
    rope_theta=None,
    norm="layernorm",
    act="relu",
    ffn_type="mlp",               # channel-mix handles its own shape
    tie_embeddings=False,
    sub_quadratic=True,           # O(1) state: runs long_500k
    source="arXiv:2404.05892; unverified",
)
