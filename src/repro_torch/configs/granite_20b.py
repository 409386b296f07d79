"""granite-20b [dense] — llama-arch code model with MQA (kv=1).
[arXiv:2405.04324; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,               # MQA
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    ffn_type="glu",
    tie_embeddings=False,
    sub_quadratic=False,
    source="arXiv:2405.04324; hf",
)
