"""internlm2-20b [dense] — GQA kv=8. [arXiv:2403.17297; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1000000.0,
    norm="rmsnorm",
    act="silu",
    ffn_type="glu",
    tie_embeddings=False,
    sub_quadratic=False,          # pure full attention: skips long_500k
    source="arXiv:2403.17297; hf",
)
