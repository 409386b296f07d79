"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision frontend (stub:
precomputed patch embeddings). [hf:microsoft/Phi-3-vision-128k-instruct; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,              # MHA
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="silu",
    ffn_type="glu",
    tie_embeddings=False,
    frontend="vision",
    num_frontend_tokens=576,      # 336px / 14 -> 24x24 CLIP patches
    sub_quadratic=False,
    source="hf:microsoft/Phi-3-vision-128k-instruct; hf",
)
