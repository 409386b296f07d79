"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 1:2 ratio
(pattern rec,rec,local_attn; 26 = 8x3 + 2 tail rec). [arXiv:2402.19427; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,               # MQA in the local-attention blocks
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rec", "rec", "local_attn"),
    tail_pattern=("rec", "rec"),
    local_window=2048,
    d_rnn=2560,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="gelu",
    ffn_type="glu",
    embed_scale=True,
    tie_embeddings=True,
    sub_quadratic=True,           # O(1) recurrent state + bounded local attn
    source="arXiv:2402.19427; hf",
)
