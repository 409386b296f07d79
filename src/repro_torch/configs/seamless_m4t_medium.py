"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone; the
speech frontend is a stub per the assignment (precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,                # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    rope_theta=None,              # learned absolute positions (encdec.py)
    norm="layernorm",
    act="relu",
    ffn_type="mlp",
    tie_embeddings=True,
    frontend="audio",
    num_frontend_tokens=4096,     # default encoder frames (overridden per shape)
    max_seq_len=32768,
    sub_quadratic=False,          # full attention + 4k-positions family:
                                  # skips long_500k (DESIGN.md §5)
    source="arXiv:2308.11596; hf",
)
