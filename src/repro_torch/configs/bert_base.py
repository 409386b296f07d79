"""bert-base-uncased — the paper's own model (Devlin et al. 2019), used by the
reproduction benchmarks. Encoder-only: no decode shapes; not part of the 40
assigned dry-run cells (it is dry-run-able via --arch bert-base for its
train/prefill shapes)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    family="encoder",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=30522,
    rope_theta=None,              # learned absolute positions
    norm="layernorm",
    act="gelu",
    ffn_type="mlp",
    tie_embeddings=True,
    max_seq_len=512,
    skip_decode=True,
    sub_quadratic=False,
    source="Devlin et al. 2019 (paper's model)",
)
