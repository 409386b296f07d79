"""gemma2-2b [dense] — local+global alternating attention, logit softcap,
post-norm sandwich, scaled embeddings. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("local_attn", "attn"),   # alternating local/global
    local_window=4096,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    rope_theta=10000.0,
    norm="rmsnorm",
    act="gelu",
    ffn_type="glu",
    post_norm=True,
    embed_scale=True,
    tie_embeddings=True,
    # half the layers are bounded-window; global layers decode linearly with
    # an SP-sharded cache -> included in long_500k (DESIGN.md §5)
    sub_quadratic=True,
    source="arXiv:2408.00118; hf",
)
