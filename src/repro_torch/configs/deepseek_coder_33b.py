"""deepseek-coder-33b [dense]: llama-arch GQA.

62L, d_model=7168, 56 heads (GQA kv=8), d_ff=19200, vocab=32256,
head_dim=128. [arXiv:2401.14196; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    num_layers=62,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=19_200,
    vocab_size=32_256,
    attn_type="gqa",
    pos_type="rope",
    rope_theta=100_000.0,
    mlp_act="silu",
    norm_type="rmsnorm",
    source="[arXiv:2401.14196; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-coder-33b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=160,
        vocab_size=256,
        attn_type="gqa",
        pos_type="rope",
        mlp_act="silu",
        norm_type="rmsnorm",
        max_seq_len=128,
        source=CONFIG.source,
    )
