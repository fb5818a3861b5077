"""minitron-4b [dense]: pruned nemotron (GQA + squared-ReLU).

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000,
head_dim=128. [arXiv:2407.14679; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256_000,
    attn_type="gqa",
    pos_type="rope",
    mlp_act="relu2",
    norm_type="layernorm",
    source="[arXiv:2407.14679; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minitron-4b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=192,
        vocab_size=256,
        attn_type="gqa",
        pos_type="rope",
        mlp_act="relu2",
        norm_type="layernorm",
        max_seq_len=128,
        source=CONFIG.source,
    )
