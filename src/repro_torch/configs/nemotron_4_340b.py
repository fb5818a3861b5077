"""nemotron-4-340b [dense]: GQA + squared-ReLU MLP.

96L, d_model=18432, 96 heads (GQA kv=8), d_ff=73728, vocab=256000.
head_dim = 18432/96 = 192. [arXiv:2402.16819; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    attn_type="gqa",
    pos_type="rope",
    mlp_act="relu2",
    norm_type="layernorm",
    source="[arXiv:2402.16819; unverified]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b-smoke",
        family="dense",
        num_layers=2,
        d_model=96,
        num_heads=6,
        num_kv_heads=2,
        head_dim=16,
        d_ff=256,
        vocab_size=256,
        attn_type="gqa",
        pos_type="rope",
        mlp_act="relu2",
        norm_type="layernorm",
        max_seq_len=128,
        source=CONFIG.source,
    )
