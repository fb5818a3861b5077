"""mamba2-370m [ssm]: SSD (state-space duality), attention-free.

48L, d_model=1024, ssm_state=128, vocab=50280, expand=2 (d_inner=2048),
head_dim=64 (32 SSD heads), d_conv=4. [arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    num_layers=48,
    d_model=1024,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    attn_type="none",
    pos_type="none",
    mlp_act="silu",
    norm_type="rmsnorm",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    tie_embeddings=True,
    source="[arXiv:2405.21060; unverified]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke",
        family="ssm",
        num_layers=2,
        d_model=64,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=256,
        attn_type="none",
        pos_type="none",
        mlp_act="silu",
        norm_type="rmsnorm",
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk_size=32),
        tie_embeddings=True,
        max_seq_len=128,
        source=CONFIG.source,
    )
