"""minicpm3-4b [dense]: MLA attention.

62L, d_model=2560, 40 heads (kv=40 at the MLA latent level), d_ff=6400,
vocab=73448. [hf:openbmb/MiniCPM3-4B; hf]
"""
from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    num_layers=62,
    d_model=2560,
    num_heads=40,
    num_kv_heads=40,
    d_ff=6400,
    vocab_size=73_448,
    attn_type="mla",
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
    pos_type="rope",
    rope_theta=10_000.0,
    mlp_act="silu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[hf:openbmb/MiniCPM3-4B; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b-smoke",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_type="mla",
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=8,
            qk_rope_head_dim=8,
            v_head_dim=8,
        ),
        pos_type="rope",
        mlp_act="silu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        max_seq_len=128,
        source=CONFIG.source,
    )
