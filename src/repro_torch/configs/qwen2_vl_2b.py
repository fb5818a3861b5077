"""qwen2-vl-2b [vlm]: M-RoPE, dynamic-resolution vision frontend (stubbed).

28L, d_model=1536, 12 heads (GQA kv=2), d_ff=8960, vocab=151936,
head_dim=128, M-RoPE sections (16, 24, 24). [arXiv:2409.12191; hf]

The vision frontend is a STUB, as in the reference: a batch carries token ids
and, optionally, the (3, batch, seq) M-RoPE position ids that the real
ViT/patch pipeline would emit for interleaved text+vision streams; without
them the three streams are the token positions (the text-only case).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151_936,
    attn_type="gqa",
    pos_type="mrope",
    rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24),
    mlp_act="silu",
    norm_type="rmsnorm",
    tie_embeddings=True,
    source="[arXiv:2409.12191; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_type="gqa",
        pos_type="mrope",
        mrope_sections=(2, 3, 3),
        mlp_act="silu",
        norm_type="rmsnorm",
        tie_embeddings=True,
        max_seq_len=128,
        source=CONFIG.source,
    )
