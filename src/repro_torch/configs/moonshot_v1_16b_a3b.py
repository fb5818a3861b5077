"""moonshot-v1-16b-a3b [moe]: kimi/moonlight, 64 routed experts top-6.

48L, d_model=2048, 16 heads (MHA kv=16), expert d_ff=1408, vocab=163840,
plus 2 shared experts (moonlight-style). [hf:moonshotai/Moonlight-16B-A3B; hf]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163_840,
    attn_type="gqa",
    pos_type="rope",
    rope_theta=50_000.0,
    mlp_act="silu",
    norm_type="rmsnorm",
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_expert=1408,
        num_shared_experts=2,
        d_shared=2816,
        every_k_layers=1,
        norm_topk_prob=True,
    ),
    source="[hf:moonshotai/Moonlight-16B-A3B; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        attn_type="gqa",
        pos_type="rope",
        mlp_act="silu",
        norm_type="rmsnorm",
        moe=MoEConfig(
            num_experts=8,
            top_k=3,
            d_expert=96,
            num_shared_experts=1,
            d_shared=96,
            every_k_layers=1,
            norm_topk_prob=True,
        ),
        max_seq_len=128,
        source=CONFIG.source,
    )
