"""qwen2-moe-a2.7b [moe]: 60 routed experts top-4 + 4 shared experts.

24L, d_model=2048, 16 heads (MHA kv=16), expert d_ff=1408, vocab=151936,
shared-expert hidden 5632 (= 4x1408). [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.configs.base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    attn_type="gqa",
    pos_type="rope",
    rope_theta=1_000_000.0,
    mlp_act="silu",
    norm_type="rmsnorm",
    moe=MoEConfig(
        num_experts=60,
        top_k=4,
        d_expert=1408,
        num_shared_experts=4,
        d_shared=5632,
        every_k_layers=1,
        norm_topk_prob=False,
    ),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-moe-a2.7b-smoke",
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
            top_k=2,
            d_expert=96,
            num_shared_experts=2,
            d_shared=192,
            every_k_layers=1,
            norm_topk_prob=False,
        ),
        max_seq_len=128,
        source=CONFIG.source,
    )
