"""jamba-v0.1-52b [hybrid]: Mamba+attention 1:7 interleave + MoE 16e top-2.

32L, d_model=4096, attention layers 32 heads (GQA kv=8), d_ff=14336,
vocab=65536. Period-8 layout with attention at in-period offset 4; MoE
replaces the MLP on every second layer (16 experts, top-2).
[arXiv:2403.19887; hf]

Adaptation note (the reference's): Jamba v0.1 uses Mamba-1 internally; the
Mamba-2 SSD block stands in for it, so the hybrid shares the SSD-scan kernel
(`kernels.ops.ssd_scan`). State width follows Jamba (d_state=16).
"""
from repro_torch.configs.base import MoEConfig, ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    attn_type="gqa",
    pos_type="rope",
    mlp_act="silu",
    norm_type="rmsnorm",
    moe=MoEConfig(
        num_experts=16,
        top_k=2,
        d_expert=14_336,
        num_shared_experts=0,
        d_shared=0,
        every_k_layers=2,
        offset=1,
        norm_topk_prob=True,
    ),
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, d_conv=4, chunk_size=256),
    hybrid_period=8,
    hybrid_attn_offsets=(4,),
    source="[arXiv:2403.19887; hf]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="jamba-v0.1-52b-smoke",
        family="hybrid",
        num_layers=8,          # one full period
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        attn_type="gqa",
        pos_type="rope",
        mlp_act="silu",
        norm_type="rmsnorm",
        moe=MoEConfig(
            num_experts=4,
            top_k=2,
            d_expert=128,
            every_k_layers=2,
            offset=1,
            norm_topk_prob=True,
        ),
        ssm=SSMConfig(d_state=16, head_dim=16, expand=2, d_conv=4, chunk_size=32),
        hybrid_period=8,
        hybrid_attn_offsets=(4,),
        max_seq_len=128,
        source=CONFIG.source,
    )
