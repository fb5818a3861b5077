"""whisper-large-v3 [audio]: enc-dec, conv frontend stubbed.

32L decoder (+32L encoder), d_model=1280, 20 heads (MHA kv=20), d_ff=5120,
vocab=51866. [arXiv:2212.04356; unverified]

The audio frontend (log-mel + conv downsampling) is a STUB: ``input_specs``
provides precomputed (batch, frames, d_model) frame embeddings.
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    num_layers=32,
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    attn_type="gqa",
    pos_type="learned",
    mlp_act="gelu",
    norm_type="layernorm",
    encdec=EncDecConfig(num_encoder_layers=32, encoder_seq_len=1500),
    tie_embeddings=True,
    max_seq_len=32_768,
    source="[arXiv:2212.04356; unverified]",
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3-smoke",
        family="encdec",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        attn_type="gqa",
        pos_type="learned",
        mlp_act="gelu",
        norm_type="layernorm",
        encdec=EncDecConfig(num_encoder_layers=2, encoder_seq_len=32),
        tie_embeddings=True,
        max_seq_len=128,
        source=CONFIG.source,
    )
