"""Architecture config dataclasses.

Every assigned architecture is described by a single `ModelConfig`. The
model zoo (`repro_torch.models`) consumes only these fields, so new architectures
are added by writing a config file, not new model code.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek/MiniCPM3 style)."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 60
    top_k: int = 4
    d_expert: int = 1408            # per-expert FFN hidden dim
    num_shared_experts: int = 0     # shared experts (always active)
    d_shared: int = 0               # shared expert FFN hidden dim (total)
    every_k_layers: int = 1         # MoE replaces MLP on layers where
    #                                 (layer_idx % every_k_layers == offset)
    offset: int = 0
    norm_topk_prob: bool = False
    capacity_factor: float = 1.25   # dense-dispatch capacity factor
    router_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block config."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk_size: int = 256
    n_groups: int = 1               # B/C groups (GVA-style)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Encoder config for enc-dec models (Whisper)."""

    num_encoder_layers: int = 32
    encoder_seq_len: int = 1500     # nominal frame count (stubbed frontend)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # --- attention variant ---
    attn_type: str = "gqa"          # gqa | mla | none
    mla: Optional[MLAConfig] = None
    qk_norm: bool = False

    # --- positional encoding ---
    pos_type: str = "rope"          # rope | mrope | learned | sinusoidal
    rope_theta: float = 10_000.0
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)

    # --- MLP ---
    mlp_act: str = "silu"           # silu (gated) | relu2 | gelu
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    norm_eps: float = 1e-5

    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None

    # --- state-space ---
    ssm: Optional[SSMConfig] = None
    # hybrid layout: period + indices of attention layers within a period
    # (Jamba: period 8, attention at offset 4, the rest Mamba).
    hybrid_period: int = 0
    hybrid_attn_offsets: Tuple[int, ...] = ()

    # --- encoder-decoder ---
    encdec: Optional[EncDecConfig] = None

    # --- embeddings ---
    tie_embeddings: bool = False

    # --- numerics ---
    param_dtype: str = "bfloat16"
    activ_dtype: str = "bfloat16"

    # --- bookkeeping ---
    max_seq_len: int = 524_288
    source: str = ""                # provenance note ([arXiv/hf; tier])

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def param_count(self) -> int:
        """Approximate total parameter count (embedding + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_q, n_kv = self.num_heads, self.num_kv_heads
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            if self.attn_type == "mla":
                m = self.mla or MLAConfig()
                qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
                p = d * m.q_lora_rank + m.q_lora_rank * n_q * qk_head
                p += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                p += m.kv_lora_rank * n_q * (m.qk_nope_head_dim + m.v_head_dim)
                p += n_q * m.v_head_dim * d
                return p
            return d * hd * (n_q + 2 * n_kv) + n_q * hd * d

        def mlp_params(ff: int) -> int:
            n_mat = 3 if self.mlp_act == "silu" else 2
            return n_mat * d * ff

        def moe_params() -> int:
            assert self.moe is not None
            m = self.moe
            p = m.num_experts * mlp_params(m.d_expert) + d * m.num_experts
            if m.num_shared_experts:
                p += mlp_params(m.d_shared)
            return p

        def ssm_params() -> int:
            s = self.ssm or SSMConfig()
            d_in = s.expand * d
            nheads = d_in // s.head_dim
            conv_dim = d_in + 2 * s.n_groups * s.d_state
            p = d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)  # in_proj
            p += conv_dim * s.d_conv                                  # conv
            p += 2 * nheads + d_in                                    # A, D, norm
            p += d_in * d                                             # out_proj
            return p

        for layer in range(self.num_layers):
            is_attn = True
            if self.family == "ssm":
                is_attn = False
            elif self.hybrid_period:
                is_attn = (layer % self.hybrid_period) in self.hybrid_attn_offsets
            if is_attn:
                total += attn_params()
            else:
                total += ssm_params()
            if self.family == "ssm":
                continue  # mamba2 has no MLP
            if self.moe is not None and (layer % self.moe.every_k_layers == self.moe.offset):
                total += moe_params()
            else:
                total += mlp_params(self.d_ff)
        if self.encdec is not None:
            e = self.encdec
            per_enc = attn_params() + mlp_params(self.d_ff)
            total += e.num_encoder_layers * per_enc
            total += self.num_layers * attn_params()  # decoder cross-attn
        return total

    def active_param_count(self) -> int:
        """Parameters active per token (for MoE archs)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        dense_expert = self.param_count()
        # subtract inactive routed experts
        n_mat = 3 if self.mlp_act == "silu" else 2
        per_expert = n_mat * self.d_model * m.d_expert
        n_moe_layers = sum(
            1 for l in range(self.num_layers)
            if (l % m.every_k_layers == m.offset)
            and not (self.hybrid_period and (l % self.hybrid_period) in self.hybrid_attn_offsets and self.family == "ssm")
        )
        return dense_expert - n_moe_layers * (m.num_experts - m.top_k) * per_expert


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell."""

    name: str          # train_4k | prefill_32k | decode_32k | long_500k
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPE_CELLS = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)


def get_shape_cell(name: str) -> ShapeCell:
    for c in SHAPE_CELLS:
        if c.name == name:
            return c
    raise KeyError(f"unknown shape cell {name!r}")
