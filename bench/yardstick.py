"""The yardstick's arithmetic, frozen here: the published H100 peaks, the
operations and bytes of a model token, of a prefill and of the two prefill
kernels' calls, and the card's power limit.

Counts follow the published model (the config file's ``model`` section),
not the program's code: every routed expert a token picks counts (no
capacity drop), the real vocabulary (not the padded one), causal
attention over the pairs the mask keeps. A multiply-add is 2 operations.
Copied from ``chip_smoke.py`` (``bound``, ``train_flops``, the flash and
MoE top-k timing lines) and the kernels' ``flops`` formulas
(``repro_torch/kernels/flash_attention.py``, ``moe_dispatch.py``).
"""
from __future__ import annotations

import subprocess
from typing import Any, Dict, Tuple

#: NVIDIA H100 SXM data sheet: dense rates without sparsity, at 700 W
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12
DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def bound_s(ops: float, nbytes: float, dtype: str) -> Tuple[float, str]:
    """(least seconds on the card, "operations" | "bytes")."""
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _ffn_weights(m: Dict[str, Any]) -> int:
    """Matmul weights one token multiplies through in one layer's FFN."""
    d = m["d_model"]
    n_mat = 3 if m["mlp_act"] == "silu" else 2
    moe = m.get("moe")
    if moe:
        w = d * moe["num_experts"] + moe["top_k"] * n_mat * d * moe["d_expert"]
        if moe.get("num_shared_experts"):
            w += n_mat * d * moe["d_shared"]
        return w
    return n_mat * d * m["d_ff"]


def token_weights(m: Dict[str, Any]) -> int:
    """Matmul weights a token multiplies through in every layer (the LM
    head apart)."""
    d, hd = m["d_model"], m["head_dim"]
    attn = d * hd * (m["num_heads"] + 2 * m["num_kv_heads"]) + m["num_heads"] * hd * d
    return m["num_layers"] * (attn + _ffn_weights(m))


def attention_ops(m: Dict[str, Any], keys: int) -> int:
    """Q K^T and P V of one query over ``keys`` keys, every layer."""
    return m["num_layers"] * 4 * m["num_heads"] * m["head_dim"] * keys


def head_ops(m: Dict[str, Any]) -> int:
    return 2 * m["d_model"] * m["vocab_size"]


def prefill_ops(m: Dict[str, Any], S: int) -> int:
    """A prefill of ``S`` prompt tokens: every token through the layers,
    causal attention over ``S (S + 1) / 2`` pairs, logits at the last
    position."""
    return (2 * S * token_weights(m) + attention_ops(m, S * (S + 1) // 2)
            + head_ops(m))


def decode_ops(m: Dict[str, Any], keys: int) -> int:
    """One decoded token attending over ``keys`` positions (itself
    included), with its logits."""
    return 2 * token_weights(m) + attention_ops(m, keys) + head_ops(m)


def flash_call(m: Dict[str, Any], L: int) -> Tuple[int, int]:
    """(operations, bytes) of one causal flash call at the launched length
    ``L`` (batch 1): the two products over the kept pairs; q, k, v read
    and the output written once, in the activation dtype."""
    hq, hkv, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    ops = 4 * hq * hd * (L * (L + 1) // 2)
    nbytes = DTYPE_BYTES[m["activ_dtype"]] * L * hd * (2 * hq + 2 * hkv)
    return ops, nbytes


def moe_topk_call(m: Dict[str, Any], T: int) -> Tuple[int, int]:
    """(operations, bytes) of one MoE gate top-k over ``T`` tokens: the
    softmax at 5 a logit and a compare a logit for each pick; the fp32
    logits read, the fp32 weights and int32 ids written."""
    E, k = m["moe"]["num_experts"], m["moe"]["top_k"]
    return T * E * (5 + k), 4 * T * E + 8 * T * k


def card_power() -> Dict[str, str]:
    """``nvidia-smi``'s name and power limit of the first card, or
    "not read" where the tool does not answer."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20).stdout.strip().splitlines()
        name, limit = (s.strip() for s in out[0].split(","))
        return {"name": name, "power_limit": limit}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "not read", "power_limit": "not read"}
