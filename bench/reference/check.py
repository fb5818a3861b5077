"""The comparison that decides ``correct`` for a served model.

Once the window has closed, a sample of the requests the program finished,
drawn from the seed, the request with the most served tokens always among
them, goes through the plain reference (`bench.reference.lm`) once, each
over its prompt and its served tokens. At every served token's position
the reference's best logit less its logit of the served token is that
token's gap; the widest gap over the sample is the number compared with
the configuration's limit is the mean gap over the sample's served
tokens. Greedy decoding serves the best token, so a sound bf16 run's gaps
are rounding at near-ties: most are 0, a few hundredths. The widest gap is
logged beside it but not compared: it is one token's, bounded by the
logits' spread, and the control's widest gap reads only 2.6x the
program's over a dozen seeds (PERF.md, PR 32), where the mean separates.

The control reads, at the same positions, the gap of the token that the
reference in float8 puts first.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from bench.reference import lm as ref_lm


def sample(done: Sequence[Any], seed: int, target_tokens: int, max_requests: int,
           strata: Optional[Sequence[str]] = None) -> List[int]:
    """Indices into ``done`` (records with ``served`` token lists): the one
    with the most served tokens, then, from the seed, one of each other
    stratum (``strata[i]`` names request ``i``'s), then more at random
    until ``target_tokens`` served tokens or ``max_requests``."""
    if not done:
        return []
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    order = list(rng.permutation(len(done)))
    longest = max(range(len(done)), key=lambda i: (len(done[i].served), -i))
    picked = [longest]
    if strata is not None:
        for s in sorted(set(strata)):
            if s != strata[longest]:
                picked.append(next(i for i in order if strata[i] == s))
    for i in order:
        if len(picked) >= max_requests or sum(len(done[j].served) for j in picked) >= target_tokens:
            break
        if i not in picked:
            picked.append(i)
    return picked


def gaps(model: Dict[str, Any], params: Dict[str, Any], prompts: Sequence[np.ndarray],
         served: Sequence[Sequence[int]], launched: Sequence[int], device,
         control: bool = False) -> Dict[str, Any]:
    """The widest gap of the served tokens against the fp32 reference, and
    with ``control`` the widest gap of the fp8 reference's first picks."""
    seqs, pos, n_prompt = [], [], []
    for p, s in zip(prompts, served):
        toks = np.concatenate([np.asarray(p, np.int64), np.asarray(s[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        pos.append(torch.arange(len(p) - 1, len(p) - 1 + len(s), device=device))
        n_prompt.append(len(p))
    picks8: List[torch.Tensor] = []
    if control:
        ref_lm.logits_at(model, params, seqs, pos, n_prompt, launched, precision="fp8",
                         on_logits=lambda j, lg: picks8.append(lg.argmax(-1)))
    per_req, per_req8 = [], []
    acc = {"sum": 0.0, "sum8": 0.0, "off": 0, "off8": 0}

    def judge(j, lg):
        best = lg.max(-1).values
        tok = torch.as_tensor(np.asarray(served[j], np.int64), device=lg.device)
        g = best - lg.gather(1, tok[:, None])[:, 0]
        per_req.append(float(g.max()) if torch.isfinite(g).all() else float("inf"))
        acc["sum"] += float(g.sum())
        acc["off"] += int((g > 0).sum())
        if control:
            g8 = best - lg.gather(1, picks8[j][:, None])[:, 0]
            per_req8.append(float(g8.max()))
            acc["sum8"] += float(g8.sum())
            acc["off8"] += int((g8 > 0).sum())

    ref_lm.logits_at(model, params, seqs, pos, n_prompt, launched, on_logits=judge)
    n = int(sum(len(s) for s in served))
    out = {"mean_gap": acc["sum"] / n if n else float("nan"),
           "gap": max(per_req) if per_req else float("nan"), "per_request": per_req,
           "requests": len(served), "tokens": n, "disagree": acc["off"]}
    if control:
        out.update(control_mean_gap=acc["sum8"] / n, control_gap=max(per_req8),
                   control_per_request=per_req8, control_disagree=acc["off8"])
    return out
