"""Analytical serving-cost estimator: decode-step cost features through a
device roofline.

`features_from_engine` counts what a roofline needs over one decode step
of an engine — FLOPs, bytes accessed, collective wire bytes per device —
by dispatching the step's aten ops on meta tensors (the reference reads
the same features from the compiled HLO, `repro.core.hlo_cost`). This
module turns those features plus a `DeviceProfile` and a traffic mix into
TTFT / TPOT / throughput / memory estimates the configuration search can
rank candidates by.

Model (every approximation is deliberate and documented):

  * decode step time  = max(flops/peak, bytes/hbm_bw, wire/link_bw)
    — the classic three-ceiling roofline over the POOLED profile;
  * TPOT              = decode step time (each step emits one token per
    occupied slot; a request's tokens arrive one step apart);
  * prefill time      = roofline over (flops_per_token x prompt_len,
    one weight-stream of bytes, one step of wire) — weights-dominated
    short-prompt regime; the attention-quadratic term is ignored (small
    against the matmul term at serving prompt lengths);
  * TTFT under load   = queue amplification ``prefill / (1 - rho)`` with
    utilization ``rho = demand_tok_rate / capacity`` — an M/D/1-shaped
    penalty that makes the estimate demand-sensitive, which is what lets
    the planner trade engine count against latency targets;
  * memory            = param bytes + KV-pool bytes, checked against the
    pooled capacity (this is where an 80 GB A100 and a 48 GB L40s give
    genuinely different answers for the same plan).

Rankings produced by this model are validated against measured step
latencies on the calibrated host profile (tests/test_planner.py) —
ranking, not absolute values, so the contract is hardware-robust.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import flop_registry

from repro_torch.models import Model
from repro_torch.planner.catalog import DeviceProfile
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.executable import DecodeExecutable


@dataclasses.dataclass(frozen=True)
class CostFeatures:
    """Per-decode-step cost features of one engine configuration, as
    counted over its decode step (per device; `features_from_engine`).

    Attributes:
        flops: FLOPs per decode step.
        bytes: bytes accessed per decode step (HBM traffic).
        wire_bytes: collective wire bytes per device per step.
        n_slots: the engine's decode batch width.
        s_max: the engine's KV sequence capacity.
        param_bytes: resident parameter bytes.
        kv_bytes: resident KV-pool bytes.
        kv_tokens: the engine's KV token capacity (a paged pool's
            admission budget). 0 means "slot-granular, one full extent
            per slot" (``n_slots * s_max``) — the pre-paging default, so
            existing feature tuples keep their meaning.
    """

    flops: float
    bytes: float
    wire_bytes: float
    n_slots: int
    s_max: int
    param_bytes: int
    kv_bytes: int
    kv_tokens: int = 0

    def concurrency(self, prompt_len: float, new_tokens: float) -> int:
        """Decode slots this engine can actually keep occupied under a
        traffic mix: the decode width, capped by how many mean-sized
        requests the KV token budget admits (token-granular memory-fit —
        a paged engine with a small ``kv_tokens`` budget runs a wide
        batch of short requests but throttles on long ones)."""
        cap = self.kv_tokens if self.kv_tokens > 0 \
            else self.n_slots * self.s_max
        per_req = min(max(prompt_len + new_tokens, 1.0), float(self.s_max))
        return max(min(self.n_slots, int(cap / per_req)), 1)

    @property
    def flops_per_token(self) -> float:
        """FLOPs attributable to one generated token (a decode step
        advances every occupied slot by one token)."""
        return self.flops / max(self.n_slots, 1)

    @property
    def resident_bytes(self) -> int:
        """Memory footprint of the engine (params + KV pool)."""
        return self.param_bytes + self.kv_bytes


@dataclasses.dataclass(frozen=True)
class TrafficMix:
    """The workload shape an estimate is conditioned on.

    Attributes:
        prompt_len: mean prompt length, tokens.
        new_tokens: mean generation length, tokens.
        rate: request arrival rate, requests per second (0.0 == estimate
            the unloaded latencies only).
    """

    prompt_len: float = 64.0
    new_tokens: float = 16.0
    rate: float = 0.0

    @property
    def tok_rate(self) -> float:
        """Demanded decode throughput, tokens/s."""
        return self.rate * self.new_tokens


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """The estimator's output for one (features, profile, mix) triple.

    Attributes:
        step_s: decode step time (the roofline maximum).
        tpot_s: time per output token (== step_s).
        prefill_s: unloaded prefill time for the mix's prompt length.
        ttft_s: prefill under queue amplification at the mix's load
            (``inf`` when demand exceeds capacity).
        throughput_tok_s: peak decode tokens/s at full slot occupancy.
        utilization: demanded / available decode throughput.
        mem_bytes: resident footprint (params + KV pool).
        fits: footprint <= the profile's pooled capacity.
        bottleneck: ``"compute" | "memory" | "network"`` — which roofline
            ceiling binds the decode step.
        breakdown: the three ceiling times, seconds.
    """

    step_s: float
    tpot_s: float
    prefill_s: float
    ttft_s: float
    throughput_tok_s: float
    utilization: float
    mem_bytes: int
    fits: bool
    bottleneck: str
    breakdown: Dict[str, float]

    def meets(self, max_ttft_s: Optional[float],
              max_tpot_s: Optional[float]) -> bool:
        """Does this estimate satisfy a service-level target?  A missing
        (None) target is vacuously met; an infeasible placement
        (``fits=False``) never meets anything."""
        if not self.fits:
            return False
        if max_ttft_s is not None and not self.ttft_s <= max_ttft_s:
            return False
        if max_tpot_s is not None and not self.tpot_s <= max_tpot_s:
            return False
        return True


def roofline_times(flops: float, bytes_: float, wire: float,
                   profile: DeviceProfile) -> Dict[str, float]:
    """The three ceiling times of one kernel invocation on a profile."""
    return {
        "compute_s": flops / profile.total_flops,
        "memory_s": bytes_ / profile.total_hbm_bw,
        "network_s": wire / profile.link_bw if wire else 0.0,
    }


_CEILING_NAME = {"compute_s": "compute", "memory_s": "memory",
                 "network_s": "network"}


def estimate(features: CostFeatures, profile: DeviceProfile,
             mix: TrafficMix = TrafficMix(), *,
             engines: int = 1) -> CostEstimate:
    """Estimate serving behaviour of ``engines`` identical engines with
    ``features`` on ``profile`` under ``mix``.

    Args:
        features: compiled-module cost features (see `features_from_engine`).
        profile: the device (slice) each engine runs on.
        mix: the traffic the estimate is conditioned on; ``mix.rate`` is
            the TOTAL arrival rate shared by all ``engines``.
        engines: how many identical engines split the load.

    Returns:
        The `CostEstimate`; ``ttft_s`` is ``inf`` when the demanded token
        rate meets or exceeds the pool's capacity (an overloaded queue
        has no stationary waiting time).
    """
    if engines < 1:
        raise ValueError(f"engines must be >= 1, got {engines}")
    bd = roofline_times(features.flops, features.bytes,
                        features.wire_bytes, profile)
    step_s = max(bd.values())
    bottleneck = _CEILING_NAME[max(bd, key=bd.get)]

    # prefill: prompt_len tokens of matmul work, one weight stream, one
    # step of collective wire (short-prompt weights-dominated regime)
    pf = roofline_times(features.flops_per_token * mix.prompt_len,
                        features.bytes, features.wire_bytes, profile)
    prefill_s = max(pf.values())

    conc = features.concurrency(mix.prompt_len, mix.new_tokens)
    throughput = conc / step_s * engines
    rho = mix.tok_rate / throughput if throughput > 0 else math.inf
    if rho < 1.0:
        ttft_s = prefill_s / (1.0 - rho)
    else:
        ttft_s = math.inf

    mem = features.resident_bytes
    return CostEstimate(
        step_s=step_s, tpot_s=step_s, prefill_s=prefill_s, ttft_s=ttft_s,
        throughput_tok_s=throughput, utilization=rho, mem_bytes=mem,
        fits=mem <= profile.total_mem_bytes, bottleneck=bottleneck,
        breakdown=bd)


def prefill_interference(est: CostEstimate, mix: TrafficMix, *,
                         engines: int = 1) -> CostEstimate:
    """Inflate a UNIFIED estimate with prefill/decode interference.

    `estimate` prices decode capacity as if prefill were free: on a
    unified engine every arriving prompt actually steals ``prefill_s``
    of decode time, stalling the whole decode batch (continuous batching
    admits at step boundaries). The engine spends a prefill *duty
    fraction* ``d = rate × prefill_s / engines`` of its time not
    decoding, so both served latencies stretch by ``1/(1-d)`` —
    infinitely at ``d >= 1`` (prefill alone saturates the engine).

    Applied by the search ONLY when role-split candidates are in play —
    comparing unified against disaggregated configurations with the
    interference the disaggregation removes priced in on one side only
    would rig the comparison; with no disaggregated candidate the legacy
    numbers are left untouched (bitwise — this function is not called).
    """
    duty = mix.rate * est.prefill_s / max(engines, 1)
    if duty <= 0.0:
        return est
    factor = 1.0 / (1.0 - duty) if duty < 1.0 else math.inf
    return dataclasses.replace(
        est, tpot_s=est.tpot_s * factor, ttft_s=est.ttft_s * factor,
        utilization=max(est.utilization, duty))


def estimate_disagg(prefill_features: CostFeatures,
                    decode_features: CostFeatures,
                    mix: TrafficMix, *,
                    prefill_profile: DeviceProfile,
                    decode_profile: DeviceProfile,
                    prefill_engines: int = 1,
                    decode_engines: int = 1,
                    handoff_s: float = 0.0) -> CostEstimate:
    """Estimate a DISAGGREGATED configuration: ``prefill_engines``
    role=prefill engines own TTFT, ``decode_engines`` role=decode
    engines own TPOT, every request handed off at its first token.

    The split is exactly what the ceilings become independent of each
    other for: the prefill tier is an M/D/c-style queue on whole-prompt
    prefills (``rho_p = rate × prefill_s / n_p``; TTFT =
    ``prefill_s / (1 - rho_p) + handoff_s``, inf at saturation — no
    decode interference, because the tier never decodes past token one),
    and the decode tier prices TPOT exactly as `estimate` does
    (``tpot = step_s``, ``rho_d`` over decode token throughput) with no
    prefill stalls.

    Args:
        prefill_features / decode_features: per-role engine features
            (different specs — e.g. prefill-heavy A100 vs decode L40S —
            are the point).
        mix: total traffic over the whole label (both tiers see it all).
        prefill_profile / decode_profile: the device each tier runs on.
        prefill_engines / decode_engines: tier sizes (>= 1 each — a
            disaggregated config without both tiers is not one).
        handoff_s: per-request first-token handoff pause added to TTFT
            (the measured <50 ms budget; 0 ignores it).

    Returns:
        A `CostEstimate` for the joint config: ``ttft_s``/``prefill_s``
        from the prefill tier, ``tpot_s``/``step_s``/``throughput`` from
        the decode tier, ``utilization`` the max of the two tier loads,
        ``fits`` only when BOTH tiers fit their profiles, ``mem_bytes``
        the larger single-engine footprint, and ``bottleneck``/
        ``breakdown`` from whichever tier is more loaded.
    """
    if prefill_engines < 1 or decode_engines < 1:
        raise ValueError(
            f"a disaggregated config needs >= 1 engine per role, got "
            f"prefill={prefill_engines}, decode={decode_engines}")
    # ---- prefill tier: whole-prompt service, no decode duty ----
    pf = roofline_times(
        prefill_features.flops_per_token * mix.prompt_len,
        prefill_features.bytes, prefill_features.wire_bytes,
        prefill_profile)
    prefill_s = max(pf.values())
    rho_p = mix.rate * prefill_s / prefill_engines
    if rho_p < 1.0:
        ttft_s = prefill_s / (1.0 - rho_p) + handoff_s
    else:
        ttft_s = math.inf
    # ---- decode tier: pure decode, no prefill stalls ----
    bd = roofline_times(decode_features.flops, decode_features.bytes,
                        decode_features.wire_bytes, decode_profile)
    step_s = max(bd.values())
    conc = decode_features.concurrency(mix.prompt_len, mix.new_tokens)
    throughput = conc / step_s * decode_engines
    rho_d = mix.tok_rate / throughput if throughput > 0 else math.inf
    # ---- joint view ----
    loaded_pf = rho_p >= rho_d
    bneck = (_CEILING_NAME[max(pf, key=pf.get)] if loaded_pf
             else _CEILING_NAME[max(bd, key=bd.get)])
    fits = (prefill_features.resident_bytes
            <= prefill_profile.total_mem_bytes
            and decode_features.resident_bytes
            <= decode_profile.total_mem_bytes)
    return CostEstimate(
        step_s=step_s, tpot_s=step_s, prefill_s=prefill_s, ttft_s=ttft_s,
        throughput_tok_s=throughput, utilization=max(rho_p, rho_d),
        mem_bytes=max(prefill_features.resident_bytes,
                      decode_features.resident_bytes),
        fits=fits, bottleneck=bneck, breakdown=dict(pf if loaded_pf
                                                    else bd))


# ---------------------------------------------------------------------------
# online calibration (observed TTFT/TPOT -> EWMA residual correction)
# ---------------------------------------------------------------------------


class ResidualCalibration:
    """Online EWMA residual correction closing the predicted-vs-measured
    loop on the analytical roofline.

    The roofline is a *shape* model: it ranks configurations correctly
    but its absolute TTFT/TPOT numbers carry a systematic residual on
    any real host (interpreter overhead, cache effects, an optimistic
    datasheet profile). This class learns that residual per workload
    label as an EWMA of observed/predicted ratios and multiplies it back
    into later estimates.

    FAIL-CLOSED COLD START: with zero observations for a label the
    correction factor is exactly 1.0 — `apply` returns the analytical
    estimate unchanged, bit for bit. The calibrated path can therefore
    be wired in unconditionally; it only deviates from the roofline once
    real measurements exist.

    Observations are guarded: non-finite or non-positive predicted or
    measured values are ignored (an overloaded queue predicts
    ``ttft=inf``; a ratio against it is meaningless), and each ratio is
    clipped to ``[1/ratio_cap, ratio_cap]`` so one pathological window
    cannot poison the EWMA.

    Args:
        alpha: EWMA smoothing factor in (0, 1]; the first observation
            seeds the EWMA directly.
        ratio_cap: clip bound for a single observed/predicted ratio.
    """

    def __init__(self, alpha: float = 0.25, ratio_cap: float = 50.0):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        if ratio_cap <= 1.0:
            raise ValueError(f"ratio_cap must exceed 1, got {ratio_cap}")
        self.alpha = alpha
        self.ratio_cap = ratio_cap
        self._ttft: Dict[str, float] = {}
        self._tpot: Dict[str, float] = {}
        self._n: Dict[str, int] = {}

    def _fold(self, store: Dict[str, float], label: str,
              predicted: float, measured: float) -> bool:
        if not (math.isfinite(predicted) and predicted > 0.0
                and math.isfinite(measured) and measured > 0.0):
            return False
        ratio = min(max(measured / predicted, 1.0 / self.ratio_cap),
                    self.ratio_cap)
        if label in store:
            store[label] += self.alpha * (ratio - store[label])
        else:
            store[label] = ratio
        return True

    def observe(self, label: str, *, predicted_ttft_s: float,
                predicted_tpot_s: float, measured_ttft_s: float,
                measured_tpot_s: float) -> None:
        """Fold one measurement window into the label's EWMAs. Invalid
        pairs (non-finite / non-positive on either side) are skipped
        per-metric; the observation count rises if either folded."""
        folded = self._fold(self._ttft, label, predicted_ttft_s,
                            measured_ttft_s)
        folded |= self._fold(self._tpot, label, predicted_tpot_s,
                             measured_tpot_s)
        if folded:
            self._n[label] = self._n.get(label, 0) + 1

    def n_observations(self, label: str) -> int:
        """Windows folded for ``label`` (0 == cold: identity factors)."""
        return self._n.get(label, 0)

    def factors(self, label: str) -> Tuple[float, float]:
        """The ``(ttft_factor, tpot_factor)`` multipliers for ``label``;
        exactly ``(1.0, 1.0)`` when nothing was observed."""
        return (self._ttft.get(label, 1.0), self._tpot.get(label, 1.0))

    def apply(self, label: str, est: CostEstimate) -> CostEstimate:
        """The calibrated estimate: latency predictions (``ttft_s``,
        ``tpot_s``) scaled by the learned residual factors. The
        analytical ceilings (``step_s``, ``breakdown``, throughput,
        memory) are left untouched — the correction models what the
        roofline abstracts away, it does not rewrite the roofline.
        With zero observations this returns ``est`` unchanged."""
        f_ttft, f_tpot = self.factors(label)
        if f_ttft == 1.0 and f_tpot == 1.0:
            return est
        return dataclasses.replace(
            est, ttft_s=est.ttft_s * f_ttft, tpot_s=est.tpot_s * f_tpot)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        """Telemetry snapshot: per-label factors + observation counts."""
        labels = sorted(set(self._ttft) | set(self._tpot) | set(self._n))
        return {label: {"ttft_factor": self._ttft.get(label, 1.0),
                        "tpot_factor": self._tpot.get(label, 1.0),
                        "observations": self._n.get(label, 0)}
                for label in labels}


def calibrated_estimate(features: CostFeatures, profile: DeviceProfile,
                        mix: TrafficMix = TrafficMix(), *,
                        engines: int = 1,
                        calibration: Optional[ResidualCalibration] = None,
                        label: str = "*") -> CostEstimate:
    """`estimate` with an optional residual correction applied. With no
    ``calibration`` (or a cold one) this is EXACTLY the analytical
    estimate — the fail-closed contract tests pin."""
    est = estimate(features, profile, mix, engines=engines)
    if calibration is None:
        return est
    return calibration.apply(label, est)


# ---------------------------------------------------------------------------
# feature extraction (one counted decode step -> CostFeatures)
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# matrix products: 2 x prod(result) x K, K the contracted extent of the
# first operand's last axis (the reference's `dot` convention)
_MATMULS = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
            _aten.baddbmm.default}
# ops that cost no FLOPs, as in the reference's `_FREE_OPS`: copies and
# casts (copy / convert), static slices and concatenation, iota and
# constants, select, comparisons and reductions. Gathers and scatters by an
# index tensor are not free there either: they count their result's
# elements, as every other op does.
_FREE = {
    _aten.clone.default, _aten.copy_.default, _aten._to_copy.default,
    _aten.cat.default, _aten.stack.default, _aten.slice_scatter.default,
    _aten.select_scatter.default, _aten.arange.default,
    _aten.arange.start, _aten.arange.start_step, _aten.scalar_tensor.default,
    _aten.zeros.default, _aten.empty.memory_format, _aten.full.default,
    _aten.fill_.Scalar, _aten.zero_.default, _aten.where.self,
    _aten.eq.Tensor, _aten.eq.Scalar, _aten.ne.Tensor, _aten.ne.Scalar,
    _aten.lt.Tensor, _aten.lt.Scalar, _aten.le.Tensor, _aten.le.Scalar,
    _aten.gt.Tensor, _aten.gt.Scalar, _aten.ge.Tensor, _aten.ge.Scalar,
    _aten.logical_and.default, _aten.logical_or.default,
    _aten.logical_not.default, _aten.sum.dim_IntList, _aten.mean.dim,
    _aten.amax.default, _aten.max.dim, _aten.argmax.default,
}
# not flagged as views by their schema, but views all the same
_VIEWS = {_aten._unsafe_view.default}


class _StepCount(TorchDispatchMode):
    """Counts FLOPs and bytes of every aten op dispatched under it (see
    `features_from_engine` for the conventions); a kernel's custom op
    (`kernels.ops`) counts its FLOP formula."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func in _VIEWS:
            return out
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if func in _MATMULS:
            self.flops += 2.0 * outs[0].numel() * args[-2].shape[-1]
        elif func.namespace == "repro_torch":      # a kernel: its FLOP formula
            self.flops += flop_registry[func._overloadpacket](*args, out_val=out, **kwargs)
        elif func not in _FREE and outs:
            self.flops += outs[0].numel()
        return out


def _meta_engine(engine):
    """An engine of ``engine``'s shapes on the meta device: its model's
    parameters and its pool as meta tensors (shapes and dtypes, no memory,
    nothing of the live pool), the same pool layout and page tables."""
    meta = lambda t: torch.empty_like(t, device="meta")  # noqa: E731
    model = Model(engine.model.cfg, tree_map(meta, engine.model.params),
                  device="meta")
    kw = {"paged": engine.paged}
    if engine.paged:
        kw["page_size"] = engine.page_size
    probe = ServingEngine(model, n_slots=engine.n_slots, s_max=engine.s_max,
                          device="meta", **kw)
    probe.cache = {k: meta(v) for k, v in engine.cache.items()}
    return probe


def features_from_engine(engine, mesh=None) -> CostFeatures:
    """Count `CostFeatures` over one decode step of ``engine`` (a live or
    probe `ServingEngine`, on any device).

    The step is the engine's `DecodeExecutable` step (the paged gather, the
    model's ``decode_step``, the KV scatter, the greedy pick), run on an
    engine of the same shapes on the meta device, so the live pool is never
    written and the counts depend only on shapes: the card and the CPU give
    the same numbers. Conventions, those of the reference's compiled-HLO
    count (`repro.core.hlo_cost`):

      * a matrix product is ``2 x prod(result) x K``;
      * every other op costs its result's element count, except the free
        ones: views, copies, casts, static slices, concatenation,
        comparisons, select and reductions;
      * bytes are operand bytes plus result bytes of every op that is not
        a view. The reference counts bytes at XLA's fusion boundaries; the
        eager step has no fusion, so its bytes are its own (PERF.md gives
        the ratio);
      * ``wire_bytes`` comes from the step's recorded collectives
        (`ServingEngine.decode_collectives`): none on one device;
      * ``param_bytes`` and ``kv_bytes`` are ``numel x element_size`` over
        the model's parameters and the engine's pool.

    Args:
        engine: the `repro_torch.serving.ServingEngine` to count.
        mesh: the cluster's `Mesh` (the reference's signature); the port
            places an engine on one device, so a mesh of more than one
            device is refused.

    Raises:
        ValueError: ``mesh`` holds more than one device.
        NotImplementedError: the step issues collectives (an engine
            sharded across devices is not ported yet).
    """
    if mesh is not None and mesh.devices.size > 1:
        raise ValueError(f"features of an engine over {mesh.devices.size} "
                         "devices: the port places an engine on one device")
    if engine.decode_collectives():
        raise NotImplementedError("the decode step issues collectives; wire "
                                  "bytes of a sharded engine are not counted yet")
    count = _StepCount()
    exe = DecodeExecutable(_meta_engine(engine))
    with count:
        exe.forward()

    def tree_bytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree))

    return CostFeatures(
        flops=count.flops, bytes=count.bytes, wire_bytes=0.0,
        n_slots=engine.n_slots, s_max=engine.s_max,
        param_bytes=tree_bytes(engine.model.params),
        kv_bytes=tree_bytes(engine.cache),
        kv_tokens=engine.kv_token_capacity)
