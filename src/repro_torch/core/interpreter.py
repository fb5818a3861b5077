"""The knowledge plane: intent interpretation behind an LLM-shaped interface.

The paper drives this with GPT-4o over the OpenAI API; the default
backend here is a deterministic semantic parser (no network) with the SAME
modular role structure the paper prompts for (§4.1):

  1. IntentClassifier  — computing / networking / hybrid
  2. StateChecker      — which infrastructure state to retrieve
  3. ServiceScheduler  — placement clauses -> structured directives
  4. PathPlanner       — routing clauses -> ⟨src, dst, must_go/avoid⟩ triples

Every role emits schema-validated JSON-able dicts ("do not include fields
outside the specified schema"); anything else is rejected fail-closed by
the orchestrator's safety layer, exactly like the paper treats LLM output
as a *suggested* plan.

`FaultyInterpreter` reproduces the paper's four observed failure modes
(§6.3) at a configurable rate so the validator's fail-closed behaviour and
the paper's accuracy comparisons (Fig. 7) can be exercised offline.
Plug a real LLM in by implementing `InterpreterBackend.complete`.

Token accounting mirrors the paper's metric: prompt tokens ≈ len(prompt)/4
(intent + condensed state snapshot) and completion tokens ≈ len(json)/4.
"""
from __future__ import annotations

import dataclasses
import json
import re
import time
from typing import Any, Dict, List, Optional, Protocol, Sequence, Tuple

from repro_torch.core.intents import (
    Component,
    DEFAULT_WORKLOAD,
    Flow,
    Intent,
    PlacementConstraint,
    RoutingConstraint,
    ScalingConstraint,
    ServiceLevelConstraint,
)
from repro_torch.core.labels import Fabric, REGIONS

# ---------------------------------------------------------------------------
# ontology (the paper's "ontological linking")
# ---------------------------------------------------------------------------

ONTOLOGY_DATA = {
    "phi": ("phi", "personal health", "health data", "patient data",
            "patient record", "sensitive data", "most sensitive",
            "medical record", "protected health"),
    "general": ("general", "non-sensitive", "public data"),
}

ONTOLOGY_APP = {
    "appointment": ("appointment",),
    "doctor": ("doctor",),
    "patient": ("patient service", "patient record", "patient microservice",
                "patient workload", "the patient"),
    "phi-db": ("phi database", "phi-db", "sensitive database",
               "medical database", "phi db"),
    "general-db": ("general database", "general-db", "general db"),
    "vital-sign-monitor": ("vital sign", "vital-sign", "monitor service"),
    "image-preprocessor": ("image preprocessor", "image-preprocessor"),
}

ONTOLOGY_SECURITY = {
    "high": ("high-security", "high security", "secure infrastructure",
             "trusted infrastructure", "high-trust", "high trust"),
    "low": ("low-security", "low security"),
}

ONTOLOGY_ZONE = {
    "cloud": ("cloud zone", "the cloud", "cloud nodes", "cloud node"),
    "edge": ("edge zone", "the edge", "edge nodes", "edge node"),
}

PROVIDERS = ("aws", "azure", "alibaba-cloud", "gcp")
VENDORS = ("huawei", "cisco", "juniper", "arista")

# capacity nouns + number words for scaling clauses ("keep at least two
# serving engines for phi traffic")
SCALING_NOUNS = ("engine", "engines", "replica", "replicas",
                 "instance", "instances")

# service-level metric phrases ("keep TTFT under 200 ms for phi traffic",
# "per-token latency below 20 milliseconds")
SLO_METRICS = {
    "ttft": ("ttft", "time to first token", "time-to-first-token",
             "first token", "first-token"),
    "tpot": ("tpot", "time per output token", "per-token latency",
             "per token latency", "token latency", "decode latency"),
}
# "<metric> under 200 ms" / "below 0.2 seconds" / "within 150ms"
_SLO_NUM = r"(\d+(?:\.\d+)?)\s*(ms|milliseconds?|s|sec|seconds?)\b"
_SLO_RE = re.compile(
    r"(?:under|below|within|less than|at most|<=?)\s+" + _SLO_NUM)
WORD_NUMS = {"one": 1, "two": 2, "three": 3, "four": 4, "five": 5,
             "six": 6, "seven": 7, "eight": 8, "nine": 9, "ten": 10}
# trailing \b keeps teen words from misparsing to their prefix
# ("fourteen" must not match as "four")
_NUM = r"(\d+|" + "|".join(WORD_NUMS) + r")\b"


def _to_int(tok: str) -> int:
    return WORD_NUMS[tok] if tok in WORD_NUMS else int(tok)


@dataclasses.dataclass
class InterpretResult:
    intent: Intent                     # structured output (compiled IR)
    classified_domain: str
    state_requests: Tuple[str, ...]    # what the StateChecker asked for
    directives: Dict[str, Any]         # raw JSON-able directives (auditable)
    prompt_tokens: int
    completion_tokens: int
    latency_s: float


class InterpreterBackend(Protocol):
    name: str

    def interpret(self, text: str, fabric: Fabric,
                  components: Sequence[Component]) -> InterpretResult: ...


# ---------------------------------------------------------------------------
# deterministic semantic parser backend
# ---------------------------------------------------------------------------


def _find_any(text: str, ontology: Dict[str, Tuple[str, ...]]) -> List[str]:
    found = []
    low = text.lower()
    for canon, phrases in ontology.items():
        if any(p in low for p in phrases) or canon in low:
            found.append(canon)
    return found


def _negated(text: str, phrase_pos: int) -> bool:
    window = text[max(0, phrase_pos - 60):phrase_pos].lower()
    return any(w in window for w in
               ("not ", "never", "avoid", "prohibit", "forbid", "prevent",
                "keep off", "exclude", "must not", "shouldn't", "outside",
                "ban ", "block "))


class DeterministicInterpreter:
    """Grammar + ontology parser implementing the four LLM roles."""

    name = "det-parser-v1"

    # ---- role 1: intent classifier ----
    def classify(self, text: str) -> str:
        low = text.lower()
        net_kw = any(w in low for w in
                     ("traffic", "route", "path", "switch", "flow", "link",
                      "traverse", "hop", "network", "packets"))
        comp_kw = any(w in low for w in
                      ("deploy", "schedule", "place", "run ", "host",
                       "node", "zone", "pod", "service", "database",
                       "workload", "reside", "stay", "remain", "stored"))
        if net_kw and comp_kw:
            return "hybrid"
        if net_kw:
            return "networking"
        return "computing"

    # ---- role 2: state checker ----
    def state_requests(self, domain: str) -> Tuple[str, ...]:
        reqs = []
        if domain in ("computing", "hybrid"):
            reqs += ["k8s/node_labels", "k8s/pod_placement"]
        if domain in ("networking", "hybrid"):
            reqs += ["onos/topology", "onos/hosts", "onos/flows"]
        return tuple(reqs)

    # ---- role 3+4: schedulers ----
    def interpret(self, text: str, fabric: Fabric,
                  components: Sequence[Component]) -> InterpretResult:
        t0 = time.time()
        domain = self.classify(text)
        state = self.state_requests(domain)
        low = text.lower()

        placement: List[PlacementConstraint] = []
        routing: List[RoutingConstraint] = []
        scaling: List[ScalingConstraint] = []
        service: List[ServiceLevelConstraint] = []

        # --- clause splitting (the paper's countermeasure to first-clause
        # capture: decompose multi-clause sentences) ---
        clauses = re.split(r"(?:, and |; | and also |, then |\. )", low)
        if len(clauses) == 1:
            clauses = [low]

        for clause in clauses:
            # a clause can carry capacity AND placement/routing predicates
            # ("at least two patient instances in the cloud zone") — parse
            # all four grammars; each only emits when its own predicates
            # are present, so a pure capacity clause adds nothing else
            scaling += self._scaling_clauses(clause)
            service += self._service_clauses(clause)
            placement += self._placement_clauses(clause)
            routing += self._routing_clauses(clause)

        # fold whole-sentence context for clauses the splitter separated from
        # their subjects
        if not placement and not routing and not scaling and not service:
            placement += self._placement_clauses(low)
            routing += self._routing_clauses(low)
            scaling += self._scaling_clauses(low)
            service += self._service_clauses(low)

        routing = self._merge_orphan_routing(routing, low)

        directives = {
            "domain": domain,
            "placement": [dataclasses.asdict(p) for p in placement],
            "routing": [dataclasses.asdict(r) for r in routing],
            "scaling": [dataclasses.asdict(s) for s in scaling],
            "service": [dataclasses.asdict(s) for s in service],
        }
        snapshot = json.dumps(sorted(fabric.label_inventory().items(),
                                     key=str), default=str)
        prompt_tokens = (len(text) + len(snapshot) + 800) // 4  # + role prompts
        completion_tokens = max(len(json.dumps(directives)) // 4, 16)

        intent = Intent(
            text=text, domain=domain,
            complexity="complex" if (len(placement) + len(routing)
                                     + len(scaling) + len(service) > 1
                                     or domain == "hybrid") else "simple",
            placement=tuple(placement), routing=tuple(routing),
            scaling=tuple(scaling), service=tuple(service))
        return InterpretResult(
            intent=intent, classified_domain=domain, state_requests=state,
            directives=directives, prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens, latency_s=time.time() - t0)

    # ---- placement clause grammar ----
    def _placement_clauses(self, clause: str) -> List[PlacementConstraint]:
        out: List[PlacementConstraint] = []
        subjects = _find_any(clause, ONTOLOGY_APP)
        data_types = _find_any(clause, ONTOLOGY_DATA)
        selector: Dict[str, str] = {}
        if subjects:
            selector["app"] = subjects[0]
        elif data_types:
            selector["data-type"] = data_types[0]
        elif any(w in clause for w in ("financial", "billing")):
            # paper Table 6: unenforceable selector — parser passes it through
            # and the validator fails closed
            selector["app"] = "financial-db"
        else:
            return out

        require: Dict[str, str] = {}
        forbid: Dict[str, str] = {}

        # regions / locations
        for region in REGIONS:
            pats = {"eu": ("european union", "the eu", " eu ", "eu-only", "europe"),
                    "us": ("united states", "the us", " us ", "u.s."),
                    "apac": ("apac", "asia-pacific", "australia"),
                    "cn": ("china",)}[region] if region in ("eu", "us", "apac", "cn") else (region,)
            for p in pats:
                pos = clause.find(p)
                if pos >= 0:
                    (forbid if _negated(clause, pos) else require)["region"] = region
        for locs in REGIONS.values():
            for loc in locs:
                pos = clause.find(loc)
                if pos >= 0:
                    (forbid if _negated(clause, pos) else require)["location"] = loc

        # zones
        for zone in ("cloud", "edge"):
            for p in ONTOLOGY_ZONE[zone]:
                pos = clause.find(p)
                if pos >= 0:
                    (forbid if _negated(clause, pos) else require)["zone"] = zone

        # security tiers
        for tier, phrases in ONTOLOGY_SECURITY.items():
            for p in phrases:
                pos = clause.find(p)
                if pos >= 0:
                    if tier == "low" and not _negated(clause, pos):
                        # "never on low-security" idioms arrive as forbids
                        forbid["security"] = "low"
                    else:
                        (forbid if _negated(clause, pos) else require)["security"] = tier

        # providers
        for prov in PROVIDERS:
            pos = clause.find(prov.split("-")[0])
            if pos >= 0:
                (forbid if _negated(clause, pos) else require)["provider"] = prov

        if require or forbid or selector.get("app") == "financial-db":
            out.append(PlacementConstraint(
                selector=tuple(sorted(selector.items())),
                require=tuple(sorted(require.items())),
                forbid=tuple(sorted(forbid.items()))))
        return out

    # ---- scaling clause grammar (runtime capacity: autoscaler bounds) ----
    def _scaling_clauses(self, clause: str) -> List[ScalingConstraint]:
        if not any(n in clause for n in SCALING_NOUNS):
            return []
        lo: Optional[int] = None
        hi: Optional[int] = None
        m = re.search(r"between\s+%s\s+and\s+%s" % (_NUM, _NUM), clause)
        if m:
            lo, hi = _to_int(m.group(1)), _to_int(m.group(2))
        m = re.search(r"at\s+least\s+%s" % _NUM, clause)
        if m:
            lo = _to_int(m.group(1))
        m = re.search(r"(?:at\s+most|no\s+more\s+than|up\s+to)\s+%s" % _NUM,
                      clause)
        if m:
            hi = _to_int(m.group(1))
        m = re.search(r"exactly\s+%s" % _NUM, clause)
        if m:
            lo = hi = _to_int(m.group(1))
        if lo is None and hi is None:
            return []

        subjects = _find_any(clause, ONTOLOGY_APP)
        data_types = _find_any(clause, ONTOLOGY_DATA)
        selector: Dict[str, str] = {}
        if subjects:
            selector["app"] = subjects[0]
        elif data_types:
            selector["data-type"] = data_types[0]
        else:
            return []      # capacity clause with no workload subject
        return [ScalingConstraint(selector=tuple(sorted(selector.items())),
                                  min_engines=lo or 0, max_engines=hi)]

    # ---- service-level clause grammar (latency targets: planner SLOs) ----
    def _service_clauses(self, clause: str) -> List[ServiceLevelConstraint]:
        """Parse latency-target clauses ("keep TTFT under 200 ms for phi
        traffic") into `ServiceLevelConstraint`s. A clause only emits
        when BOTH a recognized metric phrase and a bounded number with a
        time unit are present; the workload subject resolves through the
        same app/data-type ontology the other grammars use.

        Each metric binds to the first bound stated AFTER its own phrase
        ("TTFT under 200 ms and TPOT under 20 ms" must not relax TPOT to
        200 ms), and TTFT phrase spans are masked before TPOT matching
        ("first token latency" is a TTFT phrasing, not a per-token
        target)."""
        ttft_spans = [(m.start(), m.end())
                      for p in SLO_METRICS["ttft"]
                      for m in re.finditer(re.escape(p), clause)]
        positions: Dict[str, int] = {}
        if ttft_spans:
            positions["ttft"] = min(s for s, _ in ttft_spans)
        tpot_hits = [m.start()
                     for p in SLO_METRICS["tpot"]
                     for m in re.finditer(re.escape(p), clause)
                     if not any(s <= m.start() < e for s, e in ttft_spans)]
        if tpot_hits:
            positions["tpot"] = min(tpot_hits)
        if not positions:
            return []
        bounds = list(_SLO_RE.finditer(clause))
        if not bounds:
            return []

        def seconds(m) -> float:
            v = float(m.group(1))
            return v / 1e3 if m.group(2).startswith("m") else v

        targets: Dict[str, float] = {}
        for metric, pos in positions.items():
            after = [b for b in bounds if b.start() > pos]
            v = seconds(after[0] if after else bounds[0])
            if v > 0:
                targets[metric] = v
        if not targets:
            return []

        subjects = _find_any(clause, ONTOLOGY_APP)
        data_types = _find_any(clause, ONTOLOGY_DATA)
        selector: Dict[str, str] = {}
        if subjects:
            selector["app"] = subjects[0]
        elif data_types:
            selector["data-type"] = data_types[0]
        else:
            return []      # latency clause with no workload subject
        return [ServiceLevelConstraint(
            selector=tuple(sorted(selector.items())),
            max_ttft_s=targets.get("ttft"),
            max_tpot_s=targets.get("tpot"))]

    def _merge_orphan_routing(self, routing: List[RoutingConstraint],
                              full_text: str) -> List[RoutingConstraint]:
        """Clause splitting can orphan a predicate from its subject ("..., and
        never cross untrusted switches"): merge endpoint-less, selector-less
        constraints into the preceding routing constraint, or scope them by a
        whole-sentence data selector (the paper's decomposition
        countermeasure to first-clause capture)."""
        merged: List[RoutingConstraint] = []
        for rc in routing:
            orphan = (rc.flow.src == "*" and rc.flow.dst == "*"
                      and not rc.selector and not rc.waypoints)
            if orphan and merged:
                prev = merged[-1]
                merged[-1] = dataclasses.replace(
                    prev,
                    forbid_vertex=tuple(dict.fromkeys(
                        prev.forbid_vertex + rc.forbid_vertex)),
                    forbidden_axes=tuple(dict.fromkeys(
                        prev.forbidden_axes + rc.forbidden_axes)))
                continue
            if orphan:
                data_types = _find_any(full_text, ONTOLOGY_DATA)
                if data_types:
                    rc = dataclasses.replace(
                        rc, selector=(("data-type", data_types[0]),))
            merged.append(rc)
        return merged

    # ---- routing clause grammar ----
    def _routing_clauses(self, clause: str) -> List[RoutingConstraint]:
        out: List[RoutingConstraint] = []
        if not any(w in clause for w in ("traffic", "path", "route", "switch",
                                         "traverse", "flow", "hop", "link",
                                         "packets")):
            return out

        # endpoints: "host 2", "from X to Y", component names
        hosts = re.findall(r"host\s*(\d+)", clause)
        apps = _find_any(clause, ONTOLOGY_APP)
        data_types = _find_any(clause, ONTOLOGY_DATA)

        src, dst = "*", "*"
        m = re.search(r"from\s+(host\s*\d+|[\w-]+)\s+to\s+(host\s*\d+|[\w-]+)",
                      clause)
        if m:
            src = m.group(1).replace(" ", "")
            dst = m.group(2).replace(" ", "")
        elif len(hosts) >= 2:
            src, dst = f"host{hosts[0]}", f"host{hosts[1]}"
        elif len(hosts) == 1:
            dst = f"host{hosts[0]}"
        elif data_types and any(p in clause for p in
                                ("traffic", "flows", "flow", "data")):
            pass  # selector-scoped flows ("all phi traffic ...")
        elif len(apps) >= 2:
            src, dst = apps[0], apps[1]
        elif len(apps) == 1:
            dst = apps[0]

        waypoints: List[str] = []
        for m2 in re.finditer(r"(?:switch\s+|through\s+|via\s+)s(\d+)", clause):
            if not _negated(clause, m2.start()):
                waypoints.append(f"s{m2.group(1)}")
        if "backup switch" in clause and not waypoints:
            waypoints.append("backup")

        forbid_vertex: List[Tuple[str, str]] = []
        for vendor in VENDORS:
            pos = clause.find(vendor)
            if pos >= 0 and _negated(clause, pos):
                forbid_vertex.append(("mfr", vendor))
        if "untrusted" in clause:
            forbid_vertex.append(("trusted", "no"))
        for region, locs in REGIONS.items():
            for loc in locs:
                pos = clause.find(loc)
                if pos >= 0 and _negated(clause, pos):
                    forbid_vertex.append(("location", loc))
        m3 = re.search(r"(?:avoid|not|never|outside)[^.]*region[- ](\w+)", clause)
        if m3:
            forbid_vertex.append(("region", m3.group(1)))

        forbidden_axes: Tuple[str, ...] = ()
        if any(p in clause for p in ("stay within the pod", "inside the pod",
                                     "leave the pod", "within pod",
                                     "within the pod", "cross-pod",
                                     "leave the site")):
            forbidden_axes = ("pod",)
        selector: Tuple[Tuple[str, str], ...] = ()
        if data_types:
            selector = (("data-type", data_types[0]),)
            if data_types[0] == "phi" and any(
                    p in clause for p in ("never leave", "must stay", "remain")):
                forbidden_axes = ("pod",)

        if waypoints or forbid_vertex or forbidden_axes or (src, dst) != ("*", "*"):
            out.append(RoutingConstraint(
                flow=Flow(src, dst),
                forbid_vertex=tuple(forbid_vertex),
                waypoints=tuple(waypoints),
                forbidden_axes=forbidden_axes,
                selector=selector))
        return out


# ---------------------------------------------------------------------------
# degraded backends (paper §6.3 failure modes / Fig. 7 comparison shape)
# ---------------------------------------------------------------------------


class FaultyInterpreter(DeterministicInterpreter):
    """Injects the paper's observed failure modes at a configurable rate.

    modes: first_clause | empty_path | hallucinated_label | partial_topology
    """

    def __init__(self, name: str = "faulty", rate: float = 0.2,
                 modes: Sequence[str] = ("first_clause", "empty_path",
                                         "hallucinated_label",
                                         "partial_topology"),
                 seed: int = 0):
        self.name = name
        self.rate = rate
        self.modes = tuple(modes)
        self._seed = seed

    def interpret(self, text: str, fabric: Fabric,
                  components: Sequence[Component]) -> InterpretResult:
        res = super().interpret(text, fabric, components)
        # deterministic pseudo-randomness per intent text
        h = (hash((text, self._seed)) % 10_000) / 10_000
        if h >= self.rate:
            return res
        mode = self.modes[hash((text, "m", self._seed)) % len(self.modes)]
        intent = res.intent
        if mode == "first_clause" and (len(intent.placement)
                                       + len(intent.routing)) > 1:
            # keep only the first clause encountered
            if intent.placement:
                intent = dataclasses.replace(intent,
                                             placement=intent.placement[:1],
                                             routing=())
            else:
                intent = dataclasses.replace(intent, routing=intent.routing[:1])
        elif mode == "empty_path" and intent.routing:
            # drop src/dst -> no-op policy (validator flags "no applicable flow")
            r0 = intent.routing[0]
            intent = dataclasses.replace(
                intent, routing=(dataclasses.replace(
                    r0, flow=Flow("nonexistent-src", "nonexistent-dst")),)
                + intent.routing[1:])
        elif mode == "hallucinated_label" and intent.placement:
            p0 = intent.placement[0]
            intent = dataclasses.replace(
                intent, placement=(dataclasses.replace(
                    p0, require=(("region", "eu_region"),)),)
                + intent.placement[1:])
        elif mode == "partial_topology" and intent.routing:
            r0 = intent.routing[0]
            if r0.forbid_vertex:
                intent = dataclasses.replace(
                    intent, routing=(dataclasses.replace(
                        r0, forbid_vertex=r0.forbid_vertex[:-1]),)
                    + intent.routing[1:])
        res.intent = intent
        res.directives["injected_fault"] = mode
        return res
