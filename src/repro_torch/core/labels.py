"""Label schema + fabric inventory (the paper's λ_N / λ_V label functions).

The cloud-edge testbed maps onto a logical accelerator fabric as follows:
  * a POD is a site: it carries location / region / provider / security /
    zone labels (the paper's worker-node label matrix, Table 5);
  * within a pod, the inter-chip fabric is a 2-D torus over the (data, model) mesh
    axes; torus links and per-pod border routers are the network vertices
    (the paper's OpenFlow switches) and carry mfr / protocol / location /
    trusted labels (Table 4);
  * workload components (tenants, model blocks, KV caches, expert groups)
    are the paper's pods/services and carry app / data-type labels.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, FrozenSet, Iterable, List, Mapping, Optional, Tuple

Labels = Mapping[str, str]


def label_set(labels: Labels) -> FrozenSet[Tuple[str, str]]:
    return frozenset(labels.items())


# ---------------------------------------------------------------------------
# sites (pods)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Site:
    pod: int
    labels: Dict[str, str]


# the default two-pod production fabric — mirrors the paper's 5-worker label
# matrix (Table 5) at pod granularity, EU + US sites
DEFAULT_SITES = (
    Site(0, {"location": "london", "region": "eu", "provider": "aws",
             "security": "high", "zone": "cloud", "trusted": "yes"}),
    Site(1, {"location": "newyork", "region": "us", "provider": "azure",
             "security": "medium", "zone": "edge", "trusted": "yes"}),
)

# single-pod fabric used for the 16x16 mesh
SINGLE_SITE = (DEFAULT_SITES[0],)


# region ontology (the paper's "EU" -> concrete locations linking)
REGIONS: Dict[str, Tuple[str, ...]] = {
    "eu": ("london", "dublin", "frankfurt", "paris"),
    "us": ("newyork", "sanfrancisco", "oregon"),
    "apac": ("sydney", "tokyo", "singapore"),
    "cn": ("beijing", "shanghai"),
}


def region_of(location: str) -> Optional[str]:
    for region, locs in REGIONS.items():
        if location in locs:
            return region
    return None


# ---------------------------------------------------------------------------
# network vertices (switches / routers) and links
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NetVertex:
    vid: str                       # e.g. "pod0/sw_r3" or "pod0/border"
    kind: str                      # ici-switch | border-router | device
    labels: Dict[str, str]


@dataclasses.dataclass(frozen=True)
class NetLink:
    src: str
    dst: str
    bw: float                      # B/s
    labels: Dict[str, str]


@dataclasses.dataclass
class Fabric:
    """Device + network inventory for one deployment."""

    sites: Tuple[Site, ...]
    mesh_shape: Tuple[int, ...]            # e.g. (2, 16, 16) or (16, 16)
    axis_names: Tuple[str, ...]
    vertices: Dict[str, NetVertex] = dataclasses.field(default_factory=dict)
    links: List[NetLink] = dataclasses.field(default_factory=list)

    # ---- label functions -------------------------------------------------
    def site_of_pod(self, pod: int) -> Site:
        return self.sites[pod]

    def pod_labels(self, pod: int) -> Dict[str, str]:
        return dict(self.sites[pod].labels)

    def device_labels(self, device_index: int) -> Dict[str, str]:
        """λ_N for one device (flat index into the mesh)."""
        if "pod" in self.axis_names:
            pod_size = 1
            for n, s in zip(self.axis_names, self.mesh_shape):
                if n != "pod":
                    pod_size *= s
            pod = device_index // pod_size
        else:
            pod = 0
        labels = self.pod_labels(pod)
        labels["pod"] = str(pod)
        return labels

    def vertex_labels(self, vid: str) -> Dict[str, str]:
        """λ_V for one network vertex."""
        return dict(self.vertices[vid].labels)

    def pods(self) -> List[int]:
        return list(range(len(self.sites)))

    def devices_of_pod(self, pod: int) -> List[int]:
        if "pod" not in self.axis_names:
            return list(range(int(_prod(self.mesh_shape))))
        pod_size = int(_prod(self.mesh_shape)) // self.mesh_shape[self.axis_names.index("pod")]
        return list(range(pod * pod_size, (pod + 1) * pod_size))

    def label_inventory(self) -> Dict[str, FrozenSet[str]]:
        """All (key -> set of values) present anywhere — the validator's
        hallucination cross-check ("eu_region does not exist on any node")."""
        inv: Dict[str, set] = {}
        for site in self.sites:
            for k, v in site.labels.items():
                inv.setdefault(k, set()).add(v)
        for v in self.vertices.values():
            for k, val in v.labels.items():
                inv.setdefault(k, set()).add(val)
        inv.setdefault("region", set()).update(REGIONS.keys())
        return {k: frozenset(vs) for k, vs in inv.items()}


def _prod(xs: Iterable[int]) -> int:
    out = 1
    for x in xs:
        out *= x
    return out


# ---------------------------------------------------------------------------
# fabric construction
# ---------------------------------------------------------------------------

_SWITCH_VENDORS = ("cisco", "huawei", "juniper", "arista")


def build_fabric(mesh_shape: Tuple[int, ...], axis_names: Tuple[str, ...],
                 sites: Optional[Tuple[Site, ...]] = None) -> Fabric:
    """Model the ICI/DCN topology as a labeled graph.

    Each pod's (data x model) torus is aggregated into one ICI switch per
    data-row (16 row switches per pod) plus a per-pod border router; border
    routers interconnect over DCN. This is the granularity at which routing
    intents operate (the paper's 9/25-switch topologies are comparable).
    """
    if sites is None:
        sites = DEFAULT_SITES if "pod" in axis_names else SINGLE_SITE
    fabric = Fabric(sites=sites, mesh_shape=mesh_shape, axis_names=axis_names)
    n_pods = len(sites) if "pod" in axis_names else 1
    rows = mesh_shape[axis_names.index("data")]

    for pod in range(n_pods):
        site = sites[pod]
        for r in range(rows):
            vid = f"pod{pod}/sw_r{r}"
            fabric.vertices[vid] = NetVertex(
                vid, "ici-switch",
                {"mfr": _SWITCH_VENDORS[(pod + r) % len(_SWITCH_VENDORS)],
                 "protocol": "OF_13",
                 "location": site.labels["location"],
                 "region": site.labels.get("region", ""),
                 "trusted": "yes" if r % 8 else "no",   # one untrusted/8 rows
                 "role": "backup" if r == rows - 1 else "normal",
                 "pod": str(pod)})
            # hosts hang off their row switch (endpoints are hosts, not
            # switches — vendor/trust predicates never apply to endpoints)
            host = f"pod{pod}/host{r}"
            fabric.vertices[host] = NetVertex(
                host, "host",
                {"location": site.labels["location"],
                 "region": site.labels.get("region", ""),
                 "pod": str(pod)})
            fabric.links.append(NetLink(host, vid, 50e9, {"type": "access"}))
        border = f"pod{pod}/border"
        # border routers are vendor-neutral core devices, so vendor-avoid
        # paths can always detour row -> border -> row
        fabric.vertices[border] = NetVertex(
            border, "border-router",
            {"mfr": "neutral-core",
             "protocol": "OF_13",
             "location": site.labels["location"],
             "region": site.labels.get("region", ""),
             "trusted": "yes", "role": "border", "pod": str(pod)})
        # intra-pod ring over row switches + uplinks to border
        for r in range(rows):
            nxt = f"pod{pod}/sw_r{(r + 1) % rows}"
            fabric.links.append(NetLink(f"pod{pod}/sw_r{r}", nxt, 50e9,
                                        {"type": "ici"}))
            fabric.links.append(NetLink(f"pod{pod}/sw_r{r}", border, 25e9,
                                        {"type": "uplink"}))
    # DCN mesh between border routers
    for a, b in itertools.combinations(range(n_pods), 2):
        fabric.links.append(NetLink(f"pod{a}/border", f"pod{b}/border", 12.5e9,
                                    {"type": "dcn"}))
    return fabric


def match_labels(labels: Labels, predicate: Labels) -> bool:
    """predicate ⊆ labels, with region ontology expansion for 'location'."""
    for k, want in predicate.items():
        have = labels.get(k)
        if have == want:
            continue
        if k == "region" and have is None:
            loc = labels.get("location")
            if loc and region_of(loc) == want:
                continue
        return False
    return True
