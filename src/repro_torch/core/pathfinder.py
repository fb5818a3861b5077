"""Constrained path search over the labeled fabric graph.

Weighted Dijkstra with BFS fallback, exactly the paper's path scheduler
(§4.2): forbidden-vertex predicates prune the graph, waypoint constraints
decompose the search into src -> wp1 -> ... -> dst legs. Weights are
1/bandwidth so DCN hops (12.5 GB/s) cost 4x an ICI hop (50 GB/s).
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.labels import Fabric, match_labels


def _adjacency(fabric: Fabric) -> Dict[str, List[Tuple[str, float]]]:
    adj: Dict[str, List[Tuple[str, float]]] = {v: [] for v in fabric.vertices}
    for link in fabric.links:
        w = 1.0 / max(link.bw, 1.0)
        adj.setdefault(link.src, []).append((link.dst, w))
        adj.setdefault(link.dst, []).append((link.src, w))
    return adj


def _allowed(fabric: Fabric, vid: str,
             forbid: Sequence[Tuple[str, str]]) -> bool:
    labels = fabric.vertex_labels(vid)
    return not any(match_labels(labels, {k: v}) for k, v in forbid)


def dijkstra(fabric: Fabric, src: str, dst: str,
             forbid: Sequence[Tuple[str, str]] = (),
             exempt: Optional[set] = None) -> Optional[List[str]]:
    """Min-cost path avoiding forbidden vertices (exempt set excepted)."""
    if src not in fabric.vertices or dst not in fabric.vertices:
        return None
    exempt = exempt or {src, dst}
    adj = _adjacency(fabric)
    dist = {src: 0.0}
    prev: Dict[str, str] = {}
    heap = [(0.0, src)]
    seen = set()
    while heap:
        d, u = heapq.heappop(heap)
        if u in seen:
            continue
        seen.add(u)
        if u == dst:
            break
        for v, w in adj.get(u, []):
            if v not in exempt and not _allowed(fabric, v, forbid):
                continue
            nd = d + w
            if nd < dist.get(v, float("inf")):
                dist[v] = nd
                prev[v] = u
                heapq.heappush(heap, (nd, v))
    if dst not in seen:
        return None
    path = [dst]
    while path[-1] != src:
        path.append(prev[path[-1]])
    return path[::-1]


def bfs(fabric: Fabric, src: str, dst: str,
        forbid: Sequence[Tuple[str, str]] = (),
        exempt: Optional[set] = None) -> Optional[List[str]]:
    """Unweighted fallback (paper: 'weighted Dijkstra, BFS fallback')."""
    if src not in fabric.vertices or dst not in fabric.vertices:
        return None
    exempt = exempt or {src, dst}
    adj = _adjacency(fabric)
    prev: Dict[str, Optional[str]] = {src: None}
    queue = [src]
    while queue:
        u = queue.pop(0)
        if u == dst:
            break
        for v, _ in adj.get(u, []):
            if v in prev:
                continue
            if v not in exempt and not _allowed(fabric, v, forbid):
                continue
            prev[v] = u
            queue.append(v)
    if dst not in prev:
        return None
    path: List[str] = [dst]
    while prev[path[-1]] is not None:
        path.append(prev[path[-1]])  # type: ignore[arg-type]
    return path[::-1]


def find_path(fabric: Fabric, src: str, dst: str, *,
              forbid: Sequence[Tuple[str, str]] = (),
              waypoints: Sequence[str] = ()) -> Optional[List[str]]:
    """Full constrained search: src -> wp1 -> ... -> dst, Dijkstra with BFS
    fallback per leg. Endpoint attachment switches are exempt from the
    forbidden predicates (a host cannot avoid its own access switch)."""
    exempt = exempt_set(fabric, src, dst, *waypoints)

    def leg_forbid(vid_ok):
        return forbid

    legs = [src, *waypoints, dst]
    path: List[str] = [src]
    for a, b in zip(legs, legs[1:]):
        sub = (dijkstra(fabric, a, b, forbid, exempt=exempt)
               or bfs(fabric, a, b, forbid, exempt=exempt))
        if sub is None:
            return None
        path += sub[1:]
    return path


def attachment_switch(fabric: Fabric, vid: str) -> Optional[str]:
    """The access switch a host endpoint hangs off (exempt from vendor/trust
    avoidance — a host cannot avoid its own attachment)."""
    v = fabric.vertices.get(vid)
    if v is None or v.kind != "host":
        return None
    for link in fabric.links:
        if link.src == vid:
            return link.dst
        if link.dst == vid:
            return link.src
    return None


def exempt_set(fabric: Fabric, *endpoints: str) -> set:
    out = set()
    for e in endpoints:
        out.add(e)
        att = attachment_switch(fabric, e)
        if att:
            out.add(att)
    return out


def resolve_endpoint(fabric: Fabric, name: str, placement: Dict[str, int]
                     ) -> Optional[str]:
    """Map a flow endpoint (component / hostN / switch id) to a vertex id.

    Out-of-range host/switch indices resolve to None — the compiler then
    fails closed ("unknown endpoint"), catching hallucinated identifiers.
    """
    if name in fabric.vertices:
        return name
    rows = fabric.mesh_shape[fabric.axis_names.index("data")]
    if name.startswith("host"):
        try:
            n = int(name[4:])
        except ValueError:
            return None
        return f"pod0/host{n}" if n < rows else None
    # sN -> row switch N (the paper's switch naming)
    if name.startswith("s") and name[1:].isdigit():
        n = int(name[1:])
        return f"pod0/sw_r{n}" if n < rows else None
    if name == "backup":
        return f"pod0/sw_r{rows - 1}"     # role=backup switch
    # component name -> a host vertex in its pod (stable per-name index),
    # so co-located components still have distinct, routable endpoints
    if name in placement:
        idx = sum(name.encode()) % rows
        return f"pod{placement[name]}/host{idx}"
    return None
