"""The 90-intent benchmark corpus (paper §5.3).

30 computing / 30 networking / 30 hybrid; 38 simple / 52 complex (hybrid
intents predominantly complex, 28/30 — matching the paper's distribution).
Each entry carries the natural-language text plus the expected outcome:
  * "enforce"     — the validator must PASS after deployment;
  * "fail-closed" — the intent is unenforceable on this fabric (missing
    workload/label, impossible constraint) and the system must detect that
    and refuse (paper Table 6 row 1, failure-mode taxonomy §6.3).
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class CorpusEntry:
    text: str
    domain: str           # computing | networking | hybrid
    complexity: str       # simple | complex
    expect: str = "enforce"   # enforce | fail-closed


def _c(text, complexity="simple", expect="enforce"):
    return CorpusEntry(text, "computing", complexity, expect)


def _n(text, complexity="simple", expect="enforce"):
    return CorpusEntry(text, "networking", complexity, expect)


def _h(text, complexity="complex", expect="enforce"):
    return CorpusEntry(text, "hybrid", complexity, expect)


COMPUTING: List[CorpusEntry] = [
    # -- simple (20) --
    _c("Ensure all personal health data remains within the European Union."),
    _c("Place the patient service only on nodes located in london."),
    _c("Keep the phi database on high-security infrastructure."),
    _c("Deploy the appointment service in the cloud zone."),
    _c("The doctor service must run on aws nodes."),
    _c("Sensitive data must stay in the eu region."),
    _c("Run the general database on any edge node."),
    _c("Patient records must be stored on trusted infrastructure."),
    _c("Do not deploy the phi database in the edge zone."),
    _c("Never place patient data on low security nodes."),
    _c("The vital sign monitor must be hosted in the eu."),
    _c("Avoid azure nodes for the phi database."),
    _c("Host the image preprocessor in the cloud zone."),
    _c("Medical records should reside on high-security nodes."),
    _c("Schedule the appointment service on azure infrastructure."),
    _c("The general database should not run in the eu region."),
    _c("Keep health data off the edge zone."),
    _c("Protected health information must remain in london."),
    _c("Deploy the doctor service on edge nodes."),
    _c("Most sensitive data should never leave the eu."),
    # -- complex (10) --
    _c("Place phi workloads on high-security cloud nodes in the eu.",
       "complex"),
    _c("Run the patient service on aws nodes, and keep the phi database in "
       "the cloud zone.", "complex"),
    _c("Deploy the appointment service on edge nodes and ensure the general "
       "database stays on azure.", "complex"),
    _c("Sensitive health data must remain in the eu and never be scheduled "
       "on low-security nodes.", "complex"),
    _c("Keep the phi database on high-security nodes in london, and host "
       "the doctor service in the cloud zone.", "complex"),
    _c("Prohibit financial database service deployment in the cloud zone.",
       "complex", expect="fail-closed"),
    _c("Deploy the billing workload on trusted infrastructure only.",
       "complex", expect="fail-closed"),
    _c("Place the patient service and the vital sign monitor on "
       "high-security eu nodes.", "complex"),
    _c("The phi database must be on aws in the eu, and the general database "
       "must avoid the edge zone.", "complex"),
    _c("Never run patient data in china, and keep it on high-security "
       "infrastructure.", "complex"),
]

NETWORKING: List[CorpusEntry] = [
    # -- simple (16) --
    _n("Ensure that all traffic from host 2 to host 4 must traverse the "
       "backup switch s15."),
    _n("Route traffic from host 1 to host 3 avoiding huawei switches."),
    _n("Traffic from host 0 to host 5 must never cross untrusted switches."),
    _n("All packets from host 3 to host 7 must go via switch s8."),
    _n("Flows from host 2 to host 6 should avoid cisco switches."),
    _n("Traffic between host 1 and host 4 must traverse switch s5."),
    _n("Route the flow from host 0 to host 2 through switch s10."),
    _n("Packets from host 5 to host 9 must avoid untrusted switches."),
    _n("Traffic from host 4 to host 8 must not pass huawei switches."),
    _n("The flow from host 6 to host 1 must traverse the backup switch."),
    _n("Ensure traffic from host 7 to host 2 goes via switch s3."),
    _n("Route packets from host 8 to host 0 avoiding juniper switches."),
    _n("Traffic from host 9 to host 5 must traverse switch s12."),
    _n("The path from host 3 to host 1 must avoid untrusted switches."),
    _n("Flows from host 2 to host 8 must go through switch s6."),
    _n("Traffic from host 1 to host 7 must not traverse arista switches."),
    # -- complex (14) --
    _n("Traffic from host 2 to host 4 must traverse switch s8 and avoid "
       "huawei switches.", "complex"),
    _n("Route flows from host 1 to host 5 through switch s3, and never "
       "cross untrusted switches.", "complex"),
    _n("All phi traffic must stay within the pod and avoid untrusted "
       "switches.", "complex"),
    _n("Traffic from host 0 to host 6 must go via switch s4 and avoid "
       "cisco switches.", "complex"),
    _n("Packets from host 3 to host 9 must traverse switch s7 and must "
       "not pass huawei switches.", "complex"),
    _n("The flow from host 5 to host 2 must traverse the backup switch "
       "and avoid untrusted switches.", "complex"),
    _n("Route traffic from host 4 to host 1 via switch s9, avoiding "
       "juniper switches.", "complex"),
    _n("Traffic from host 6 to host 3 must traverse switch s2 and switch "
       "s11.", "complex"),
    _n("Flows from host 7 to host 0 must go through switch s13 and never "
       "cross huawei switches.", "complex"),
    _n("Traffic from host 8 to host 4 must traverse switch s1 and avoid "
       "untrusted switches.", "complex"),
    _n("Sensitive data flows must never leave the pod.", "complex"),
    _n("Phi traffic must remain inside the pod and avoid huawei "
       "switches.", "complex"),
    _n("Hosts communicating with host 4 must pass through the backup "
       "switch.", "complex"),
    _n("Traffic from host 1 to host 2 must traverse switch s99.",
       "complex", expect="fail-closed"),   # s99 does not exist -> fail closed
]

HYBRID: List[CorpusEntry] = [
    # -- simple (2) --
    _h("Keep the phi database in the eu and route its traffic through "
       "switch s5.", "simple"),
    _h("Run the patient service in the cloud zone and keep its traffic "
       "off huawei switches.", "simple"),
    # -- complex (28) --
    _h("Run appointment only on high-security cloud nodes, enforce that "
       "all other hosts communicating with host 4 must pass through the "
       "backup switch s15, and prevent sensitive databases from being "
       "deployed in the edge zone."),
    _h("Place phi workloads on eu nodes and ensure their traffic avoids "
       "untrusted switches."),
    _h("Keep patient data on high-security nodes, and route traffic from "
       "host 2 to host 5 via switch s6."),
    _h("Deploy the phi database in the cloud zone and make sure phi "
       "traffic never leaves the pod."),
    _h("Host the doctor service on aws, and traffic from host 1 to host 3 "
       "must traverse switch s4."),
    _h("Sensitive data must remain in the eu, and its flows must avoid "
       "huawei switches."),
    _h("Run the vital sign monitor on edge nodes and route its traffic "
       "through the backup switch."),
    _h("Place the general database on azure and keep traffic from host 0 "
       "to host 2 away from untrusted switches."),
    _h("Keep phi workloads in london, and phi traffic must stay within "
       "the pod."),
    _h("Deploy the appointment service on cloud nodes and route traffic "
       "from host 6 to host 1 via switch s9."),
    _h("Patient records stay on high-security eu nodes, and their traffic "
       "must avoid cisco switches."),
    _h("Run the image preprocessor on edge nodes, and traffic from host 3 "
       "to host 8 must traverse switch s2."),
    _h("The phi database must avoid the edge zone, and flows from host 4 "
       "to host 7 must go via switch s11."),
    _h("Host patient data on aws nodes in the eu and keep its traffic off "
       "untrusted switches."),
    _h("Keep the general database out of the eu, and traffic from host 5 "
       "to host 0 must traverse switch s3."),
    _h("Place the phi database on high-security nodes and route all phi "
       "traffic inside the pod avoiding huawei switches."),
    _h("Deploy the doctor service in the cloud zone, and packets from "
       "host 2 to host 9 must avoid juniper switches."),
    _h("Sensitive health data must never be deployed in china, and its "
       "traffic must avoid untrusted switches."),
    _h("Run the patient service on high-security infrastructure and "
       "traffic from host 1 to host 6 must traverse the backup switch."),
    _h("Keep the phi database in the eu region, and traffic from host 7 "
       "to host 3 must go through switch s5 avoiding huawei switches."),
    _h("Place the vital sign monitor on cloud nodes, route its traffic "
       "via switch s8, and avoid untrusted switches."),
    _h("The appointment service runs on azure edge nodes, and flows from "
       "host 0 to host 4 must traverse switch s7."),
    _h("Host phi workloads on trusted eu infrastructure, and phi flows "
       "must remain inside the pod."),
    _h("Deploy the general database in the cloud zone and route traffic "
       "from host 8 to host 2 via switch s10 avoiding cisco switches."),
    _h("Patient data must stay in the eu on high-security nodes, and its "
       "traffic must never cross untrusted switches."),
    _h("Run the financial database on eu nodes and route its traffic "
       "through switch s4.", expect="fail-closed"),
    _h("Keep the phi database on high-security cloud nodes, prevent "
       "deployment in the edge zone, and route phi traffic via the "
       "backup switch."),
    _h("Place the doctor and appointment services on cloud nodes, and "
       "traffic from host 3 to host 6 must avoid huawei switches."),
]

CORPUS: Tuple[CorpusEntry, ...] = tuple(COMPUTING + NETWORKING + HYBRID)

assert len(COMPUTING) == 30 and len(NETWORKING) == 30 and len(HYBRID) == 30
assert sum(1 for e in CORPUS if e.complexity == "simple") == 38
assert sum(1 for e in CORPUS if e.complexity == "complex") == 52
