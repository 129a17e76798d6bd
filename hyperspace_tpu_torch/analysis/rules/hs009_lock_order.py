"""HS009 — lock-order inversion across the call graph.

The port holds many locks: residency caches, the serve queue
condition, writer leases, catalog and scan-gate locks, the build
pipeline's coordination. Two locks acquired in opposite orders on two
code paths deadlock the moment both paths run concurrently — and nothing
intra-procedural can see it, because each path is individually correct.
This rule builds the ACQUISITION-ORDER GRAPH over the whole project and
reports every edge participating in a cycle.

Detection (whole-program, documented blind spots):
  * an edge A→B exists when lock B is acquired while A is held — either
    lexically inside one function, or INTERPROCEDURALLY: a call made
    while holding A whose callee (transitively, via the resolved call
    graph) acquires B;
  * lock identity is the DEFINING owner attribute
    (``module:Class.attr`` / ``module:global``), so two instances of one
    class share an identity — conservative for instance-disjoint locks
    (suppress with justification when two instances are provably never
    shared between threads in opposite orders);
  * self-edges (A→A) are dropped: re-acquiring the same identity is
    either an RLock, a Condition idiom, or distinct instances of one
    class (the metrics parent-chain walk) — flagging them would bury the
    cross-lock signal;
  * locks the resolver cannot bind to the inventory (parameters named
    ``lock``, attributes of untyped receivers) are invisible here —
    HS002 still covers them lexically;
  * cycles are reported per EDGE (each witness acquisition/call site
    gets its own finding) so a justified suppression can target one
    site.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Set, Tuple

from ..core import ProjectRule

Witness = Tuple[str, int, int, str]  # path, line, col, description


class LockOrderRule(ProjectRule):
    code = "HS009"
    name = "lock-order-inversion"
    description = (
        "two locks are acquired in opposite orders on different code "
        "paths (acquisition-order graph cycle via the project call "
        "graph) — a concurrent pair deadlocks"
    )

    def check_project(self, project) -> Iterator[Tuple[str, int, int, str]]:
        edges: Dict[Tuple[str, str], List[Witness]] = {}
        lock_closure = project.closure("locks")
        for f in project.functions.values():
            for a in f.acquires:
                for held in a.held:
                    if held != a.lock:
                        edges.setdefault((held, a.lock), []).append(
                            (f.path, a.line, a.col, f"in {f.qual}")
                        )
            for site in f.calls:
                if not site.held or site.callee is None:
                    continue
                for inner in lock_closure.get(site.callee, ()):
                    for held in site.held:
                        if held != inner:
                            edges.setdefault((held, inner), []).append(
                                (
                                    f.path,
                                    site.line,
                                    site.col,
                                    f"in {f.qual} via call to {site.callee}",
                                )
                            )
        if not edges:
            return
        cyclic = _edges_in_cycles(set(edges))
        emitted = set()
        for a, b in sorted(cyclic):
            reverse = _reverse_witness(edges, cyclic, a, b)
            # every witness site is its own finding: a suppression
            # justified for one acquisition site must not silence the
            # same inversion somewhere else
            for path, line, col, desc in sorted(edges[(a, b)]):
                key = (path, line, col, a, b)
                if key in emitted:
                    continue
                emitted.add(key)
                yield (
                    path,
                    line,
                    col,
                    f"lock-order inversion: '{b}' is acquired while "
                    f"'{a}' is held ({desc}), but the opposite order "
                    f"exists ({reverse}) — a concurrent pair deadlocks; "
                    "acquire in one global order",
                )

    # -- graph helpers -------------------------------------------------------


def _edges_in_cycles(
    edge_set: Set[Tuple[str, str]]
) -> Set[Tuple[str, str]]:
    """Edges whose endpoints share a strongly connected component — i.e.
    edges lying on at least one cycle."""
    adj: Dict[str, List[str]] = {}
    nodes: Set[str] = set()
    for a, b in edge_set:
        adj.setdefault(a, []).append(b)
        nodes.add(a)
        nodes.add(b)
    comp = _tarjan_scc(nodes, adj)
    return {(a, b) for a, b in edge_set if comp[a] == comp[b]}


def _tarjan_scc(
    nodes: Set[str], adj: Dict[str, List[str]]
) -> Dict[str, int]:
    """Iterative Tarjan: node -> SCC id."""
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    on_stack: Set[str] = set()
    stack: List[str] = []
    comp: Dict[str, int] = {}
    counter = [0]
    comp_id = [0]

    for root in sorted(nodes):
        if root in index:
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, ei = work.pop()
            if ei == 0:
                index[node] = low[node] = counter[0]
                counter[0] += 1
                stack.append(node)
                on_stack.add(node)
            neighbors = adj.get(node, [])
            advanced = False
            while ei < len(neighbors):
                nxt = neighbors[ei]
                ei += 1
                if nxt not in index:
                    work.append((node, ei))
                    work.append((nxt, 0))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            if low[node] == index[node]:
                while True:
                    top = stack.pop()
                    on_stack.discard(top)
                    comp[top] = comp_id[0]
                    if top == node:
                        break
                comp_id[0] += 1
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
    return comp


def _reverse_witness(
    edges: Dict[Tuple[str, str], List[Witness]],
    cyclic: Set[Tuple[str, str]],
    a: str,
    b: str,
) -> str:
    """Human pointer to the opposing order: the direct reverse edge's
    witness when the cycle is a 2-cycle, else the cycle's lock set."""
    if (b, a) in edges:
        path, line, _col, _desc = sorted(edges[(b, a)])[0]
        return f"'{a}' acquired under '{b}' at {path}:{line}"
    locks = sorted({x for e in cyclic for x in e})
    return "cycle through locks " + ", ".join(f"'{x}'" for x in locks)
