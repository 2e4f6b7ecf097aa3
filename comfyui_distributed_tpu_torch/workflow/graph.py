"""Workflow graph parsing: the API-format part of
``comfyui_distributed_tpu/workflow/graph.py``.

API format is ``{node_id: {class_type, inputs: {...}}}`` where a link
input is a ``[src_id, slot]`` pair; keys without a ``class_type`` (such
as ``__doc__``) are metadata and skipped.  The UI format waits.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Set, Tuple, Union

# importing the op modules registers their ops
from comfyui_distributed_tpu_torch.ops import (  # noqa: F401
    basic, distributed, tiled_upscale)
from comfyui_distributed_tpu_torch.ops.base import NODE_CLASS_MAPPINGS

Link = Tuple[str, int]  # (source node id, output slot)


@dataclasses.dataclass
class Node:
    id: str
    class_type: str
    inputs: Dict[str, Any]          # name -> literal or Link
    hidden: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def link_inputs(self) -> Dict[str, Link]:
        return {k: tuple(v) for k, v in self.inputs.items() if _is_link(v)}


def _is_link(v: Any) -> bool:
    return (isinstance(v, (list, tuple)) and len(v) == 2
            and isinstance(v[1], int) and not isinstance(v[0], (list, dict)))


@dataclasses.dataclass
class Graph:
    nodes: Dict[str, Node]

    def to_api_format(self) -> Dict[str, Any]:
        """The graph as API-format JSON; a node's hidden inputs ride under
        ``hidden`` and parse back as hidden inputs."""
        out = {}
        for nid, n in self.nodes.items():
            entry: Dict[str, Any] = {"class_type": n.class_type,
                                     "inputs": dict(n.inputs)}
            if n.hidden:
                entry["hidden"] = dict(n.hidden)
            out[nid] = entry
        return out

    def find_by_type(self, *types: str) -> List[str]:
        return [nid for nid, n in self.nodes.items()
                if n.class_type in types]

    def topo_order(self) -> List[str]:
        """Dependency order; raises on cycles."""
        state: Dict[str, int] = {}
        order: List[str] = []

        def visit(nid: str):
            st = state.get(nid, 0)
            if st == 1:
                raise ValueError(f"workflow graph has a cycle at node {nid}")
            if st == 2:
                return
            state[nid] = 1
            node = self.nodes.get(nid)
            if node is None:
                raise KeyError(f"node {nid} referenced but not defined")
            for src, _slot in node.link_inputs().values():
                visit(str(src))
            state[nid] = 2
            order.append(nid)

        for nid in self.nodes:
            visit(nid)
        return order


def connected_component(graph: Graph, roots: List[str]) -> Set[str]:
    """The nodes reachable from ``roots`` over links in either
    direction: what a worker keeps of a fanned-out graph."""
    adj: Dict[str, Set[str]] = {nid: set() for nid in graph.nodes}
    for nid, node in graph.nodes.items():
        for src, _ in node.link_inputs().values():
            src = str(src)
            if src in adj:
                adj[nid].add(src)
                adj[src].add(nid)
    seen: Set[str] = set()
    frontier = [r for r in roots if r in adj]
    while frontier:
        cur = frontier.pop()
        if cur in seen:
            continue
        seen.add(cur)
        frontier.extend(adj[cur] - seen)
    return seen


def parse_api_format(doc: Dict[str, Any]) -> Graph:
    nodes: Dict[str, Node] = {}
    for nid, entry in doc.items():
        if not isinstance(entry, dict) or "class_type" not in entry:
            continue  # metadata keys ("__doc__", "extra_data", ...)
        cls = NODE_CLASS_MAPPINGS.get(entry["class_type"])
        inputs = dict(cls.DEFAULTS) if cls and cls.DEFAULTS else {}
        for k, v in dict(entry.get("inputs", {})).items():
            inputs[k] = [str(v[0]), int(v[1])] if _is_link(v) else v
        nodes[str(nid)] = Node(id=str(nid), class_type=entry["class_type"],
                               inputs=inputs,
                               hidden=dict(entry.get("hidden", {})))
    return Graph(nodes=nodes)


def parse_workflow(doc: Union[str, Dict[str, Any]]) -> Graph:
    """Parse an API-format workflow from a JSON string, a path or a
    dict."""
    if isinstance(doc, str):
        if doc.lstrip().startswith("{"):
            doc = json.loads(doc)
        else:
            with open(doc, "r", encoding="utf-8") as f:
                doc = json.load(f)
    if isinstance(doc.get("nodes"), list):
        raise NotImplementedError(
            "UI-format workflows are not ported yet; export the workflow "
            "in API format")
    return parse_api_format(doc)
