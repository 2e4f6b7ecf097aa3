"""Workflow graph parsing: the counterpart of
``comfyui_distributed_tpu/workflow/graph.py``, both formats.

API format is ``{node_id: {class_type, inputs: {...}}}`` where a link
input is a ``[src_id, slot]`` pair; keys without a ``class_type`` (such
as ``__doc__``) are metadata and skipped.  UI format (what ComfyUI's
browser saves, and what SaveImage embeds as ``extra_pnginfo.workflow``)
is ``{nodes: [...], links: [...]}``: each node's ``widgets_values`` map
onto its op's ``WIDGETS`` in order (``CONTROL`` slots skipped), its
linked inputs onto ``links``; a bypassed node (mode 4) passes each input
through to its output of the same type, and a muted node (mode 2) ends
the link.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Set, Tuple, Union

# importing the op modules registers their ops
from comfyui_distributed_tpu_torch.ops import (  # noqa: F401
    basic, distributed, tiled_upscale)
from comfyui_distributed_tpu_torch.ops.base import CONTROL, NODE_CLASS_MAPPINGS

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


def _widgets_to_inputs(class_type: str,
                       widgets_values: Optional[Any]) -> Dict[str, Any]:
    """A UI node's ``widgets_values`` as inputs: over the op's defaults,
    in ``WIDGETS`` order without the ``CONTROL`` slots; a dict is taken
    as it is, and an unknown class keeps them under ``__widgets__`` (the
    executor refuses the class before any node runs)."""
    cls = NODE_CLASS_MAPPINGS.get(class_type)
    if cls is None:
        return {"__widgets__": widgets_values}
    inputs: Dict[str, Any] = dict(cls.DEFAULTS) if cls.DEFAULTS else {}
    if not widgets_values:
        return inputs
    if isinstance(widgets_values, dict):
        inputs.update(widgets_values)
        return inputs
    for name, value in zip(cls.WIDGETS, widgets_values):
        if name != CONTROL:
            inputs[name] = value
    return inputs


def parse_ui_format(doc: Dict[str, Any]) -> Graph:
    # link id -> (source node, source slot, type); a link row is
    # [link_id, src_node, src_slot, dst_node, dst_slot, type]
    links: Dict[int, Tuple[str, int, str]] = {
        int(ln[0]): (str(ln[1]), int(ln[2]), str(ln[5]) if len(ln) > 5
                     else "")
        for ln in doc.get("links", []) or []}
    raw_nodes = {str(n["id"]): n for n in doc.get("nodes", [])}
    bypassed = {nid for nid, n in raw_nodes.items() if n.get("mode") == 4}
    muted = {nid for nid, n in raw_nodes.items() if n.get("mode") == 2}

    def resolve(src: str, slot: int, want_type: str) -> Optional[Link]:
        """Follow bypassed nodes to the upstream input of the type of
        the output read; a muted node, a loop or a bypassed node with
        no such input ends the link."""
        seen: Set[str] = set()
        while src in bypassed:
            if src in seen:
                return None
            seen.add(src)
            n = raw_nodes[src]
            outs = n.get("outputs", []) or []
            otype = (outs[slot].get("type", want_type)
                     if slot < len(outs) else want_type)
            nxt = next((links[int(inp["link"])]
                        for inp in n.get("inputs", []) or []
                        if inp.get("link") is not None
                        and int(inp["link"]) in links
                        and inp.get("type", "") == otype), None)
            if nxt is None:
                return None
            src, slot = nxt[0], nxt[1]
        if src in muted:
            return None
        return src, slot

    nodes: Dict[str, Node] = {}
    for nid, n in raw_nodes.items():
        if nid in bypassed or nid in muted:
            continue
        inputs = _widgets_to_inputs(n["type"], n.get("widgets_values"))
        for inp in n.get("inputs", []) or []:
            link_id = inp.get("link")
            if link_id is not None and int(link_id) in links:
                src, slot, ltype = links[int(link_id)]
                resolved = resolve(src, slot, inp.get("type", ltype))
                if resolved is not None:
                    inputs[inp["name"]] = [resolved[0], resolved[1]]
        nodes[nid] = Node(id=nid, class_type=n["type"], inputs=inputs)
    return Graph(nodes=nodes)


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
    """Parse a workflow, either format, from a JSON string, a path or a
    dict."""
    if isinstance(doc, str):
        if doc.lstrip().startswith("{"):
            doc = json.loads(doc)
        else:
            with open(doc, "r", encoding="utf-8") as f:
                doc = json.load(f)
    if isinstance(doc.get("nodes"), list):
        return parse_ui_format(doc)
    return parse_api_format(doc)
