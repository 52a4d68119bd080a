"""Fake control plane: an in-process pod/node store with watch-style fanout.

Plays the role of client-go fake.Clientset + informers in the reference's unit
layer: scheduler event handlers subscribe, API writes (bind, create, delete)
synchronously fan out to them — the apiserver watch streams collapsed to
function calls. Every pod/node write passes the scope guard (core/scope.py).
"""

from __future__ import annotations

import copy
import itertools
from typing import Callable, Dict, List, Optional

from ..api.types import Node, Pod
from .scope import check_node, check_pod


class FakeClientset:
    def __init__(self):
        self.pods: Dict[str, Pod] = {}
        self.nodes: Dict[str, Node] = {}
        self.bindings: Dict[str, str] = {}  # pod uid -> node name
        self._pod_handlers: List = []
        self._node_handlers: List = []
        self._rv_counter = itertools.count(1)

    # -- informer-ish registration ----------------------------------------

    def on_pod_event(self, handler: Callable[[str, Optional[Pod], Pod], None]) -> None:
        """handler(kind, old, new) with kind in add/update/delete."""
        self._pod_handlers.append(handler)

    def on_node_event(self, handler: Callable[[str, Optional[Node], Node], None]) -> None:
        self._node_handlers.append(handler)

    # -- writes ------------------------------------------------------------

    def create_node(self, node: Node) -> Node:
        check_node(node)
        node.resource_version = next(self._rv_counter)
        self.nodes[node.name] = node
        for h in self._node_handlers:
            h("add", None, node)
        return node

    def update_node(self, node: Node) -> Node:
        check_node(node)
        old = self.nodes.get(node.name)
        node.resource_version = next(self._rv_counter)
        self.nodes[node.name] = node
        for h in self._node_handlers:
            h("update", old, node)
        return node

    def delete_node(self, name: str) -> None:
        node = self.nodes.pop(name, None)
        if node is not None:
            for h in self._node_handlers:
                h("delete", node, node)

    def create_pod(self, pod: Pod) -> Pod:
        check_pod(pod)
        pod.resource_version = next(self._rv_counter)
        self.pods[pod.uid] = pod
        for h in self._pod_handlers:
            h("add", None, pod)
        return pod

    def update_pod(self, pod: Pod) -> Pod:
        check_pod(pod)
        old = self.pods.get(pod.uid)
        pod.resource_version = next(self._rv_counter)
        # An in-place spec change on the same object drops the derived-spec
        # memos, including the template-shared signature holder.
        d = pod.__dict__
        d.pop("_sig_cache", None)
        d.pop("_sig_shared", None)
        d.pop("_req_cache", None)
        self.pods[pod.uid] = pod
        for h in self._pod_handlers:
            h("update", old, pod)
        return pod

    def delete_pod(self, pod: Pod) -> None:
        p = self.pods.pop(pod.uid, None)
        if p is not None:
            for h in self._pod_handlers:
                h("delete", p, p)

    def bind(self, pod: Pod, node_name: str) -> None:
        """POST pods/{name}/binding (DefaultBinder target)."""
        stored = self.pods.get(pod.uid)
        if stored is None:
            raise KeyError(f"pod {pod.namespace}/{pod.name} not found")
        new = copy.copy(stored)
        new.node_name = node_name
        new.resource_version = next(self._rv_counter)
        self.pods[pod.uid] = new
        self.bindings[pod.uid] = node_name
        for h in self._pod_handlers:
            h("update", stored, new)
