"""NodeDeclaredFeatures (the reference fork's nodedeclaredfeatures plugin):
a pod that names features in its `features.k8s.io/required` annotation
fits only nodes that declare each of them (Node.declared_features). The
JAX package's plugins/extras.py:27-47; its DeferredPodScheduling is not in
the default profile and is not ported."""

from __future__ import annotations

from ..api.types import Pod
from ..core.framework import OK, CycleState, Status
from ..core.node_info import NodeInfo

REQUIRED_FEATURES_ANNOTATION = "features.k8s.io/required"


def required_features(pod: Pod) -> list:
    """The features `pod` requires, in annotation order, blanks dropped."""
    return [f.strip() for f in pod.annotations.get(REQUIRED_FEATURES_ANNOTATION, "").split(",")
            if f.strip()]


class NodeDeclaredFeatures:
    """Filter: every feature the pod requires must be declared true by the
    node."""

    name = "NodeDeclaredFeatures"

    def filter(self, state: CycleState, pod: Pod, node_info: NodeInfo) -> Status:
        declared = node_info.node.declared_features if node_info.node else {}
        for feat in required_features(pod):
            if not declared.get(feat, False):
                return Status.unschedulable("node(s) didn't declare required feature " + feat)
        return OK

    def sign(self, pod: Pod):
        return pod.annotations.get(REQUIRED_FEATURES_ANNOTATION, "")
