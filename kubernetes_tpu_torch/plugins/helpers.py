"""Shared plugin helpers: compiled affinity terms and namespace resolution.

Mirrors pkg/scheduler/framework/types.go AffinityTerm (the precompiled form of
v1.PodAffinityTerm) and util helpers in pkg/scheduler/util. Read by
InterPodAffinity and by the device batch builder (ops/features.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from ..api.labels import IN, LabelSelector, Requirement
from ..api.types import Pod, PodAffinityTerm


@dataclass(frozen=True)
class AffinityTerm:
    """Precompiled affinity term (framework/types.go AffinityTerm):
    namespaces resolved to a set, selector merged with matchLabelKeys."""

    namespaces: frozenset
    selector: Optional[LabelSelector]
    topology_key: str
    namespace_selector: Optional[LabelSelector]

    def matches(self, pod: Pod, ns_labels_fn) -> bool:
        """Does `pod` match this term? ns_labels_fn(ns) -> labels dict or None."""
        in_ns = pod.namespace in self.namespaces
        if not in_ns and self.namespace_selector is not None:
            labels = ns_labels_fn(pod.namespace) if ns_labels_fn else None
            in_ns = labels is not None and self.namespace_selector.matches(labels)
        if not in_ns:
            return False
        if self.selector is None:
            return False
        return self.selector.matches(pod.labels)


def compile_term(term: PodAffinityTerm, owner: Pod) -> AffinityTerm:
    """GetAffinityTerms/newAffinityTerm: default namespaces to the owner pod's
    namespace when neither namespaces nor namespaceSelector is given; merge
    matchLabelKeys/mismatchLabelKeys from the owner's labels into the selector
    (MatchLabelKeysInPodAffinity, reference plugin.go mergeAffinityTermsLabelKeys)."""
    namespaces = frozenset(term.namespaces) if term.namespaces else (
        frozenset() if term.namespace_selector is not None else frozenset((owner.namespace,))
    )
    selector = term.label_selector
    extra_reqs = []
    for key in term.match_label_keys:
        if key in owner.labels:
            extra_reqs.append(Requirement(key, IN, (owner.labels[key],)))
    for key in term.mismatch_label_keys:
        if key in owner.labels:
            extra_reqs.append(Requirement(key, "NotIn", (owner.labels[key],)))
    if extra_reqs and selector is not None:
        selector = LabelSelector(
            match_labels=selector.match_labels,
            match_expressions=selector.match_expressions + tuple(extra_reqs),
        )
    return AffinityTerm(
        namespaces=namespaces,
        selector=selector,
        topology_key=term.topology_key,
        namespace_selector=term.namespace_selector,
    )


def compile_terms(terms: Sequence[PodAffinityTerm], owner: Pod):
    return tuple(compile_term(t, owner) for t in terms)
