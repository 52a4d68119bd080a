"""Label sets and label selectors.

Re-implements the matching semantics of staging/src/k8s.io/apimachinery/pkg/labels
(Selector/Requirement) and apimachinery/pkg/apis/meta/v1 LabelSelector
(matchLabels + matchExpressions) — the predicate language every affinity /
spread / selector feature in the scheduler is written in.

The device path never evaluates these structures directly: selectors are
evaluated host-side into per-node masks and per-domain count tables
(ops/features.py build_batch).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Optional, Sequence

# Operators — apimachinery/pkg/apis/meta/v1/types.go LabelSelectorOperator and
# pkg/labels selection.Operator.
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"


@dataclass(frozen=True)
class Requirement:
    """One selector requirement: key op values."""

    key: str
    operator: str
    values: tuple = ()

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        op = self.operator
        if op == EXISTS:
            return has
        if op == DOES_NOT_EXIST:
            return not has
        if not has:
            return False
        v = labels[self.key]
        if op == IN:
            return v in self.values
        if op == NOT_IN:
            return v not in self.values
        if op in (GT, LT):
            # Gt/Lt: both sides must parse as integers
            # (apimachinery labels.Requirement.Matches).
            try:
                lhs = int(v)
                rhs = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return lhs > rhs if op == GT else lhs < rhs
        raise ValueError(f"unknown operator {op!r}")


@dataclass(frozen=True)
class LabelSelector:
    """metav1.LabelSelector: matchLabels AND matchExpressions, all ANDed.

    A None selector matches nothing; an empty selector matches everything
    (metav1 LabelSelectorAsSelector semantics).
    """

    match_labels: tuple = ()  # tuple of (key, value) pairs, sorted
    match_expressions: tuple = ()  # tuple of Requirement

    @classmethod
    def of(
        cls,
        match_labels: Optional[Mapping[str, str]] = None,
        match_expressions: Optional[Sequence[Requirement]] = None,
    ) -> "LabelSelector":
        ml = tuple(sorted((match_labels or {}).items()))
        me = tuple(match_expressions or ())
        return cls(match_labels=ml, match_expressions=me)

    def matches(self, labels: Mapping[str, str]) -> bool:
        for k, v in self.match_labels:
            if labels.get(k) != v:
                return False
        for req in self.match_expressions:
            if not req.matches(labels):
                return False
        return True

    def is_empty(self) -> bool:
        return not self.match_labels and not self.match_expressions
