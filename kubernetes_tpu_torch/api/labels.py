"""Label selector semantics.

Host-side reference semantics of k8s label selectors
(staging/src/k8s.io/apimachinery/pkg/labels/selector.go) and of the
LabelSelector API type conversion
(apimachinery/pkg/apis/meta/v1/helper: LabelSelectorAsSelector).

The device kernels (kubernetes_tpu_torch/ops) evaluate interned compilations of
these; this module is the golden scalar semantics they are tested against.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Mapping, Optional

# Operators (labels.selection in the reference).
IN = "In"
NOT_IN = "NotIn"
EXISTS = "Exists"
DOES_NOT_EXIST = "DoesNotExist"
GT = "Gt"
LT = "Lt"

_OPS = {IN, NOT_IN, EXISTS, DOES_NOT_EXIST, GT, LT}


@dataclass(frozen=True)
class Requirement:
    """key <op> values — one conjunct of a selector."""

    key: str
    op: str
    values: tuple = ()

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown selector operator {self.op!r}")
        object.__setattr__(self, "values", tuple(self.values))

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.op == EXISTS:
            return has
        if self.op == DOES_NOT_EXIST:
            return not has
        if self.op == IN:
            return has and labels[self.key] in self.values
        if self.op == NOT_IN:
            # NotIn matches when the key is present with a value outside the
            # set — and ALSO when the key is absent (labels.Requirement.Matches).
            return not has or labels[self.key] not in self.values
        # Gt/Lt: value must exist and parse as integer on both sides
        # (labels/selector.go: non-integer ⇒ no match).
        if not has:
            return False
        try:
            lv = int(labels[self.key])
            rv = int(self.values[0])
        except (ValueError, IndexError):
            return False
        return lv > rv if self.op == GT else lv < rv


@dataclass(frozen=True)
class Selector:
    """Conjunction of requirements. Empty selector matches everything.

    ``match_nothing`` encodes labels.Nothing() — the selector produced from a
    nil LabelSelector, which matches no objects.
    """

    requirements: tuple = ()
    match_nothing: bool = False

    def __post_init__(self):
        object.__setattr__(self, "requirements", tuple(self.requirements))

    def matches(self, labels: Mapping[str, str]) -> bool:
        if self.match_nothing:
            return False
        return all(r.matches(labels) for r in self.requirements)

    @property
    def empty(self) -> bool:
        return not self.match_nothing and not self.requirements


NOTHING = Selector(match_nothing=True)
EVERYTHING = Selector()


def selector_from_map(match_labels: Optional[Mapping[str, str]]) -> Selector:
    if not match_labels:
        return EVERYTHING
    return Selector(
        tuple(Requirement(k, IN, (v,)) for k, v in sorted(match_labels.items()))
    )


def selector_from_label_selector(ls) -> Selector:
    """LabelSelector (matchLabels + matchExpressions) → Selector.

    ``None`` → Nothing (matches no objects); empty selector → Everything.
    Mirrors metav1.LabelSelectorAsSelector.
    """
    if ls is None:
        return NOTHING
    reqs: List[Requirement] = []
    if ls.match_labels:
        for k, v in sorted(ls.match_labels.items()):
            reqs.append(Requirement(k, IN, (v,)))
    for e in ls.match_expressions or ():
        reqs.append(Requirement(e.key, e.operator, tuple(e.values or ())))
    return Selector(tuple(reqs))
