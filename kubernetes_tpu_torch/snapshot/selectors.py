"""Selector compilation: API selector trees → interned requirement rows.

A *conjunction* (CompiledRequirements) is the unit: a LabelSelector compiles
to one conjunction; a NodeSelector (OR of terms) compiles to a list of them
(DNF).  The schema packer pads these into dense int32 tensors; the kernels
evaluate them with pure vectorized compares (ops/common.py eval_table and
kernel K1).

Node field selectors (metadata.name) are folded into the label tables: every
packed node carries an implicit pseudo-label ``metadata.name`` → its name, so
matchFields evaluates through the same path as matchExpressions (the
reference special-cases this in component-helpers nodeaffinity; we make it
uniform, which also preserves the O(1) PreFilterResult narrowing as a plain
mask).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from kubernetes_tpu_torch.api import labels as k8slabels
from kubernetes_tpu_torch.api.types import (
    LabelSelector,
    NodeSelector,
    NodeSelectorTerm,
)
from kubernetes_tpu_torch.snapshot.interner import INT_INVALID, Vocab

OP_IN = 0
OP_NOT_IN = 1
OP_EXISTS = 2
OP_DOES_NOT_EXIST = 3
OP_GT = 4
OP_LT = 5

_OP_CODE = {
    k8slabels.IN: OP_IN,
    k8slabels.NOT_IN: OP_NOT_IN,
    k8slabels.EXISTS: OP_EXISTS,
    k8slabels.DOES_NOT_EXIST: OP_DOES_NOT_EXIST,
    k8slabels.GT: OP_GT,
    k8slabels.LT: OP_LT,
}

METADATA_NAME_KEY = "metadata.name"


@dataclass
class CompiledRequirements:
    """One conjunction of interned requirements.

    ``match_nothing`` encodes both the nil-LabelSelector case and the empty
    NodeSelectorTerm case.  With no requirements and not match_nothing, the
    conjunction matches everything.
    """

    keys: List[int] = field(default_factory=list)
    ops: List[int] = field(default_factory=list)
    vals: List[List[int]] = field(default_factory=list)  # per-req value-id set
    rhs_int: List[int] = field(default_factory=list)  # Gt/Lt right-hand side
    match_nothing: bool = False

    def add(self, key: str, op: str, values: Sequence[str], vocab: Vocab) -> None:
        self.keys.append(vocab.label_keys.intern(key))
        code = _OP_CODE[op]
        self.ops.append(code)
        self.vals.append([vocab.intern_val(v) for v in values])
        if code in (OP_GT, OP_LT) and values:
            try:
                self.rhs_int.append(int(values[0]))
            except ValueError:
                self.rhs_int.append(INT_INVALID)
        else:
            self.rhs_int.append(0)

    @property
    def n_reqs(self) -> int:
        return len(self.keys)


MATCH_NOTHING = CompiledRequirements(match_nothing=True)
MATCH_EVERYTHING = CompiledRequirements()


def compile_label_selector(
    ls: Optional[LabelSelector], vocab: Vocab
) -> CompiledRequirements:
    """LabelSelector → one conjunction (None ⇒ match nothing)."""
    if ls is None:
        return CompiledRequirements(match_nothing=True)
    c = CompiledRequirements()
    if ls.match_labels:
        for k, v in sorted(ls.match_labels.items()):
            c.add(k, k8slabels.IN, (v,), vocab)
    for e in ls.match_expressions or ():
        c.add(e.key, e.operator, tuple(e.values or ()), vocab)
    return c


def compile_node_selector_term(
    term: NodeSelectorTerm, vocab: Vocab
) -> CompiledRequirements:
    if not term.match_expressions and not term.match_fields:
        return CompiledRequirements(match_nothing=True)
    c = CompiledRequirements()
    for e in term.match_expressions:
        c.add(e.key, e.operator, tuple(e.values), vocab)
    for f in term.match_fields:
        # Only metadata.name In/NotIn are valid field selectors; anything else
        # can never match (api validation rejects it anyway).
        if f.key != METADATA_NAME_KEY or f.operator not in (
            k8slabels.IN,
            k8slabels.NOT_IN,
        ):
            return CompiledRequirements(match_nothing=True)
        c.add(METADATA_NAME_KEY, f.operator, tuple(f.values), vocab)
    return c


def compile_node_selector_dnf(
    sel: Optional[NodeSelector], vocab: Vocab
) -> List[CompiledRequirements]:
    """NodeSelector → DNF (list of ORed conjunctions).

    Returns [] for None (caller treats as "no constraint").
    """
    if sel is None:
        return []
    return [compile_node_selector_term(t, vocab) for t in sel.node_selector_terms]


def compile_match_labels_conjunction(
    match_labels: Optional[dict], vocab: Vocab
) -> CompiledRequirements:
    """pod.spec.nodeSelector (plain map) → conjunction."""
    c = CompiledRequirements()
    for k, v in sorted((match_labels or {}).items()):
        c.add(k, k8slabels.IN, (v,), vocab)
    return c
