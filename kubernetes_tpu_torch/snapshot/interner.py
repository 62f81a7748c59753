"""String interning tables.

Every string the kernels touch becomes a dense int32 id.  Separate namespaces
keep the hot tables small:

- label *keys* index the columns of the per-node / per-pod dense label-value
  matrices, so their id space must stay compact;
- label *values* share one table, with a side array of parsed-integer values
  to support Gt/Lt selector operators on device;
- namespaces and extended-resource names get their own tables.

Interners are append-only: ids are stable for the life of the process, which
is what lets the HBM mirror be updated incrementally (a label seen once keeps
its column forever).  Sentinels: -1 = "absent", -2 = "padding".
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

ABSENT = -1
PAD = -2

# Sentinel for label values that don't parse as integers (Gt/Lt never match).
INT_INVALID = -(2**31) + 1


class Interner:
    """Append-only str → int32 id table."""

    def __init__(self) -> None:
        self._ids: Dict[str, int] = {}
        self._strs: List[str] = []

    def intern(self, s: str) -> int:
        i = self._ids.get(s)
        if i is None:
            i = len(self._strs)
            self._ids[s] = i
            self._strs.append(s)
        return i

    def lookup(self, s: str) -> int:
        """Id for s, or ABSENT if never interned (read-only path)."""
        return self._ids.get(s, ABSENT)

    def string(self, i: int) -> str:
        return self._strs[i]

    def __len__(self) -> int:
        return len(self._strs)

    def __contains__(self, s: str) -> bool:
        return s in self._ids


def _parse_label_int(s: str) -> int:
    """Label value as integer for Gt/Lt, or INT_INVALID."""
    try:
        v = int(s)
    except ValueError:
        return INT_INVALID
    # Clamp into int32 so device compares stay valid.
    return max(min(v, 2**31 - 1), -(2**31) + 2)


@dataclass
class Vocab:
    """The full interning state shared by cache, snapshot and kernels."""

    label_keys: Interner = field(default_factory=Interner)
    label_vals: Interner = field(default_factory=Interner)
    namespaces: Interner = field(default_factory=Interner)
    resources: Interner = field(default_factory=Interner)  # extended resources
    node_names: Interner = field(default_factory=Interner)
    ports: Interner = field(default_factory=Interner)  # "proto:port" and host IPs
    images: Interner = field(default_factory=Interner)  # container image names

    # Parsed-integer view of label_vals (same indexing), grown lazily.
    _val_ints: List[int] = field(default_factory=list)

    def intern_label(self, key: str, val: str) -> tuple[int, int]:
        return self.label_keys.intern(key), self.intern_val(val)

    def intern_val(self, val: str) -> int:
        i = self.label_vals.intern(val)
        while len(self._val_ints) < len(self.label_vals):
            self._val_ints.append(
                _parse_label_int(self.label_vals.string(len(self._val_ints)))
            )
        return i

    def val_ints(self) -> List[int]:
        """Dense id → parsed-int table (len == len(label_vals))."""
        while len(self._val_ints) < len(self.label_vals):
            self._val_ints.append(
                _parse_label_int(self.label_vals.string(len(self._val_ints)))
            )
        return self._val_ints
