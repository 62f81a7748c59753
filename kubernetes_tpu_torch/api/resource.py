"""Resource quantities.

Semantics follow Kubernetes quantity parsing
(staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go) restricted to
what the scheduler consumes, and the scheduler's flattened ``Resource`` struct
(reference pkg/scheduler/framework/types.go:651-744): MilliCPU, Memory,
EphemeralStorage, AllowedPodNumber, ScalarResources.

CPU is tracked in integer millicores, everything else in integer base units
(bytes for memory/storage, counts for extended resources).  Keeping these as
ints on the host mirrors the reference exactly; the device snapshot packs them
into int32 lanes (see kubernetes_tpu_torch/snapshot).
"""

from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

# Binary and decimal suffixes accepted by Kubernetes quantities.
_BIN_SUFFIX = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DEC_SUFFIX = {
    "n": 10**-9,
    "u": 10**-6,
    "m": 10**-3,
    "": 1,
    "k": 10**3,
    "M": 10**6,
    "G": 10**9,
    "T": 10**12,
    "P": 10**15,
    "E": 10**18,
}

_QUANTITY_RE = re.compile(
    r"^(?P<sign>[+-]?)(?P<num>\d+(?:\.\d+)?|\.\d+)(?P<suffix>(?:[numkMGTPE]|[KMGTPE]i|e[+-]?\d+)?)$"
)

# Well-known resource names (subset the scheduler cares about).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

# Resources whose requests default to a non-zero value for spreading purposes
# (reference pkg/scheduler/framework/types.go:926 calculateResource /
# non-zero requests, util defaults: 100m CPU, 200Mi memory).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST = 200 * 1024 * 1024


def parse_quantity(s: str | int | float) -> float:
    """Parse a Kubernetes quantity string into a float of base units.

    Examples: "100m" → 0.1, "1Gi" → 1073741824, "2" → 2, "1e3" → 1000.

    String parses are memoized: workloads repeat a handful of distinct
    quantity strings across hundreds of thousands of pods, and the regex
    parse dominates compute_requests on large drains.
    """
    if isinstance(s, (int, float)):
        return float(s)
    return _parse_quantity_str(s)


@functools.lru_cache(maxsize=8192)
def _parse_quantity_str(s: str) -> float:
    s = s.strip()
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    sign = -1.0 if m.group("sign") == "-" else 1.0
    num = float(m.group("num"))
    suffix = m.group("suffix")
    if suffix in _BIN_SUFFIX:
        mult = float(_BIN_SUFFIX[suffix])
    elif suffix.startswith("e") or suffix.startswith("E"):
        mult = 10.0 ** float(suffix[1:])
    elif suffix in _DEC_SUFFIX:
        mult = _DEC_SUFFIX[suffix]
    else:
        raise ValueError(f"invalid quantity suffix: {s!r}")
    return sign * num * mult


def parse_cpu_millis(s: str | int | float) -> int:
    """CPU quantity → integer millicores (ceil, as MilliValue does)."""
    return int(math.ceil(parse_quantity(s) * 1000 - 1e-9))


def parse_int_quantity(s: str | int | float) -> int:
    """Non-CPU quantity → integer base units (ceil)."""
    return int(math.ceil(parse_quantity(s) - 1e-9))


@dataclass
class Resource:
    """Flattened resource vector (reference framework/types.go:651).

    ``milli_cpu`` in millicores; ``memory``/``ephemeral_storage`` in bytes;
    ``allowed_pod_number`` a count; ``scalars`` holds extended resources
    (e.g. "nvidia.com/gpu", hugepages-*) in base units.
    """

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalars: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_map(cls, m: Optional[Mapping[str, str | int | float]]) -> "Resource":
        r = cls()
        if not m:
            return r
        for name, q in m.items():
            r.set(name, q)
        return r

    def set(self, name: str, q: str | int | float) -> None:
        if name == CPU:
            self.milli_cpu = parse_cpu_millis(q)
        elif name == MEMORY:
            self.memory = parse_int_quantity(q)
        elif name == EPHEMERAL_STORAGE:
            self.ephemeral_storage = parse_int_quantity(q)
        elif name == PODS:
            self.allowed_pod_number = parse_int_quantity(q)
        else:
            self.scalars[name] = parse_int_quantity(q)

    def get(self, name: str) -> int:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if name == EPHEMERAL_STORAGE:
            return self.ephemeral_storage
        if name == PODS:
            return self.allowed_pod_number
        return self.scalars.get(name, 0)

    def add(self, other: "Resource") -> "Resource":
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalars.items():
            self.scalars[k] = self.scalars.get(k, 0) + v
        return self

    def sub(self, other: "Resource") -> "Resource":
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalars.items():
            self.scalars[k] = self.scalars.get(k, 0) - v
        return self

    def max_with(self, other: "Resource") -> "Resource":
        """Element-wise max (used for init-container folding)."""
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        self.ephemeral_storage = max(self.ephemeral_storage, other.ephemeral_storage)
        for k, v in other.scalars.items():
            self.scalars[k] = max(self.scalars.get(k, 0), v)
        return self

    def clone(self) -> "Resource":
        return Resource(
            milli_cpu=self.milli_cpu,
            memory=self.memory,
            ephemeral_storage=self.ephemeral_storage,
            allowed_pod_number=self.allowed_pod_number,
            scalars=dict(self.scalars),
        )

    def non_zero_defaulted(self) -> "Resource":
        """Copy with cpu/memory floored at the spreading defaults.

        Mirrors GetNonzeroRequests (reference uses it for the
        ``NonZeroRequested`` accounting that feeds scoring).
        """
        r = self.clone()
        if r.milli_cpu == 0:
            r.milli_cpu = DEFAULT_MILLI_CPU_REQUEST
        if r.memory == 0:
            r.memory = DEFAULT_MEMORY_REQUEST
        return r
