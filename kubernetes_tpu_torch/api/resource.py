"""Resource quantities and aggregate resource vectors.

Re-expresses the reference's resource model (staging/src/k8s.io/apimachinery
/pkg/api/resource and pkg/scheduler/framework/types.go `Resource` struct,
reference framework/types.go around NodeInfo) in a flat, vector-friendly form:
CPU is canonicalised to integer millicores, everything else to integer base
units (bytes / counts), so that node state can be mirrored onto fixed-width
device tensors without string math on the hot path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from decimal import Decimal
from typing import Dict, Iterable, Mapping, Optional

# Well-known resource names (reference: staging/src/k8s.io/api/core/v1/types.go
# ResourceCPU/ResourceMemory/... constants).
CPU = "cpu"
MEMORY = "memory"
EPHEMERAL_STORAGE = "ephemeral-storage"
PODS = "pods"

HUGEPAGES_PREFIX = "hugepages-"
ATTACHABLE_VOLUMES_PREFIX = "attachable-volumes-"

_BINARY_SUFFIXES = {
    "Ki": 1024,
    "Mi": 1024**2,
    "Gi": 1024**3,
    "Ti": 1024**4,
    "Pi": 1024**5,
    "Ei": 1024**6,
}
_DECIMAL_SUFFIXES = {
    "n": Decimal("1e-9"),
    "u": Decimal("1e-6"),
    "m": Decimal("1e-3"),
    "": Decimal(1),
    "k": Decimal("1e3"),
    "M": Decimal("1e6"),
    "G": Decimal("1e9"),
    "T": Decimal("1e12"),
    "P": Decimal("1e15"),
    "E": Decimal("1e18"),
}


def parse_quantity(value) -> Decimal:
    """Parse a Kubernetes quantity string ("100m", "1.5Gi", "2") to a Decimal.

    Mirrors apimachinery resource.Quantity parsing for the suffix set the
    scheduler actually encounters; exotic exponent forms ("12e6") included.
    """
    if isinstance(value, (int, float, Decimal)):
        return Decimal(str(value))
    s = value.strip()
    if not s:
        raise ValueError("empty quantity")
    for suf, mult in _BINARY_SUFFIXES.items():
        if s.endswith(suf):
            return Decimal(s[: -len(suf)]) * mult
    # longest decimal suffixes first (single-char)
    if s[-1] in _DECIMAL_SUFFIXES and not s[-1].isdigit():
        return Decimal(s[:-1]) * _DECIMAL_SUFFIXES[s[-1]]
    return Decimal(s)


def cpu_to_milli(value) -> int:
    """CPU quantity -> integer millicores (rounds up, as Quantity.MilliValue does)."""
    d = parse_quantity(value) * 1000
    return int(d.to_integral_value(rounding="ROUND_CEILING"))


def to_int(value) -> int:
    """Non-CPU quantity -> integer base units (rounds up)."""
    d = parse_quantity(value)
    return int(d.to_integral_value(rounding="ROUND_CEILING"))


@dataclass
class Resource:
    """Aggregate resource vector.

    Mirrors the reference scheduler's Resource struct
    (pkg/scheduler/framework/types.go: MilliCPU/Memory/EphemeralStorage/
    AllowedPodNumber/ScalarResources) — the unit system the Filter/Score
    kernels operate in.
    """

    milli_cpu: int = 0
    memory: int = 0
    ephemeral_storage: int = 0
    allowed_pod_number: int = 0
    scalar_resources: Dict[str, int] = field(default_factory=dict)

    @classmethod
    def from_map(cls, m: Optional[Mapping[str, object]]) -> "Resource":
        r = cls()
        if not m:
            return r
        for name, q in m.items():
            r.set(name, q)
        return r

    def set(self, name: str, quantity) -> None:
        if name == CPU:
            self.milli_cpu = cpu_to_milli(quantity)
        elif name == MEMORY:
            self.memory = to_int(quantity)
        elif name == EPHEMERAL_STORAGE:
            self.ephemeral_storage = to_int(quantity)
        elif name == PODS:
            self.allowed_pod_number = to_int(quantity)
        else:
            self.scalar_resources[name] = to_int(quantity)

    def get(self, name: str) -> int:
        if name == CPU:
            return self.milli_cpu
        if name == MEMORY:
            return self.memory
        if name == EPHEMERAL_STORAGE:
            return self.ephemeral_storage
        if name == PODS:
            return self.allowed_pod_number
        return self.scalar_resources.get(name, 0)

    def add(self, other: "Resource") -> None:
        self.milli_cpu += other.milli_cpu
        self.memory += other.memory
        self.ephemeral_storage += other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) + v

    def sub(self, other: "Resource") -> None:
        self.milli_cpu -= other.milli_cpu
        self.memory -= other.memory
        self.ephemeral_storage -= other.ephemeral_storage
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = self.scalar_resources.get(k, 0) - v

    def set_max(self, other: "Resource") -> None:
        """Component-wise max (used for init-container folding)."""
        self.milli_cpu = max(self.milli_cpu, other.milli_cpu)
        self.memory = max(self.memory, other.memory)
        self.ephemeral_storage = max(self.ephemeral_storage, other.ephemeral_storage)
        for k, v in other.scalar_resources.items():
            self.scalar_resources[k] = max(self.scalar_resources.get(k, 0), v)

    def clone(self) -> "Resource":
        return Resource(
            milli_cpu=self.milli_cpu,
            memory=self.memory,
            ephemeral_storage=self.ephemeral_storage,
            allowed_pod_number=self.allowed_pod_number,
            scalar_resources=dict(self.scalar_resources),
        )

    def is_zero(self) -> bool:
        return (
            self.milli_cpu == 0
            and self.memory == 0
            and self.ephemeral_storage == 0
            and all(v == 0 for v in self.scalar_resources.values())
        )

    def names(self) -> Iterable[str]:
        yield CPU
        yield MEMORY
        yield EPHEMERAL_STORAGE
        yield from self.scalar_resources.keys()
