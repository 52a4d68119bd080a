"""String interning for the device mirror.

Everything string-ish in the API objects (taint keys/values, label key=value
pairs, topology values, node names) must become small dense integer ids before
it can live in device tensors (SURVEY.md §7.2: "everything string-ish must be
interned host-side"). Id 0 is always the reserved empty/absent sentinel so
device code can use `== 0` for "unset" and padding.
"""

from __future__ import annotations

from typing import Dict, Hashable, List


class Codebook:
    """Monotonic hashable→dense-int interner. Id 0 is reserved for the empty
    sentinel (``""`` by default); ids are never reused or reordered, so device
    rows built against an older codebook stay valid as it grows."""

    __slots__ = ("_ids", "_items")

    def __init__(self, sentinel: Hashable = ""):
        self._ids: Dict[Hashable, int] = {sentinel: 0}
        self._items: List[Hashable] = [sentinel]

    def intern(self, item: Hashable) -> int:
        i = self._ids.get(item)
        if i is None:
            i = len(self._items)
            self._ids[item] = i
            self._items.append(item)
        return i

    def lookup(self, item: Hashable) -> int:
        """Id of an already-interned item, or -1 if unseen. -1 never equals
        any stored id, so lookups of unseen values compare false on device."""
        return self._ids.get(item, -1)

    def item(self, i: int) -> Hashable:
        return self._items[i]

    def __len__(self) -> int:
        return len(self._items)

    def __contains__(self, item: Hashable) -> bool:
        return item in self._ids


# Fixed taint-effect encoding shared by host feature extraction and the device
# kernel (api/types.py NO_SCHEDULE/PREFER_NO_SCHEDULE/NO_EXECUTE).
EFFECT_EMPTY = 0
EFFECT_NO_SCHEDULE = 1
EFFECT_PREFER_NO_SCHEDULE = 2
EFFECT_NO_EXECUTE = 3

EFFECT_IDS = {
    "": EFFECT_EMPTY,
    "NoSchedule": EFFECT_NO_SCHEDULE,
    "PreferNoSchedule": EFFECT_PREFER_NO_SCHEDULE,
    "NoExecute": EFFECT_NO_EXECUTE,
}

# Toleration operator encoding.
OP_EQUAL = 0
OP_EXISTS = 1
