"""Dynamic Resource Allocation (DRA) API objects, structured parameters
(the JAX package's api/dra.py).

The scheduling-relevant slices of resource.k8s.io/v1: a ResourceSlice
publishes one node's devices for one driver, a ResourceClaim requests
devices by class, attribute equality and a selector expression, and a
DeviceClass names a device category (and may back an extended resource).
The reference's CEL device selectors are a restricted Python expression
here (compile_device_expression), with CEL's quantity typing.
"""

from __future__ import annotations

import ast as _ast
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .resource import parse_quantity
from .types import _next_uid


@dataclass
class Device:
    name: str
    attributes: Dict[str, str] = field(default_factory=dict)
    capacity: Dict[str, str] = field(default_factory=dict)
    # Node-allocatable resources this device consumes when allocated
    # (nodeallocatabledynamicresources.go), e.g. {"cpu": "2", "memory": "4Gi"}.
    consumes: Dict[str, str] = field(default_factory=dict)


@dataclass
class ResourceSlice:
    """One node's devices for one driver."""

    node_name: str
    driver: str
    devices: List[Device] = field(default_factory=list)


@dataclass
class DeviceClass:
    """A named device category: `selectors` are attribute equalities every
    matching device satisfies. `extended_resource_name` maps a v1 extended
    resource (e.g. example.com/gpu) onto the class: pods requesting it are
    satisfied through DRA where no device plugin advertises it
    (extendeddynamicresources.go)."""

    name: str
    selectors: Dict[str, str] = field(default_factory=dict)
    extended_resource_name: str = ""


@dataclass
class DeviceRequest:
    """One request of a claim (spec.devices.requests[*])."""

    name: str = "req"
    device_class: str = ""
    count: int = 1
    selectors: Dict[str, str] = field(default_factory=dict)
    # The CEL-equivalent selector (compile_device_expression), evaluated per
    # candidate device beside the equality selectors.
    expression: str = ""


@dataclass
class AllocatedDevice:
    driver: str
    device: str

    def key(self) -> Tuple[str, str]:
        return (self.driver, self.device)


@dataclass
class ResourceClaim:
    name: str = ""
    namespace: str = "default"
    uid: str = ""
    requests: List[DeviceRequest] = field(default_factory=list)
    # status
    allocated_node: str = ""                      # "": unallocated
    allocations: List[AllocatedDevice] = field(default_factory=list)
    reserved_for: List[str] = field(default_factory=list)  # pod uids

    def __post_init__(self):
        if not self.uid:
            self.uid = _next_uid("claim")

    @property
    def key(self) -> str:
        return f"{self.namespace}/{self.name}"

    @property
    def allocated(self) -> bool:
        return bool(self.allocated_node)


# ---------------------------------------------------------------------------
# Device selector expressions: the structured-parameters CEL equivalent
# (dynamic-resource-allocation/cel; DeviceSelector.cel.expression), e.g.
#
#     device.attributes["gpu.example.com/model"] == "a100"
#     device.capacity["memory"] >= 40 and device.driver == "gpu.example.com"
#
# The AST is checked against a whitelist (comparisons, boolean logic,
# arithmetic, subscripts of device.attributes and device.capacity,
# literals): no calls, no imports, no dunder access. Compiled once a
# request, evaluated a device.
# ---------------------------------------------------------------------------

_ALLOWED_NODES = (
    _ast.Expression, _ast.BoolOp, _ast.And, _ast.Or, _ast.UnaryOp, _ast.Not,
    _ast.USub, _ast.Compare, _ast.Eq, _ast.NotEq, _ast.Lt, _ast.LtE, _ast.Gt,
    _ast.GtE, _ast.In, _ast.NotIn, _ast.BinOp, _ast.Add, _ast.Sub, _ast.Mult,
    _ast.Div, _ast.Mod, _ast.Constant, _ast.Name, _ast.Load, _ast.Attribute,
    _ast.Subscript, _ast.Index, _ast.Tuple, _ast.List,
)


class ExpressionError(ValueError):
    """An invalid or disallowed device selector expression."""


class _ConstCoercer(_ast.NodeTransformer):
    """Coerce quantity-shaped string literals once, at compile time, as
    CEL types quantity constants: `"40Gi"` compared with
    `device.attributes[...]` or `device.capacity[...]` becomes its number,
    bound to an injected name, so that every comparison at run time is
    numeric on both sides (the map values are coerced once a device). The
    coerced classes then need no string equality, and their __eq__ stays
    consistent with their int/float __hash__.

    Only the direct comparator operands (and their tuple or list members,
    for `in`) of a comparison that involves one of the two maps are
    coerced: subscript keys (`device.attributes["8"]` looks up the string
    "8") and comparisons with the string fields (`device.name == "0"`) keep
    their strings. A chained comparison that mixes a string field and a map
    (`device.name == "8" == device.attributes["c"]`) reads its literals as
    quantities: CEL has no chained comparisons. Runs after validation, so
    the injected names cannot collide with an identifier (only `device` is
    legal)."""

    def __init__(self):
        self.bindings = {}

    @staticmethod
    def _qty_map_operand(n) -> bool:
        return (isinstance(n, _ast.Subscript)
                and isinstance(n.value, _ast.Attribute)
                and n.value.attr in ("attributes", "capacity"))

    def _coerce_const(self, node):
        if isinstance(node, _ast.Constant) and isinstance(node.value, str):
            coerced = _CoercingMap._coerce(node.value)
            if not isinstance(coerced, str):
                name = f"_qty{len(self.bindings)}"
                self.bindings[name] = coerced
                return _ast.copy_location(_ast.Name(id=name, ctx=_ast.Load()), node)
        elif isinstance(node, (_ast.Tuple, _ast.List)):
            node.elts = [self._coerce_const(e) for e in node.elts]
        return node

    def visit_Compare(self, node):
        self.generic_visit(node)  # comparisons nested in the operands first
        operands = [node.left] + list(node.comparators)
        if any(self._qty_map_operand(o) for o in operands):
            node.left = self._coerce_const(node.left)
            node.comparators = [self._coerce_const(c) for c in node.comparators]
        return node


def compile_device_expression(expr: str):
    """Validate and compile a device selector expression. Returns a callable
    (device, driver) -> bool; raises ExpressionError on disallowed syntax."""
    try:
        tree = _ast.parse(expr, mode="eval")
    except SyntaxError as e:
        raise ExpressionError(f"invalid expression: {e}") from e
    for node in _ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ExpressionError(
                f"disallowed syntax {type(node).__name__!r} in device expression")
        if isinstance(node, _ast.Name) and node.id != "device":
            raise ExpressionError(f"unknown identifier {node.id!r}")
        if isinstance(node, _ast.Attribute):
            if node.attr.startswith("__") or node.attr not in (
                    "attributes", "capacity", "driver", "name"):
                raise ExpressionError(f"unknown device field {node.attr!r}")
    coercer = _ConstCoercer()
    tree = _ast.fix_missing_locations(coercer.visit(tree))
    qty_consts = coercer.bindings
    code = compile(tree, "<device-selector>", "eval")

    class _DeviceView:
        __slots__ = ("attributes", "capacity", "driver", "name")

        def __init__(self, device, driver):
            # The coerced maps are memoized on the device (the coercion
            # costs more than the match), keyed on the raw maps' identities:
            # a slice update replaces the maps (they are never edited in
            # place), which drops the memo.
            raw_cap = getattr(device, "capacity", None)
            memo = device.__dict__.get("_coerced_memo")
            if memo is None or memo[0] is not device.attributes or memo[1] is not raw_cap:
                memo = device._coerced_memo = (
                    device.attributes, raw_cap,
                    _CoercingMap.coerced(device.attributes),
                    _CoercingMap.coerced(raw_cap or {}))
            self.attributes = memo[2]
            self.capacity = memo[3]
            self.driver = driver
            self.name = device.name

    def matcher(device, driver="") -> bool:
        try:
            env = {"device": _DeviceView(device, driver)}
            if qty_consts:
                env.update(qty_consts)
            return bool(eval(code, {"__builtins__": {}}, env))  # noqa: S307 - AST-whitelisted
        except Exception:
            # A CEL runtime error makes the device not match.
            return False

    return matcher


class _CoercingMap(dict):
    """An attribute or capacity map whose values compare numerically where
    they are numbers, with quantity semantics for suffixed strings (the
    typed CEL surface: device.capacity["memory"] >= 40 * 1024**3 holds for
    "40Gi"). A missing key reads None."""

    @classmethod
    def coerced(cls, raw: Dict[str, str]) -> "_CoercingMap":
        out = cls()
        for k, v in raw.items():
            out[k] = cls._coerce(v)
        return out

    @staticmethod
    def _coerce(v):
        if isinstance(v, str):
            try:
                return _QtyInt(int(v))
            except ValueError:
                pass
            try:
                return _QtyFloat(float(v))
            except ValueError:
                pass
            try:
                q = parse_quantity(v)
                iq = int(q)
                return _QtyInt(iq) if q == iq else _QtyFloat(float(q))
            except Exception:
                return v
        return v

    def __getitem__(self, key):
        return dict.get(self, key)


class _QtyMixin:
    """Coerced quantity values. Equality is numeric only (the int or float
    __eq__ and __hash__: equal objects hash equal, so coerced values mix
    with any other form in a set or a dict). `device.capacity["mem"] ==
    "40Gi"` still holds because the expression's literals are coerced at
    compile time (_ConstCoercer). Ordering coerces a string operand
    (`qty >= "32Gi"`); ordering has no hash contract."""

    __slots__ = ()

    def _other(self, other):
        if isinstance(other, str):
            return _CoercingMap._coerce(other)
        return other

    def __lt__(self, other):
        return super().__lt__(self._other(other))

    def __le__(self, other):
        return super().__le__(self._other(other))

    def __gt__(self, other):
        return super().__gt__(self._other(other))

    def __ge__(self, other):
        return super().__ge__(self._other(other))


class _QtyInt(_QtyMixin, int):
    pass


class _QtyFloat(_QtyMixin, float):
    pass
