"""Dynamic Resource Allocation in the PyTorch port against the JAX
reference, on the CPU.

Expressions: compile_device_expression of both packages on seeded devices
and on the expressions of tests/test_dra.py, the rejected ones included;
the quantity coercion and its hash and equality contract. Eligibility:
dra_device_support for each reason, count_free_matching_devices on each
node, batch_supported's claim branch and build_batch's aux_room, aux_inc
and has_aux for claim counts 1 and 2. Schedulers: each scenario of
tests/test_dra.py through the JAX package's host Scheduler and the port's
(`host`), and through TPUScheduler (CPU JAX, no mesh) and
TorchScheduler(device="cpu"), score hints off in both (`device`) and on in
both (`device-hints`), with
the profile DEFAULT_PLUGINS + NodeDeclaredFeatures + DynamicResources
(core/registry.py dra_profile), its gated branches off (the JAX defaults)
and on: bindings, claim allocations, reservedFor, scheduled and failure
counts, queue counts and, on the device, the device and host-path pods
are equal. Then the claim-template cut of the bench shape against the JAX
perf harness, a profile without DynamicResources, gangs of claim pods, a
2-shard node mesh, and the commit's lean tail against its full tail.
Every comparison is exact."""

import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kubernetes_tpu.api import dra as jax_dra
from kubernetes_tpu.api import storage as jax_storage
from kubernetes_tpu.api.types import PodGroup as JaxPodGroup
from kubernetes_tpu.api.types import Volume as JaxVolume
from kubernetes_tpu.core.clientset import FakeClientset as JaxClientset
from kubernetes_tpu.core.config import SchedulerConfiguration
from kubernetes_tpu.core.registry import DEFAULT_PLUGINS, build_framework
from kubernetes_tpu.core.scheduler import Scheduler as JaxScheduler
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.ops import features as jax_features
from kubernetes_tpu.plugins.dynamicresources import (
    allocate_pending_claims as jax_allocate_pending_claims,
)
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch import bench
from kubernetes_tpu_torch.api import dra
from kubernetes_tpu_torch.api import storage
from kubernetes_tpu_torch.api.types import PodGroup, Volume
from kubernetes_tpu_torch.core.clientset import FakeClientset
from kubernetes_tpu_torch.core.framework import Framework
from kubernetes_tpu_torch.core.registry import default_profile, dra_profile, gang_placement_profile
from kubernetes_tpu_torch.core.scheduler import Scheduler
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import features
from kubernetes_tpu_torch.plugins.basic import DefaultBinder
from kubernetes_tpu_torch.plugins.dynamicresources import allocate_pending_claims
from kubernetes_tpu_torch.testing import make_node, make_pod

JAX = SimpleNamespace(make_node=jax_make_node, make_pod=jax_make_pod, dra=jax_dra,
                      st=jax_storage, Volume=JaxVolume, PodGroup=JaxPodGroup,
                      Clientset=JaxClientset, features=jax_features)
PORT = SimpleNamespace(make_node=make_node, make_pod=make_pod, dra=dra, st=storage,
                       Volume=Volume, PodGroup=PodGroup, Clientset=FakeClientset,
                       features=features)

JAX_DRA_PLUGINS = DEFAULT_PLUGINS + (("NodeDeclaredFeatures", 0), ("DynamicResources", 0))
GATES = {"DynamicResourceAllocation": True, "DRAExtendedResource": True,
         "DRANodeAllocatableResources": True}
A100 = 'device.attributes["model"] == "a100"'


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# device selector expressions
# ---------------------------------------------------------------------------

# The expressions of tests/test_dra.py, and more over the same surface.
EXPRESSIONS = [
    'device.attributes["model"] == "a100" and device.attributes["mem"] >= 32',
    'device.attributes["model"] == "h100"',
    'device.attributes["model"] == "t4"',
    A100,
    'device.capacity["memory"] >= 42949672960',
    'device.capacity["memory"] == "40Gi"',
    'device.capacity["memory"] == 42949672960',
    'device.attributes["count"] == "8"',
    'device.attributes["count"] >= "4"',
    'device.capacity["memory"] == "16Gi"',
    'device.attributes["8"] == "yes"',
    'device.name == "0"',
    'device.name == "1"',
    'device.attributes["count"] in ("4", "8")',
    'device.attributes["model"] in ("a100", "h100")',
    'device.capacity["memory"] >= "32Gi"',
    'device.capacity["memory"] in ["40Gi", "80Gi"]',
    'device.attributes["count"] * 2 == 16',
    'device.attributes["count"] % 3 == 2',
    '-device.attributes["count"] < -4',
    'device.capacity["memory"] / 1024 > 1',
    'not device.attributes["model"] == "a100"',
    'device.attributes["model"] != "t4" or device.driver == "drv-b"',
    'device.attributes["mem"] < 20 and device.attributes["missing"] == None',
    'device.attributes["model"] + "x" == "a100x"',
    'device.name == "8" == device.attributes["count"]',
    'device.attributes["count"] > device.attributes["mem"]',
]
REJECTED = ['__import__("os").system("true")', 'open("/etc/passwd")', 'device.__class__',
            'x + 1', 'device.foo', 'lambda: 1', 'device.attributes["a"](1)',
            '[d for d in (1,)]', 'device.attributes[', 'device.name.upper()']


def _devices(kit, seed, n=40):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        attrs = {"model": str(rng.choice(["a100", "h100", "t4"])),
                 "count": str(rng.choice(["8", "4", "16", "2.5"])),
                 "mem": str(rng.choice(["40", "16", "2.5", "32Gi"]))}
        if rng.random() < 0.3:
            attrs["8"] = str(rng.choice(["yes", "no"]))
        cap = {"memory": str(rng.choice(["40Gi", "80Gi", "16Gi", "42949672960", "1.5Ti",
                                          "bogus", "500M"]))}
        out.append(kit.dra.Device(name=str(rng.choice(["0", "1", "8", f"gpu-{i}"])),
                                  attributes=attrs, capacity=cap))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expressions_match_like_jax_on_seeded_devices(seed):
    jdevs, tdevs = _devices(JAX, seed), _devices(PORT, seed)
    for expr in EXPRESSIONS:
        jm, tm = jax_dra.compile_device_expression(expr), dra.compile_device_expression(expr)
        for j, (jd, td) in enumerate(zip(jdevs, tdevs)):
            driver = "drv-a" if j % 2 else "drv-b"
            assert jm(jd, driver) == tm(td, driver), (expr, td)


@pytest.mark.parametrize("expr", REJECTED)
def test_rejected_expressions_like_jax(expr):
    with pytest.raises(jax_dra.ExpressionError) as je:
        jax_dra.compile_device_expression(expr)
    with pytest.raises(dra.ExpressionError) as te:
        dra.compile_device_expression(expr)
    assert str(je.value) == str(te.value)


@pytest.mark.parametrize("value", ["8", "2.5", "40Gi", "1.5Ti", "500M", "100m", "a100", "",
                                   "-3", "1e3", "0x10", "Gi"])
def test_quantity_coercion_like_jax(value):
    a, b = jax_dra._CoercingMap._coerce(value), dra._CoercingMap._coerce(value)
    assert type(a).__name__ == type(b).__name__ and a == b
    assert isinstance(b, str) or hash(b) == hash(a)


def test_quantity_hash_eq_consistency():
    q8, q25, qgi = (dra._CoercingMap._coerce(v) for v in ("8", "2.5", "40Gi"))
    forms = [q8, "8", 8, q25, 2.5, "2.5", qgi, 40 * 1024 ** 3, "40Gi"]
    for a in forms:
        for b in forms:
            if a == b:
                assert hash(a) == hash(b), (a, b)
    s = {q8, "8", 8}
    assert len(s) == 2 and 8 in s and "8" in s
    d = {q8: "qty", "8": "raw"}
    assert len(d) == 2 and d[8] == "qty" and d["8"] == "raw"
    assert qgi >= "32Gi" and q8 < "16"


def test_coerced_memo_invalidates_on_map_replacement():
    for kit in (JAX, PORT):
        d = kit.dra.Device(name="d", attributes={"model": "a100"})
        m = kit.dra.compile_device_expression(A100)
        assert m(d, "drv")
        d.attributes = {"model": "h100"}
        assert not m(d, "drv")
        assert kit.dra.compile_device_expression('device.attributes["model"] == "h100"')(d, "drv")


# ---------------------------------------------------------------------------
# eligibility, free devices and the aux lane's inputs
# ---------------------------------------------------------------------------


def _claim(kit, name, count=1, expression="", selectors=None, device_class="", requests=1,
           namespace="default"):
    return kit.dra.ResourceClaim(name=name, namespace=namespace, requests=[
        kit.dra.DeviceRequest(name=f"r{i}", count=count, expression=expression,
                              selectors=dict(selectors or {}), device_class=device_class)
        for i in range(requests)])


def _slices(kit, cs, n_nodes=6, devices=4):
    """Node i's slice: `devices` devices, model a100 for j < i % 3 + 1, else
    t4, and a second driver's slice on even nodes."""
    for i in range(n_nodes):
        cs.create_resource_slice(kit.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.x",
            devices=[kit.dra.Device(name=f"n{i}-d{j}", attributes={
                "model": "a100" if j < i % 3 + 1 else "t4", "index": str(j)})
                for j in range(devices)]))
        if i % 2 == 0:
            cs.create_resource_slice(kit.dra.ResourceSlice(
                node_name=f"n{i}", driver="fpga.y",
                devices=[kit.dra.Device(name=f"n{i}-f0", attributes={"model": "a100"})]))


SUPPORT_CASES = {
    "no claims": (lambda kit, cs, p: None, None),
    "two claims": (lambda kit, cs, p: p.resource_claims.extend(["c", "c2"]), None),
    "no clientset": (lambda kit, cs, p: p.resource_claims.append("c"), "none"),
    "missing claim": (lambda kit, cs, p: p.resource_claims.append("nope"), None),
    "allocated": (lambda kit, cs, p: (p.resource_claims.append("c"),
                                      setattr(cs.resource_claims["default/c"],
                                              "allocated_node", "n0")), None),
    "reserved": (lambda kit, cs, p: (p.resource_claims.append("c"),
                                     cs.resource_claims["default/c"].reserved_for.append("u")),
                 None),
    "consuming devices": (lambda kit, cs, p: (p.resource_claims.append("c"),
                                              cs.create_resource_slice(kit.dra.ResourceSlice(
                                                  node_name="n1", driver="z", devices=[
                                                      kit.dra.Device("z0", consumes={
                                                          "cpu": "1"})]))), None),
    "shared in session": (lambda kit, cs, p: p.resource_claims.append("c"), "session"),
    "multi-request": (lambda kit, cs, p: p.resource_claims.append("multi"), None),
    "template": (lambda kit, cs, p: p.resource_claims.append("c"), None),
}


@pytest.mark.parametrize("case", list(SUPPORT_CASES))
def test_dra_device_support_like_jax(case):
    setup, arg = SUPPORT_CASES[case]
    out = []
    for kit in (JAX, PORT):
        cs = kit.Clientset()
        cs.create_resource_claim(_claim(kit, "c", count=2, expression=A100,
                                        selectors={"index": "0"}, device_class="gpu"))
        cs.create_resource_claim(_claim(kit, "c2"))
        cs.create_resource_claim(_claim(kit, "multi", requests=2))
        p = kit.make_pod().name("p").obj()
        setup(kit, cs, p)
        session = {"dra:default/c"} if arg == "session" else set()
        args = (p, None if arg == "none" else cs) + ((set(),) if kit is JAX else ())
        out.append(kit.features.dra_device_support(*args, session))
    assert out[0] == out[1]
    assert (out[1][0] is None) == (case in ("no claims", "template"))


SHAPES = [("", 1, (), ""), ("", 2, (), A100), ("gpu", 1, (), ""), ("", 1, (("index", "1"),), ""),
          ("gpu", 3, (("index", "0"),), 'device.attributes["index"] >= 0'),
          ("missing-class", 1, (), 'device.name == "n2-d0"')]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"shape{i}" for i in range(len(SHAPES))])
def test_count_free_matching_devices_like_jax(shape):
    counts = []
    for kit in (JAX, PORT):
        cs = kit.Clientset()
        _slices(kit, cs)
        cs.create_device_class(kit.dra.DeviceClass(name="gpu", selectors={"model": "a100"}))
        in_use = {("n1", "gpu.x", "n1-d0"), ("n2", "gpu.x", "n2-d1"), ("n0", "fpga.y", "n0-f0"),
                  ("n3", "gpu.x", "n4-d0")}
        counts.append([kit.features.count_free_matching_devices(cs, f"n{i}", shape, in_use)
                       for i in range(7)])
    assert counts[0] == counts[1] and sum(counts[1]) > 0


def _limited_volume(kit, cs, pod, driver):
    pv = kit.st.PersistentVolume.of("pv-v", "1Gi", access_modes=(kit.st.ROX,), csi_driver=driver)
    pvc = kit.st.PersistentVolumeClaim.of("v", "1Gi", access_modes=(kit.st.ROX,))
    pv.claim_ref = pvc.key
    pvc.volume_name = pv.name
    cs.create_pv(pv)
    cs.create_pvc(pvc)
    pod.volumes.append(kit.Volume(name="data", pvc_name="v"))


@pytest.mark.parametrize("volume", ["", "limited", "unlimited"])
@pytest.mark.parametrize("dra_on", [False, True], ids=["inert", "dra"])
def test_batch_supported_claim_branch_like_jax(dra_on, volume):
    """A claim pod batches as plain without DynamicResources; with it, its
    claim admits it unless an attach limit counts too."""
    out = []
    for kit in (JAX, PORT):
        cs = kit.Clientset()
        cs.create_resource_claim(_claim(kit, "c"))
        pod = kit.make_pod().name("p").obj()
        pod.resource_claims.append("c")
        if volume:
            _limited_volume(kit, cs, pod, "ebs" if volume == "limited" else "other")
        vol = kit.features.volume_device_support(pod, cs, {}, frozenset({"ebs"}))
        dra_in_use = set() if dra_on else None
        if kit is JAX:
            out.append(jax_features.batch_supported(
                pod, None, clientset=cs, pvc_refs={}, limited_drivers=frozenset({"ebs"}),
                dra_enabled=dra_on, dra_in_use=dra_in_use, session_claims=set()))
        else:
            d = features.dra_device_support(pod, cs, set()) if dra_on else None
            out.append(features.batch_supported(pod, vol, d))
    assert out[0] == out[1]
    assert (out[1] is None) == (not dra_on or volume != "limited")


def _dra_cluster(s, kit, n_nodes=6, in_use_claims=True):
    cs = s.clientset
    for i in range(n_nodes):
        cs.create_node(kit.make_node().name(f"n{i}").capacity(
            {"cpu": "16", "memory": "32Gi", "pods": 20}).obj())
    _slices(kit, cs, n_nodes)
    cs.create_device_class(kit.dra.DeviceClass(name="gpu", selectors={"model": "a100"}))
    if in_use_claims:
        for i, (node, dev) in enumerate((("n2", "n2-d0"), ("n4", "n4-d1"), ("n5", "n5-d2"))):
            c = _claim(kit, f"held-{i}")
            c.allocated_node = node
            c.allocations = [kit.dra.AllocatedDevice("gpu.x", dev)]
            cs.create_resource_claim(c)


def _jax_factory(plugins=JAX_DRA_PLUGINS):
    return lambda h: {"default-scheduler": build_framework(h, plugins=plugins)}


def _tpu(gates=False, plugins=JAX_DRA_PLUGINS, hints=False, **kw):
    """TPUScheduler with the DRA profile, score hints on or off."""
    cfg = SchedulerConfiguration(feature_gates=dict(GATES)) if gates else None
    s = TPUScheduler(mesh=None, config=cfg, profile_factory=_jax_factory(plugins), **kw)
    s._hints.enabled = hints
    return s


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


def _port_profile(gates=False):
    return functools.partial(dra_profile, extended_resources=True,
                             node_allocatable=True) if gates else dra_profile


@pytest.mark.parametrize("count", [1, 2])
def test_build_batch_dra_aux_lane_like_jax(count):
    """build_batch's aux_room (each row's free devices the claim matches,
    AUX_BIG past the rows), aux_inc (the request's count) and has_aux equal
    the JAX package's."""
    plans = []
    for s, kit in ((_tpu(), JAX), (TorchScheduler(device="cpu", profile_factory=dra_profile),
                                   PORT)):
        _dra_cluster(s, kit)
        s.clientset.create_resource_claim(_claim(kit, "c", count=count, device_class="gpu"))
        pod = kit.make_pod().name("p").req({"cpu": "100m"}).obj()
        pod.resource_claims.append("c")
        _state, plan = s.build_plan(s.profiles["default-scheduler"], pod, 8)
        plans.append(plan)
    jplan, tplan = plans
    np.testing.assert_array_equal(np.asarray(jplan.features.aux_room),
                                  tplan.features.aux_room.numpy())
    assert int(np.asarray(jplan.features.aux_inc)) == int(tplan.features.aux_inc) == count
    assert jplan.has_aux and tplan.facts.has_aux
    assert tplan.features.aux_room.numpy()[:6].tolist() == [2, 2, 3, 1, 2, 2]
    assert tplan.features.aux_room[6:].eq(features.AUX_BIG).all()


def test_dra_profile_like_jax_build_framework():
    """dra_profile: the JAX build_framework(DEFAULT_PLUGINS + NodeDeclaredFeatures +
    DynamicResources), plugin for plugin and weight for weight, and each
    extension point in the same order."""
    jfw = _tpu().profiles["default-scheduler"]
    tfw = TorchScheduler(device="cpu", profile_factory=dra_profile).profiles["default-scheduler"]
    assert [(p.name, w) for p, w in jfw._plugins] == [(p.name, w) for p, w in tfw._plugins]
    for point in ("pre_filter_plugins", "filter_plugins", "reserve_plugins", "pre_bind_plugins",
                  "permit_plugins", "bind_plugins", "post_bind_plugins"):
        assert ([p.name for p in getattr(jfw, point)]
                == [p.name for p in getattr(tfw, point)]), point
    dr = tfw.plugin("DynamicResources")
    assert not dr.extended_resources and not dr.node_allocatable


# ---------------------------------------------------------------------------
# the scenarios of tests/test_dra.py, through both packages
# ---------------------------------------------------------------------------


def _gpu_node(kit, cs, name, n_gpus, gpu_type="a100"):
    cs.create_node(kit.make_node().name(name).capacity({"cpu": "16", "pods": 20}).obj())
    cs.create_resource_slice(kit.dra.ResourceSlice(
        node_name=name, driver="gpu.example.com",
        devices=[kit.dra.Device(name=f"{name}-gpu{i}", attributes={"type": gpu_type})
                 for i in range(n_gpus)]))


def _claim_pod(kit, cs, pod_name, claim_name, count=1, selectors=None, device_class="",
               expression="", cpu="1"):
    cs.create_resource_claim(kit.dra.ResourceClaim(name=claim_name, requests=[
        kit.dra.DeviceRequest(count=count, selectors=selectors or {},
                              device_class=device_class, expression=expression)]))
    p = kit.make_pod().name(pod_name).req({"cpu": cpu}).obj()
    p.resource_claims.append(claim_name)
    cs.create_pod(p)


def _expr_cluster(kit, cs):
    for i in range(4):
        cs.create_node(kit.make_node().name(f"n{i}").capacity(
            {"cpu": 8, "memory": "32Gi", "pods": 110}).obj())
        model = "a100" if i % 2 == 0 else "t4"
        cs.create_resource_slice(kit.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.example.com",
            devices=[kit.dra.Device(name=f"gpu-{i}-{j}", attributes={
                "model": model, "mem": "40" if model == "a100" else "16"}) for j in range(2)]))


def _allocates(kit, cs, run):
    _gpu_node(kit, cs, "cpu-only", 0)
    _gpu_node(kit, cs, "gpu-node", 2)
    _claim_pod(kit, cs, "p", "claim-a", count=2)
    run()


def _exclusive(kit, cs, run):
    _gpu_node(kit, cs, "gpu-node", 1)
    _claim_pod(kit, cs, "p1", "c1")
    _claim_pod(kit, cs, "p2", "c2")
    run()


def _selector(kit, cs, run):
    _gpu_node(kit, cs, "a100-node", 1, gpu_type="a100")
    _gpu_node(kit, cs, "h100-node", 1, gpu_type="h100")
    _claim_pod(kit, cs, "p", "c", selectors={"type": "h100"})
    run()


def _device_class(kit, cs, run):
    cs.create_device_class(kit.dra.DeviceClass(name="big-gpu", selectors={"type": "h100"}))
    _gpu_node(kit, cs, "small", 4, gpu_type="a100")
    _gpu_node(kit, cs, "big", 1, gpu_type="h100")
    _claim_pod(kit, cs, "p", "c", device_class="big-gpu")
    run()


def _preallocated(kit, cs, run):
    _gpu_node(kit, cs, "n0", 1)
    _gpu_node(kit, cs, "n1", 1)
    claim = kit.dra.ResourceClaim(name="pinned", requests=[kit.dra.DeviceRequest(count=1)])
    claim.allocated_node = "n1"
    cs.create_resource_claim(claim)
    p = kit.make_pod().name("p").req({"cpu": "1"}).obj()
    p.resource_claims.append("pinned")
    cs.create_pod(p)
    run()


def _missing(kit, cs, run):
    _gpu_node(kit, cs, "n0", 1)
    p = kit.make_pod().name("p").req({"cpu": "1"}).obj()
    p.resource_claims.append("no-such-claim")
    cs.create_pod(p)
    run()


def _expr_match(kit, cs, run):
    _expr_cluster(kit, cs)
    _claim_pod(kit, cs, "train", "big-gpu",
               expression='device.attributes["model"] == "a100" and '
                          'device.attributes["mem"] >= 32')
    run()


def _expr_no_match(kit, cs, run):
    _expr_cluster(kit, cs)
    _claim_pod(kit, cs, "train", "h100", expression='device.attributes["model"] == "h100"')
    run()


def _extended_backed(kit, cs, run):
    cs.create_node(kit.make_node().name("n0").capacity({"cpu": "8", "pods": 10}).obj())
    cs.create_resource_slice(kit.dra.ResourceSlice(
        node_name="n0", driver="gpu.example.com",
        devices=[kit.dra.Device(name=f"gpu-{i}") for i in range(4)]))
    cs.create_device_class(kit.dra.DeviceClass(name="gpus",
                                               extended_resource_name="example.com/gpu"))
    cs.create_pod(kit.make_pod().name("p").req({"cpu": "1", "example.com/gpu": 2}).obj())
    run()


def _extended_by_plugin(kit, cs, run):
    cs.create_node(kit.make_node().name("n0").capacity(
        {"cpu": "8", "pods": 10, "example.com/gpu": 4}).obj())
    cs.create_device_class(kit.dra.DeviceClass(name="gpus",
                                               extended_resource_name="example.com/gpu"))
    cs.create_pod(kit.make_pod().name("p").req({"cpu": "1", "example.com/gpu": 2}).obj())
    run()


def _consumption(kit, cs, run):
    cs.create_node(kit.make_node().name("n0").capacity({"cpu": "4", "pods": 10}).obj())
    cs.create_resource_slice(kit.dra.ResourceSlice(
        node_name="n0", driver="x.csi", devices=[kit.dra.Device(name="d0",
                                                                consumes={"cpu": "3"})]))
    _claim_pod(kit, cs, "p", "c", cpu="2")
    run()
    _claim_pod(kit, cs, "p2", "c2", cpu="1")
    run()


def _claim_template(kit, cs, run):
    for i in range(8):
        cs.create_node(kit.make_node().name(f"n{i}").capacity({"cpu": "32", "pods": 110}).obj())
        cs.create_resource_slice(kit.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.x",
            devices=[kit.dra.Device(name=f"n{i}-d{j}",
                                    attributes={"model": "a100" if j < 2 else "v100"})
                     for j in range(4)]))
    for i in range(20):  # 20 pods, one matching device each; 16 exist
        _claim_pod(kit, cs, f"p{i}", f"c{i}", expression=A100, cpu="100m")
    run()


def _claim_template_two(kit, cs, run):
    """Claims of two devices, two waves: the lane's increment is 2, and the
    second wave's plan counts the devices the first allocated."""
    for i in range(6):
        cs.create_node(kit.make_node().name(f"n{i}").capacity({"cpu": "32", "pods": 110}).obj())
        cs.create_resource_slice(kit.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.x",
            devices=[kit.dra.Device(name=f"n{i}-d{j}", attributes={"model": "a100"})
                     for j in range(i % 4 + 1)]))
    for wave in range(2):
        for i in range(5):
            _claim_pod(kit, cs, f"w{wave}-{i}", f"w{wave}-c{i}", count=2, expression=A100,
                       cpu="100m")
        run()


SCENARIOS = {
    "allocates-on-fitting-node": _allocates, "devices-are-exclusive": _exclusive,
    "selector-matching": _selector, "device-class-selectors": _device_class,
    "preallocated-claim-pins-node": _preallocated, "missing-claim-unresolvable": _missing,
    "expression-picks-matching": _expr_match, "expression-no-match": _expr_no_match,
    "extended-resources-backed-by-dra": _extended_backed,
    "extended-resources-by-device-plugin": _extended_by_plugin,
    "node-allocatable-consumption": _consumption,
    "claim-template-pods": _claim_template, "claim-template-count-2": _claim_template_two,
}
GATED = ("extended-resources-backed-by-dra", "extended-resources-by-device-plugin",
         "node-allocatable-consumption")


def _outcome(s, device: bool):
    cs = s.clientset
    names = {p.uid: p.name for p in cs.pods.values()}
    pods = {p.name: p.node_name for p in cs.pods.values()}
    claims = {k: (c.allocated_node, [(a.driver, a.device) for a in c.allocations],
                  [names.get(u, "<deleted pod>") for u in c.reserved_for])
              for k, c in cs.resource_claims.items()}
    status = {p.name: getattr(p, "extended_resource_claim_status", None)
              for p in cs.pods.values()}
    counts = [s.scheduled, s.failures, s.queue.pending_counts()]
    if device:
        counts += [s.device_scheduled, s.host_path_pods]
    return pods, claims, status, counts


def _run_pair(scenario, kind: str, gates: bool):
    if kind == "host":
        cfg = SchedulerConfiguration(feature_gates=dict(GATES)) if gates else None
        jax_s = JaxScheduler(clientset=JaxClientset(), deterministic_ties=True, config=cfg,
                             profile_factory=_jax_factory())
        port_s = Scheduler(profile_factory=_port_profile(gates))
    else:
        hints = kind == "device-hints"
        jax_s = _tpu(gates, hints=hints)
        port_s = TorchScheduler(device="cpu", profile_factory=_port_profile(gates),
                                score_hints=hints)
    for s, kit in ((jax_s, JAX), (port_s, PORT)):
        SCENARIOS[scenario](kit, s.clientset, s.run_until_idle)
    got, want = _outcome(port_s, kind != "host"), _outcome(jax_s, kind != "host")
    assert got == want
    return port_s


@pytest.mark.parametrize("kind", ["host", "device", "device-hints"])
@pytest.mark.parametrize("scenario,gates", [(n, False) for n in SCENARIOS]
                         + [(n, True) for n in GATED],
                         ids=[n for n in SCENARIOS] + [f"{n}-gates-on" for n in GATED])
def test_dra_scenario_like_jax(scenario, gates, kind):
    s = _run_pair(scenario, kind, gates)
    cs = s.clientset
    bound = {p.name: p.node_name for p in cs.pods.values()}
    if scenario == "allocates-on-fitting-node":
        assert bound == {"p": "gpu-node"}
        assert len(cs.resource_claims["default/claim-a"].allocations) == 2
    elif scenario == "devices-are-exclusive":
        assert s.scheduled == 1
    elif scenario == "extended-resources-backed-by-dra":
        claim = cs.resource_claims.get("default/p-extended-resources")
        assert (bound["p"] == "n0" and claim is not None
                and len(claim.allocations) == 2) == gates
    elif scenario == "node-allocatable-consumption":
        assert bound == ({"p": "", "p2": "n0"} if gates else {"p": "n0", "p2": ""})
    elif scenario == "claim-template-pods":
        assert sum(1 for v in bound.values() if v) == 16
        if kind != "host":
            assert s.device_scheduled >= 14
        for p in cs.pods.values():
            claim = cs.resource_claims[f"default/{p.resource_claims[0]}"]
            assert claim.allocated_node == p.node_name
            assert len(claim.allocations) == (1 if p.node_name else 0)


@pytest.mark.parametrize("kit", [JAX, PORT], ids=["jax", "port"])
def test_alloc_claims_opcode_respects_expressions(kit):
    cs = kit.Clientset()
    _expr_cluster(kit, cs)
    for i in range(3):
        cs.create_resource_claim(_claim(kit, f"c{i}", expression='device.attributes["model"] '
                                                                 '== "t4"'))
    rv = cs.resource_claims_rv
    n = (jax_allocate_pending_claims if kit is JAX else allocate_pending_claims)(cs)
    assert n == 3 and cs.resource_claims_rv == rv + 1
    assert {cs.resource_claims[f"default/c{i}"].allocated_node for i in range(3)} <= {"n1", "n3"}


def test_alloc_claims_opcode_like_jax():
    got = []
    for kit, fn in ((JAX, jax_allocate_pending_claims), (PORT, allocate_pending_claims)):
        cs = kit.Clientset()
        _slices(kit, cs)
        cs.create_device_class(kit.dra.DeviceClass(name="gpu", selectors={"model": "a100"}))
        for i, (count, cls, expr) in enumerate([(1, "gpu", ""), (2, "", A100), (3, "", ""),
                                                (1, "", 'device.name == "n5-d3"'),
                                                (2, "gpu", ""), (9, "", "")]):
            cs.create_resource_claim(_claim(kit, f"c{i}", count=count, device_class=cls,
                                            expression=expr))
        n = fn(cs)
        got.append((n, {k: (c.allocated_node, [(a.driver, a.device) for a in c.allocations])
                        for k, c in cs.resource_claims.items()}))
    assert got[0] == got[1] and got[1][0] == 5


# ---------------------------------------------------------------------------
# claim pods on the device: profiles, gangs, the mesh, the bench cut
# ---------------------------------------------------------------------------


def test_claim_pods_inert_without_dynamic_resources_like_jax(hints):
    """The JAX package's default profile has no DynamicResources: a pod's
    claims (even one that does not exist) are inert, and it binds on the
    device as a plain pod."""
    outs = []
    for s, kit in ((_tpu(plugins=DEFAULT_PLUGINS, hints=hints), JAX),
                   (TorchScheduler(device="cpu", score_hints=hints), PORT)):
        cs = s.clientset
        for i in range(4):
            cs.create_node(kit.make_node().name(f"n{i}").capacity({"cpu": "4", "pods": 10}).obj())
        cs.create_resource_claim(_claim(kit, "real"))
        for i in range(12):
            p = kit.make_pod().name(f"p{i}").req({"cpu": "500m"}).obj()
            p.resource_claims.append("real" if i % 2 else f"ghost-{i}")
            cs.create_pod(p)
        s.run_until_idle()
        outs.append(_outcome(s, True))
    assert outs[0] == outs[1]
    pods, claims, _status, counts = outs[1]
    assert all(pods.values()) and counts[3] == 12 and claims["default/real"][0] == ""


def test_claim_gangs_take_the_host_group_cycle_like_jax(hints):
    """Gang members with claims never ride a gang device session: the host
    group cycle allocates each member's devices, as in JAX, and each group
    counts once as a host-path entity."""
    outs = []
    for s, kit in ((_tpu(hints=hints), JAX),
                   (TorchScheduler(device="cpu", profile_factory=dra_profile, score_hints=hints),
                    PORT)):
        _dra_cluster(s, kit)
        cs = s.clientset
        for g in range(3):
            cs.create_pod_group(kit.PodGroup(name=f"g{g}", min_count=3))
            for j in range(3):
                cs.create_resource_claim(_claim(kit, f"g{g}-c{j}", device_class="gpu"))
                p = kit.make_pod().name(f"g{g}-{j}").req({"cpu": "100m"}).obj()
                p.resource_claims.append(f"g{g}-c{j}")
                p.pod_group = f"g{g}"
                cs.create_pod(p)
        s.run_until_idle()
        outs.append(_outcome(s, True))
    assert outs[0] == outs[1]
    pods, _claims, _status, counts = outs[1]
    assert counts[3] == 0 and counts[4] == 3 and all(pods.values())


def test_claim_pods_under_a_node_mesh_like_jax(hints):
    """The claim-template scenario under a 2-shard NodeMesh on the CPU (the
    aux lane's plan is not row-local: the gathered schedule_batch) equals
    TPUScheduler under its mesh of the conftest's virtual devices."""
    from kubernetes_tpu.parallel import make_mesh as jax_make_mesh
    from kubernetes_tpu_torch.parallel import make_mesh

    jax_s = TPUScheduler(mesh=jax_make_mesh(n_cells=1), profile_factory=_jax_factory())
    jax_s._hints.enabled = hints
    port_s = TorchScheduler(device="cpu", profile_factory=dra_profile, score_hints=hints,
                            mesh=make_mesh(devices=["cpu"] * 2))
    for s, kit in ((jax_s, JAX), (port_s, PORT)):
        _claim_template(kit, s.clientset, s.run_until_idle)
    assert _outcome(port_s, True) == _outcome(jax_s, True)
    assert port_s.device_scheduled >= 14 and port_s.shard_map_dispatches == 0


W = "SchedulingWithResourceClaimTemplate/500Nodes_2000Pods"


def test_bench_claim_template_cut_like_the_jax_harness(monkeypatch, hints):
    """The bench shape at 50 nodes and 200 measured pods: the JAX perf
    harness's own workload (its createPods run synchronously, as the port's
    bench creates them) and the port's bench give the same scheduled,
    device and host-path pods and device batches; every claim holds one
    a100 device on its pod's node, none held twice."""
    from kubernetes_tpu.perf import harness

    wl = next(w for w in harness.load_config("kubernetes_tpu/perf/configs/"
                                             "performance-config.yaml")
              if w.testcase == "SchedulingWithResourceClaimTemplate")
    wl.params = {"nodes": 50, "measurePods": 200}

    class Synchronous:
        blocks_idle = False

        def __init__(self, fn):
            fn()

        def tick(self):
            return False

    monkeypatch.setattr(harness, "_ThreadedCreator", Synchronous)
    jax_s = _tpu(plugins=DEFAULT_PLUGINS + (("DynamicResources", 0),), hints=hints)
    harness.run_workload(wl, sched=jax_s)
    w = bench.WORKLOADS[W]
    s = bench.build_cluster(50, device="cpu", node=w.node, profile_factory=bench.profile_for(W),
                            score_hints=hints)
    bench.warm(s, w.init_pods, W)
    result = bench.measure(s, 200, workload=W)
    for c in ("scheduled", "failures", "device_scheduled", "host_path_pods", "device_batches"):
        assert getattr(s, c) == getattr(jax_s, c), c
    assert s.scheduled == s.device_scheduled == 201 and s.host_path_pods == 0
    assert result["detail"]["device_scheduled"] == 200
    held = set()
    for p in s.clientset.pods.values():
        claim = s.clientset.resource_claims[f"default/{p.name}-claim"]
        assert claim.allocated_node == p.node_name and claim.reserved_for == [p.uid]
        assert len(claim.allocations) == 1
        dev = claim.allocations[0]
        assert dev.device.startswith(p.node_name + "-dev") and (p.node_name, dev.key()) not in held
        held.add((p.node_name, dev.key()))


def test_claim_session_never_resumes_after_a_claim_write(hints):
    """The claims' revision is part of the resume key: a wave of claim pods
    after a claim was allocated out of band rebuilds its plan (its rooms
    would be stale), as in JAX."""
    outs = []
    for s, kit, fn in ((_tpu(hints=hints), JAX, jax_allocate_pending_claims),
                       (TorchScheduler(device="cpu", profile_factory=dra_profile,
                                       score_hints=hints), PORT, allocate_pending_claims)):
        cs = s.clientset
        for i in range(4):
            cs.create_node(kit.make_node().name(f"n{i}").capacity({"cpu": "8", "pods": 50}).obj())
            cs.create_resource_slice(kit.dra.ResourceSlice(
                node_name=f"n{i}", driver="gpu.x",
                devices=[kit.dra.Device(name=f"n{i}-d{j}", attributes={"model": "a100"})
                         for j in range(3)]))
        for wave in range(3):
            for i in range(3):
                _claim_pod(kit, cs, f"w{wave}-{i}", f"w{wave}-c{i}", expression=A100,
                           cpu="100m")
            s.run_until_idle()
            if wave == 0:
                cs.create_resource_claim(_claim(kit, "side", count=2))
                fn(cs)
        outs.append(_outcome(s, True) + ((s.plan_rebuilds_full, s.plan_rebuilds_delta,
                                          s.plan_rebuilds_resume),))
    assert outs[0] == outs[1]
    assert outs[1][4][2] == 0 and all(outs[1][0].values())


# ---------------------------------------------------------------------------
# the commit: the lean tail against the full tail
# ---------------------------------------------------------------------------


class _PostBind:
    name = "RecordsBinds"

    def __init__(self):
        self.seen = []

    def post_bind(self, state, pod, node_name):
        self.seen.append((pod.name, node_name))


class _NoBinder(DefaultBinder):
    name = "NoBinder"

    def bind(self, state, pod, node_name):
        from kubernetes_tpu_torch.core.framework import Status
        return Status.skip()


def _with(extra):
    def profile(handle):
        fw = dra_profile(handle)
        out = Framework(profile_name=fw.profile_name, plugins=fw._plugins + [(extra(handle), 0)])
        out.plugin("DefaultPreemption").set_framework(out)
        out.plugin("NodeResourcesFit").set_framework(out)
        return out
    return profile


PROFILES = {"dra": dra_profile, "default": default_profile,
            "gang-placement": gang_placement_profile,
            "postbind": _with(lambda h: _PostBind()),
            "second-binder": _with(lambda h: _NoBinder(h.clientset))}


def _commit_drive(kit, s):
    """Plain pods, attach-limited volume pods, claim pods (one short of
    devices), a too-big pod and a preemption: every tail of the commit."""
    cs = s.clientset
    for i in range(6):
        cs.create_node(kit.make_node().name(f"n{i}").capacity(
            {"cpu": "4", "memory": "16Gi", "pods": 12}).obj())
        cs.create_csi_node(kit.st.CSINode(node_name=f"n{i}", driver_limits={"ebs": 2}))
        cs.create_resource_slice(kit.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.x",
            devices=[kit.dra.Device(name=f"n{i}-d{j}", attributes={"model": "a100"})
                     for j in range(i % 2 + 1)]))
    for i in range(20):
        cs.create_pod(kit.make_pod().name(f"plain-{i}").req({"cpu": "250m"}).obj())
    s.run_until_idle()
    for i in range(8):
        pv = kit.st.PersistentVolume.of(f"pv-{i}", "1Gi", access_modes=(kit.st.ROX,),
                                        csi_driver="ebs")
        pvc = kit.st.PersistentVolumeClaim.of(f"v{i}", "1Gi", access_modes=(kit.st.ROX,))
        pv.claim_ref, pvc.volume_name = pvc.key, pv.name
        cs.create_pv(pv)
        cs.create_pvc(pvc)
        p = kit.make_pod().name(f"vol-{i}").req({"cpu": "100m"}).obj()
        p.volumes.append(kit.Volume(name="data", pvc_name=f"v{i}"))
        cs.create_pod(p)
    s.run_until_idle()
    for i in range(10):
        _claim_pod(kit, cs, f"claim-{i}", f"c{i}", expression=A100, cpu="100m")
    s.run_until_idle()
    cs.create_pod(kit.make_pod().name("big").req({"cpu": "64"}).obj())
    s.run_until_idle()
    for i in range(6):
        cs.create_pod(kit.make_pod().name(f"fill-{i}").req({"cpu": "2500m"}).obj())
    s.run_until_idle()
    cs.create_pod(kit.make_pod().name("urgent").req({"cpu": "3"}).priority(100).obj())
    s.run_until_idle()


def _commit_state(s):
    cache = s.cache
    names = {p.uid: p.name for p in s.clientset.pods.values()}
    return (_outcome(s, True),
            {p.name: p.node_name for p in cache.pod_states.values()},
            sorted(cache.pod_states[u].name for u in cache.assumed_pods),
            {n: (ni.requested.milli_cpu, len(ni.pods)) for n, ni in cache.nodes.items()},
            [(e.kind, e.key) for e in s.journal.since(0)],
            {names[u]: n for u, n in s.queue.nominator._pod_to_node.items()},
            (s.attempts, s.state_unwinds, s.preemption_counts()))


@pytest.mark.parametrize("profile", list(PROFILES))
def test_lean_commit_tail_leaves_what_the_full_tail_leaves(profile, monkeypatch):
    """The same drive with _commit_fast_eligible forced off and on: bindings,
    claims, cache state, counters, queue counts, the journal's events and
    the nominations are equal. The predicate takes the DRA and default
    profiles (whose Reserve and PreBind plugins are state-driven) and the
    gang placement profile (its Permit plugin acts on gang members only),
    and refuses a PostBind plugin and a second binder."""
    runs, fast = [], []
    for forced in (False, True):
        s = TorchScheduler(device="cpu", profile_factory=PROFILES[profile])
        real = TorchScheduler._commit_fast_eligible

        def eligible(fw, _s=s, _f=forced, _real=real):
            ok = _f and _real(_s, fw)
            fast.append(ok)
            return ok
        monkeypatch.setattr(s, "_commit_fast_eligible", eligible)
        _commit_drive(PORT, s)
        runs.append(_commit_state(s))
    assert runs[0] == runs[1]
    verdict = TorchScheduler(device="cpu", profile_factory=PROFILES[profile])
    ok = verdict._commit_fast_eligible(verdict.profiles["default-scheduler"])
    assert ok == (profile in ("dra", "default", "gang-placement")) and any(fast) == ok
    (pods, _claims, _status, counts), *_ = runs[1]
    assert counts[3] > 0 and counts[4] > 0 and pods["urgent"]


@pytest.mark.parametrize("profile", ["dra", "default"])
def test_commit_drive_like_jax(profile, hints):
    """The commit drive through TPUScheduler and TorchScheduler: bindings,
    claims, counters, queue counts and the journal's events equal."""
    plugins = JAX_DRA_PLUGINS if profile == "dra" else DEFAULT_PLUGINS + (
        ("NodeDeclaredFeatures", 0),)
    jax_s = _tpu(plugins=plugins, hints=hints)
    port_s = TorchScheduler(device="cpu", profile_factory=PROFILES[profile], score_hints=hints)
    _commit_drive(JAX, jax_s)
    _commit_drive(PORT, port_s)
    assert _outcome(port_s, True) == _outcome(jax_s, True)
    assert ([(e.kind, e.key) for e in port_s.journal.since(0)]
            == [(e.kind, e.key) for e in jax_s.journal.since(0)])
    assert port_s.preemption_counts()["victims"] > 0 and port_s.attempts == jax_s.attempts


def test_post_bind_runs_after_each_bind():
    """The PostBind extension point the lean tail's predicate checks: it
    runs once a bound pod, on the full tail."""
    s = TorchScheduler(device="cpu", profile_factory=PROFILES["postbind"])
    fw = s.profiles["default-scheduler"]
    for i in range(3):
        s.clientset.create_node(make_node().name(f"n{i}").capacity({"cpu": "4", "pods": 9}).obj())
    for i in range(5):
        s.clientset.create_pod(make_pod().name(f"p{i}").req({"cpu": "100m"}).obj())
    s.run_until_idle()
    seen = fw.plugin("RecordsBinds").seen
    assert len(seen) == 5 and sorted(seen) == sorted(
        (p.name, p.node_name) for p in s.clientset.pods.values())
