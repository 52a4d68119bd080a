"""The port's failure memo (TorchScheduler._fail_from_memo,
_memoize_failure and _fail_state_key) held against the JAX package's
(kubernetes_tpu/models/tpu_scheduler.py:1982-2085), on the CPU.

A pod the device places nowhere is diagnosed once against a state; an
identical pod against the same state (signature, priority, cluster events,
our binds, unwinds, nominations) parks from the memo without a rerun, and
the session goes on. Floods of alternating signatures, with binds, foreign
binds and a preemption's nomination between them, and claim pods that stay
unplaced across sessions, give the same bindings, attempts, failures,
host-path pods, device batches, plan acquisitions and queue counts in both
packages, score hints on (both defaults).
"""

import pytest
import torch

from kubernetes_tpu.api import dra as jax_dra
from kubernetes_tpu.core.registry import DEFAULT_PLUGINS, build_framework
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api import dra
from kubernetes_tpu_torch.core.registry import dra_profile
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

COUNTERS = ("attempts", "scheduled", "failures", "host_path_pods", "device_batches",
            "device_scheduled", "plan_rebuilds_full", "plan_rebuilds_delta",
            "plan_rebuilds_resume", "hint_hits", "hint_misses", "hint_invalidations")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


class Kit:
    """One scheduler with its package's builders, on a clock that moves a
    microsecond a read and 30 s between steps (`tick`): backoff expiry never
    depends on how long a package took, and queue timestamps stay distinct
    and in event order."""

    def __init__(self, kind, max_batch=64, claims=False):
        self.kind = kind
        self.clock = [1000.0]
        if kind == "jax":
            kw = {}
            if claims:
                plugins = DEFAULT_PLUGINS + (("NodeDeclaredFeatures", 0), ("DynamicResources", 0))
                kw["profile_factory"] = lambda h: {
                    "default-scheduler": build_framework(h, plugins=plugins)}
            self.s = TPUScheduler(mesh=None, max_batch=max_batch, **kw)
            self.mk_node, self.mk_pod, self.dra = jax_make_node, jax_make_pod, jax_dra
        else:
            kw = {"profile_factory": dra_profile} if claims else {}
            self.s = TorchScheduler(device="cpu", max_batch=max_batch, **kw)
            self.mk_node, self.mk_pod, self.dra = make_node, make_pod, dra
        self.cs = self.s.clientset
        self.s.now = self.s.queue.now = self.now

    def now(self):
        self.clock[0] += 1e-6
        return self.clock[0]

    def tick(self, seconds=30.0):
        self.clock[0] += seconds

    def pods(self, prefix, n, cpu, memory="128Mi", priority=0, node=""):
        for i in range(n):
            p = (self.mk_pod().name(f"{prefix}-{i}").req({"cpu": cpu, "memory": memory})
                 .priority(priority).obj())
            p.node_name = node
            self.cs.create_pod(p)


def _run(steps, **kw):
    kits = [Kit("jax", **kw), Kit("port", **kw)]
    marks = []
    for step in steps:
        for k in kits:
            k.tick()
            step(k)
            k.s.run_until_idle()
        marks.append([{c: getattr(k.s, c) for c in COUNTERS} for k in kits])
    jax_k, port_k = kits
    want = {p.name: p.node_name for p in jax_k.cs.pods.values()}
    got = {p.name: p.node_name for p in port_k.cs.pods.values()}
    assert got == want
    for j, p in marks:
        assert p == j
    assert port_k.s.queue.pending_counts() == jax_k.s.queue.pending_counts()
    assert len(port_k.s._fail_memo) == len(jax_k.s._fail_memo)
    return jax_k.s, port_k.s, marks


def _nodes(k, n=6, cpu=4):
    for i in range(n):
        k.cs.create_node(k.mk_node().name(f"n{i}").capacity(
            {"cpu": cpu, "memory": "16Gi", "pods": 110}).zone(f"z{i % 2}").obj())


def test_unschedulable_flood_of_alternating_signatures_parks_from_the_memo():
    """Floods of two signatures that fit nowhere (alternating runs), with
    binds, foreign binds and a preemption's nomination between them. The
    first pod of a run against a state is diagnosed and the rest park from
    the memo; a 300-pod flood stays one session of five batches."""
    steps = [
        _nodes,
        lambda k: k.pods("fill", 12, "1500m"),
        lambda k: k.pods("a", 40, "9"),
        lambda k: k.pods("b", 40, "10", memory="1Gi"),
        lambda k: k.pods("a2", 40, "9"),
        lambda k: k.pods("small", 6, "100m"),          # our binds move the memo key
        lambda k: k.pods("b2", 40, "10", memory="1Gi"),
        lambda k: k.pods("foreign", 2, "100m", node="n1"),   # foreign binds: cluster events
        lambda k: k.pods("a3", 40, "9"),
        lambda k: k.pods("flood", 300, "9"),
        lambda k: k.pods("pre", 1, "3", priority=1000),      # preempts: a nomination
        lambda k: k.pods("a4", 30, "9"),
        lambda k: k.pods("b3", 30, "10", memory="1Gi"),
    ]
    jax_s, port, marks = _run(steps)
    before, after = marks[8][1], marks[9][1]
    sessions = sum(after[c] - before[c] for c in
                   ("plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume"))
    assert sessions == 1 and after["device_batches"] - before["device_batches"] == 5
    assert after["attempts"] - before["attempts"] == 300
    assert after["host_path_pods"] == before["host_path_pods"]
    assert port.failures >= 500 and port.queue.nominator.version > 0
    assert port.memo_hits >= 300
    assert 0 < len(port._fail_memo) <= 64


def test_memo_lru_holds_many_signatures():
    """More signatures than the memo holds (70 against 64): the oldest
    entries go first, as in JAX."""
    steps = [lambda k: _nodes(k, 2)]
    for g in range(70):
        steps.append(lambda k, g=g: k.pods(f"s{g}", 3, f"{20 + g}"))
    for g in range(0, 70, 7):
        steps.append(lambda k, g=g: k.pods(f"again{g}", 3, f"{20 + g}"))
    _jax, port, _marks = _run(steps)
    assert len(port._fail_memo) == 64


def _claim_wave(prefix, n):
    def step(k):
        for i in range(n):
            name = f"{prefix}-{i}"
            k.cs.create_resource_claim(k.dra.ResourceClaim(name=f"{name}-claim", requests=[
                k.dra.DeviceRequest(count=1, expression='device.attributes["model"] == "a100"')]))
            p = k.mk_pod().name(name).req({"cpu": "100m", "memory": "128Mi"}).obj()
            p.resource_claims.append(f"{name}-claim")
            k.cs.create_pod(p)
    return step


def _gpu_nodes(k, n=4, devices=2):
    for i in range(n):
        k.cs.create_node(k.mk_node().name(f"n{i}").capacity(
            {"cpu": 8, "memory": "32Gi", "pods": 110}).obj())
        k.cs.create_resource_slice(k.dra.ResourceSlice(
            node_name=f"n{i}", driver="gpu.example.com",
            devices=[k.dra.Device(name=f"n{i}-d{j}", attributes={"model": "a100"})
                     for j in range(devices)]))


def test_unplaced_claim_pods_across_sessions():
    """Claim-template pods past the cluster's devices, created in waves so
    that each wave is a session of its own: the pods the device places
    nowhere park as in JAX (host rerun once a state, then the memo), with
    the same host-path pods, allocations and queue counts."""
    steps = [_gpu_nodes, _claim_wave("w0", 12), _claim_wave("w1", 6), _claim_wave("w2", 6),
             lambda k: k.pods("plain", 4, "100m"), _claim_wave("w3", 5)]
    jax_s, port, marks = _run(steps, claims=True)
    assert port.scheduled == jax_s.scheduled == 8 + 4
    claims = {k: (c.allocated_node, len(c.allocations))
              for k, c in port.clientset.resource_claims.items()}
    assert claims == {k: (c.allocated_node, len(c.allocations))
                      for k, c in jax_s.clientset.resource_claims.items()}
    assert marks[-1][1]["host_path_pods"] > 0


def test_batch_supported_verdict_is_memoized_on_the_template():
    """The verdict of a template clone is kept on the template's shared
    holder a profile (so a workload of clones asks once), a nominated pod is
    answered outside the memo, and a pod with a PVC is never memoized: the
    verdicts equal the JAX package's _batch_supported_memo."""
    from kubernetes_tpu.api.types import Volume as JaxVolume
    from kubernetes_tpu_torch.api.types import Volume

    got = []
    for k, vol in ((Kit("jax"), JaxVolume), (Kit("port"), Volume)):
        fw = k.s.profiles["default-scheduler"]
        memo = (k.s._batch_supported_memo if k.kind == "jax"
                else lambda pod, fw: k.s._batch_supported(fw, pod))
        proto = k.mk_pod().name("proto").req({"cpu": "100m"}).obj()
        a, b = proto.clone_from_template("a"), proto.clone_from_template("b")
        verdicts = [memo(a, fw)]
        shared = a.__dict__["_sig_shared"]
        assert ("_bsup", id(fw)) in shared and b.__dict__["_sig_shared"] is shared
        b.nominated_node_name = "n0"
        verdicts.append(memo(b, fw))
        c = proto.clone_from_template("c")
        c.volumes = [vol(name="data", pvc_name="claim")]
        verdicts.append(memo(c, fw))
        shared.clear()
        verdicts.append(memo(c, fw))
        assert ("_bsup", id(fw)) not in shared
        got.append(verdicts)
    assert got[0] == got[1]
    assert got[1][0] is None and got[1][1] == "nominated node fast path"
    assert got[1][2] is not None and got[1][3] == got[1][2]
