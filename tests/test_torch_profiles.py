"""Profiles that lack a plugin, in the PyTorch port against the JAX
reference, on the CPU: a profile without InterPodAffinity builds its plans
with the plugin's defaults, and a pod whose spread constraints or affinity
terms name a plugin the profile lacks takes the host path, which ignores
them, as in the JAX package (its _device_unsupported_profile)."""

import pytest
import torch

from kubernetes_tpu.core.registry import DEFAULT_PLUGINS, build_framework, fit_only_profiles
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.core.framework import Framework
from kubernetes_tpu_torch.core.registry import default_profile
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.plugins.basic import DefaultBinder, PrioritySort
from kubernetes_tpu_torch.plugins.noderesources import Fit
from kubernetes_tpu_torch.testing import make_node, make_pod

ZONE = "topology.kubernetes.io/zone"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(params=[False, True], ids=["hints-off", "hints-on"])
def hints(request):
    """Score hints off (the dispatch path alone) and on (both packages'
    defaults): each parity case runs both ways."""
    return request.param


def _jax_without(name):
    def profiles(handle):
        return {"default-scheduler": build_framework(
            handle, plugins=tuple(p for p in DEFAULT_PLUGINS if p[0] != name))}
    return profiles


def _port_without(name):
    def profile(handle):
        base = default_profile(handle)
        fw = Framework(profile_name=base.profile_name,
                       plugins=[(p, w) for p, w in base._plugins if p.name != name])
        fw.plugin("DefaultPreemption").set_framework(fw)
        return fw
    return profile


def _port_fit_only(handle):
    return Framework(plugins=[(PrioritySort(), 0), (Fit(), 1),
                              (DefaultBinder(handle.clientset), 0)])


def _pair(jax_profiles, port_profile, hints=False):
    """The JAX scheduler and the port's, score hints on or off in both."""
    jax_s = TPUScheduler(mesh=None, profile_factory=jax_profiles)
    jax_s._hints.enabled = hints
    return ((jax_s, jax_make_node, jax_make_pod),
            (TorchScheduler(device="cpu", profile_factory=port_profile, score_hints=hints),
             make_node, make_pod))


def _bindings(s):
    return {p.name: p.node_name for p in s.clientset.pods.values()}


def _run(pair, nodes, pods):
    for s, mk_node, mk_pod in pair:
        for build in nodes(mk_node):
            s.clientset.create_node(build.obj())
        for build in pods(mk_pod):
            s.clientset.create_pod(build.obj())
        s.run_until_idle()
    (jax_s, *_), (port, *_) = pair
    assert _bindings(port) == _bindings(jax_s)
    assert (port.scheduled, port.failures) == (jax_s.scheduled, jax_s.failures)
    return jax_s, port


def test_fit_only_profile_binds_every_pod(hints):
    """The BASELINE config[0] profile (PrioritySort, NodeResourcesFit,
    DefaultBinder) has no InterPodAffinity: the plan takes its defaults."""
    _jax, port = _run(
        _pair(fit_only_profiles, _port_fit_only, hints=hints),
        lambda mk: [mk().name(f"node-{i}").capacity({"cpu": 4, "memory": "8Gi", "pods": 110})
                    for i in range(6)],
        lambda mk: [mk().name(f"pod-{i}").req({"cpu": "500m", "memory": "256Mi"})
                    for i in range(20)])
    assert all(_bindings(port).values()) and len(_bindings(port)) == 20
    assert port.host_path_pods == 0


def test_spread_without_pod_topology_spread_is_ignored(hints):
    """Three nodes in zone-a, one in zone-b, eight pods under a hard zone
    spread of skew 1: without PodTopologySpread in the profile the spread
    binds nothing, so the pods fill zone-a's three nodes first."""
    _jax, port = _run(
        _pair(_jax_without("PodTopologySpread"), _port_without("PodTopologySpread"),
              hints=hints),
        lambda mk: [mk().name(f"node-{i}").label(ZONE, "zone-a" if i < 3 else "zone-b")
                    .capacity({"cpu": 8, "memory": "16Gi", "pods": 110}) for i in range(4)],
        lambda mk: [mk().name(f"pod-{i}").label("app", "web").req({"cpu": "1"})
                    .spread_constraint(1, ZONE, match_labels={"app": "web"}) for i in range(8)])
    zone_b = sum(node == "node-3" for node in _bindings(port).values())
    assert (8 - zone_b, zone_b) == (6, 2)
    assert port.host_path_pods == 8


def test_affinity_without_inter_pod_affinity_takes_the_host_path(hints):
    """Pods with required hostname anti-affinity against each other, under
    a profile without InterPodAffinity: the term binds nothing, and every
    pod takes the host path, as in the JAX package."""
    jax_s, port = _run(
        _pair(_jax_without("InterPodAffinity"), _port_without("InterPodAffinity"),
              hints=hints),
        lambda mk: [mk().name(f"node-{i}").capacity({"cpu": 8, "memory": "16Gi", "pods": 110})
                    for i in range(3)],
        lambda mk: [mk().name(f"pod-{i}").label("app", "db").req({"cpu": "1"})
                    .pod_affinity("kubernetes.io/hostname", {"app": "db"}, anti=True)
                    for i in range(6)])
    assert all(_bindings(port).values())
    assert max(sum(n == f"node-{i}" for n in _bindings(port).values()) for i in range(3)) > 1
    assert port.host_path_pods == jax_s.host_path_pods == 6
