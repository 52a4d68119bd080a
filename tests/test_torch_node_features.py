"""NodeDeclaredFeatures and ImageLocality in the PyTorch port against the
JAX reference, on the CPU, through TPUScheduler and
TorchScheduler(device="cpu"), score hints off in both and on in both: pods requiring declared features bind only
on nodes that declare them, and their failures carry the plugin's
diagnosis; a node update that drops a feature ends the resumable plan
(the node-update classifier compares declared features); ImageLocality
scores nodes by the images they hold, discounted by how many nodes hold
each (the snapshot's image_num_nodes), on the device and on the host."""

import pytest
import torch

from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.core.cache import Cache, Snapshot
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.plugins.basic import ImageLocality
from kubernetes_tpu_torch.testing import make_node, make_pod

REQUIRED = "features.k8s.io/required"
MI = 1024 * 1024


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


def _pair(max_batch=None, hints=False):
    """The JAX scheduler and the port's, score hints on or off in both."""
    jax_s = TPUScheduler(mesh=None, max_batch=max_batch)
    jax_s._hints.enabled = hints
    return ((jax_s, jax_make_node, jax_make_pod),
            (TorchScheduler(device="cpu", max_batch=max_batch, score_hints=hints), make_node,
             make_pod))


def _each(pair, fn):
    for s, mk_node, mk_pod in pair:
        fn(s, mk_node, mk_pod)
        s.run_until_idle()


def _same(pair):
    (a, *_), (b, *_) = pair
    want = {p.name: p.node_name for p in a.clientset.pods.values()}
    got = {p.name: p.node_name for p in b.clientset.pods.values()}
    diffs = {k: (v, got.get(k)) for k, v in want.items() if got.get(k) != v}
    assert not diffs and set(got) == set(want), f"JAX/port divergence: {diffs}"
    assert (a.scheduled, a.failures) == (b.scheduled, b.failures)
    assert a.queue.pending_counts() == b.queue.pending_counts()
    return got


def _feature_nodes(n, declared):
    def build(s, mk_node, _mk_pod):
        for i in range(n):
            node = mk_node().name(f"node-{i}").capacity(
                {"cpu": 4, "memory": "16Gi", "pods": 110}).obj()
            node.declared_features = declared(i)
            s.clientset.create_node(node)
    return build


def _feature_pods(n, feats, prefix="p", cpu="500m"):
    def create(s, _mk_node, mk_pod):
        for i in range(n):
            p = mk_pod().name(f"{prefix}-{i}").req({"cpu": cpu}).obj()
            p.annotations[REQUIRED] = feats
            s.clientset.create_pod(p)
    return create


@pytest.mark.parametrize("max_batch", [None, 64], ids=["lap", "scan"])
def test_declared_features_bind_like_jax(max_batch, hints):
    """Only odd nodes declare gpu-x: pods requiring it fill the odd nodes
    and the rest fail with NodeDeclaredFeatures' diagnosis; pods requiring
    a feature no node declares fail everywhere; plain pods go anywhere."""
    pair = _pair(max_batch, hints=hints)
    _each(pair, _feature_nodes(10, lambda i: {"gpu-x": True} if i % 2 else {"gpu-x": False}))
    _each(pair, _feature_pods(44, "gpu-x"))
    _each(pair, _feature_pods(3, "gpu-x, missing", prefix="none"))
    _each(pair, _feature_pods(4, "", prefix="plain", cpu="100m"))
    got = _same(pair)
    port = pair[1][0]
    for name, node in got.items():
        if name.startswith("p-") and node:
            assert int(node.split("-")[1]) % 2 == 1
        if name.startswith("none-"):
            assert not node
    assert sum(1 for k, v in got.items() if k.startswith("p-") and v) == 40
    assert port.device_scheduled > 0 and port.failures > 0


def test_dropping_a_declared_feature_is_not_a_delta_patch(hints):
    """Fault 3: a node update that drops a feature leaves labels and images
    as they were, so a classifier that compared only those would
    delta-patch the row and keep the plan's extra_ok, which lets the
    feature pods onto the node. It must end the resumable plan instead:
    the next session rebuilds, as JAX's does, and the node stays empty."""
    pair = _pair(max_batch=64, hints=hints)
    _each(pair, _feature_nodes(6, lambda i: {"gpu-x": True}))
    _each(pair, _feature_pods(2, "gpu-x", prefix="w1"))
    port = pair[1][0]
    empty = sorted({f"node-{i}" for i in range(6)}
                   - {p.node_name for p in port.clientset.pods.values()})[0]
    full = port.plan_rebuilds_full

    def drop(s, mk_node, _mk_pod):
        node = mk_node().name(empty).capacity({"cpu": 4, "memory": "16Gi", "pods": 110}).obj()
        s.clientset.update_node(node)
    _each(pair, drop)
    assert port.journal.since(port.journal.seq - 1)[0].kind == "other"
    _each(pair, _feature_pods(4, "gpu-x", prefix="w2"))
    got = _same(pair)
    assert empty not in got.values()
    assert port.plan_rebuilds_full == full + 1


def test_image_locality_scores_like_jax(hints):
    """Nodes hold a 900 MiB image `big` (3 of 12) or a 600 MiB image
    `small` (9 of 12): pods naming each score the nodes that hold it,
    discounted by the share of nodes that hold it, and bind as in JAX on
    the device (lap and scan) — the discount makes `small` nearly
    worthless."""
    for max_batch in (None, 64):
        pair = _pair(max_batch, hints=hints)

        def nodes(s, mk_node, _mk_pod):
            for i in range(12):
                b = mk_node().name(f"node-{i}").capacity(
                    {"cpu": 8, "memory": "16Gi", "pods": 110})
                b = b.image("reg/big:1", 900 * MI) if i % 4 == 0 else b.image("reg/small:1",
                                                                                600 * MI)
                s.clientset.create_node(b.obj())

        def pods(s, _mk_node, mk_pod):
            for i in range(6):
                s.clientset.create_pod(mk_pod().name(f"big-{i}").req({"cpu": "1"})
                                       .image("reg/big:1").obj())
            for i in range(6):
                s.clientset.create_pod(mk_pod().name(f"small-{i}").req({"cpu": "1"})
                                       .image("reg/small:1").obj())
        _each(pair, nodes)
        _each(pair, pods)
        got = _same(pair)
        assert all(int(got[f"big-{i}"].split("-")[1]) % 4 == 0 for i in range(3))
        assert pair[1][0].device_scheduled == 12


def test_image_num_nodes_and_the_scaled_score():
    """The snapshot counts each image's nodes (images added, replaced and
    removed with their nodes), and scaled_score's float discount is the
    JAX package's: 23 MiB and 1000 MiB a container bound the range."""
    cache, snap = Cache(), Snapshot()
    for i in range(4):
        b = make_node().name(f"n{i}").capacity({"cpu": 4})
        if i < 3:
            b = b.image("a", 500 * MI)
        if i == 0:
            b = b.image("b", 2000 * MI)
        cache.add_node(b.obj())
    cache.update_snapshot(snap)
    assert snap.image_num_nodes == {"a": 3, "b": 1}
    cache.add_node(make_node().name("n1").capacity({"cpu": 4}).obj())   # images dropped
    cache.remove_node("n2")
    cache.update_snapshot(snap)
    assert snap.image_num_nodes == {"a": 1, "b": 1}
    pod = make_pod().name("p").image("a").obj()
    ni = snap.get("n0")
    assert ImageLocality.scaled_score(pod, ni, {"a": 1}, 1) == int(100 * (500 - 23) / 977)
    assert ImageLocality.scaled_score(pod, ni, {"a": 3}, 4) == int(
        100 * (int(500 * MI * 0.75) - 23 * MI) / (977 * MI))
    assert ImageLocality.scaled_score(pod, ni, {"a": 1}, 30) == 0
    pod_b = make_pod().name("q").image("b").obj()
    assert ImageLocality.scaled_score(pod_b, ni, {"b": 1}, 1) == 100
    assert ImageLocality.scaled_score(pod_b, snap.get("n3"), {"b": 1}, 1) == 0
