"""SchedulingGates in the PyTorch port against the JAX reference, on the
CPU: the PreEnqueue gate and the queue's gated pods — parked on admission,
released by the update that lifts their gates, skipped by cluster-event
moves (the pool's non-gated index) and by the leftover flush — with every
queue count equal to the JAX package's, state for state; end to end
through TPUScheduler and TorchScheduler(device="cpu"), score hints off in
both and on in both, and SchedulingWhileGated/1Node_10GatedPods at its upstream size."""

import pytest
import torch

from kubernetes_tpu.core.queue import PriorityQueue as JaxQueue
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.core.queue import EVENT_ASSIGNED_POD_DELETE, PriorityQueue
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.testing import make_node, make_pod


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


def _pair(hints=False):
    """The JAX scheduler and the port's, score hints on or off in both."""
    jax_s = TPUScheduler(mesh=None)
    jax_s._hints.enabled = hints
    return ((jax_s, jax_make_node, jax_make_pod),
            (TorchScheduler(device="cpu", score_hints=hints), make_node, make_pod))


def _same(pair):
    (a, *_), (b, *_) = pair
    got = {p.name: p.node_name for p in b.clientset.pods.values()}
    want = {p.name: p.node_name for p in a.clientset.pods.values()}
    assert got == want
    assert (a.scheduled, a.failures) == (b.scheduled, b.failures)
    assert a.queue.pending_counts() == b.queue.pending_counts()
    return b.queue.pending_counts()


def test_gated_pods_parked_released_and_skipped(hints):
    """Gated pods park in the unschedulable pool beside plain ones; a bound
    pod's deletion (a cluster event) moves nothing gated; an update that
    lifts one pod's gates releases it; one that keeps a gate does not."""
    pair = _pair(hints=hints)
    for s, mk_node, mk_pod in pair:
        for i in range(3):
            s.clientset.create_node(mk_node().name(f"node-{i}")
                                    .capacity({"cpu": 2, "memory": "8Gi", "pods": 110}).obj())
        for i in range(4):
            s.clientset.create_pod(mk_pod().name(f"gated-{i}").req({"cpu": "0"})
                                   .scheduling_gate("hold").scheduling_gate("other").obj())
        for i in range(8):  # two fit nowhere: unschedulable, not gated
            s.clientset.create_pod(mk_pod().name(f"plain-{i}").req({"cpu": "1"}).obj())
        s.run_until_idle()
    assert _same(pair) == (0, 0, 6)
    assert len(pair[1][0].queue.unschedulable.non_gated) == 2
    for s, *_ in pair:
        s.clientset.delete_pod(next(p for p in s.clientset.pods.values()
                                    if p.name == "plain-0"))
        s.run_until_idle()
    _same(pair)
    for s, *_ in pair:
        for name, gates in (("gated-0", []), ("gated-1", ["other"])):
            pod = next(p for p in s.clientset.pods.values() if p.name == name)
            pod.scheduling_gates = gates
            s.clientset.update_pod(pod)
        s.run_until_idle()
    counts = _same(pair)
    port = pair[1][0]
    assert port.clientset.pods[next(u for u, p in port.clientset.pods.items()
                                    if p.name == "gated-0")].node_name
    assert sum(port.queue.unschedulable[u].gated for u in port.queue.unschedulable) == 3
    assert counts[2] == 3 + len(port.queue.unschedulable.non_gated)


def test_scheduling_while_gated_upstream_short(hints):
    """SchedulingWhileGated/1Node_10GatedPods (performance-config.yaml:449):
    one node of 1000 cpu / 4Ti / 90000 pods, 10 gated pods, 10 pods in
    namespace `deleting` scheduled then deleted, 10 measured pods: the
    measured pods bind, the gated ones stay parked, as in JAX."""
    pair = _pair(hints=hints)
    for s, mk_node, mk_pod in pair:
        s.clientset.create_node(mk_node().name("scheduler-perf-node")
                                .capacity({"cpu": 1000, "memory": "4Ti", "pods": 90000}).obj())
        for i in range(10):
            s.clientset.create_pod(mk_pod().name(f"gated-{i}").req({"cpu": "0", "memory": "0"})
                                   .scheduling_gate("test.k8s.io/hold").obj())
        s.run_until_idle()
        deleting = [mk_pod().name(f"deleting-{i}").namespace("deleting")
                    .req({"cpu": "0", "memory": "0"}).obj() for i in range(10)]
        for p in deleting:
            s.clientset.create_pod(p)
        s.run_until_idle()
        for i in range(10):
            s.clientset.create_pod(mk_pod().name(f"measured-{i}")
                                   .req({"cpu": "0", "memory": "0"}).obj())
            s.clientset.delete_pod(deleting[i])
        s.run_until_idle()
    assert _same(pair) == (0, 0, 10)
    port = pair[1][0]
    assert sum(1 for p in port.clientset.pods.values() if p.node_name) == 10
    assert port.device_scheduled == 20 and not port.queue.unschedulable.non_gated


class Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_queue_gated_pods_count_like_jax():
    """The queue alone, on one fake clock: gated and plain pods admitted,
    the plain ones popped and parked unschedulable, a node-add move, the
    leftover flush past max_in_unschedulable and an activate. Every state's
    counts equal the JAX queue's; a gated pod never leaves the pool."""
    jax_fw = TPUScheduler(mesh=None).profiles["default-scheduler"]
    port_fw = TorchScheduler(device="cpu").profiles["default-scheduler"]
    clock = Clock()
    queues = ((JaxQueue(framework=jax_fw, now=clock), jax_make_pod),
              (PriorityQueue(port_fw, now=clock), make_pod))
    pods = {}

    def both(fn):
        for q, mk in queues:
            fn(q, mk)
        counts = [q.pending_counts() for q, _ in queues]
        assert counts[0] == counts[1]
        return counts[1]

    def admit(q, mk):
        pods[id(q)] = [mk().name(f"g{i}").req({"cpu": "1"}).scheduling_gate("hold").obj()
                       for i in range(3)] + [mk().name(f"p{i}").req({"cpu": "1"}).obj()
                                             for i in range(3)]
        for p in pods[id(q)]:
            q.add(p)
    assert both(admit) == (3, 0, 3)

    def park(q, _mk):
        for _ in range(3):
            qpi = q.pop()
            qpi.unschedulable_plugins = {"NodeResourcesFit"}
            q.add_unschedulable_if_not_present(qpi)
            q.done(qpi.uid)
    assert both(park) == (0, 0, 6)
    clock.t += 30.0
    # A freed node helps the plain pods' NodeResourcesFit rejection, never
    # a gated pod.
    assert both(lambda q, _: q.move_all_to_active_or_backoff(EVENT_ASSIGNED_POD_DELETE)) == (
        3, 0, 3)

    def repark(q, _mk):
        while (qpi := q.pop()) is not None:
            qpi.unschedulable_plugins = {"NodeResourcesFit"}
            q.add_unschedulable_if_not_present(qpi)
            q.done(qpi.uid)
    assert both(repark) == (0, 0, 6)
    clock.t += 400.0
    assert both(lambda q, _: q.flush_unschedulable_left_over()) == (3, 0, 3)
    both(repark)
    assert both(lambda q, _: q.activate(pods[id(q)][3])) == (1, 0, 5)
    # activate on a gated pod: the port keeps it parked; the JAX queue pops
    # it from the pool and drops it.
    for q, _ in queues:
        q.activate(pods[id(q)][0])
    (jq, _), (pq, _) = queues
    assert pq.pending_counts() == (1, 0, 5) and jq.pending_counts() == (1, 0, 4)
    assert pq.unschedulable[pods[id(pq)][0].uid].gated
