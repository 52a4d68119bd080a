"""PodTopologySpread, InterPodAffinity, preferred node affinity and
PreferNoSchedule taints through the PyTorch port, against the JAX reference:
the same cluster and pod stream through kubernetes_tpu's TPUScheduler (CPU
JAX, no mesh) and kubernetes_tpu_torch's TorchScheduler on the CPU (the
kernels' plain versions) must give identical pod→node assignments and
identical scheduled/failure counts. Scores are exact integers: no
tolerance. Clusters are 20-60 nodes across 4 zones."""

import collections
import random

import pytest
import torch

from kubernetes_tpu.api.types import Namespace as JaxNamespace
from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.api.types import Namespace
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.ops import kernel as K
from kubernetes_tpu_torch.testing import make_node, make_pod

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one intra-op thread is enough, and it keeps
    this module from crowding the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def paths(monkeypatch):
    """Counts the plain kernel versions the port's sessions ran."""
    seen = collections.Counter()
    for name in ("_lap_schedule_plain", "_scan_general_plain"):
        fn = getattr(K, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            seen[_name[1:-6]] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(K, name, spy)
    return seen


def _cluster(mk, cs, n_nodes, seed=0, zones=4, taint_frac=0.0, pns_frac=0.0,
             unlabeled=()):
    rng = random.Random(seed)
    for i in range(n_nodes):
        b = (mk().name(f"node-{i}")
             .capacity({"cpu": rng.choice([2, 4, 8, 16]),
                        "memory": f"{rng.choice([4, 8, 16, 32])}Gi", "pods": 110})
             .label("disk", rng.choice(["ssd", "hdd"])))
        if i not in unlabeled:
            b = b.zone(f"zone-{i % zones}")
        if taint_frac and rng.random() < taint_frac:
            b = b.taint("dedicated", "infra", "NoSchedule")
        if pns_frac and rng.random() < pns_frac:
            b = b.taint("soft", "x", "PreferNoSchedule")
        cs.create_node(b.obj())


def _pods(mk, n, prefix="pod", cpu="250m", mem="256Mi", labels=None, build=None,
          namespace=None):
    out = []
    for i in range(n):
        b = mk().name(f"{prefix}-{i}").req({"cpu": cpu, "memory": mem})
        if namespace:
            b = b.namespace(namespace)
        if labels:
            b = b.labels(dict(labels))
        if build:
            b = build(b)
        out.append(b.obj())
    return out


def _assignments(sched):
    return {p.name: p.node_name for p in sched.clientset.pods.values()}


def _assert_same(jax_s, port):
    a_jax, a_port = _assignments(jax_s), _assignments(port)
    diffs = {k: (a_jax[k], a_port.get(k)) for k in a_jax if a_jax[k] != a_port.get(k)}
    assert not diffs, f"JAX/port assignment divergence: {diffs}"
    assert set(a_jax) == set(a_port)
    assert (jax_s.scheduled, jax_s.failures) == (port.scheduled, port.failures)


class Pair:
    """One JAX and one port scheduler driven with the same calls."""

    def __init__(self, n_nodes, max_batch=64, **cluster_kw):
        self.jax = TPUScheduler(mesh=None, max_batch=max_batch)
        self.port = TorchScheduler(device="cpu", max_batch=max_batch)
        self.both = ((jax_make_node, jax_make_pod, self.jax),
                     (make_node, make_pod, self.port))
        for mk_node, _mk_pod, s in self.both:
            _cluster(mk_node, s.clientset, n_nodes, **cluster_kw)

    def pods(self, n, run=True, **kw):
        for _mk_node, mk_pod, s in self.both:
            for p in _pods(mk_pod, n, **kw):
                s.clientset.create_pod(p)
            if run:
                s.run_until_idle()
        return self

    def run(self):
        for _mk_node, _mk_pod, s in self.both:
            s.run_until_idle()
        _assert_same(self.jax, self.port)
        return self


def _spread(skew, key, when="DoNotSchedule", **kw):
    return lambda b: b.spread_constraint(skew, key, when, {"app": "s"}, **kw)


class TestSpread:
    @pytest.mark.parametrize("key,skew", [(ZONE, 1), (HOSTNAME, 2)], ids=["zone", "hostname"])
    def test_do_not_schedule(self, key, skew, paths):
        p = Pair(24).pods(30, labels={"app": "s"}, build=_spread(skew, key)).run()
        assert p.port.host_path_pods == 0 and p.port.device_scheduled > 0
        assert set(paths) == {"scan_general"}

    @pytest.mark.parametrize("kw", [
        dict(min_domains=6),
        dict(node_affinity_policy="Ignore"),
        dict(node_taints_policy="Honor"),
    ], ids=["min-domains", "affinity-policy-ignore", "taints-policy-honor"])
    def test_min_domains_and_honor_policies(self, kw):
        def build(b):
            return _spread(1, ZONE, **kw)(b).node_selector({"disk": "ssd"})
        Pair(30, taint_frac=0.3, unlabeled=(3, 9)).pods(
            40, labels={"app": "s"}, build=build).run()

    def test_schedule_anyway(self, paths):
        p = Pair(28).pods(8, prefix="seed", labels={"app": "s"})
        paths.clear()
        p.pods(40, labels={"app": "s"}, build=_spread(1, ZONE, "ScheduleAnyway")).run()
        assert p.port.host_path_pods == 0 and set(paths) == {"scan_general"}


class TestInterPodAffinity:
    @pytest.mark.parametrize("max_batch", [1024, 64], ids=["lap", "scan"])
    def test_hostname_anti_affinity(self, max_batch, paths):
        p = Pair(20, max_batch=max_batch).pods(
            26, labels={"app": "x"},
            build=lambda b: b.pod_affinity(HOSTNAME, {"app": "x"}, anti=True)).run()
        placed = [n for n in _assignments(p.port).values() if n]
        assert len(placed) == len(set(placed)) == 20 and p.port.failures > 0
        # Row-local anti-affinity: the lap above 64 steps, the general scan's
        # incremental mode at 64.
        assert paths["lap_schedule" if max_batch > 64 else "scan_general"] > 0

    def test_zone_anti_affinity(self, paths):
        # Four zones: four pods land, one per zone; the rest fail. Zones
        # are shared by many rows: not row-local, so never the lap.
        p = Pair(20, max_batch=1024).pods(
            7, labels={"app": "z"},
            build=lambda b: b.pod_affinity(ZONE, {"app": "z"}, anti=True)).run()
        assert p.port.scheduled == 4 and set(paths) == {"scan_general"}

    def test_required_affinity_bootstrap(self):
        p = Pair(24).pods(30, labels={"app": "pack"},
                          build=lambda b: b.pod_affinity(ZONE, {"app": "pack"})).run()
        zones = {int(n.split("-")[1]) % 4 for n in _assignments(p.port).values() if n}
        assert len(zones) == 1 and p.port.host_path_pods == 0

    @pytest.mark.parametrize("anti", [False, True], ids=["affinity", "anti-affinity"])
    def test_preferred_terms(self, anti):
        p = Pair(24).pods(6, prefix="seed", labels={"app": "w"})
        p.pods(30, labels={"app": "w"},
               build=lambda b: b.pod_affinity(ZONE, {"app": "w"}, anti=anti, weight=10)).run()

    def test_existing_pods_required_terms(self):
        # Pods with required anti-affinity against `app: web` and required
        # affinity to it are placed first; plain `app: web` pods then see
        # their terms (exist_anti and the hard-affinity weight).
        p = Pair(24)
        p.pods(4, prefix="guard", labels={"app": "guard"},
               build=lambda b: b.pod_affinity(ZONE, {"app": "web"}, anti=True))
        p.pods(4, prefix="friend", labels={"app": "friend"},
               build=lambda b: b.pod_affinity(HOSTNAME, {"app": "friend"}))
        p.pods(30, labels={"app": "web"},
               build=lambda b: b.pod_affinity(HOSTNAME, {"app": "friend"}, weight=5)).run()

    def test_namespace_selector(self):
        p = Pair(24)
        for ns, cls in ((JaxNamespace, p.jax), (Namespace, p.port)):
            cls.clientset.create_namespace(ns(name="team-a", labels={"team": "a"}))
            cls.clientset.create_namespace(ns(name="team-b", labels={"team": "b"}))
        p.pods(6, prefix="a", labels={"app": "db"}, namespace="team-a")
        p.pods(6, prefix="b", labels={"app": "db"}, namespace="team-b")
        p.pods(20, labels={"app": "web"}, build=lambda b: b.pod_affinity(
            ZONE, {"app": "db"}, anti=True, weight=8, ns_labels={"team": "a"})).run()


class TestScoring:
    def test_prefer_no_schedule(self, paths):
        p = Pair(24, pns_frac=0.5).pods(40).run()
        assert p.port.host_path_pods == 0 and set(paths) == {"scan_general"}

    def test_preferred_node_affinity(self):
        Pair(20).pods(24, build=lambda b: b.preferred_node_affinity(7, "disk", ["hdd"])).run()


class TestSessions:
    def test_warm_for_is_inert_and_launches_the_rowlocal_fallback(self, paths):
        # A row-local anti-affinity plan warms its two carries on the lap,
        # the two of its nominated-lane variant (an empty lane) on the lap,
        # and its fallback (anti_rowlocal off) once on the general scan;
        # nothing binds, and the pods then land exactly as on an unwarmed
        # JAX scheduler.
        anti = lambda b: b.pod_affinity(HOSTNAME, {"app": "x"}, anti=True)  # noqa: E731
        p = Pair(20, max_batch=1024)
        p.port.warm_for(_pods(make_pod, 1, prefix="warm", labels={"app": "x"}, build=anti)[0])
        assert dict(paths) == {"lap_schedule": 4, "scan_general": 1}
        assert not p.port.clientset.bindings and p.port.scheduled == 0
        p.pods(26, labels={"app": "x"}, build=anti).run()

    def test_chained_multi_batch_session(self):
        # 150 spread pods at max_batch 64: three batches of one session
        # chain their count tables through the carry.
        p = Pair(40).pods(150, cpu="100m", labels={"app": "s"}, build=_spread(1, ZONE)).run()
        assert p.port.device_batches >= 3 and p.port.host_path_pods == 0

    def test_foreign_pod_deleted_mid_session(self):
        # Bound spread pods are deleted during the first batch's commit:
        # their zones' counts drop under a live carry, so the session ends
        # after that batch and the batch in flight takes the host path.
        p = Pair(30).pods(20, prefix="old", labels={"app": "s"}, build=_spread(1, ZONE))
        for _mk_node, _mk_pod, s in p.both:
            cs = s.clientset
            victims = [q for q in cs.pods.values() if q.name in ("old-0", "old-5", "old-9")]
            binds = [0]

            def bind_then_delete(pod, node, cs=cs, bind=cs.bind, victims=victims, binds=binds):
                bind(pod, node)
                binds[0] += 1
                if binds[0] == 10:
                    for v in victims:
                        cs.delete_pod(v)
            cs.bind = bind_then_delete
        p.pods(150, cpu="100m", labels={"app": "s"}, build=_spread(1, ZONE)).run()
        assert p.port.host_path_pods > 0


class TestMixed:
    def test_interleaved_shapes(self):
        """Waves of every shape in a shuffled order on one 40-node cluster
        with NoSchedule and PreferNoSchedule taints and unschedulable
        nodes, until capacity runs out: sessions of different plans follow
        each other, infeasible pods take the host path, and the bound pods
        of one shape feed the next shape's count tables."""
        shapes = [
            lambda b: b,
            lambda b: b.toleration("dedicated", "infra", "Equal", "NoSchedule"),
            lambda b: b.node_selector({"disk": "ssd"}),
            lambda b: b.labels({"app": "s"}).spread_constraint(1, ZONE, "DoNotSchedule",
                                                               {"app": "s"}),
            lambda b: b.labels({"app": "h"}).spread_constraint(2, HOSTNAME, "DoNotSchedule",
                                                               {"app": "h"}),
            lambda b: b.labels({"app": "soft"}).spread_constraint(1, ZONE, "ScheduleAnyway",
                                                                  {"app": "soft"}),
            lambda b: b.labels({"app": "x"}).pod_affinity(HOSTNAME, {"app": "x"}, anti=True),
            lambda b: b.labels({"app": "pack"}).pod_affinity(ZONE, {"app": "pack"}),
            lambda b: b.labels({"app": "w"}).pod_affinity(ZONE, {"app": "s"}, weight=10)
            .pod_affinity(ZONE, {"app": "w"}, anti=True, weight=5),
            lambda b: b.preferred_node_affinity(7, "disk", ["hdd"]),
        ]
        rng = random.Random(1)
        order = list(range(len(shapes))) * 2
        rng.shuffle(order)
        p = Pair(40, taint_frac=0.3, pns_frac=0.2)
        for wave, k in enumerate(order):
            p.pods(rng.choice([5, 20, 60]), prefix=f"w{wave}", cpu=rng.choice(["250m", "1"]),
                   build=shapes[k])
        p.pods(5, prefix="big", cpu="20").run()
        assert p.port.failures > 0 and p.port.device_scheduled > 0
