"""The PyTorch port's fit-only slice against the JAX reference, end to end:
the same cluster and pod stream through kubernetes_tpu's TPUScheduler
(CPU JAX, no mesh) and through kubernetes_tpu_torch's TorchScheduler on
the CPU (the kernels' plain versions) must give identical pod→node
assignments and identical failure counts — the scores are exact integers,
so there is no tolerance. Also: the scope guard refuses what the slice
does not cover, and the port never imports JAX or the JAX package."""

import ast
import os
import random
import subprocess
import sys

import pytest
import torch

from kubernetes_tpu.models.tpu_scheduler import TPUScheduler
from kubernetes_tpu.testing.wrappers import make_node as jax_make_node
from kubernetes_tpu.testing.wrappers import make_pod as jax_make_pod
from kubernetes_tpu_torch.models import TorchScheduler
from kubernetes_tpu_torch.testing import make_node, make_pod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The inputs are small: one intra-op thread is enough, and it keeps
    this module from crowding the other test workers' CPUs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _mk_cluster(mk, cs, n_nodes, seed=0, zones=4, taint_frac=0.0, unsched_frac=0.0):
    rng = random.Random(seed)
    for i in range(n_nodes):
        b = (mk().name(f"node-{i}")
             .capacity({"cpu": rng.choice([2, 4, 8, 16]),
                        "memory": f"{rng.choice([4, 8, 16, 32])}Gi", "pods": 110})
             .zone(f"zone-{i % zones}")
             .label("disk", rng.choice(["ssd", "hdd"])))
        if taint_frac and rng.random() < taint_frac:
            b = b.taint("dedicated", "infra", "NoSchedule")
        if unsched_frac and rng.random() < unsched_frac:
            b = b.unschedulable()
        cs.create_node(b.obj())


def _pods(mk, n, cpu="500m", mem="256Mi", build=None, prefix="pod"):
    out = []
    for i in range(n):
        b = mk().name(f"{prefix}-{i}").req({"cpu": cpu, "memory": mem})
        if build:
            b = build(b)
        out.append(b.obj())
    return out


def _assignments(sched):
    return {p.name: p.node_name for p in sched.clientset.pods.values()}


def _run_pair(n_nodes, pods_kw, max_batch=None, seed=0, **cluster_kw):
    jax_s = TPUScheduler(mesh=None, max_batch=max_batch)
    port = TorchScheduler(device="cpu", max_batch=max_batch)
    for mk, s in ((jax_make_node, jax_s), (make_node, port)):
        _mk_cluster(mk, s.clientset, n_nodes, seed=seed, **cluster_kw)
    for mk, s in ((jax_make_pod, jax_s), (make_pod, port)):
        for p in _pods(mk, **pods_kw):
            s.clientset.create_pod(p)
        s.run_until_idle()
    _assert_same(jax_s, port)
    return jax_s, port


def _assert_same(jax_s, port):
    a_jax, a_port = _assignments(jax_s), _assignments(port)
    diffs = {k: (a_jax[k], a_port.get(k)) for k in a_jax if a_jax[k] != a_port.get(k)}
    assert not diffs, f"JAX/port assignment divergence: {diffs}"
    assert set(a_jax) == set(a_port)
    assert (jax_s.scheduled, jax_s.failures) == (port.scheduled, port.failures)


class TestSliceParity:
    def test_basic_fit(self):
        _, port = _run_pair(23, dict(n=40))
        assert port.device_scheduled == 40 and port.host_path_pods == 0
        assert port.device_batches >= 1

    def test_fill_until_infeasible(self):
        jax_s, port = _run_pair(5, dict(n=30, cpu="2"))
        assert port.failures > 0 and port.failures == jax_s.failures

    def test_truncation_and_rotation(self):
        # >100 nodes: numFeasibleNodesToFind truncation + rotation.
        _run_pair(140, dict(n=60))

    def test_zero_requests(self):
        _run_pair(9, dict(n=12, cpu="0", mem="0"))

    @pytest.mark.parametrize("cluster_kw,build", [
        (dict(taint_frac=0.5), None),
        (dict(taint_frac=0.5),
         lambda b: b.toleration("dedicated", "infra", "Equal", "NoSchedule")),
        (dict(unsched_frac=0.3), None),
    ], ids=["taints", "tolerated", "unschedulable"])
    def test_taints_tolerations_unschedulable(self, cluster_kw, build):
        _run_pair(16, dict(n=20, build=build), **cluster_kw)

    def test_node_selector(self):
        _run_pair(20, dict(n=15, build=lambda b: b.node_selector({"disk": "ssd"})))

    def test_required_node_affinity(self):
        _run_pair(20, dict(n=15, build=lambda b: b.node_affinity_in("disk", ["ssd"])))

    def test_churn_pod_delete_node_update_and_delete(self):
        # Bound pods leave, nodes gain a NoSchedule taint or go away; the
        # next pods must land exactly where the reference puts them.
        jax_s, port = _run_pair(30, dict(n=60))
        for mk, s in ((jax_make_node, jax_s), (make_node, port)):
            cs = s.clientset
            for name in [f"pod-{i}" for i in range(0, 60, 6)]:
                cs.delete_pod(next(p for p in cs.pods.values() if p.name == name))
            for i in (3, 7, 11):
                cs.update_node(mk().name(f"node-{i}").capacity(
                    {"cpu": 16, "memory": "32Gi", "pods": 110}).zone(f"zone-{i % 4}")
                    .label("disk", "ssd").taint("dedicated", "infra", "NoSchedule").obj())
            for i in (5, 20):
                cs.delete_node(f"node-{i}")
        for mk, s in ((jax_make_pod, jax_s), (make_pod, port)):
            for p in _pods(mk, 50, prefix="late"):
                s.clientset.create_pod(p)
            s.run_until_idle()
        _assert_same(jax_s, port)
        late = {n for k, n in _assignments(port).items() if k.startswith("late-")}
        assert late and not late & {"node-3", "node-5", "node-7", "node-11", "node-20"}

    @pytest.mark.parametrize("max_batch", [128, 32], ids=["lap", "scan"])
    def test_multi_batch_chained_session(self, max_batch):
        # A session's step count follows max_batch: 128 takes the lap path
        # (512 steps), 32 the scan path (64 steps). Consecutive batches
        # chain through the carry.
        _, port = _run_pair(150, dict(n=456, cpu="250m"), max_batch=max_batch)
        assert port.device_batches >= 456 // max_batch and port.host_path_pods == 0

    def test_unschedulable_requeue_on_node_add(self):
        jax_s = TPUScheduler(mesh=None)
        port = TorchScheduler(device="cpu")
        for mk, s in ((jax_make_node, jax_s), (make_node, port)):
            _mk_cluster(mk, s.clientset, 3, seed=3)
        for mk, s in ((jax_make_pod, jax_s), (make_pod, port)):
            for p in _pods(mk, 12, cpu="3"):
                s.clientset.create_pod(p)
            s.run_until_idle()
        assert port.failures > 0
        _assert_same(jax_s, port)
        for mk, s in ((jax_make_node, jax_s), (make_node, port)):
            s.clientset.create_node(mk().name("big").capacity(
                {"cpu": 64, "memory": "64Gi", "pods": 110}).zone("zone-9").obj())
            s.run_until_idle()
        _assert_same(jax_s, port)
        assert any(node == "big" for node in _assignments(port).values())


class TestScope:
    @pytest.mark.parametrize("build", [
        lambda b: b.spread_constraint(1, "topology.kubernetes.io/zone"),
        lambda b: b.pod_affinity("kubernetes.io/hostname", {"app": "a"}),
        lambda b: b.pod_affinity("kubernetes.io/hostname", {"app": "a"}, anti=True),
        lambda b: b.preferred_node_affinity(5, "disk", ["ssd"]),
        lambda b: b.host_port(8080),
        lambda b: b.volume("claim"),
        lambda b: b.resource_claim("gpu"),
        lambda b: b.scheduling_gate("wait"),
        lambda b: b.pod_group("gang"),
        lambda b: b.priority(10),
    ], ids=["spread", "affinity", "anti-affinity", "preferred-node-affinity",
            "host-ports", "volumes", "claims", "gates", "pod-groups", "priority"])
    def test_out_of_scope_pod_refused(self, build):
        s = TorchScheduler(device="cpu")
        with pytest.raises(NotImplementedError):
            s.clientset.create_pod(build(make_pod().name("p").req({"cpu": "1"})).obj())
        assert not s.clientset.pods and s.queue.pending_counts() == (0, 0, 0)

    @pytest.mark.parametrize("build", [
        lambda b: b.taint("soft", "", "PreferNoSchedule"),
        lambda b: b.image("nginx", 100 << 20),
    ], ids=["prefer-no-schedule", "images"])
    def test_out_of_scope_node_refused(self, build):
        s = TorchScheduler(device="cpu")
        with pytest.raises(NotImplementedError):
            s.clientset.create_node(build(make_node().name("n").capacity({"cpu": 4})).obj())
        assert not s.clientset.nodes

    def test_cuda_is_the_default_device(self):
        if torch.cuda.is_available():
            assert TorchScheduler().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                TorchScheduler()


def _port_sources():
    for root, _dirs, files in os.walk(os.path.join(REPO, "kubernetes_tpu_torch")):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib") or top == "kubernetes_tpu"


class TestImportHygiene:
    def test_loading_the_port_loads_no_jax(self):
        code = ("import sys, pkgutil, importlib, kubernetes_tpu_torch as p\n"
                "for m in pkgutil.walk_packages(p.__path__, 'kubernetes_tpu_torch.'):\n"
                "    importlib.import_module(m.name)\n"
                "print(sorted(m for m in sys.modules if m.split('.')[0] in "
                "('jax', 'jaxlib', 'kubernetes_tpu')))\n")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "[]"

    def test_no_source_names_jax(self):
        for path in _port_sources():
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                else:
                    continue
                assert not any(_forbidden(n) for n in names), (path, names)
