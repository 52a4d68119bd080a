"""Benchmark of the port: `python -m kubernetes_tpu_torch.bench [--workload NAME]`.

The upstream scheduler_perf shapes that the JAX package carries in
kubernetes_tpu/perf/configs/performance-config.yaml. Five run on 5000 nodes
of 32 cpu / 256Gi / 110 pods across 50 zones with 100m pods:

  SchedulingBasic/5000Nodes_10000Pods        (the default) 1024 warm-up pods
                                             of the measured shape, then
                                             10000 identical 100m/128Mi pods;
  HomogeneousReplicaSurge/5000Nodes_10000Replicas
                                             512 init pods, then 10000
                                             measured ones, all 100m/128Mi
                                             labelled app: web-frontend
                                             (floors 680 pods/s and a hint
                                             hit rate of 0.9): after the
                                             init session the score-hint
                                             walker binds the replicas
                                             where it serves (by default
                                             on the CPU, not on a card:
                                             TorchScheduler score_hints);
  TopologySpreading/5000Nodes_5000Pods       1000 `app: warm` pods, then 5000
                                             pods under a hard zone spread
                                             (maxSkew 1, DoNotSchedule);
  PreferredTopologySpreading/5000Nodes_5000Pods   5000 pods, ScheduleAnyway;
  SchedulingPodAntiAffinity/5000Nodes_2000Pods    2000 pods, required
                                             anti-affinity on the hostname;
  SchedulingPodAffinity/5000Nodes_5000Pods   5000 pods, required affinity on
                                             the zone (the bootstrap case);
  Unschedulable/5kNodes/100Init/10kPods      100 pending 900-cpu init pods,
                                             then 10000 100m/128Mi pods while
                                             a churner creates a 900-cpu,
                                             priority-1000 pod every 200 ms
                                             (each runs DefaultPreemption and
                                             finds no candidate).
  Unschedulable/5kNodes/20kInit/10kPods      the same with 20000 init pods
                                             (floor 600): the failure memo
                                             parks the flood.

  PreemptionAsync/5000Nodes                  5000 nodes of 4 cpu / 16Gi / 32
                                             pods, no zones: 2000 priority-1
                                             4-cpu init pods, then 1000
                                             priority-100 4-cpu pods. In this
                                             shape nothing is preempted: the
                                             measured pods find 3000 empty
                                             nodes.
  SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods
                                             6000 of the 32-cpu nodes, 101
                                             namespaces labelled team: devops,
                                             100 x 40 init pods (100m, color:
                                             green, one namespace each 40),
                                             then 2000 pods in measure-ns-0
                                             with hostname anti-affinity to
                                             color: green pods of team: devops
                                             namespaces.
  SchedulingGangs/1000Nodes_250Groups        1000 of the 32-cpu nodes over 10
                                             zones, 250 pod groups of 4
                                             500m/256Mi members (min_count 4):
                                             gang device sessions.
  SchedulingGangsPlacement/1000Nodes_250Groups
                                             the same groups with the
                                             harness's topology constraint
                                             (topologyKey
                                             topology.kubernetes.io/zone) under
                                             the placement plugins, on the
                                             1000 nodes of 10 zones: each
                                             group's 10 candidate placements
                                             in one schedule_placements
                                             launch (the JAX config's shape,
                                             floor 60 pods/s).
  SchedulingGangsPlacement/5000Nodes_250Groups
                                             the same on the 5000 nodes of 50
                                             zones: 50 candidate placements a
                                             group. No upstream shape (no
                                             threshold: vs_baseline is null).

  NodeDeclaredFeaturesEnabled/5000Nodes20DeclaredFeatures
                                             the 5000 nodes, each declaring
                                             feature-0..19 (the harness's
                                             declaredFeatures), 5000 100m init
                                             pods, then 50000 100m/128Mi pods
                                             (floor 890 pods/s): the lap under
                                             the full default profile.
  SchedulingWhileGated/1Node_10000GatedPods  one node of 1000 cpu / 4Ti /
                                             90000 pods, 10000 pods held by a
                                             scheduling gate, 20000 pods in
                                             namespace `deleting`, then 20000
                                             measured pods while the deleting
                                             pods are deleted at 50/s (floor
                                             910 pods/s): every pod of 0 cpu,
                                             one pod a lap.
  HostPorts/5000Nodes_4000Pods               TopologySpreading's 5000 nodes,
                                             those of the first 10 zones
                                             reporting the 600 MiB image
                                             registry.example/agent:1; 1000 init
                                             pods bound to nodes 0-999, each
                                             holding TCP hostPort 8080; then
                                             4000 100m/128Mi pods with that port
                                             and image: one a node, the lap with
                                             the blocked lane and ImageLocality
                                             scores. No upstream shape (no
                                             threshold): DaemonSet-like agents.

  SchedulingCSIPVs/5000Nodes_5000Pods        5000 nodes of 32 cpu / 256Gi / 110
                                             pods with no zone label, each
                                             with a CSINode allowing 39
                                             ebs.csi.aws.com attachments;
                                             every pod 100m/128Mi with one
                                             pre-bound 1Gi ReadOnlyMany PV of
                                             that driver and its claim
                                             (bind-completed): 5000 init pods,
                                             one measured pod scheduled before
                                             the window, then 5000 (floor 100
                                             pods/s): the lap with the aux_cnt
                                             lane live, room 39 - existing.
  SchedulingMigratedInTreePVs/5000Nodes_5000Pods
                                             the same plan (the migrated
                                             in-tree PV carries the CSI driver).
  SchedulingInTreePVs/5000Nodes_2000Pods     the same nodes without CSINodes,
                                             PVs of no driver: 1000 init pods,
                                             then 2000 (floor 290): volume pods
                                             on the device with no lane.
  CSIAttachLimit/5000Nodes_9000Pods          the CSIPVs cluster with a limit of
                                             3: 5000 init pods, then 9000 —
                                             15000 attach slots for 14000 pods,
                                             the lane binding on most rows. No
                                             upstream shape (no threshold):
                                             clouds whose instance types cap
                                             attached disks.
  SchedulingWithResourceClaimTemplate/500Nodes_2000Pods
                                             500 of the 32-cpu nodes over 10
                                             zones, each with one ResourceSlice
                                             of 8 gpu.example.com devices
                                             (model: a100, index: j); every pod
                                             100m/128Mi with its own claim of
                                             one request (count 1, expression
                                             device.attributes["model"] ==
                                             "a100"), one measured pod
                                             scheduled before the window, then
                                             2000 (floor 60 pods/s) under the
                                             profile with DynamicResources: the
                                             lap with the aux_cnt lane counting
                                             each row's free matching devices.

  ChurnDriftRebalance/5000Nodes_Rebalance    the descheduler (`rebalance`):
                                             5000 nodes of the hollow plane's
                                             default shape (32 cpu / 256Gi /
                                             100Gi ephemeral / 110 pods) over
                                             100 zones, 2000 pods of 2000m/4Gi
                                             placed by TorchScheduler, then
                                             every node's cpu and memory
                                             skewed in place (hollowImbalance
                                             0.4, hollowSeed 20) and every
                                             100th node tainted NoSchedule;
                                             then descheduler ticks
                                             (hysteresis 2, margin 0.02, 64
                                             moves a tick: a 128 x 5000
                                             what-if batch), each followed by
                                             a scheduler round that places the
                                             pods it evicted. Prints the moves
                                             and the ticks' split.

The kernels are built and every plan of the measured shape is dispatched
once with no active pod (TorchScheduler.warm_for, and warm_for_placements
for a placement workload) before the warm-up pods, outside the measured
window. Prints one JSON line with the keys of the JAX
package's bench.py (`metric`, `value`, `unit`, `vs_baseline`, `detail`);
`vs_baseline` divides by the upstream threshold of the shape (the
reference's own pods/s floor, no target of the port), `detail.platform`
names the card, `detail.preemption` counts the window's PostFilter
attempts, device dry runs, victims and verification divergences,
`detail.churn_pods` the churner's pods, `detail.hint_hits`,
`hint_misses`, `hint_invalidations` and `hint_s` the score-hint walker's
binds, misses, invalidations and seconds, `detail.hint_hit_rate` the
window's pods it bound over those scheduled (beside `hint_hit_rate_floor`,
the shape's HintHitRate threshold where it has one), `detail.memo_hits` the
pods parked from the failure memo,
`detail.placement_device_evals`
and `placement_eval_s` the group cycles whose placements the kernel
evaluated and their seconds, and the plan acquisitions by kind
(`plan_rebuilds_full` / `_delta` / `_resume`), the rows the delta patches
wrote (`delta_dirty_rows`) and the seconds of full rebuilds (`plan_build_s`)
and of every acquisition and in-session patch (`plan_acquire_s`).

Environment: BENCH_NODES, BENCH_PODS, BENCH_WARMUP (the warm-up or init
pods), BENCH_MAX_BATCH; `--device cpu` runs the kernels' plain versions on
the CPU. `--profile` runs the measured window under torch.profiler and adds
`detail.profile`: the device's busy time (the union of its kernel and copy
intervals), its busy share of the window, and the time and count of each
device kernel. The profiler slows the host, so pods/s comes from a run
without it.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from .api.dra import Device, DeviceRequest, ResourceClaim, ResourceSlice
from .api.resource import to_int
from .api.storage import BIND_COMPLETED, ROX, CSINode, PersistentVolume, PersistentVolumeClaim
from .api.types import Namespace, PodGroup, Volume
from .controllers.descheduler import DeschedulerController, default_strategies
from .core.registry import default_profile, dra_profile, gang_placement_profile
from .models import TorchScheduler
from .ops import kernel
from .ops.whatif import whatif_score
from .testing import EvictingClientset, make_node, make_pod

ZONE = "topology.kubernetes.io/zone"
HOSTNAME = "kubernetes.io/hostname"

WINDOW_COUNTERS = ("scheduled", "failures", "device_batches", "device_scheduled",
                   "host_path_pods", "plan_build_s", "plan_acquire_s", "collect_s",
                   "dispatch_s", "device_wait_s", "host_commit_s", "session_end_s",
                   "plan_rebuilds_full", "plan_rebuilds_delta", "plan_rebuilds_resume",
                   "delta_dirty_rows", "placement_device_evals", "placement_eval_s",
                   "shard_map_dispatches", "hint_hits", "hint_misses", "hint_invalidations",
                   "hint_s", "memo_hits")


class NodeTemplate(NamedTuple):
    """createNodes' nodeTemplate: capacity, the zone count (0: no zone
    label), the declared features feature-0..features-1 on every node, an
    image (name, bytes, zones) that the nodes of the first `zones` zones
    report, csiNodeAllocatable (driver, count): every node's CSINode, and
    createResourceSlices' devicesPerNode: one ResourceSlice of that many
    DRA_DRIVER devices a node (0: none)."""

    cpu: int = 32
    memory: str = "256Gi"
    pods: int = 110
    zones: int = 50
    features: int = 0
    image: Optional[Tuple[str, int, int]] = None
    csi: Optional[Tuple[str, int]] = None
    devices: int = 0


class Churn(NamedTuple):
    """The churn opcode in `create` mode (scheduler_perf.go:72): a pod of
    the template every `interval_s` while the measured window runs."""

    build: Callable
    interval_s: float


class Namespaces(NamedTuple):
    """createNamespaces + createPodSets: `init` namespaces `init-ns-<i>`
    share the init pods evenly (in namespace order), the measured pods go
    to `measure-ns-0`; all carry `labels`."""

    init: int
    labels: dict


class Gang(NamedTuple):
    """createPodGroups: the measured pods in groups of `size` (min_count
    `size`), each group created before its members; a `topology_key`
    constrains each group to one of its domains (the placement plugins)."""

    size: int
    topology_key: str = ""


class Deleting(NamedTuple):
    """deletePods with skipWaitToCompletion: the init pods, created in
    `namespace`, are deleted at `per_second` while the measured window
    runs."""

    namespace: str = "deleting"
    per_second: float = 50.0


class Volumes(NamedTuple):
    """createPods' persistentVolumeTemplate and persistentVolumeClaimTemplate:
    each pod gets one PV of `capacity` and `access_modes` (of the CSI driver
    `csi`, "" for none) pre-bound to its own claim, bind-completed (the JAX
    package's perf harness, kubernetes_tpu/perf/harness.py:800-827)."""

    csi: str = ""
    capacity: str = "1Gi"
    access_modes: Tuple[str, ...] = (ROX,)


class Claims(NamedTuple):
    """createPods' resourceClaimTemplate: each pod gets its own
    ResourceClaim `<pod>-claim` of one request (the JAX package's perf
    harness, kubernetes_tpu/perf/harness.py:829-841)."""

    count: int = 1
    expression: str = 'device.attributes["model"] == "a100"'


class Workload(NamedTuple):
    """One scheduler_perf shape: the measured pods' template (a builder
    step over make_pod), their count, the warm-up/init pods (`init_build`
    their template; None: the measured shape), the upstream pods/s
    threshold (None: no upstream shape), the nodes, the churn during the
    window, the namespaces the pods are created in (None: `default`), the
    pod groups they form (None: none), the pods of the measured shape held
    by a scheduling gate (created first, never released), the init pods'
    deletion during the window, whether init pod i is created bound to
    node i, the PV and claim each pod gets (None: no volume), and the
    resource claim each pod gets (None: none), and the shape's HintHitRate
    floor (None: none)."""

    measure_pods: int
    build: Callable
    init_pods: int
    init_build: Optional[Callable]
    threshold: Optional[float]
    node: NodeTemplate = NodeTemplate()
    churn: Optional[Churn] = None
    namespaces: Optional[Namespaces] = None
    gang: Optional[Gang] = None
    gated: int = 0
    deleting: Optional[Deleting] = None
    bound_init: bool = False
    volumes: Optional[Volumes] = None
    claims: Optional[Claims] = None
    hint_floor: Optional[float] = None


AGENT_IMAGE = "registry.example/agent:1"
EBS = "ebs.csi.aws.com"
NO_ZONES = NodeTemplate(zones=0)
GATE = "test.k8s.io/hold"
DRA_DRIVER = "gpu.example.com"


def _basic(b):
    return b.req({"cpu": "100m", "memory": "128Mi"})


def _replica(b):
    return _basic(b).labels({"app": "web-frontend"})


def _big(b):
    return b.req({"cpu": 900, "memory": "128Mi"})


def _gang_member(b):
    return b.req({"cpu": "500m", "memory": "256Mi"})


def _zero(b):
    return b.req({"cpu": "0", "memory": "0"})


def _agent(b):
    return _basic(b).host_port(8080).image(AGENT_IMAGE)


WORKLOADS = {
    "SchedulingBasic/5000Nodes_10000Pods": Workload(10000, _basic, 1024, None, 680.0),
    "HomogeneousReplicaSurge/5000Nodes_10000Replicas": Workload(
        10000, _replica, 512, None, 680.0, hint_floor=0.9),
    "TopologySpreading/5000Nodes_5000Pods": Workload(
        5000, lambda b: b.req({"cpu": "100m"}).labels({"app": "spread"})
        .spread_constraint(1, ZONE, "DoNotSchedule", {"app": "spread"}), 1000,
        lambda b: b.req({"cpu": "100m"}).labels({"app": "warm"}), 460.0),
    "PreferredTopologySpreading/5000Nodes_5000Pods": Workload(
        5000, lambda b: b.req({"cpu": "100m"}).labels({"app": "soft-spread"})
        .spread_constraint(1, ZONE, "ScheduleAnyway", {"app": "soft-spread"}), 0, None, 340.0),
    "SchedulingPodAntiAffinity/5000Nodes_2000Pods": Workload(
        2000, lambda b: b.req({"cpu": "100m"}).labels({"app": "exclusive"})
        .pod_affinity(HOSTNAME, {"app": "exclusive"}, anti=True), 0, None, 180.0),
    "SchedulingPodAffinity/5000Nodes_5000Pods": Workload(
        5000, lambda b: b.req({"cpu": "100m"}).labels({"app": "pack"})
        .pod_affinity(ZONE, {"app": "pack"}), 0, None, 70.0),
    "PreemptionAsync/5000Nodes": Workload(
        1000, lambda b: b.req({"cpu": 4}).priority(100), 2000,
        lambda b: b.req({"cpu": 4}).priority(1), 570.0,
        node=NodeTemplate(cpu=4, memory="16Gi", pods=32, zones=0)),
    "Unschedulable/5kNodes/100Init/10kPods": Workload(
        10000, _basic, 100, _big, 590.0,
        churn=Churn(lambda b: b.req({"cpu": 900, "memory": "1Gi"}).priority(1000), 0.2)),
    "Unschedulable/5kNodes/20kInit/10kPods": Workload(
        10000, _basic, 20000, _big, 600.0,
        churn=Churn(lambda b: b.req({"cpu": 900, "memory": "1Gi"}).priority(1000), 0.2)),
    "SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods": Workload(
        2000, lambda b: b.req({"cpu": "100m"}).labels({"color": "green"})
        .pod_affinity(HOSTNAME, {"color": "green"}, anti=True, ns_labels={"team": "devops"}),
        4000, lambda b: b.req({"cpu": "100m"}).labels({"color": "green"}), 140.0,
        namespaces=Namespaces(100, {"team": "devops"})),
    "SchedulingGangs/1000Nodes_250Groups": Workload(
        1000, _gang_member, 0, None, 200.0, node=NodeTemplate(zones=10), gang=Gang(4)),
    "SchedulingGangsPlacement/1000Nodes_250Groups": Workload(
        1000, _gang_member, 0, None, 60.0, node=NodeTemplate(zones=10), gang=Gang(4, ZONE)),
    "SchedulingGangsPlacement/5000Nodes_250Groups": Workload(
        1000, _gang_member, 0, None, None, gang=Gang(4, ZONE)),
    "NodeDeclaredFeaturesEnabled/5000Nodes20DeclaredFeatures": Workload(
        50000, _basic, 5000, lambda b: b.req({"cpu": "100m"}), 890.0,
        node=NodeTemplate(features=20)),
    "SchedulingWhileGated/1Node_10000GatedPods": Workload(
        20000, _zero, 20000, None, 910.0,
        node=NodeTemplate(cpu=1000, memory="4Ti", pods=90000, zones=0),
        gated=10000, deleting=Deleting()),
    "HostPorts/5000Nodes_4000Pods": Workload(
        4000, _agent, 1000, lambda b: _basic(b).host_port(8080), None,
        node=NodeTemplate(image=(AGENT_IMAGE, 600 * 1024 ** 2, 10)), bound_init=True),
    "SchedulingCSIPVs/5000Nodes_5000Pods": Workload(
        5000, _basic, 5000, None, 100.0, node=NO_ZONES._replace(csi=(EBS, 39)),
        volumes=Volumes(csi=EBS)),
    "SchedulingMigratedInTreePVs/5000Nodes_5000Pods": Workload(
        5000, _basic, 5000, None, 100.0, node=NO_ZONES._replace(csi=(EBS, 39)),
        volumes=Volumes(csi=EBS)),
    "SchedulingInTreePVs/5000Nodes_2000Pods": Workload(
        2000, _basic, 1000, None, 290.0, node=NO_ZONES, volumes=Volumes()),
    "CSIAttachLimit/5000Nodes_9000Pods": Workload(
        9000, _basic, 5000, None, None, node=NO_ZONES._replace(csi=(EBS, 3)),
        volumes=Volumes(csi=EBS)),
    "SchedulingWithResourceClaimTemplate/500Nodes_2000Pods": Workload(
        2000, _basic, 0, None, 60.0, node=NodeTemplate(zones=10, devices=8), claims=Claims()),
}
NODES = {"SchedulingRequiredPodAntiAffinityWithNSSelector/5000Nodes_2000Pods": 6000,
         "SchedulingGangs/1000Nodes_250Groups": 1000,
         "SchedulingGangsPlacement/1000Nodes_250Groups": 1000,
         "SchedulingWhileGated/1Node_10000GatedPods": 1,
         "SchedulingWithResourceClaimTemplate/500Nodes_2000Pods": 500}
DEFAULT_WORKLOAD = "SchedulingBasic/5000Nodes_10000Pods"


def cluster_node(i: int, node: NodeTemplate = NodeTemplate(), taint=None):
    """createNodes' node `node-<i>` of the template (`taint`: a (key, value,
    effect) to add)."""
    b = make_node().name(f"node-{i}").capacity({"cpu": node.cpu, "memory": node.memory,
                                                 "pods": node.pods})
    if node.zones:
        b = b.zone(f"zone-{i % node.zones}")
    if taint is not None:
        b = b.taint(*taint)
    if node.image is not None and i % max(1, node.zones) < node.image[2]:
        b = b.image(*node.image[:2])
    out = b.obj()
    out.declared_features = {f"feature-{j}": True for j in range(node.features)}
    return out


def profile_for(workload: str):
    """The profile a workload's scheduler runs: the placement plugins for
    topology-constrained groups (GenericWorkload-gated in the reference),
    DynamicResources for a workload with resource claims
    (DynamicResourceAllocation-gated)."""
    w = WORKLOADS[workload]
    if w.gang is not None and w.gang.topology_key:
        return gang_placement_profile
    return dra_profile if w.claims is not None else default_profile


def build_cluster(n_nodes: int, device="cuda", max_batch=None,
                  node: NodeTemplate = NodeTemplate(), resume: bool = True,
                  profile_factory=default_profile, mesh="auto",
                  score_hints: Optional[bool] = None) -> TorchScheduler:
    sched = TorchScheduler(device=device, max_batch=max_batch, resume=resume,
                           profile_factory=profile_factory, mesh=mesh, score_hints=score_hints)
    for i in range(n_nodes):
        sched.clientset.create_node(cluster_node(i, node))
        if node.csi is not None:
            sched.clientset.create_csi_node(CSINode(node_name=f"node-{i}",
                                                    driver_limits={node.csi[0]: node.csi[1]}))
        if node.devices:
            sched.clientset.create_resource_slice(ResourceSlice(
                node_name=f"node-{i}", driver=DRA_DRIVER,
                devices=[Device(name=f"node-{i}-dev{j}",
                                attributes={"model": "a100", "index": str(j)})
                         for j in range(node.devices)]))
    return sched


def _clones(build: Callable, n: int, prefix: str, namespace: str = "default"):
    proto = build(make_pod().name("proto").namespace(namespace)).obj()
    return [proto.clone_from_template(f"{prefix}-{i}") for i in range(n)]


def make_pods(n: int, prefix: str, workload: str = DEFAULT_WORKLOAD):
    """N clones of the workload's measured template (shared spec and
    signature memo), in its measured namespace. SchedulingBasic pods carry
    `app: <prefix>`; a gang workload's pods name their group,
    `<prefix>-group-<i>`, `size` consecutive pods a group; in a volume
    workload pod `<name>` mounts its own claim `pvc-<name>`, in a claim
    workload it names its resource claim `<name>-claim` (create_pods
    creates the claims and PVs)."""
    w = WORKLOADS[workload]
    ns = "measure-ns-0" if w.namespaces is not None else "default"
    if workload == DEFAULT_WORKLOAD:
        return _clones(lambda b: w.build(b).labels({"app": prefix}), n, prefix)
    pods = _clones(w.build, n, prefix, ns)
    if w.gang is not None:
        for i, p in enumerate(pods):
            p.pod_group = f"{prefix}-group-{i // w.gang.size}"
    if w.volumes is not None:
        for p in pods:
            p.volumes = [Volume(name="data", pvc_name=f"pvc-{p.name}")]
    if w.claims is not None:
        for p in pods:
            p.resource_claims = [f"{p.name}-claim"]
    return pods


def create_volume(sched: TorchScheduler, pod, vol: Volumes) -> None:
    """The pod's pre-bound PV and claim (the harness's pv-csi.yaml / pvc.yaml
    pair, bind-completed)."""
    cap = to_int(vol.capacity)
    for v in pod.volumes:
        pv = PersistentVolume(name=f"pv-{v.pvc_name}", capacity=cap,
                              access_modes=vol.access_modes, csi_driver=vol.csi)
        pvc = PersistentVolumeClaim(name=v.pvc_name, namespace=pod.namespace, request=cap,
                                    access_modes=vol.access_modes, volume_name=pv.name,
                                    annotations={BIND_COMPLETED: "true"})
        pv.claim_ref = pvc.key
        sched.clientset.create_pv(pv)
        sched.clientset.create_pvc(pvc)


def create_pods(sched: TorchScheduler, pods, workload: str) -> None:
    """Create `pods`; in a gang workload each group is created before its
    first member (createPodGroups), in a volume workload each pod's PV and
    claim before the pod, in a claim workload its resource claim."""
    w = WORKLOADS[workload]
    gang = w.gang
    made = set()
    for p in pods:
        if gang is not None and p.pod_group not in made:
            made.add(p.pod_group)
            sched.clientset.create_pod_group(PodGroup(
                name=p.pod_group, namespace=p.namespace, min_count=gang.size,
                topology_keys=(gang.topology_key,) if gang.topology_key else ()))
        if w.volumes is not None:
            create_volume(sched, p, w.volumes)
        for name in p.resource_claims:
            sched.clientset.create_resource_claim(ResourceClaim(
                name=name, namespace=p.namespace, requests=[DeviceRequest(
                    name="req", count=w.claims.count, expression=w.claims.expression)]))
        sched.clientset.create_pod(p)


def init_pods(n: int, workload: str):
    """The workload's init pods (its warm-up pods of the measured shape
    where it has no init template), spread evenly over its init
    namespaces in namespace order (createPodSets), one template each."""
    w = WORKLOADS[workload]
    if w.deleting is not None:
        return _clones(w.init_build or w.build, n, w.deleting.namespace, w.deleting.namespace)
    if w.init_build is None:
        return make_pods(n, "warm", workload)
    if w.namespaces is None:
        pods = _clones(w.init_build, n, "init")
        if w.bound_init:
            for i, p in enumerate(pods):
                p.node_name = f"node-{i}"
        return pods
    k = w.namespaces.init
    return [p for i in range(k)
            for p in _clones(w.init_build, n // k + (i < n % k), f"init-{i}", f"init-ns-{i}")]


def create_namespaces(sched: TorchScheduler, workload: str) -> None:
    """createNamespaces: the init namespaces, then measure-ns-0."""
    ns = WORKLOADS[workload].namespaces
    if ns is None:
        return
    for name in [f"init-ns-{i}" for i in range(ns.init)] + ["measure-ns-0"]:
        sched.clientset.create_namespace(Namespace(name=name, labels=dict(ns.labels)))


class Churner:
    """Creates the workload's churn pods, the first one interval into the
    window (a Go ticker's first tick); `tick()` runs between scheduling
    cycles, as the JAX package's perf harness drives its churner
    (kubernetes_tpu/perf/harness.py:376-411). With a `limit` it creates
    exactly that many, and the window lasts until it has."""

    def __init__(self, sched: TorchScheduler, churn: Churn, limit: Optional[int] = None):
        self.sched = sched
        self.churn = churn
        self.limit = limit
        self.pods: list = []
        self._next = time.perf_counter() + churn.interval_s

    def tick(self) -> None:
        while (time.perf_counter() >= self._next
               and (self.limit is None or len(self.pods) < self.limit)):
            self._next += self.churn.interval_s
            p = self.churn.build(make_pod().name(f"churn-{len(self.pods)}")).obj()
            self.sched.clientset.create_pod(p)
            self.pods.append(p)

    def pending(self) -> bool:
        """A limited churner that has pods still to create."""
        return self.limit is not None and len(self.pods) < self.limit


class Deleter:
    """The init pods deleted at a fixed rate while the window runs, counted
    from the window's start (the JAX package's perf harness _RateDeleter,
    kubernetes_tpu/perf/harness.py:355-372); `tick()` runs between
    scheduling cycles. It never holds the window open."""

    def __init__(self, sched: TorchScheduler, pods, per_second: float):
        self.sched = sched
        self.pods = list(pods)
        self.per_second = per_second
        self.deleted = 0
        self._t0 = time.perf_counter()

    def tick(self) -> None:
        due = min(int((time.perf_counter() - self._t0) * self.per_second), len(self.pods))
        while self.deleted < due:
            self.sched.clientset.delete_pod(self.pods[self.deleted])
            self.deleted += 1

    def pending(self) -> bool:
        return False


def drain(sched: TorchScheduler, tickers=()) -> None:
    """Schedule until the queue stops yielding (and a limited churner has
    created all its pods), the tickers (a churner, a deleter) ticking
    between cycles."""
    if not tickers:
        sched.run_until_idle()
        return
    while True:
        for t in tickers:
            t.tick()
        if not sched.schedule_one():
            sched.queue.flush_backoff_completed()
            if not sched.schedule_one():
                if not any(t.pending() for t in tickers):
                    break
                time.sleep(0.001)


def platform_name(sched: TorchScheduler) -> str:
    if sched.device.type == "cuda":
        return torch.cuda.get_device_name(sched.device)
    return "cpu"


def warm(sched: TorchScheduler, warmup: int, workload: str = DEFAULT_WORKLOAD) -> None:
    """The workload's namespaces, kernel build and inert dispatches of the
    measured shape, then the workload's warm-up (or init) pods, scheduled
    (or tried)."""
    create_namespaces(sched, workload)
    w = WORKLOADS[workload]
    shape = make_pods(1, "warmshape", workload)[0]
    sched.warm_for(shape)
    if w.gang is not None and w.gang.topology_key:
        sched.warm_for_placements(shape, w.gang.size, max(1, w.node.zones))
    if w.gated:
        create_pods(sched, _clones(lambda b: w.build(b).scheduling_gate(GATE), w.gated,
                                   "gated"), workload)
    create_pods(sched, init_pods(warmup, workload), workload)
    sched.run_until_idle()


def measure(sched: TorchScheduler, n_pods: int, prefix: str = "bench",
            workload: str = DEFAULT_WORKLOAD, churn_limit: Optional[int] = None,
            label: Optional[str] = None) -> dict:
    """Schedule n_pods pods of the workload's measured shape, with its
    churn; returns the window's result line. A `label` names a run that is
    not the workload itself (other init pods, say): it heads the metric, and
    `vs_baseline` is None, since the upstream threshold is the workload's."""
    w = WORKLOADS[workload]
    if w.volumes is not None or w.claims is not None:
        # The harness schedules one measured pod, claim and PV included,
        # before the window opens (kubernetes_tpu/perf/harness.py:903-910).
        create_pods(sched, make_pods(1, f"{prefix}-first", workload), workload)
        sched.run_until_idle()
    win0 = {a: getattr(sched, a) for a in WINDOW_COUNTERS}
    pre0 = sched.preemption_counts()
    evals0 = sched.preemption_device_evals
    create_pods(sched, make_pods(n_pods, prefix, workload), workload)
    churner = Churner(sched, w.churn, churn_limit) if w.churn is not None else None
    deleter = None
    if w.deleting is not None:
        ns = w.deleting.namespace
        deleter = Deleter(sched, [p for p in sched.clientset.pods.values() if p.namespace == ns],
                          w.deleting.per_second)
    t0 = time.perf_counter()
    drain(sched, [t for t in (churner, deleter) if t is not None])
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    elapsed = time.perf_counter() - t0
    detail = {a: getattr(sched, a) - win0[a] for a in WINDOW_COUNTERS}
    pods_per_sec = detail["scheduled"] / elapsed if elapsed > 0 else 0.0
    preemption = {k: v - pre0[k] for k, v in sched.preemption_counts().items()}
    preemption["device_evals"] = sched.preemption_device_evals - evals0
    if detail["scheduled"]:
        detail["hint_hit_rate"] = detail["hint_hits"] / detail["scheduled"]
    if w.hint_floor is not None:
        detail["hint_hit_rate_floor"] = w.hint_floor
    detail.update(workload=workload, elapsed_s=elapsed, platform=platform_name(sched),
                  launches={w.__name__: w.launches for w in kernel.WRAPPERS},
                  preemption=preemption,
                  churn_pods=len(churner.pods) if churner is not None else 0,
                  deleted_pods=deleter.deleted if deleter is not None else 0)
    return {
        "metric": (f"pods scheduled/sec ({label or workload}: {sched.snapshot.num_nodes()} "
                   f"nodes, {n_pods} pods, device batch path)"),
        "value": pods_per_sec,
        "unit": "pods/s",
        "vs_baseline": None if label or w.threshold is None else pods_per_sec / w.threshold,
        "detail": detail,
    }


def profile(sched: TorchScheduler, n_pods: int, workload: str = DEFAULT_WORKLOAD) -> dict:
    """measure() under torch.profiler, with the device timeline summarized."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if sched.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts) as prof:
        result = measure(sched, n_pods, prefix="profiled", workload=workload)
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        spans.append((e.time_range.start, e.time_range.end))
        k = kernels.setdefault(e.name, {"count": 0, "ms": 0.0})
        k["count"] += 1
        k["ms"] += (e.time_range.end - e.time_range.start) / 1e3
    busy_us, reach = 0.0, float("-inf")
    for a, b in sorted(spans):  # union of the device intervals
        if b > reach:
            busy_us += b - max(a, reach)
            reach = b
    elapsed = result["detail"]["elapsed_s"]
    result["detail"]["profile"] = {
        "device_events": len(spans), "device_busy_s": busy_us / 1e6,
        "device_busy_share": busy_us / 1e6 / elapsed if elapsed > 0 else 0.0,
        "kernels": dict(sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])),
    }
    return result


REBALANCE = "ChurnDriftRebalance/5000Nodes_Rebalance"


class Rebalance(NamedTuple):
    """The ChurnDriftRebalance/5000Nodes_Rebalance row's parameters
    (kubernetes_tpu/perf/configs/performance-config.yaml:199-218) and the
    hollow plane's default node and 100 zones. The row churns hollow nodes
    into skewed replacements; here every node is skewed once, in place, by
    the same formula, with no PodDisruptionBudget and no settle window."""

    nodes: int = 5000
    pods: int = 2000
    zones: int = 100
    imbalance: float = 0.4     # hollowImbalance
    seed: int = 20             # hollowSeed
    taint_every: int = 100     # an untolerated NoSchedule taint on every 100th node
    hysteresis: int = 2        # descheduleHysteresis
    margin: float = 0.02       # descheduleMargin
    max_moves: int = 64        # descheduleMaxMoves: 128 candidates a tick
    tick_s: float = 0.5        # descheduleTickS, on the controller's clock
    max_ticks: int = 20
    stddev_ceiling: int = 50   # the row's MaxUtilizationStddevMilli


def hollow_node(i: int, cfg: Rebalance, factor: float = 1.0, taint: bool = False):
    """The hollow plane's default node (kubernetes_tpu/hollow/profile.py:40-43)
    `node-<i>`, its cpu and memory scaled by `factor` with the plane's floors
    (kubernetes_tpu/hollow/plane.py:421-436)."""
    b = make_node().name(f"node-{i}").capacity({
        "cpu": f"{max(1000, int(32000 * factor))}m",
        "memory": max(1 << 20, int(256 * 1024 ** 3 * factor)),
        "ephemeral-storage": "100Gi", "pods": 110}).zone(f"zone-{i % cfg.zones}")
    if taint:
        b = b.taint("drift", "true", "NoSchedule")
    return b.obj()


def skew_factor(name: str, cfg: Rebalance) -> float:
    """The hollow plane's capacity skew of `name`: keyed off the seed and the
    name alone."""
    rnd = random.Random(f"{cfg.seed}:{name}")
    return 1.0 + cfg.imbalance * (2.0 * rnd.random() - 1.0)


def _round(sched: TorchScheduler) -> float:
    t0 = time.perf_counter()
    sched.run_until_idle()
    if sched.device.type == "cuda":
        torch.cuda.synchronize(sched.device)
    return time.perf_counter() - t0


def rebalance(device="cuda", cfg: Rebalance = Rebalance()) -> dict:
    """The ChurnDriftRebalance drive: place cfg.pods pods on cfg.nodes nodes
    with TorchScheduler, skew every node in place, then run descheduler
    ticks, each followed by a scheduler round that places the pods the tick
    evicted, until a tick emits no move or cfg.max_ticks ticks. Returns the
    drive's counts and each tick's split; `sched`, `ctrl` and `cs` are the
    objects it drove."""
    cs = EvictingClientset()
    clock = [0.0]
    cs.lease_now = lambda: clock[0]
    sched = TorchScheduler(clientset=cs, device=device)
    for i in range(cfg.nodes):
        cs.create_node(hollow_node(i, cfg))
    proto = make_pod().name("proto").req({"cpu": "2000m", "memory": "4Gi"}).obj()
    sched.warm_for(proto)
    for i in range(cfg.pods):
        p = proto.clone_from_template(f"rebalance-{i}")
        p.uid = p.name    # the same uids on every run: intents are uid@node
        cs.create_pod(p)
    place_s = _round(sched)
    placed = sum(1 for p in cs.pods.values() if p.node_name)
    for i in range(cfg.nodes):
        name = f"node-{i}"
        cs.update_node(hollow_node(i, cfg, skew_factor(name, cfg),
                                   taint=i % cfg.taint_every == 0))
    ctrl = DeschedulerController(cs, device=device, hysteresis=cfg.hysteresis,
                                 strategies=default_strategies(margin=cfg.margin),
                                 max_moves_per_tick=cfg.max_moves, now=lambda: clock[0])
    ticks = []
    for _ in range(cfg.max_ticks):
        before = (sum(ctrl.moves_total.values()), cs.evictions_committed, ctrl.whatif_batches,
                  whatif_score.launches, ctrl.whatif_encode_s, ctrl.whatif_score_s,
                  ctrl.whatif_moves_s)
        t0 = time.perf_counter()
        ctrl.tick_once()
        tick_s = time.perf_counter() - t0
        clock[0] += cfg.tick_s
        evicted = cs.evictions_committed - before[1]
        round_s = _round(sched)
        ticks.append(dict(
            moves=sum(ctrl.moves_total.values()) - before[0], evicted=evicted,
            batches=ctrl.whatif_batches - before[2], launches=whatif_score.launches - before[3],
            errors=ctrl.errors, util_stddev_milli=ctrl.util_stddev_milli,
            tick_s=tick_s, encode_s=ctrl.whatif_encode_s - before[4],
            score_s=ctrl.whatif_score_s - before[5], best_moves_s=ctrl.whatif_moves_s - before[6],
            round_s=round_s, round_pods_per_s=evicted / round_s if evicted and round_s else 0.0))
        if not ticks[-1]["moves"]:
            break
    stddev_after = ctrl._util_stddev_milli(ctrl._snapshot())
    pods = list(cs.pods.values())
    return dict(
        workload=REBALANCE, nodes=cfg.nodes, pods=cfg.pods, device=str(sched.device),
        initial_placed=placed, initial_place_s=place_s, ticks=ticks,
        moves=dict(ctrl.moves_total), blocked=dict(ctrl.blocked_total),
        no_target=ctrl.no_target, drift=dict(ctrl.drift), errors=ctrl.errors,
        evictions=cs.evictions_committed, pending_evictions=ctrl.evictor.pending_count(),
        util_stddev_milli_before=ticks[0]["util_stddev_milli"] if ticks else 0,
        util_stddev_milli_after=stddev_after, stddev_ceiling=cfg.stddev_ceiling,
        bound=sum(1 for p in pods if p.node_name), total=len(pods),
        sched=sched, ctrl=ctrl, cs=cs)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = argv[argv.index("--device") + 1] if "--device" in argv else "cuda"
    workload = argv[argv.index("--workload") + 1] if "--workload" in argv else DEFAULT_WORKLOAD
    if workload == REBALANCE:
        cfg = Rebalance(nodes=int(os.environ.get("BENCH_NODES", Rebalance.nodes)),
                        pods=int(os.environ.get("BENCH_PODS", Rebalance.pods)))
        out = rebalance(device, cfg)
        moves = sum(out["moves"].values())
        for key in ("sched", "ctrl", "cs"):
            del out[key]
        out["platform"] = torch.cuda.get_device_name() if device != "cpu" else "cpu"
        print(json.dumps({"metric": f"descheduler moves ({REBALANCE}: {cfg.nodes} nodes, "
                                    f"{cfg.pods} pods, {len(out['ticks'])} ticks)",
                          "value": moves, "unit": "moves", "vs_baseline": None,
                          "detail": out}))
        return 0
    if workload not in WORKLOADS:
        print(f"unknown workload {workload!r}; one of: "
              f"{', '.join(list(WORKLOADS) + [REBALANCE])}", file=sys.stderr)
        return 2
    w = WORKLOADS[workload]
    n_nodes = int(os.environ.get("BENCH_NODES", NODES.get(workload, 5000)))
    n_pods = int(os.environ.get("BENCH_PODS", w.measure_pods))
    warmup = int(os.environ.get("BENCH_WARMUP", w.init_pods))
    max_batch = int(os.environ.get("BENCH_MAX_BATCH", 0)) or None
    sched = build_cluster(n_nodes, device=device, max_batch=max_batch, node=w.node,
                          profile_factory=profile_for(workload))
    warm(sched, warmup, workload)
    kernel.reset_launch_counts()
    if "--profile" in argv:
        print(json.dumps(profile(sched, n_pods, workload)))
    else:
        print(json.dumps(measure(sched, n_pods, workload=workload)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
