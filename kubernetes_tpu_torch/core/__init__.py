from .cache import Cache, Snapshot
from .clientset import FakeClientset
from .framework import Framework, Status
from .node_info import NodeInfo, PodInfo
from .queue import PriorityQueue, QueuedPodInfo
from .scheduler import ScheduleResult, Scheduler, num_feasible_nodes_to_find

__all__ = ["Cache", "Snapshot", "FakeClientset", "Framework", "Status",
           "NodeInfo", "PodInfo", "PriorityQueue", "QueuedPodInfo",
           "ScheduleResult", "Scheduler", "num_feasible_nodes_to_find"]
