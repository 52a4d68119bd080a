"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The scheduler's device path on an NVIDIA GPU — resource fit, taints,
node affinity, topology spread, inter-pod affinity, preemption and pod
groups: the host scheduling core (api/, core/, plugins/), the device
mirror and features (ops/), ten hand-written CUDA kernels (csrc/), the
TorchScheduler (models/) and the descheduler (controllers/), whose
what-if rescore is one of the kernels. The package imports torch and
numpy, never jax and nothing of kubernetes_tpu; the JAX package stays the
reference it is held against.
"""
