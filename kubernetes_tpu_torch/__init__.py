"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The scheduler's device path on an NVIDIA GPU — resource fit, taints,
node affinity, topology spread and inter-pod affinity: the host scheduling
core (api/, core/, plugins/), the device mirror and features (ops/), five
hand-written CUDA kernels (csrc/) and the TorchScheduler (models/). The
package imports torch and numpy, never jax and nothing of kubernetes_tpu;
the JAX package stays the reference it is held against.
"""
