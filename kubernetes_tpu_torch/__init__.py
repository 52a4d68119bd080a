"""kubernetes_tpu_torch — the PyTorch/CUDA port of kubernetes_tpu.

The fit-only SchedulingBasic path on an NVIDIA GPU: the host scheduling
core (api/, core/, plugins/), the device mirror and features (ops/), four
hand-written CUDA kernels (csrc/) and the TorchScheduler (models/). The
package imports torch and numpy, never jax and nothing of kubernetes_tpu;
the JAX package stays the reference it is held against.
"""
