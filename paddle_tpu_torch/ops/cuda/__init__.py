"""Hand-written Hopper kernels, one module per Pallas file of
``paddle_tpu/ops/pallas`` (``rms_norm``, ``fused_ops``, ``flash_attention``,
``decode_attention``, ``decode_megakernel``), and ``multi_tensor_adam``, the
optimizer's update (JAX's XLA program, no Pallas file). Each module holds
a kernel's wrapper and its plain PyTorch version (and, where the Pallas kernel has a backward, the
backward kernel and a ``torch.autograd.Function`` joining the two);
``launch_counts`` counts the launches by kernel name."""
from ._build import launch_counts

__all__ = ["launch_counts"]
