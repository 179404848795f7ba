"""paddle_tpu_torch: the PyTorch and CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package ``paddle_tpu`` stays the reference; this package imports
neither it nor JAX. Its slices so far: serving, the LLaMA model
(``models.llama``) behind a continuous-batching engine over a paged KV
pool (``models.serving``: chunked prefill, a copy-on-write prefix cache,
preemption, deadlines and abort), whose decode steps run each decoder
layer's attention half as one fused kernel; training, the model's ``labels=``
loss and ``LlamaPretrainingCriterion``, per-layer recompute
(``distributed.fleet.recompute``), ``optimizer.Adam``/``AdamW`` with
JAX's surface (``optimizer.lr`` schedules, ``nn.clip``, parameter groups,
f32 master weights, ``acc_dtype``, state dicts) and ``jit.TrainStep``;
and the ``incubate`` fused layers with BERT (``models.bert``) built from
them. Eleven hand-written kernels under ``ops/cuda`` carry them: RMSNorm
forward and backward, RoPE and its adjoint, flash attention forward, dK/dV
and dQ, paged decode attention, the decode megakernel, bias + dropout +
residual + LayerNorm, and the multi-tensor Adam update. Entry points run
on the GPU unless given ``device="cpu"``.
"""
from . import distributed, incubate, jit, nn, optimizer
from .core.place import resolve_device, seed

__all__ = ["distributed", "incubate", "jit", "nn", "optimizer",
           "resolve_device", "seed"]
