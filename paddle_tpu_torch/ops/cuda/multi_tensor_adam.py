"""The whole Adam / AdamW update of a group of tensors: the hand-written
multi-tensor kernel (``csrc/multi_tensor_adam.cu``), its plain PyTorch
version, and the wrapper that picks between them by device.

Counterpart of no Pallas kernel: of the one jitted XLA program into which
``paddle_tpu/optimizer/optimizer.py`` folds every parameter's update
(``_build_update`` :251, ``Adam._rule`` :682, ``AdamW._rule`` :745). A
group is what one launch takes: parameters of one dtype, all with f32
masters or none, moment1 in one dtype (:class:`AdamTensors`). The update
reads the learning rate, the step t and the clip scales from ``state``, a
device f32 vector ``[lr, t, scale_0, ...]``, so nothing it reads comes from
the host at launch time.

The arithmetic is f32, as JAX's with f32 work values (f32 parameters, or
f32 masters). For bf16 parameters without masters JAX runs its rule in
bf16, where beta2 = 0.999 rounds to 1 and the first step's bias
correction divides 0 by 0 (every parameter becomes NaN); the port
computes in f32 there too and stores the parameter and both moments in
bf16, as PyTorch's own Adam does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["AdamTensors", "multi_tensor_adam", "multi_tensor_adam_plain",
           "CHUNK"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
CHUNK = 16384  # elements a block (kChunk in the source)
# one tensor of the group as the kernel reads it (struct AdamTensor)
_TENSOR = np.dtype([("p", "<i8"), ("master", "<i8"), ("m", "<i8"),
                    ("v", "<i8"), ("numel", "<i8"), ("lr_mult", "<f4"),
                    ("coeff", "<f4"), ("slot", "<i4"),
                    ("first_block", "<i4")])
assert _TENSOR.itemsize == 56


class AdamTensors:
    """One launch group of the update: ``params`` (one dtype, on one
    device), ``masters`` (all f32 or all None), ``moment1`` (one dtype),
    ``moment2`` (in the work dtype: f32 with masters, else the
    parameters'), and per tensor its learning-rate multiplier, its decay
    coefficient (0 for none) and the index of its clip scale in ``state``
    past ``[lr, t]`` (-1 for none); the multipliers and coefficients are
    f32, as JAX casts a Python scalar into its f32 work values. The device
    table is built at the first launch and kept: the state tensors must
    not move."""

    def __init__(self, params, masters, moment1, moment2, lr_mults, coeffs,
                 slots):
        self.params = list(params)
        self.masters = list(masters)
        self.moment1, self.moment2 = list(moment1), list(moment2)
        self.lr_mults = [float(x) for x in lr_mults]
        self.slots = [int(s) for s in slots]
        n = len(self.params)
        if not (len(self.masters) == len(self.moment1) == len(self.moment2)
                == len(self.lr_mults) == len(coeffs) == len(self.slots) == n):
            raise ValueError("AdamTensors: lists of different lengths")
        if n == 0:
            raise ValueError("AdamTensors: no tensors")
        self.param_dtype = self.params[0].dtype
        self.has_master = self.masters[0] is not None
        self.work_dtype = torch.float32 if self.has_master else self.param_dtype
        self.m1_dtype = self.moment1[0].dtype
        self.device = self.params[0].device
        self.coeffs = [float(np.float32(c)) for c in coeffs]
        for p, w, m, v in zip(self.params, self.masters, self.moment1,
                              self.moment2):
            if (p.dtype != self.param_dtype or (w is None) == self.has_master
                    or m.dtype != self.m1_dtype
                    or v.dtype != self.work_dtype
                    or (w is not None and w.dtype != torch.float32)):
                raise TypeError("AdamTensors: a group holds one parameter "
                                "dtype, masters for all or none, one "
                                "moment1 dtype and moment2 in the work dtype")
            for t in (p, w, m, v):
                if t is not None and (t.shape != p.shape
                                      or t.device != self.device):
                    raise ValueError("AdamTensors: state of another shape "
                                     "or device than its parameter")
        self._table = None  # (tensors, block_tensor, grad_ptrs, blocks)
        self._grad_ptrs = None  # the pointers grad_ptrs holds

    def _device_table(self):
        if self._table is None:
            for arg, ts, dtypes in (
                    ("params", self.params, _build.FLOATS),
                    ("moment1", self.moment1, _build.FLOATS),
                    ("moment2", self.moment2, _build.FLOATS),
                    ("masters", [w for w in self.masters if w is not None],
                     torch.float32)):
                for t in ts:
                    if not t.is_contiguous():
                        raise ValueError(f"multi_tensor_adam: {arg} must be "
                                         f"contiguous")
                    _build.expect("multi_tensor_adam", arg, t.view(-1),
                                  dtypes, 1)
            if self.has_master and self.param_dtype != torch.bfloat16:
                raise TypeError("multi_tensor_adam: masters are for bf16 "
                                "parameters")
            rows = np.zeros(len(self.params), dtype=_TENSOR)
            counts = [-(-p.numel() // CHUNK) for p in self.params]
            first = np.concatenate([[0], np.cumsum(counts)[:-1]])
            for i, (p, w, m, v) in enumerate(zip(
                    self.params, self.masters, self.moment1, self.moment2)):
                rows[i] = (p.data_ptr(), 0 if w is None else w.data_ptr(),
                           m.data_ptr(), v.data_ptr(), p.numel(),
                           self.lr_mults[i], self.coeffs[i], self.slots[i],
                           first[i])
            blocks = int(sum(counts))
            if blocks >= 2 ** 31:
                raise ValueError("multi_tensor_adam: too many blocks")
            block_tensor = np.repeat(np.arange(len(counts), dtype=np.int32),
                                     counts)
            self._table = (
                torch.from_numpy(rows.view(np.uint8)).to(self.device),
                torch.from_numpy(block_tensor).to(self.device),
                torch.empty(len(self.params), dtype=torch.int64,
                            device=self.device),
                blocks)
        return self._table


def multi_tensor_adam_plain(group, grads, state, *, beta1=0.9, beta2=0.999,
                            epsilon=1e-8, coupled=False):
    """JAX's update of every tensor of ``group`` in place, one tensor at a
    time in f32, as ``_build_update`` and ``Adam._rule`` compute it with
    f32 work values: g clipped by its scale (``(g.float() * s).to(g.dtype)``);
    with a decay coefficient c, ``g + c * w`` (``coupled``, Adam's L2) or
    ``w * (1 - lr_i * c)`` (AdamW); the moments; bias correction by t;
    ``w - lr_i * mhat / (sqrt(vhat) + eps)``, with lr_i the f32 ``lr *
    lr_mult`` and every scalar an f32. Moment1 is stored in its own dtype,
    moment2 and w in the work values' dtype (the master's when there is
    one, and the parameter is its cast)."""
    dev = state.device

    def const(x):
        return torch.full((), x, dtype=torch.float32, device=dev)

    b1, b2, eps = const(beta1), const(beta2), const(epsilon)
    bc1, bc2 = 1 - torch.pow(b1, state[1]), 1 - torch.pow(b2, state[1])
    for i, (p, g) in enumerate(zip(group.params, grads)):
        master = group.masters[i]
        work = master if master is not None else p
        if group.slots[i] >= 0:
            g = (g.float() * state[2 + group.slots[i]]).to(g.dtype)
        g = g.float()
        lr = state[0] * group.lr_mults[i]
        w = work.float()
        c = group.coeffs[i]
        if c:
            cw = const(c)
            if coupled:
                g = g + cw * w
            else:
                w = w * (1 - lr * cw)
        m = b1 * group.moment1[i].float() + (1 - b1) * g
        v = b2 * group.moment2[i].float() + (1 - b2) * g * g
        w = w - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
        work.copy_(w)
        if master is not None:
            p.copy_(w)
        group.moment1[i].copy_(m)
        group.moment2[i].copy_(v)


def multi_tensor_adam(group, grads, state, *, beta1=0.9, beta2=0.999,
                      epsilon=1e-8, coupled=False):
    """The update of :func:`multi_tensor_adam_plain`. CPU tensors take the
    plain version; CUDA tensors launch the kernel once for the whole group
    (parameters bf16 or f32, masters only for bf16, moment1 bf16 or f32;
    ``grads`` contiguous, each of its parameter's dtype and shape; ``state``
    a contiguous f32 vector on the same device) or raise. A bf16 launch
    counts as ``multi_tensor_adam``, an f32 one as
    ``multi_tensor_adam[f32]``. The gradients' pointers go to the device
    with one copy when they differ from the last launch's."""
    if state.device.type == "cpu":
        return multi_tensor_adam_plain(group, grads, state, beta1=beta1,
                                       beta2=beta2, epsilon=epsilon,
                                       coupled=coupled)
    tensors, block_tensor, grad_ptrs, blocks = group._device_table()
    _build.expect("multi_tensor_adam", "state", state, torch.float32, 1)
    if len(grads) != len(group.params):
        raise ValueError("multi_tensor_adam: one gradient a parameter")
    for p, g in zip(group.params, grads):
        if (not g.is_cuda or g.dtype != p.dtype or g.shape != p.shape
                or not g.is_contiguous()):
            raise ValueError(
                f"multi_tensor_adam: a gradient must be a contiguous CUDA "
                f"tensor of its parameter's dtype and shape, got "
                f"{g.dtype} {tuple(g.shape)} on {g.device} for "
                f"{p.dtype} {tuple(p.shape)}")
    ptrs = [g.data_ptr() for g in grads]
    if ptrs != group._grad_ptrs:
        grad_ptrs.copy_(torch.tensor(ptrs, dtype=torch.int64).pin_memory(),
                        non_blocking=True)
        group._grad_ptrs = ptrs
    fn = _build.function("ptt_multi_tensor_adam",
                         [_I, _I, _I, _P, _P, _P, _I, _P, _F, _F, _F, _I, _P])
    _build.check(fn(int(group.param_dtype == torch.float32),
                    int(group.m1_dtype == torch.float32),
                    int(group.has_master), tensors.data_ptr(),
                    grad_ptrs.data_ptr(), block_tensor.data_ptr(), blocks,
                    state.data_ptr(), beta1, beta2, epsilon, int(coupled),
                    _build.stream_of(state)),
                 "multi_tensor_adam")
    _build.count("multi_tensor_adam", group.param_dtype)
