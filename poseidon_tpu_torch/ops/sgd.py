"""The fused SGD + momentum + L2 update over the flat parameter arena: the
hand-written CUDA kernel, its wrapper and its plain PyTorch version.

``sgd_update_`` is what the training step calls, once per step, over the
whole arena. For CPU tensors it runs ``sgd_update_plain_``; for CUDA
tensors it launches ``csrc/sgd_update.cu`` (the port of the TPU kernel
``poseidon_tpu/ops/pallas_kernels.py:_sgd_update_kernel``) or raises —
nothing falls back. Each launch adds one to ``LAUNCHES["sgd_update"]``.

The rule is ``solvers/updates.make_flat_update_rule``'s SGD + L2 arm:

    g' = g            where the segment's decay is 0 (the per-leaf skip)
    g' = g + decay*w  elsewhere
    h' = momentum*h + (rate*lr_mult)*g'
    w' = w - h'

``w`` and ``h`` are updated IN PLACE (the arena is the step's own buffer);
``g``, ``lr_vec`` and ``decay_vec`` are read. Unlike the JAX package, where
XLA already fuses this rule into one loop and the Pallas kernel is opt-in,
eager PyTorch would run the plain version as about six separate passes over
the arena, so the port's training step runs the kernel by default.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of this module's kernel, counted where the kernel launches
LAUNCHES = {"sgd_update": 0}


def sgd_update_plain_(w: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                      rate: float, lr_vec: torch.Tensor,
                      decay_vec: torch.Tensor, momentum: float) -> None:
    """The rule in separate f32 tensor ops, in the kernel's operation
    order (no op fuses a multiply into an add); writes w and h in place."""
    local_rate = torch.tensor(rate, dtype=torch.float32,
                              device=w.device) * lr_vec
    gr = torch.where(decay_vec == 0.0, g, g + decay_vec * w)
    h_new = momentum * h + local_rate * gr
    w_new = w - h_new
    h.copy_(h_new)
    w.copy_(w_new)


def _lib():
    fn = _build.load("sgd_update").poseidon_sgd_update
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.c_longlong, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def sgd_update_cuda_(w: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                     rate: float, lr_vec: torch.Tensor,
                     decay_vec: torch.Tensor, momentum: float) -> None:
    """Launch the kernel on PyTorch's current stream: one launch over the
    whole arena, w and h updated in place."""
    ts = (w, g, h, lr_vec, decay_vec)
    for t in ts:
        if not t.is_cuda:
            raise ValueError("sgd_update_cuda_ needs CUDA tensors")
        if t.dtype != torch.float32:
            raise TypeError(f"sgd_update_cuda_ takes float32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError("sgd_update_cuda_ takes contiguous 1-D vectors")
        if t.shape != w.shape or t.device != w.device:
            raise ValueError("sgd_update_cuda_: vectors differ in length or "
                             "device")
        if t.data_ptr() % 16:
            raise ValueError("sgd_update_cuda_ needs 16-byte aligned vectors")
    fn = _lib()
    with torch.cuda.device(w.device):
        props = torch.cuda.get_device_properties(w.device)
        stream = torch.cuda.current_stream(w.device).cuda_stream
        rc = fn(w.data_ptr(), h.data_ptr(), g.data_ptr(), lr_vec.data_ptr(),
                decay_vec.data_ptr(), w.numel(), rate, momentum,
                props.multi_processor_count, stream)
    if rc != 0:
        raise RuntimeError(f"sgd_update kernel launch failed: cudaError {rc}")
    LAUNCHES["sgd_update"] += 1


def sgd_update_(w: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                rate: float, lr_vec: torch.Tensor, decay_vec: torch.Tensor,
                momentum: float) -> None:
    """The training step's entry: the plain version for CPU tensors, the
    CUDA kernel for CUDA tensors."""
    if w.device.type == "cpu":
        sgd_update_plain_(w, g, h, rate, lr_vec, decay_vec, momentum)
    else:
        sgd_update_cuda_(w, g, h, rate, lr_vec, decay_vec, momentum)
