"""Flash attention: the hand-written CUDA kernels of both directions, their
wrappers, their plain PyTorch versions, the autograd Function and the
routing rule.

``flash_attention_fwd(q, k, v, causal, scale, mode)`` returns ``(out, lse)``
over (B, H, S, D) tensors: what ``poseidon_tpu/ops/pallas_kernels.py
:_flash_fwd`` computes (out in q's dtype, the per-row logsumexp in f32,
the finite ``NEG_INF`` causal mask, ``mode`` +1/0/-1 for ring chunks).
``flash_attention_bwd(q, k, v, out, lse, g, causal, scale, mode, delta)``
returns ``(dq, dk, dv)`` in the inputs' dtype: what ``_flash_bwd``
computes. For tensors on the CPU they run the plain versions; for CUDA
tensors they launch ``csrc/flash_fwd.cu`` (the port of the TPU kernel
``_flash_fwd_kernel``) and ``csrc/flash_bwd.cu`` (``_flash_dq_kernel`` and
``_flash_dkv_kernel``) or raise: nothing falls back. Each launch adds one to
its count in ``LAUNCHES``.

The plain versions are the dense formulation, computed in f32 (f64 for f64
input, what ``gradcheck`` feeds): scores ``(q k^T) * scale``, masked entries
set to ``NEG_INF = -1e30`` (not -inf, so a fully masked row in ``mode = -1``
weighs every key equally and gives the kernel's out, the mean of V, and lse
``-1e30 + log S``), ``m`` the row max, ``p = exp(s - m)``, ``l`` its sum (1
where it is 0), ``out = (p @ v) / l``, ``lse = m + log l``. The backward
spells ``p = exp(s - lse)`` out from the saved lse, as the TPU kernels do,
rather than differentiating the forward: for a fully masked row the saved
lse is exactly ``-1e30`` in f32, so p is 1 for every key (autograd of the
forward would give 1/S). ``delta = rowsum(dO * out)`` is a torch op, as the
JAX package leaves it to XLA, unless the caller (the ring backward) passes
it in.

``flash_attention`` is the autograd Function the models call; it saves q,
k, v, out and lse, and its backward is ``flash_attention_bwd``.
``maybe_flash_attention`` keeps the JAX routing rule: the kernel when q and
k have the same length and ``pick_block(S)`` finds a tile, else the dense
``attention``. The kernels themselves take any S; the rule decides only
which lengths they see.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, attention

# launches of this module's kernels, counted where each kernel launches
LAUNCHES = {"flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0}
# the kernels keep a row's output columns in registers (csrc/flash_*.cu)
MAX_CUDA_HEAD_DIM = 128

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def pick_block(s: int) -> Optional[int]:
    """The JAX package's tile height for a sequence length (128/64/32/16/8,
    the largest that divides it), or None: the routing rule of
    ``maybe_flash_attention``."""
    return next((bs for bs in (128, 64, 32, 16, 8) if s % bs == 0), None)


def _scale(q: torch.Tensor, scale: Optional[float]) -> float:
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def _compute(t: torch.Tensor) -> torch.Tensor:
    """The plain versions' compute dtype: f32, or f64 for f64 input."""
    return t if t.dtype == torch.float64 else t.float()


def _masked_scores(q: torch.Tensor, k: torch.Tensor, scale: float,
                   causal: bool, mode) -> torch.Tensor:
    """``(q k^T) * scale`` in the compute dtype, masked to ``NEG_INF`` where
    a causal row may not see a column (by absolute position, or by the ring
    chunk's ``mode``)."""
    s = torch.matmul(_compute(q), _compute(k).transpose(-1, -2)) * scale
    if causal:
        n = s.shape[-1]
        idx = torch.arange(n, device=s.device)
        lower = idx[:, None] >= idx[None, :]
        if mode is None:
            live = lower
        else:
            mode = int(mode)
            live = lower if mode == 0 else torch.full_like(lower, mode > 0)
        s = torch.where(live, s, NEG_INF)
    return s


def flash_attention_fwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              scale: Optional[float] = None, mode=None):
    """(out, lse) of the flash forward, dense, computed in f32; out in q's
    dtype, lse (B, H, S) f32."""
    s = _masked_scores(q, k, _scale(q, scale), causal, mode)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    lsafe = torch.where(l == 0, 1.0, l)
    out = torch.matmul(p, _compute(v)) / lsafe[..., None]
    return out.to(q.dtype), m + torch.log(lsafe)


def flash_delta(g: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * out)`` in f32 (f64 for f64 input), (B, H, S)."""
    return (_compute(g) * _compute(out)).sum(dim=-1)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, g: torch.Tensor,
                              causal: bool = False,
                              scale: Optional[float] = None, mode=None,
                              delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of the flash backward, dense, from the saved lse,
    computed in f32; each in its input's dtype."""
    scale = _scale(q, scale)
    if delta is None:
        delta = flash_delta(g, out)
    s = _masked_scores(q, k, scale, causal, mode)
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    gf = _compute(g)
    dp = torch.matmul(gf, _compute(v).transpose(-1, -2))
    ds = p * (dp - delta.to(s.dtype)[..., None]) * scale
    dq = torch.matmul(ds, _compute(k))
    dk = torch.matmul(ds.transpose(-1, -2), _compute(q))
    dv = torch.matmul(p.transpose(-1, -2), gf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_cuda(name: str, q: torch.Tensor, *same: torch.Tensor,
                rows=()) -> None:
    """q and every tensor of ``same``: CUDA, f32 or bf16, (B, H, S, D),
    contiguous, alike; each of ``rows``: f32 (B, H, S), contiguous, on q's
    device."""
    for t in (q, *same):
        if not t.is_cuda:
            raise ValueError(f"{name} needs CUDA tensors")
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name} takes float32 or bfloat16, got "
                            f"{t.dtype}")
        if t.dim() != 4:
            raise ValueError(f"{name} takes (B, H, S, D), got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: q, k, v (and dO) differ in shape, "
                             f"dtype or device")
    for t in rows:
        if (t.dtype != torch.float32 or t.shape != q.shape[:3]
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError(f"{name}: lse and delta must be contiguous "
                             f"float32 {tuple(q.shape[:3])} on {q.device}")
    b, h, s, d = q.shape
    if not 1 <= d <= MAX_CUDA_HEAD_DIM:
        raise ValueError(f"{name} takes head dim 1...{MAX_CUDA_HEAD_DIM}, "
                         f"got {d}")
    if not 1 <= b * h <= 65535 or s < 1:
        raise ValueError(f"{name} takes 1..65535 (batch x heads) and S >= 1, "
                         f"got {tuple(q.shape)}")


_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_void_p]


def _lib(name: str, n_ptrs: int):
    """The C entry ``poseidon_<name>`` of ``csrc/<source>.cu``: n_ptrs tensor
    pointers, then dtype, bh, s, d, scale, causal, chunk, mode, stream."""
    source = "flash_fwd" if name == "flash_fwd" else "flash_bwd"
    fn = getattr(_build.load(source), f"poseidon_{name}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + _TAIL
        fn.restype = ctypes.c_int
    return fn


def _launch(name: str, ptrs, q: torch.Tensor, scale, causal, mode) -> None:
    """Launch one kernel on PyTorch's current stream, raise if refused,
    count it."""
    b, h, s, d = q.shape
    chunk = mode is not None
    fn = _lib(name, len(ptrs))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, _DTYPE_CODE[q.dtype], b * h, s, d, _scale(q, scale),
                int(bool(causal)), int(chunk), int(mode) if chunk else 0,
                stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    LAUNCHES[name] += 1


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mode=None):
    """Launch the forward kernel on PyTorch's current stream; (out, lse)."""
    _check_cuda("flash_fwd_cuda", q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch("flash_fwd", [t.data_ptr() for t in (q, k, v, out, lse)], q,
            scale, causal, mode)
    return out, lse


def flash_dq_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                  causal: bool = False, scale: Optional[float] = None,
                  mode=None) -> torch.Tensor:
    """Launch the dQ kernel (K2) on PyTorch's current stream; dq."""
    _check_cuda("flash_dq_cuda", q, k, v, g, rows=(lse, delta))
    dq = torch.empty_like(q)
    _launch("flash_dq", [t.data_ptr() for t in (q, k, v, g, lse, delta, dq)],
            q, scale, causal, mode)
    return dq


def flash_dkv_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mode=None):
    """Launch the dK/dV kernel (K3) on PyTorch's current stream; (dk,
    dv)."""
    _check_cuda("flash_dkv_cuda", q, k, v, g, rows=(lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_dkv",
            [t.data_ptr() for t in (q, k, v, g, lse, delta, dk, dv)], q,
            scale, causal, mode)
    return dk, dv


_ATTR_KEYS = ("registers", "static_smem_bytes", "dynamic_smem_bytes",
              "local_bytes", "threads", "blocks_per_sm", "own_rows",
              "stream_rows")


def flash_bwd_kernel_attrs(dtype: torch.dtype, head_dim: int) -> dict:
    """What the card reports for the K2 and K3 instantiations that take
    ``dtype`` and ``head_dim`` (``cudaFuncGetAttributes``, and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at their shared
    memory): ``{"flash_dq_kernel": {...}, "flash_dkv_kernel": {...}}`` keyed
    by ``_ATTR_KEYS``. Needs the card."""
    fn = _build.load("flash_bwd").poseidon_flash_bwd_attrs
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    attrs = {}
    for which, name in enumerate(("flash_dq_kernel", "flash_dkv_kernel")):
        buf = (ctypes.c_int * len(_ATTR_KEYS))()
        rc = fn(which, _DTYPE_CODE[dtype], head_dim, buf)
        if rc != 0:
            raise RuntimeError(f"{name} attributes: cudaError {rc}")
        attrs[name] = dict(zip(_ATTR_KEYS, buf))
    return attrs


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   g: torch.Tensor, lse: torch.Tensor, delta: torch.Tensor,
                   causal: bool = False, scale: Optional[float] = None,
                   mode=None):
    """K2, then K3; (dq, dk, dv)."""
    dq = flash_dq_cuda(q, k, v, g, lse, delta, causal, scale, mode)
    return (dq, *flash_dkv_cuda(q, k, v, g, lse, delta, causal, scale, mode))


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = False, scale: Optional[float] = None,
                        mode=None):
    """(out, lse): the plain version for CPU tensors, the kernel for CUDA
    tensors (made contiguous first)."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, causal, scale, mode)
    return flash_fwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal, scale, mode)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        g: torch.Tensor, causal: bool = False,
                        scale: Optional[float] = None, mode=None,
                        delta: Optional[torch.Tensor] = None):
    """(dq, dk, dv), the counterpart of ``_flash_bwd``: the plain version
    for CPU tensors, the kernels for CUDA tensors (made contiguous
    first)."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, g, causal, scale,
                                         mode, delta)
    if delta is None:
        delta = flash_delta(g, out)
    return flash_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                          g.contiguous(), lse.contiguous(),
                          delta.float().contiguous(), causal, scale, mode)


class FlashAttention(torch.autograd.Function):
    """Flash attention with the flash backward. ``plain`` runs the plain
    versions whatever the device; otherwise a CPU tensor takes the plain
    versions and a CUDA tensor the kernels (K1 forward, K2 dQ and K3
    dK/dV backward)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, mode, plain):
        ctx.plain = plain or q.device.type == "cpu"
        if ctx.plain:
            out, lse = flash_attention_fwd_plain(q, k, v, causal, scale, mode)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = flash_fwd_cuda(q, k, v, causal, scale, mode)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, mode)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, lse, g,
                                                   *ctx.args)
        else:
            dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None,
                    mode=None, plain: bool = False) -> torch.Tensor:
    """Blockwise attention, (B, H, S, D) -> (B, H, S, D). ``plain`` runs the
    plain versions on any device (``chip_smoke.py`` holds a training step
    against them on the card)."""
    return FlashAttention.apply(q, k, v, causal, scale, mode, plain)


def maybe_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False,
                          scale: Optional[float] = None, *,
                          plain: bool = False) -> torch.Tensor:
    """The flash path when q and k have the same length and ``pick_block``
    tiles it, else the dense ``attention`` (the JAX routing rule)."""
    s = q.shape[-2]
    if k.shape[-2] == s and pick_block(s) is not None:
        return flash_attention(q, k, v, causal, scale, plain=plain)
    return attention(q, k, v, causal=causal, scale=scale)
