"""Argument checks and tile shapes shared by the kernel wrappers: ``bigru``
(K1), ``bigru_vjp`` (K4, K5) and ``bilstm_vjp`` (K6). It imports nothing of
the package, so every wrapper can import it first."""

from __future__ import annotations

import torch

THREADS = 256  # BIGRU_THREADS in csrc/rnn_common.cuh
SMEM_LIMIT = 227 * 1024  # shared memory one block may use on an H100
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tile_shape(N: int, H: int, n_sms: int) -> tuple[int, int]:
    """(rows per thread R, thread rows TY): the block's tile is TY*R rows.
    Takes the largest R in 8, 4, 2, 1 that still gives about one block per SM,
    so large batches reuse each weight read across more rows."""
    ty = max(1, THREADS // (H // 4))
    for r in (8, 4, 2):
        if -(-N // (ty * r)) >= 0.9 * n_sms:
            return r, ty
    return 1, ty


def expect(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
        raise ValueError("{}: got {} {}, expected {} {}".format(
            name, tuple(t.shape), t.dtype, tuple(shape), dtype))
    if t.device != device:
        raise ValueError("{} is on {}, expected {}".format(name, t.device, device))
    if not t.is_contiguous():
        raise ValueError("{} must be contiguous".format(name))


def dims(x, w_hh, compute_dtype):
    """(L, N, C, H) of a layer's input and recurrent weights."""
    if compute_dtype not in DTYPE_CODE:
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if x.dim() != 3 or w_hh.dim() != 3:
        raise ValueError("x must be (L, N, C) and w_hh (2, H, G)")
    L, N, C = x.shape
    return L, N, C, w_hh.shape[1]


def op(t, compute_dtype):
    """An operand as the kernel sees it: rounded to compute_dtype, in f32."""
    return t.to(compute_dtype).float()


def cuda_checks(tensors, H):
    if H % 4 != 0 or H // 4 > THREADS:
        raise ValueError("kernel takes H % 4 == 0 and H <= 1024 (H={})".format(H))
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")


def device_of(x):
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError("runs on cuda or cpu, not {}".format(x.device.type))
    return x.device.type
