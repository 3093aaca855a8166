"""Host<->device wire-format primitives.

Counterpart of ``ccsmeth_tpu/utils/wirefmt.py``; the same byte rows:

  kmer4 — two 4-bit base codes per byte (codes 0..4) — EXACT round-trip.
  u16   — one uint16 little-endian scalar per row — EXACT for integer npass.
  i8q   — standardized kinetics quantized round(x*QSCALE) clipped to int8.

Host-side packers are numpy (copied unchanged); the device-side unpackers are
torch and bit-exact with the JAX ones.
"""

from __future__ import annotations

import numpy as np
import torch

QSCALE = 16.0


# --- host-side (numpy) packers ---------------------------------------------

def pack_kmer4_np(u: np.ndarray) -> np.ndarray:
    """(B, L) base codes 0..15 -> (B, ceil(L/2)) nibble-packed uint8.
    Low nibble = even position, high nibble = odd position."""
    u = u.astype(np.uint8)
    B = u.shape[0]
    if u.shape[1] % 2:
        u = np.concatenate([u, np.zeros((B, 1), np.uint8)], axis=1)
    return u[:, 0::2] | (u[:, 1::2] << 4)


def pack_u16_np(v: np.ndarray) -> np.ndarray:
    """(B,) scalars -> (B, 2) little-endian uint16 bytes (round + clip)."""
    s = np.clip(np.rint(np.asarray(v, np.float64)), 0, 65535).astype("<u2")
    return s[:, None].view(np.uint8)


def quant_i8_np(v: np.ndarray) -> np.ndarray:
    """fp32 standardized kinetics -> int8 round(x*QSCALE), clipped."""
    return np.clip(np.rint(np.asarray(v, np.float32) * QSCALE),
                   -128, 127).astype(np.int8)


# --- device-side (torch) unpackers ------------------------------------------

def unpack_kmer4(raw: torch.Tensor, L: int) -> torch.Tensor:
    """(B, nb) packed uint8 -> (B, L) uint8 base codes."""
    B, nb = raw.shape
    return torch.stack([raw & 0xF, raw >> 4], dim=-1).reshape(B, 2 * nb)[:, :L]


def unpack_u16(raw: torch.Tensor) -> torch.Tensor:
    """(B, 2) little-endian uint8 -> (B, 1) int32 holding the uint16 value
    (lo | hi << 8, built in int32: torch.uint16 supports few ops)."""
    r = raw.to(torch.int32)
    return (r[:, 0:1] | (r[:, 1:2] << 8))


def dequant_i8(q: torch.Tensor) -> torch.Tensor:
    """int8 quantized kinetics -> fp32."""
    return q.to(torch.float32) * (1.0 / QSCALE)
