"""Kernel K6: one bidirectional LSTM layer for training.

Counterpart of ``ccsmeth_tpu/ops/bigru_pallas_vjp.py``'s LSTM kernels: the
forward replaces ``_fwd_lstm_kernel`` (it keeps h, the cell-state sequence c
and the gates) and the backward replaces ``_bwd_lstm_kernel``; together they
are ``fused_bilstm_layer_tm``, a ``jax.custom_vjp``, here ``BiLSTMLayerFn``, a
``torch.autograd.Function``. The source is ``csrc/bilstm_train.cu``; its
header says what bounds the kernels on an H100 and what the design does about
that. The design is K4/K5's (``bigru_vjp``) with four gates: the recurrences
are the templates of ``csrc/rnn_train_rec.cuh`` instantiated for the LSTM, and
the products (the projection, dx, the weight gradients) are K4/K5's phase
functions and C entries run with the LSTM's plan. ``bigru_vjp.k45_plan(H,
dtype, "lstm")`` is the shape rule: ``tc`` (bf16 on the tensor cores, H = 32,
64, 128, 256) or ``simt`` (exact f32 FMAs: fp32, and the bf16 shapes tc
refuses, H = 16 .. 256); what neither takes raises ``ValueError``, and
nothing falls back to the plain version.

Layouts (time-major; direction 0 forward, 1 backward, both in natural time
order, unlike the TPU kernel which stores the backward half reversed):

    x      (L, N, C)       operand type (float32 or bfloat16)
    w_ih   (2, C, 4H)      operand type     b_ih (2, 4H) f32
    w_hh   (2, H, 4H)      operand type     b_hh (2, 4H) f32
    out    (L, N, 2H)      store type (= operand type)
    c      (2, L, N, H)    store type: the cell state after each step
    gates  (2, L, N, 4H)   store type: i, f, g, o per direction
    dout   (L, N, 2H)      store type
    ->     dx (L, N, C), dw_ih (2, C, 4H), db_ih (2, 4H), dw_hh (2, H, 4H),
           db_hh (2, 4H) (equal to db_ih), all f32

The forward is two CUDA launches, one a phase: the projection
(``bigru_vjp.k4_projection``) and the recurrence (``k6_recurrence``); the
backward three or four: the recurrence that carries dh and dc
(``k6_bwd_recurrence``), dx (``bigru_vjp.k5_dx``) and the weight and bias
gradients in fixed row slices with the in-order sum of the slices
(``bigru_vjp.k5_weight_grads``).

A CUDA tensor launches the kernels (or raises); a CPU tensor runs the plain
version beside them. ``launches_fwd`` and ``launches_bwd`` count K6 calls,
``design_calls`` those calls by design, ``cuda_launches`` each CUDA launch
where it is made (also those of K4/K5's phase functions run with the LSTM's
plan), ``plain_calls`` runs of the plain versions. The kernels are compiled
with ``nvcc`` at first use (``nvcc.py``); nothing here imports a GPU
toolchain at import time.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.rnn import lstm_cell
from . import bigru_vjp, nvcc
from .kernel_args import cuda_checks, device_of, dims, expect, op

SRC = "bilstm_train.cu"

launches_fwd = 0  # K6 forward calls since the caller last set it to 0
launches_bwd = 0  # K6 backward calls
plain_calls = 0  # runs of either plain version
cuda_launches = 0  # K6's CUDA launches, counted at each launch
design_calls = {"tc": 0, "simt": 0}  # K6 CUDA calls (forward and backward) by design

_lib = None
_lock = threading.Lock()


def build() -> str:
    """Compile ``csrc/bilstm_train.cu`` if its library is missing; returns
    the library path. Raises with nvcc's output when the build fails."""
    return nvcc.build(SRC)[0]


def bind(path: str):
    """The library at ``path`` (a build of ``csrc/bilstm_train.cu``, or of a
    copy of it) with its C entries' argument types set."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("k6_rec_launch", [i, i] + [p] * 5 + [i] * 5 + [p, i]),
                       ("k6_bwd_rec_launch", [i, i] + [p] * 6 + [i] * 5 + [p, i]),
                       ("k6_rec_occupancy", [i] * 4 + [p] * 3 + [i]),
                       ("k6_bwd_rec_occupancy", [i] * 4 + [p] * 3 + [i])):
        fn = getattr(lib, name)
        fn.restype = i
        fn.argtypes = args
    return lib


def _load():
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = bind(build())
                bigru_vjp.fwd_clusters["lstm"] = bigru_vjp.resident_fwd_clusters(lib, "lstm")
                _lib = lib
    return _lib


def _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 4 * H), compute_dtype, dev)
    expect("b_ih", b_ih, (2, 4 * H), torch.float32, dev)
    expect("w_hh", w_hh, (2, H, 4 * H), compute_dtype, dev)
    expect("b_hh", b_hh, (2, 4 * H), torch.float32, dev)
    return L, N, C, H


def _check_bwd(dout, x, w_ih, w_hh, out, c, gates, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 4 * H), compute_dtype, dev)
    expect("w_hh", w_hh, (2, H, 4 * H), compute_dtype, dev)
    expect("dout", dout, (L, N, 2 * H), compute_dtype, dev)
    expect("out", out, (L, N, 2 * H), compute_dtype, dev)
    expect("c", c, (2, L, N, H), compute_dtype, dev)
    expect("gates", gates, (2, L, N, 4 * H), compute_dtype, dev)
    return L, N, C, H


def bilstm_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh,
                                 compute_dtype=torch.float32):
    """The plain version of K6's forward: step by step with ``models/rnn.py``'s
    ``lstm_cell``, h and c carried in f32. Returns (out (L, N, 2H),
    c (2, L, N, H), gates (2, L, N, 4H)) in the store type."""
    global plain_calls
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    plain_calls += 1
    flat = op(x, compute_dtype).reshape(L * N, C)
    outs, cs, gates = [], [], []
    for d in (0, 1):
        xg = (flat @ op(w_ih[d], compute_dtype) + b_ih[d]).reshape(L, N, 4 * H)
        w = op(w_hh[d], compute_dtype)
        h = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        c = torch.zeros_like(h)
        ys, cseq, gs = [None] * L, [None] * L, [None] * L
        for s in range(L):
            t = s if d == 0 else L - 1 - s
            h, c, i, f, g, o = lstm_cell(xg[t] + (op(h, compute_dtype) @ w
                                                  + b_hh[d]), c)
            ys[t], cseq[t] = h, c
            gs[t] = torch.cat([i, f, g, o], dim=1)
        outs.append(torch.stack(ys))
        cs.append(torch.stack(cseq))
        gates.append(torch.stack(gs))
    return (torch.cat(outs, dim=-1).to(compute_dtype),
            torch.stack(cs).to(compute_dtype),
            torch.stack(gates).to(compute_dtype))


def bilstm_layer_bwd_plain(dout, x, w_ih, w_hh, out, c, gates,
                           compute_dtype=torch.float32):
    """The plain version of K6's backward: the formulas of
    ``bigru_pallas_vjp.py:173-178`` step by step on tensors, without autograd.
    Time walks in reverse per direction carrying dh and dc; c_prev and h_prev
    are the stored c and output one step earlier in the direction's own time
    (zero at its first step). With bf16 operands da is rounded to bf16 for the
    four products and not for the bias sum; db_ih and db_hh are the same sum."""
    global plain_calls
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, c, gates, compute_dtype)
    plain_calls += 1
    dev = x.device
    f32 = torch.float32
    dx = torch.zeros((L, N, C), dtype=f32, device=dev)
    dw_ih = torch.empty((2, C, 4 * H), dtype=f32, device=dev)
    dw_hh = torch.empty((2, H, 4 * H), dtype=f32, device=dev)
    db = torch.empty((2, 4 * H), dtype=f32, device=dev)
    xs = x.float().reshape(L * N, C)

    def prev(seq, d):
        """seq one step earlier in direction d's own time, zero at its first."""
        p = torch.zeros_like(seq)
        if d == 0:
            p[1:] = seq[:-1]
        else:
            p[:-1] = seq[1:]
        return p

    for d in (0, 1):
        g_all = gates[d].float()
        ig, fg, gg, og = (g_all[..., k * H:(k + 1) * H] for k in range(4))
        cd = c[d].float()
        c_prev = prev(cd, d)
        h_prev = prev(out[..., d * H:(d + 1) * H].float(), d)
        do = dout[..., d * H:(d + 1) * H].float()
        w_ihT = op(w_ih[d], compute_dtype).T
        w_hhT = op(w_hh[d], compute_dtype).T
        da_all = torch.empty((L, N, 4 * H), dtype=f32, device=dev)
        dh = torch.zeros((N, H), dtype=f32, device=dev)
        dc = torch.zeros((N, H), dtype=f32, device=dev)
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            tc = torch.tanh(cd[t])
            dt = do[t] + dh
            dc = dt * og[t] * (1.0 - tc * tc) + dc
            da = torch.cat([dc * gg[t] * ig[t] * (1.0 - ig[t]),
                            dc * c_prev[t] * fg[t] * (1.0 - fg[t]),
                            dc * ig[t] * (1.0 - gg[t] * gg[t]),
                            dt * tc * og[t] * (1.0 - og[t])], dim=1)
            dc = dc * fg[t]
            dh = op(da, compute_dtype) @ w_hhT
            dx[t] += op(da, compute_dtype) @ w_ihT
            da_all[t] = da
        da_all = da_all.reshape(L * N, 4 * H)
        dw_ih[d] = xs.T @ op(da_all, compute_dtype)
        dw_hh[d] = h_prev.reshape(L * N, H).T @ op(da_all, compute_dtype)
        db[d] = da_all.sum(0)
    return dx, dw_ih, db, dw_hh, db.clone()


def k6_recurrence(xg, w_hh, L, N, plan, compute_dtype):
    """K6 forward (b), one CUDA launch: both directions from the projection
    xg (2, L*N, 4H) f32 to out (L, N, 2H), c (2, L, N, H) and gates
    (2, L, N, 4H) in the store type, ``bigru_vjp.fwd_rows``' rows a tile."""
    H = w_hh.shape[1]
    dev = xg.device
    out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=dev)
    c = torch.empty((2, L, N, H), dtype=compute_dtype, device=dev)
    gates = torch.empty((2, L, N, 4 * H), dtype=compute_dtype, device=dev)
    bigru_vjp._launch("k6_rec_launch", plan, xg, *bigru_vjp._codes(plan, compute_dtype),
                      xg.data_ptr(), w_hh.data_ptr(), out.data_ptr(), c.data_ptr(),
                      gates.data_ptr(), L, N, H, plan["U"],
                      bigru_vjp.fwd_rows(plan, N), lib=_load())
    return out, c, gates


def k6_bwd_recurrence(dout, c, gates, w_hh, plan, compute_dtype):
    """K6 backward (a), one CUDA launch: the gate gradients
    da = [di, df, dg, do] (2, L*N, 4H), carrying dh and dc (f32 in simt, bf16
    in tc), and in tc the row tiles' partial sums of da for the bias gradient
    (``bigru_vjp.gate_grad_buffers``). Returns (da, bias partials or None)."""
    _, L, N, H = c.shape
    (da,), part = bigru_vjp.gate_grad_buffers(L, N, 4 * H, plan, c.device, two=False)
    bigru_vjp._launch("k6_bwd_rec_launch", plan, c, *bigru_vjp._codes(plan, compute_dtype),
                      dout.data_ptr(), c.data_ptr(), gates.data_ptr(), w_hh.data_ptr(),
                      da.data_ptr(), bigru_vjp._ptr(part), L, N, H, plan["U"],
                      plan["rows_bwd"], lib=_load())
    return da, part


def bilstm_layer_train_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype=torch.float32):
    """K6's forward on CUDA (two launches: ``bigru_vjp.k4_projection`` with
    the LSTM's plan, ``k6_recurrence``), the plain version on CPU: (out, c,
    gates) in the store type."""
    global launches_fwd
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    if device_of(x) == "cpu":
        return bilstm_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    plan = bigru_vjp.k45_plan(H, compute_dtype, "lstm")
    cuda_checks((x, w_ih, b_ih, w_hh, b_hh), H)
    xg = bigru_vjp.k4_projection(x, w_ih, b_ih, b_hh, plan, compute_dtype)
    out, c, gates = k6_recurrence(xg, w_hh, L, N, plan, compute_dtype)
    launches_fwd += 1
    design_calls[plan["design"]] += 1
    return out, c, gates


def bilstm_layer_bwd(dout, x, w_ih, w_hh, out, c, gates,
                     compute_dtype=torch.float32):
    """K6's backward on CUDA (``bigru_vjp.bwd_cuda_launches``:
    ``k6_bwd_recurrence``, then ``bigru_vjp.k5_dx`` and
    ``bigru_vjp.k5_weight_grads`` on its da), the
    plain version on CPU: (dx, dw_ih, db_ih, dw_hh, db_hh), all f32, db_hh a
    copy of db_ih. Every sum has one owner and a fixed order, no atomics, so
    two runs on the same inputs give bit-equal results. The weights are read
    in the layer's own layout, with no transposed copy."""
    global launches_bwd
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, c, gates, compute_dtype)
    if device_of(x) == "cpu":
        return bilstm_layer_bwd_plain(dout, x, w_ih, w_hh, out, c, gates,
                                      compute_dtype)
    plan = bigru_vjp.k45_plan(H, compute_dtype, "lstm")
    cuda_checks((dout, x, w_ih, w_hh, out, c, gates), H)
    da, part = k6_bwd_recurrence(dout, c, gates, w_hh, plan, compute_dtype)
    dx = bigru_vjp.k5_dx(da, w_ih, plan, compute_dtype)
    dw_ih, db, dw_hh, _ = bigru_vjp.k5_weight_grads(x, out, da, da, plan, compute_dtype,
                                                    part)
    launches_bwd += 1
    design_calls[plan["design"]] += 1
    return dx.view(L, N, C), dw_ih, db, dw_hh, db.clone()


class BiLSTMLayerFn(torch.autograd.Function):
    """One differentiable BiLSTM layer, zero h0 and c0: the contract of JAX's
    ``fused_bilstm_layer_tm``. Takes x (L, N, C) in compute_dtype and f32
    weights in the stacked layout (w_ih (2, C, 4H), b_ih (2, 4H),
    w_hh (2, H, 4H), b_hh (2, 4H)); returns out (L, N, 2H) f32. The weights
    are rounded to compute_dtype for the kernels and their gradients come
    back in f32, as on the TPU."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
        wih = w_ih.detach().to(compute_dtype).contiguous()
        whh = w_hh.detach().to(compute_dtype).contiguous()
        out, c, gates = bilstm_layer_train_fwd(
            x.detach().contiguous(), wih, b_ih.detach().float().contiguous(),
            whh, b_hh.detach().float().contiguous(), compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, wih, whh, out, c, gates)
        return out.float()

    @staticmethod
    def backward(ctx, g):
        x, wih, whh, out, c, gates = ctx.saved_tensors
        dout = g.to(out.dtype).contiguous()  # the TPU rounds dout alike (:565)
        dx, dw_ih, db_ih, dw_hh, db_hh = bilstm_layer_bwd(
            dout, x.contiguous(), wih, whh, out, c, gates, ctx.compute_dtype)
        return dx, dw_ih, db_ih, dw_hh, db_hh, None


def train_fwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K6's forward for one layer: per row, step and
    direction the input projection and the recurrent product, 2 (C + H) 4H."""
    return 2 * L * N * 2 * (C + H) * 4 * H


def train_bwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K6's backward for one layer: dx and dh (as the
    forward's two products) and the two weight gradients of the same sizes."""
    return 2 * train_fwd_flops(L, N, C, H)
