"""Kernels K4 and K5 (ccsmeth_tpu_torch/ops/csrc/bigru_train.cu) against their
plain PyTorch versions on the card, in both designs that ``k45_plan`` picks
(simt for fp32 and bf16 H = 16, tc for bf16 H = 32, 64, 256), at the model's
shape and at row counts that leave the last tile of each design ragged (65,
300, 1000 against tiles of 32, 64, 128 and 512 rows). Needs a CUDA device and
skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_train_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import hashlib

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp

# fp32: out, gates and dx to 1e-5; dW and db to 1e-5 * max|ref| + 1e-5, since
# they sum L*N rows in another order. bf16: stored values one bf16 ulp apart
# on [0.5, 1) (2^-8) where an f32 sum taken in another order rounds the other
# way, so 1e-2 absolute for out/gates and 1e-2 relative to max|ref| for the
# gradients (a dxg operand rounded to bf16 the other way moves one product by
# 2^-8 of itself).
SHAPES = [(13, 16, 11), (65, 32, 11), (300, 64, 128), (1000, 256, 512),
          (1024, 256, 11), (1024, 256, 512)]


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the references below


def _case(rows, hidden, cin, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + cin)
    (wih, bih, whh, bhh), = [layer_weights(ld, dtype, "cuda")
                             for ld in init_rnn_params(rng, cin, hidden, 1)]
    x = torch.from_numpy(rng.randn(21, rows, cin).astype(np.float32)).to("cuda", dtype)
    dout = torch.from_numpy(rng.randn(21, rows, 2 * hidden).astype(np.float32)
                            ).to("cuda", dtype)
    return x, wih, bih, whh, bhh, dout


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _grad_tol(ref, dtype):
    scale = ref.abs().max().item()
    return 1e-5 * scale + 1e-5 if dtype == torch.float32 else 1e-2 * scale + 1e-5


def _sum_tol(a, b):
    """An f32 sum of exact products in another order: 1e-5 of the largest
    sum of the products' magnitudes, a @ b taken on |a| and |b|."""
    return 1e-5 * (a.abs() @ b.abs()).max().item() + 1e-6


def _design(hidden, dt):
    return bigru_vjp.k45_plan(hidden, dt)["design"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k4_matches_plain(dtype, rows, hidden, cin):
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, dt)
    design = _design(hidden, dt)
    before, designs = bigru_vjp.launches_fwd, dict(bigru_vjp.design_calls)
    bigru_vjp.cuda_launches = 0
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    assert bigru_vjp.cuda_launches == 2  # the projection, the recurrence
    out2, gates2 = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    torch.cuda.synchronize()
    assert bigru_vjp.launches_fwd == before + 2
    assert bigru_vjp.design_calls[design] == designs[design] + 2
    assert torch.equal(out, out2) and torch.equal(gates, gates2)
    ref_out, ref_gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh,
                                                               bhh, dt)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert out.dtype == dt and gates.shape == (2, 21, rows, 4 * hidden)
    assert _err(out, ref_out) <= tol
    assert _err(gates, ref_gates) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", SHAPES)
def test_k5_matches_plain_and_is_deterministic(dtype, rows, hidden, cin):
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    before = bigru_vjp.launches_bwd
    bigru_vjp.cuda_launches = 0
    got = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    slices = bigru_vjp.k5_wgrad_slices(21 * rows, cin, hidden, torch.cuda.get_device_properties(
        0).multi_processor_count, _design(hidden, dt))
    # recurrence, dx, weight gradients, and the slice sum when S > 1
    assert bigru_vjp.cuda_launches == 3 + (slices > 1)
    again = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    torch.cuda.synchronize()
    assert bigru_vjp.launches_bwd == before + 2
    ref = bigru_vjp.bigru_layer_bwd_plain(dout, x, wih, whh, out, gates, dt)
    for name, a, b, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"),
                             got, again, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert torch.equal(a, b), name  # no atomics: bit-equal on a rerun
        tol = 1e-5 if (name == "dx" and dt == torch.float32) else _grad_tol(r, dt)
        assert _err(a, r) <= tol, (name, _err(a, r), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,cin", [(65, 32, 11), (1000, 256, 512),
                                             (1024, 256, 11)])
def test_each_phase_product_matches_matmul(dtype, rows, hidden, cin):
    """Each product of K4 and K5 alone, against torch.matmul in f32 on the
    same operands rounded to the operand type: the input projection, dx,
    dW_ih, dW_hh and the bias sums (of the unrounded gate gradients)."""
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    plan = bigru_vjp.k45_plan(hidden, dt)
    L, N, C, H, G = 21, rows, cin, hidden, 3 * hidden

    def op(t):
        return t.to(dt).float()

    xs = op(x).reshape(L * N, C)
    xg = bigru_vjp.k4_projection(x, wih, bih, bhh, plan, dt)
    for d in (0, 1):
        fold = bhh[d].clone()
        fold[2 * H:] = 0.0
        ref = xs @ op(wih[d]) + (bih[d] + fold)
        assert _err(xg[d], ref) <= _sum_tol(xs, op(wih[d])), ("xg", d)

    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    dxg, dhg = bigru_vjp.k5_recurrence(dout, out, gates, whh, plan, dt)
    dx = bigru_vjp.k5_dx(dxg, wih, plan, dt)
    a = torch.cat([op(dxg[0]), op(dxg[1])], dim=1)
    b = torch.cat([op(wih[0]).T, op(wih[1]).T], dim=0)
    assert _err(dx, a @ b) <= _sum_tol(a, b), "dx"

    dw_ih, db_ih, dw_hh, db_hh = bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, dt)
    o = out.float().reshape(L, N, 2 * H)
    for d in (0, 1):
        h_prev = torch.zeros((L, N, H), device="cuda")
        if d == 0:
            h_prev[1:] = o[:-1, :, :H]
        else:
            h_prev[:-1] = o[1:, :, H:]
        h_prev = h_prev.reshape(L * N, H)
        assert _err(dw_ih[d], xs.T @ op(dxg[d])) <= _sum_tol(xs.T, op(dxg[d])), ("dw_ih", d)
        assert _err(dw_hh[d], h_prev.T @ op(dhg[d])) <= _sum_tol(h_prev.T, op(dhg[d])), \
            ("dw_hh", d)
        ones = torch.ones((1, L * N), device="cuda")
        assert _err(db_ih[d], dxg[d].sum(0)) <= _sum_tol(ones, dxg[d]), ("db_ih", d)
        assert _err(db_hh[d], dhg[d].sum(0)) <= _sum_tol(ones, dhg[d]), ("db_hh", d)


@pytest.mark.cuda
def test_layer_fn_runs_the_kernels():
    _need_card()
    x, wih, bih, whh, bhh, _ = _case(40, 32, 11, torch.float32)
    ws = [t.clone().requires_grad_(True) for t in (wih, bih, whh, bhh)]
    xr = x.clone().requires_grad_(True)
    f0, b0, p0 = (bigru_vjp.launches_fwd, bigru_vjp.launches_bwd,
                  bigru_vjp.plain_calls)
    out = bigru_vjp.BiGRULayerFn.apply(xr, *ws, torch.float32)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (bigru_vjp.launches_fwd - f0, bigru_vjp.launches_bwd - b0) == (1, 1)
    assert bigru_vjp.plain_calls == p0
    assert all(t.grad is not None and bool(torch.isfinite(t.grad).all())
               for t in [xr] + ws)


@pytest.mark.cuda
def test_kernels_reject_what_they_cannot_take():
    _need_card()
    x, wih, bih, whh, bhh, _ = _case(8, 16, 11, torch.float32)
    with pytest.raises(ValueError):  # operand type differs from compute type
        bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, torch.bfloat16)
    with pytest.raises(ValueError):  # not contiguous
        bigru_vjp.bigru_layer_train_fwd(x.transpose(0, 1).contiguous().transpose(0, 1),
                                        wih, bih, whh, bhh, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hidden", [20, 48])
def test_refused_shape_raises_before_any_launch(hidden, dtype):
    """H = 20 and 48: neither design takes them; K4 and K5 raise ValueError
    and launch nothing, and no plain version runs in their place."""
    _need_card()
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(16, hidden, 11, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
    bigru_vjp.cuda_launches = 0
    plain = bigru_vjp.plain_calls
    with pytest.raises(ValueError, match="no design for H={}".format(hidden)):
        bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    with pytest.raises(ValueError, match="no design for H={}".format(hidden)):
        bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    assert bigru_vjp.cuda_launches == 0 and bigru_vjp.plain_calls == plain


# sha256 of K4's (out, gates) and K5's five gradients on ``_case(rows, hidden,
# cin, dtype)``, taken on an H100 from the kernels as they were before their
# recurrences moved into csrc/rnn_train_rec.cuh (shared with K6) and their
# products' C entries took the gate count: the shared code leaves every bit
# of K4/K5 as it was.
K45_DIGESTS = {
    (13, 16, 11, 'float32'): "180a2f9d85fd59e51466e1924c1f34a18188ac457c784cf830977ffda6335ee0",
    (13, 16, 11, 'bfloat16'): "aa304aa465c0673d0a4496c1dfb4b85f1dae68df6b69911cb3c9ec05f4f573dc",
    (65, 32, 11, 'float32'): "6ea874c7d79a49de2facf74b13c7895b49b4232efb8106c3ed4a073b14745f12",
    (65, 32, 11, 'bfloat16'): "969ffcf793456c2a2ad6cd3d4c0097ea4eb36a4d9ecd9c3ce8a4c40069246e42",
    (300, 64, 128, 'float32'): "5271ce3992aba15f518391cf9e6a26858500a6581d940442db4df068426029fb",
    (300, 64, 128, 'bfloat16'): "380e7ca4d780af05fc3304c4c310d005b4c28bce32f53ce606921571ecded659",
    (1000, 256, 512, 'float32'): "b31c6d3daf4f61a62214a6a029451b4b520a6cbd082dcce60f5f1e5fdcfa6443",
    (1000, 256, 512, 'bfloat16'): "a47f76118f4ff22dac321670626e6a784425e8e81e004c5300181a567296927d",
}


def k45_digest(rows, hidden, cin, dtype):
    """sha256 over the bytes of K4's and K5's outputs on one case."""
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, dt)
    out, gates = bigru_vjp.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    grads = bigru_vjp.bigru_layer_bwd(dout, x, wih, whh, out, gates, dt)
    h = hashlib.sha256()
    for t in (out, gates) + tuple(grads):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(K45_DIGESTS))
def test_k45_outputs_bit_equal_to_before_the_shared_header(case):
    _need_card()
    rows, hidden, cin, dtype = case
    assert k45_digest(rows, hidden, cin, dtype) == K45_DIGESTS[case]

