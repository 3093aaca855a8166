"""The training kernels at the shapes of the single-strand families and of
the aggregate trainer, on the card: K4/K5 (ccsmeth_tpu_torch/ops/csrc/
bigru_train.cu) and K6 (bilstm_train.cu) at

  - the aggregate model's layer: NL 1, H 32, C 21 (20 histogram bins and the
    offset), L 11, 512 rows (one batch of ``train_aggregate_model``);
  - the 1s families' layers: H 256, L 21, 512 rows (one strand of batch
    512), C = 11 (layer 0) and 512 (layers 1 and 2);

in fp32 and bf16, each against its plain version, with a bit-equal rerun,
the same sha256 digest in a fresh process, and a short batch whose rows
equal the same rows of the full batch. Needs a CUDA device and skips
without one.

This file imports no JAX:
    python -m pytest --noconftest -m cuda tests/test_torch_train_small_cuda.py
"""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (rows, hidden, cin, seq_len)
AGGR = (512, 32, 21, 11)
SHAPES = [AGGR, (512, 256, 11, 21), (512, 256, 512, 21)]
CELLS = {"gru": (bigru_vjp.bigru_layer_train_fwd, bigru_vjp.bigru_layer_train_fwd_plain,
                 bigru_vjp.bigru_layer_bwd, bigru_vjp.bigru_layer_bwd_plain, bigru_vjp),
         "lstm": (bilstm_vjp.bilstm_layer_train_fwd,
                  bilstm_vjp.bilstm_layer_train_fwd_plain,
                  bilstm_vjp.bilstm_layer_bwd, bilstm_vjp.bilstm_layer_bwd_plain,
                  bilstm_vjp)}
GRADS = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions


def _case(rows, hidden, cin, seq_len, cell, dtype, seed=0):
    rng = np.random.RandomState(seed + rows + cin + hidden)
    ld = init_rnn_params(rng, cin, hidden, 1, cell)[0]
    wih, bih, whh, bhh = layer_weights(ld, dtype, "cuda")
    x = torch.from_numpy(rng.randn(seq_len, rows, cin).astype(np.float32)).to("cuda", dtype)
    dout = torch.from_numpy(rng.randn(seq_len, rows, 2 * hidden).astype(np.float32)
                            ).to("cuda", dtype)
    return x, wih, bih, whh, bhh, dout


def _err(a, b):
    return (a.float() - b.float()).abs().max().item()


def _tol(ref, dtype, name):
    """fp32: values and dx 1e-5, the row sums (dW, db) 1e-5 of max|ref| +
    1e-5; bf16: 1e-2 (of max|ref| where that exceeds 1), as the kernels'
    other card tests hold them."""
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 1e-5 if name in ("out", "c", "gates", "dx") else 1e-5 * scale + 1e-5
    if name in ("out", "c", "gates"):
        return 1e-2 * max(1.0, scale)
    return 1e-2 * scale + 1e-5


def _digest(cell, rows, hidden, cin, seq_len, dtype):
    """sha256 over the kernels' outputs (forward residuals, then the five
    gradients) on one case."""
    fwd, _fp, bwd, _bp, _mod = CELLS[cell]
    dt = getattr(torch, dtype)
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, seq_len, cell, dt)
    res = fwd(x, wih, bih, whh, bhh, dt)
    grads = bwd(dout, x, wih, whh, *res, dt)
    h = hashlib.sha256()
    for t in tuple(res) + tuple(grads):
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_training_kernels_match_plain(cell, shape, dtype):
    _need_card()
    rows, hidden, cin, seq_len = shape
    dt = getattr(torch, dtype)
    fwd, fwd_plain, bwd, bwd_plain, mod = CELLS[cell]
    x, wih, bih, whh, bhh, dout = _case(rows, hidden, cin, seq_len, cell, dt)
    plan = bigru_vjp.k45_plan(hidden, dt, cell)
    assert plan["design"] == ("tc" if dt == torch.bfloat16 else "simt")
    mod.cuda_launches, plain0 = 0, mod.plain_calls
    res = fwd(x, wih, bih, whh, bhh, dt)
    assert mod.cuda_launches == 2  # the projection, the recurrence
    ref_res = fwd_plain(x, wih, bih, whh, bhh, dt)
    names = ("out", "gates") if cell == "gru" else ("out", "c", "gates")
    for name, a, r in zip(names, res, ref_res):
        assert a.dtype == dt and a.shape == r.shape, name
        assert _err(a, r) <= _tol(r, dt, name), (name, _err(a, r))
    # both backward versions on the plain version's residuals
    args = (dout, x, wih, whh) + tuple(ref_res) + (dt,)
    mod.cuda_launches = 0
    got = bwd(*args)
    assert mod.cuda_launches == bigru_vjp.bwd_cuda_launches(
        plan, seq_len * rows, cin, torch.cuda.get_device_properties(0).multi_processor_count)
    again = bwd(*args)
    torch.cuda.synchronize()
    assert mod.plain_calls == plain0 + 1  # the plain forward above only
    ref = bwd_plain(*args)
    for name, a, b, r in zip(GRADS, got, again, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert torch.equal(a, b), name  # no atomics: bit-equal on a rerun
        assert _err(a, r) <= _tol(r, dt, name), (name, _err(a, r))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_aggregate_shape_digest_equal_in_a_fresh_process(cell, dtype):
    """The kernels' outputs at the aggregate shape hash the same in this
    process and in a fresh one: nothing of them depends on the memory the
    caching allocator hands out or on what ran before."""
    _need_card()
    mine = _digest(cell, *AGGR, dtype)
    probe = ("import sys; sys.path.insert(0, {!r}); sys.path.insert(0, {!r})\n"
             "import test_torch_train_small_cuda as t\n"
             "print(t._digest({!r}, *t.AGGR, {!r}))").format(
                 REPO, os.path.join(REPO, "tests"), cell, dtype)
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                          text=True, timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == mine


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES[:2])
@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_short_batch_rows_equal_the_full_batch_rows(cell, shape, dtype):
    """The forward of a short last batch (100 of 512 rows) gives each row
    bit for bit what the row gives in the full batch."""
    _need_card()
    rows, hidden, cin, seq_len = shape
    dt = getattr(torch, dtype)
    fwd = CELLS[cell][0]
    x, wih, bih, whh, bhh, _ = _case(rows, hidden, cin, seq_len, cell, dt)
    full = fwd(x, wih, bih, whh, bhh, dt)
    short = fwd(x[:, :100].contiguous(), wih, bih, whh, bhh, dt)
    assert torch.equal(short[0], full[0][:, :100])  # out (L, N, 2H)
