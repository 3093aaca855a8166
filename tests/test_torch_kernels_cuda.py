"""Kernel K1 (ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu) against its plain
PyTorch version on the card. Needs a CUDA device and skips without one.

This file imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py
(tests/conftest.py imports JAX).
"""

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
from ccsmeth_tpu_torch.ops import bigru

# tolerances of chip_smoke.py: fp32 1e-5 (measured 2.7e-7 at full width);
# bf16 1e-2, one bf16 ulp on [0.25, 0.5) plus margin, since an f32 sum taken
# in another order can round an activation the other way
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,hidden,layers", [(13, 16, 3), (300, 64, 2),
                                                (1000, 256, 3)])
def test_kernel_matches_plain(dtype, rows, hidden, layers):
    """Odd row counts exercise the ragged last tile; H=64, NL=2 is the golden
    checkpoint's shape, H=256, NL=3 the default model's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(rows)
    ly = [layer_weights(ld, dt, "cuda")
          for ld in init_rnn_params(rng, 11, hidden, layers)]
    x = torch.from_numpy(rng.randn(21, rows, 11).astype(np.float32)).to("cuda", dt)
    before = bigru.launches
    out, hn = bigru.birnn_stack(ly, x, dt)
    torch.cuda.synchronize()
    assert bigru.launches == before + 1
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt)
    assert out.dtype == dt and out.shape == (21, rows, 2 * hidden)
    assert hn.dtype == torch.float32 and hn.shape == (2 * layers, rows, hidden)
    assert (out.float() - ref_out.float()).abs().max().item() <= TOL[dtype]
    assert (hn - ref_hn).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.RandomState(0)
    ly = [layer_weights(ld, torch.float32, "cuda")
          for ld in init_rnn_params(rng, 11, 18, 1)]  # H % 4 != 0
    x = torch.zeros((21, 4, 11), device="cuda")
    with pytest.raises(ValueError):
        bigru.birnn_stack(ly, x, torch.float32)
