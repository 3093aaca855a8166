"""K3's fp32 design (csrc/transenc_simt.cu) on the CPU: its shape rule in
``ops/transenc.py::k3_plan``, its constants held to the kernel source, and
a mirror in plain PyTorch of its order of work (64-row tiles of S samples,
one head's q | k | v from Wqkv's column slices at a time, the context into
ctx's columns, the feed-forward in the plan's hidden-column chunks, each
chunk's product by W2's rows added to the sum chunk after chunk), held to the
port's plain version and to the JAX package's Pallas encoder (interpret mode)
and XLA encoder."""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccsmeth_tpu.models.config import TransEncConfig as JaxTransEncConfig
from ccsmeth_tpu.models.transenc import _encoder
from ccsmeth_tpu.ops.transenc_pallas import encoder_pooled_pallas
from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
from ccsmeth_tpu_torch.models.transenc import randomize_affine
from ccsmeth_tpu_torch.ops import transenc
from ccsmeth_tpu_torch.ops.kernel_args import SMEM_LIMIT

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

SMALL = dict(num_layers=2, d_model=64, nhead=4, dim_ff=128, dropout_rate=0.0)


def simt_order(st, x, nhead):
    """transenc_simt.cu's arithmetic in plain PyTorch, f32, in its order of
    work: tiles of S = SIMT_ROWS // L samples (the last one padded with zero
    samples, which are dropped); per layer and head h, q | k | v from Wqkv's
    columns h HD, D + h HD, 2D + h HD, the head's context into ctx's columns
    h HD ..; x = LN(x + (ctx Wo + bo)); the hidden layer in SIMT_FC-column
    chunks relu(x W1[:, c] + b1[c]), each times W2[c, :] added to the sum
    chunk after chunk; x = LN(x + (sum + b2)); then the mean over L."""
    N, L, D = x.shape
    NL, FF = st["w1"].shape[0], st["w1"].shape[2]
    HD = D // nhead
    S = transenc.SIMT_ROWS // L
    tiles = -(-N // S)
    xt = torch.zeros((tiles * S, L, D))
    xt[:N] = x
    h = xt.reshape(tiles, S * L, D)
    for li in range(NL):
        ctx = torch.empty_like(h)
        for hh in range(nhead):
            cols = torch.cat([torch.arange(hh * HD, (hh + 1) * HD) + i * D
                              for i in range(3)])
            qkv = h @ st["wqkv"][li][:, cols] + st["bqkv"][li][cols]
            q, k, v = (qkv[..., i * HD:(i + 1) * HD].reshape(tiles, S, L, HD)
                       for i in range(3))
            p = torch.softmax((q @ k.transpose(2, 3)) * (1.0 / HD ** 0.5), dim=-1)
            ctx[..., hh * HD:(hh + 1) * HD] = (p @ v).reshape(tiles, S * L, HD)
        h = F.layer_norm(h + (ctx @ st["wo"][li] + st["bo"][li]), (D,),
                         st["ln1s"][li], st["ln1b"][li], 1e-5)
        f = None
        for c0 in range(0, FF, transenc.SIMT_FC):
            c1 = min(FF, c0 + transenc.SIMT_FC)
            hid = torch.relu(h @ st["w1"][li][:, c0:c1] + st["b1"][li][c0:c1])
            part = hid @ st["w2"][li][c0:c1]
            f = part if f is None else f + part
        h = F.layer_norm(h + (f + st["b2"][li]), (D,), st["ln2s"][li],
                         st["ln2b"][li], 1e-5)
    return h.reshape(tiles * S, L, D)[:N].mean(dim=1)


@pytest.mark.parametrize("seq_len,d,ff,nhead", [(21, 256, 512, 4), (21, 64, 128, 4),
                                               (32, 256, 512, 8), (1, 32, 48, 2)])
def test_k3_plan_takes_fp32_shapes_to_the_simt_design(seq_len, d, ff, nhead):
    """fp32 at transencoder2s's shape (226,304 bytes a CTA, 3 samples) and at
    smaller ones goes to the simt design: S = 64 // L samples a CTA, shared
    memory within the limit; it says why not tc."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, torch.float32)
    assert plan["design"] == "simt", plan
    assert plan["S"] == transenc.SIMT_ROWS // seq_len and plan["S"] * seq_len <= 64
    assert plan["smem"] == transenc.simt_smem(seq_len, d, ff, nhead) <= SMEM_LIMIT
    assert "fp32" in plan["why"]
    if (seq_len, d, ff, nhead) == (21, 256, 512, 4):
        assert (plan["S"], plan["smem"]) == (3, 226_304)


@pytest.mark.parametrize("seq_len,d,ff,nhead,why", [
    (33, 256, 512, 4, "L >"),
    (21, 40, 64, 4, "multiple of 16"),
    (21, 256, 520, 4, "multiple of 16"),
    (21, 512, 1024, 8, "D > 256"),
    (21, 256, 512, 2, "head width 128"),
    (21, 96, 128, 16, "head width 6"),
])
def test_k3_plan_sends_fp32_shapes_simt_refuses_to_l2(seq_len, d, ff, nhead, why):
    """An fp32 shape that the simt design does not take keeps the first
    f32 kernel (l2), with the reason; l2's own limits are L <= 32 and D, FF
    multiples of 4, so every shape that ran before still has a design."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, torch.float32)
    assert plan["design"] == "l2" and why in plan["why"], plan
    assert "simt: " in plan["why"]


def test_simt_constants_follow_the_kernel_source():
    """The wrapper's copy of the tile (threads, rows, k-major stride, ring
    slab rows, ring stages, widest slab, hidden chunk, the largest D, head
    width and L) is the source's #defines, and simt_smem is the source's
    transenc_simt_smem."""
    path = os.path.join(os.path.dirname(transenc.__file__), "csrc", transenc.SIMT_SRC)
    with open(path) as f:
        src = f.read()
    defines = dict(re.findall(r"^#define (TS_\w+) (\d+)", src, re.M))
    want = {"TS_THREADS": transenc.SIMT_THREADS, "TS_ROWS": transenc.SIMT_ROWS,
            "TS_LD": transenc.SIMT_LD, "TS_LMAX": transenc.LMAX,
            "TS_BK": transenc.SIMT_BK, "TS_STAGES": transenc.SIMT_STAGES,
            "TS_WMAX": transenc.SIMT_WMAX, "TS_FC": transenc.SIMT_FC,
            "TS_DMAX": transenc.SIMT_DMAX, "TS_HDMAX": transenc.SIMT_HDMAX}
    assert {k: int(defines[k]) for k in want} == want
    flat = " ".join(src.split())
    for line in ("const int HB = 3 * HD > TS_FC ? 3 * HD : TS_FC;",
                 "return ((size_t)(2 * D + HB) * TS_LD + TS_STAGES * TS_BK * TS_WMAX "
                 "+ 2 * TS_THREADS) * sizeof(float);",
                 "ring_gemm<6>(xs, D, wqkv, 3 * D, qkv_cols, 3 * HD, bqkv, ring,",
                 "const Cols qkv_cols = {h * HD, HD, D};",
                 "for (int c0 = 0; c0 < FF; c0 += TS_FC) {",
                 "*pc = c0 == 0 ? v : add4(*pc, v);"):
        assert line in flat, line
    # the widest slab holds the widest product's 32 TN columns (TN = 8)
    assert transenc.SIMT_WMAX == 32 * 8 == transenc.SIMT_DMAX


def test_simt_source_is_exact_f32_fmas():
    """The simt design's code (comments dropped) issues no tensor-core
    instruction and calls no library: its products are fmaf, and it uses
    mma_tile.cuh only for the cp.async ring."""
    path = os.path.join(os.path.dirname(transenc.__file__), "csrc", transenc.SIMT_SRC)
    with open(path) as f:
        code = re.sub(r"//.*", "", f.read())
    for word in ("mma_bf16", "ldmatrix", "wgmma", "mma.sync", "tf32", "cublas",
                 "cudnn", "__float2bfloat16"):
        assert word not in code.lower(), word
    assert "acc[r][c] = fmaf(a[r], b[c], acc[r][c]);" in code
    assert {"cp_async_16", "cp_async_commit", "cp_async_wait"} <= set(
        re.findall(r"\b(cp_async_\w+)", code))


def _case(n, seed):
    cfg = TransEncConfig(**SMALL)
    params = randomize_affine(init_transenc(seed, cfg), seed)
    x = np.random.RandomState(seed + n).randn(n, 21, 64).astype(np.float32) * 0.4
    return params, x


@pytest.mark.parametrize("reference", ["plain", "pallas", "xla"])
@pytest.mark.parametrize("n", [1, 3, 50])
def test_simt_order_matches_the_references(n, reference):
    """Ragged N: one sample in a tile of 3, one full tile, 16 full tiles and
    a tile of 2; random biases and LayerNorm parameters, different per layer.
    Tolerance as tests/test_torch_transenc.py's plain-version parity."""
    params, x = _case(n, 6)
    st = transenc.stack_layers(params["layers"])
    got = simt_order(st, torch.from_numpy(x), SMALL["nhead"])
    assert got.shape == (n, 64) and bool(torch.isfinite(got).all())
    if reference == "plain":
        want = transenc.encoder_pooled_plain(st, torch.from_numpy(x), torch.float32,
                                             SMALL["nhead"]).numpy()
    else:
        cfg = JaxTransEncConfig(**SMALL)
        if reference == "pallas":
            want = encoder_pooled_pallas(params, cfg, jnp.asarray(x), interpret=True)
        else:
            want = jnp.mean(_encoder(params, cfg, jnp.asarray(x), None, False), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("reference", ["plain", "xla"])
@pytest.mark.parametrize("ff", [208, 400])
def test_simt_order_chunks_the_feed_forward(ff, reference):
    """FF wider than one SIMT_FC chunk: 192 + 16 and 192 + 192 + 16 hidden
    columns, the chunks' products summed chunk after chunk."""
    cfg = TransEncConfig(**dict(SMALL, dim_ff=ff))
    params = randomize_affine(init_transenc(ff, cfg), ff)
    x = np.random.RandomState(ff).randn(5, 21, 64).astype(np.float32) * 0.4
    st = transenc.stack_layers(params["layers"])
    assert transenc.k3_plan(21, 64, ff, 4, torch.float32)["design"] == "simt"
    got = simt_order(st, torch.from_numpy(x), 4)
    if reference == "plain":
        want = transenc.encoder_pooled_plain(st, torch.from_numpy(x), torch.float32, 4)
    else:
        jcfg = JaxTransEncConfig(**dict(SMALL, dim_ff=ff))
        want = jnp.mean(_encoder(params, jcfg, jnp.asarray(x), None, False), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)
