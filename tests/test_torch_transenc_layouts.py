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


def fma_chain(acc, a, w):
    """acc (R, P) plus a (R, K) times w (K, P) as the kernel sums it: one
    chain a element, acc = fma(a[:, k], w[k, :], acc) for k = 0 .. K-1 in
    order (each step in f64, rounded to f32: a model of the order, not of
    fmaf's single rounding)."""
    acc = acc.double()
    for k in range(a.shape[1]):
        acc = (acc + a[:, k:k + 1].double() * w[k:k + 1, :].double()).float().double()
    return acc.float()


def _tiles(x, S):
    """x (N, L, D) -> (tiles * S * L, D): tiles of S samples, the last one
    padded with zero samples."""
    N, L, D = x.shape
    tiles = -(-N // S)
    xt = torch.zeros((tiles * S, L, D))
    xt[:N] = x
    return xt.reshape(tiles * S * L, D), tiles


def _attention(qkv, tiles, S, L, HD):
    """One head's softmax(q k^T / sqrt(HD)) v over each sample's rows, from
    a (rows, 3 HD) block [q | k | v]."""
    q, k, v = (qkv[:, i * HD:(i + 1) * HD].reshape(tiles * S, L, HD) for i in range(3))
    p = torch.softmax((q @ k.transpose(1, 2)) * (1.0 / HD ** 0.5), dim=-1)
    return (p @ v).reshape(tiles * S * L, HD)


def _layer_norm(h, st, name, li):
    D = h.shape[1]
    return F.layer_norm(h, (D,), st[name + "s"][li], st[name + "b"][li], 1e-5)


def simt_order(st, x, nhead):
    """transenc_simt.cu's arithmetic in plain PyTorch, f32, in its order of
    work: tiles of S = SIMT_ROWS // L samples (the last one padded with zero
    samples, which are dropped); every product a chain over k carried from
    ring slab to ring slab, each slab's image built from the producer's
    copies (``simt_walk``) in the walk's order; per layer and head h, q | k
    | v (Wqkv's columns h HD, D + h HD, 2D + h HD) plus its bias, the
    head's context into ctx's columns h HD ..; x = LN(x + (ctx Wo + bo));
    the hidden layer in SIMT_FC-column chunks relu(x W1[:, c] + b1[c]),
    each chunk's product by W2[c, :] (a chain from 0) added to the sum chunk
    after chunk; x = LN(x + (sum + b2)); then the mean over L."""
    N, L, D = x.shape
    NL, FF = st["w1"].shape[0], st["w1"].shape[2]
    HD = D // nhead
    S = transenc.SIMT_ROWS // L
    h, tiles = _tiles(x, S)
    walk = iter(simt_walk(NL, D, nhead, FF))

    def product(A, w, K):
        acc = None
        for k0 in range(0, K, transenc.SIMT_BK):
            _l, _kind, _idx, k0w, kn, P, copies, _ws = next(walk)
            assert k0w == k0
            slot = torch.zeros((transenc.SIMT_BK, transenc.SIMT_WMAX))
            for row, c, n, kk, sc in copies:
                slot[kk, sc:sc + n] = w[row, c:c + n]
            acc = torch.zeros((A.shape[0], P)) if acc is None else acc
            acc = fma_chain(acc, A[:, k0:k0 + kn], slot[:kn, :P])
        return acc

    for li in range(NL):
        ctx = torch.zeros((h.shape[0], D))
        for hh in range(nhead):
            cols = torch.cat([torch.arange(hh * HD, (hh + 1) * HD) + i * D for i in range(3)])
            qkv = product(h, st["wqkv"][li], D) + st["bqkv"][li][cols]
            ctx[:, hh * HD:(hh + 1) * HD] = _attention(qkv, tiles, S, L, HD)
        h = _layer_norm(h + (product(ctx, st["wo"][li], D) + st["bo"][li]), st, "ln1", li)
        f = None
        for c0 in range(0, FF, transenc.SIMT_FC):
            c1 = min(FF, c0 + transenc.SIMT_FC)
            hid = torch.relu(product(h, st["w1"][li], D) + st["b1"][li][c0:c1])
            part = product(hid, st["w2"][li], c1 - c0)
            f = part if f is None else f + part
        h = _layer_norm(h + (f + st["b2"][li]), st, "ln2", li)
    assert next(walk, None) is None
    return h.reshape(tiles * S, L, D)[:N].mean(dim=1)


def simt_order_parent(st, x, nhead):
    """The order of work of the design before (its cp.async ring), each
    product one chain over its weight's rows and columns sliced from the
    stacked weights directly: q | k | v of head h from Wqkv's column
    slices, every head's context into a context buffer's columns h HD ..,
    then one chain over its D columns by Wo; the feed-forward's chunk
    partials added into the same buffer chunk after chunk."""
    N, L, D = x.shape
    NL, FF = st["w1"].shape[0], st["w1"].shape[2]
    HD = D // nhead
    S = transenc.SIMT_ROWS // L
    h, tiles = _tiles(x, S)
    for li in range(NL):
        ctx = torch.zeros((h.shape[0], D))
        for hh in range(nhead):
            cols = torch.cat([torch.arange(hh * HD, (hh + 1) * HD) + i * D for i in range(3)])
            qkv = fma_chain(torch.zeros((h.shape[0], 3 * HD)), h, st["wqkv"][li][:, cols])
            ctx[:, hh * HD:(hh + 1) * HD] = _attention(qkv + st["bqkv"][li][cols], tiles, S, L,
                                                       HD)
        a = fma_chain(torch.zeros((h.shape[0], D)), ctx, st["wo"][li]) + st["bo"][li]
        h = _layer_norm(h + a, st, "ln1", li)
        for c0 in range(0, FF, transenc.SIMT_FC):
            c1 = min(FF, c0 + transenc.SIMT_FC)
            hid = fma_chain(torch.zeros((h.shape[0], c1 - c0)), h, st["w1"][li][:, c0:c1])
            hid = torch.relu(hid + st["b1"][li][c0:c1])
            part = fma_chain(torch.zeros((h.shape[0], D)), hid, st["w2"][li][c0:c1])
            ctx = part if c0 == 0 else ctx + part
        h = _layer_norm(h + (ctx + st["b2"][li]), st, "ln2", li)
    return h.reshape(tiles * S, L, D)[:N].mean(dim=1)


@pytest.mark.parametrize("seq_len,d,ff,nhead", [(21, 256, 512, 4), (21, 64, 128, 4),
                                               (32, 256, 512, 8), (1, 32, 48, 2)])
def test_k3_plan_takes_fp32_shapes_to_the_simt_design(seq_len, d, ff, nhead):
    """fp32 at transencoder2s's shape (229,408 bytes a CTA, 3 samples) and at
    smaller ones goes to the simt design: S = 64 // L samples a CTA, shared
    memory within the limit; it says why not tc."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, torch.float32)
    assert plan["design"] == "simt", plan
    assert plan["S"] == transenc.SIMT_ROWS // seq_len and plan["S"] * seq_len <= 64
    assert plan["smem"] == transenc.simt_smem(seq_len, d, ff, nhead) <= SMEM_LIMIT
    assert "fp32" in plan["why"]
    if (seq_len, d, ff, nhead) == (21, 256, 512, 4):
        assert (plan["S"], plan["smem"]) == (3, 229_408)


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


def _simt_source():
    path = os.path.join(os.path.dirname(transenc.__file__), "csrc", transenc.SIMT_SRC)
    with open(path) as f:
        return f.read()


def test_simt_constants_follow_the_kernel_source():
    """The wrapper's copy of the design (threads, consumer threads, rows,
    the k-major stride, ring slab rows, ring slots, a slot's row width, hidden
    chunk, the largest D, head width and L) is the source's #defines, and
    simt_smem is the source's transenc_simt_smem."""
    src = _simt_source()
    defines = dict(re.findall(r"^#define (TS_\w+) (\d+)", src, re.M))
    want = {"TS_THREADS": transenc.SIMT_THREADS, "TS_CONSUMERS": transenc.SIMT_CONSUMERS,
            "TS_ROWS": transenc.SIMT_ROWS, "TS_LD": transenc.SIMT_LD, "TS_LMAX": transenc.LMAX,
            "TS_BK": transenc.SIMT_BK, "TS_STAGES": transenc.SIMT_STAGES,
            "TS_WMAX": transenc.SIMT_WMAX, "TS_FC": transenc.SIMT_FC,
            "TS_DMAX": transenc.SIMT_DMAX, "TS_HDMAX": transenc.SIMT_HDMAX}
    assert {k: int(defines[k]) for k in want} == want
    flat = " ".join(src.split())
    for line in ("const int HB = 3 * HD > TS_FC ? 3 * HD : TS_FC;",
                 "return ((size_t)(2 * D + HB) * TS_LD + TS_STAGES * TS_BK * TS_WMAX + "
                 "2 * TS_CONSUMERS + 3 * TS_DMAX) * sizeof(float) + 2 * TS_STAGES * "
                 "sizeof(uint64_t);",
                 "const Cols qkv_cols = {h * HD, HD, D};",
                 "for (int c0 = 0; c0 < FF; c0 += TS_FC) {",
                 "epilogue(ctx, D, acc, nullptr, none, store);",
                 "epilogue(ctx, D, acc, nullptr, none, add);",
                 "const auto add = [](float4* pd, float4 v) { *pd = add4(*pd, v); };",
                 "layer_norm(xs, D, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D, red, stage, "
                 "ctx, p.b2 + (size_t)l * D);",
                 "if (add != nullptr) *px += add[(size_t)c * TS_LD + r] + stage[2 * TS_DMAX + c];",
                 "__launch_bounds__(TS_THREADS, 1)"):
        assert line in flat, line
    # the widest product (32 column groups of TN = 8) fills a slot's row;
    # the consumers are 8 warps, the producer one more
    assert transenc.SIMT_WMAX == 32 * 8 == transenc.SIMT_DMAX
    assert transenc.SIMT_THREADS == transenc.SIMT_CONSUMERS + 32 == 9 * 32
    assert transenc.SIMT_FC % transenc.SIMT_BK == 0
    assert transenc.simt_smem(21, 256, 512, 4) == (704 * 68 + 2 * 16 * 256 + 512 + 768) * 4 + 32


def test_simt_source_is_exact_f32_fmas():
    """The simt design's code (comments dropped) issues no tensor-core
    instruction, no TF32 and no bf16 conversion, and calls no library: its
    products are fmaf chains, and its copies are the producer's TMA loads of
    f32 boxes onto the ring's mbarriers."""
    code = re.sub(r"//.*", "", _simt_source())
    for word in ("mma_bf16", "ldmatrix", "wgmma", "mma.sync", "tf32", "cublas",
                 "cudnn", "__float2bfloat16", "bfloat16", "__half", "cvt.rn"):
        assert word not in code.lower(), word
    assert "acc[r][c] = fmaf(a[r], b[c], acc[r][c]);" in code
    for word in ("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes",
                 "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes",
                 "CU_TENSOR_MAP_DATA_TYPE_FLOAT32", "mbarrier.arrive.expect_tx",
                 "mbarrier.try_wait.parity", "mbarrier.init"):
        assert word in code, word


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


@pytest.mark.parametrize("n,ff", [(1, 128), (3, 128), (50, 128), (5, 208), (5, 400)])
def test_simt_order_keeps_the_parent_order(n, ff):
    """The new order of work (every product's chain carried over the ring's
    slabs of SIMT_BK k rows, each slab gathered by the producer's copies)
    gives the old order's numbers bit for bit: the same chains, in the same
    order, over the same weights."""
    cfg = TransEncConfig(**dict(SMALL, dim_ff=ff))
    params = randomize_affine(init_transenc(n + ff, cfg), n + ff)
    x = torch.from_numpy(np.random.RandomState(n).randn(n, 21, 64).astype(np.float32) * 0.4)
    st = transenc.stack_layers(params["layers"])
    assert torch.equal(simt_order(st, x, 4), simt_order_parent(st, x, 4))


# ---- the simt design's ring: the producer's walk over the weight slabs,
# the consumers' order, their barriers and the ring's protocol, and the
# consumer threads' tiles

def simt_walk(NL, D, NH, FF):
    """The producer's slabs of a tile (transenc_simt.cu's producer loop), in
    order: (layer, product, index, k0, kn, P, copies, ws). Each slab is one
    TMA box that lands as a dense [SIMT_BK][ws] image; a copy (weight row,
    first column, columns, slot row, slot column) is one of its in-bounds
    row segments (the rest of a box, past the weight's columns, arrives as
    zeros). Per layer and head the q | k | v slabs (the 3-d box of Wqkv's
    columns h HD, D + h HD, 2D + h HD: ws = 3 HD), then Wo's D rows (ws =
    D); per hidden chunk c0, W1's columns (a box of min(FF, SIMT_FC)
    columns) and W2's rows (ws = D)."""
    HD, BK, FC = D // NH, transenc.SIMT_BK, transenc.SIMT_FC
    w1b = min(FF, FC)
    walk = []

    def put(l, kind, idx, row0, K, base, seg, stride, P, ws):
        for k0 in range(0, K, BK):
            kn = min(BK, K - k0)
            copies = [(row0 + k0 + kk, base + sg * stride, seg, kk, sg * seg)
                      for kk in range(kn) for sg in range(P // seg)]
            walk.append((l, kind, idx, k0, kn, P, copies, ws))

    for l in range(NL):
        for h in range(NH):
            put(l, "qkv", h, 0, D, h * HD, HD, D, 3 * HD, 3 * HD)
        put(l, "wo", 0, 0, D, 0, D, 0, D, D)
        for c0 in range(0, FF, FC):
            P = min(FC, FF - c0)
            put(l, "w1", c0, 0, D, c0, P, 0, P, w1b)
            put(l, "w2", c0, c0, P, 0, D, 0, D, D)
    return walk


def simt_program(NL, D, NH, FF):
    """A consumer warp's program (the kernel's consumer loop): ("take",
    product, index, k0) for each slab it consumes, ("sync",) for each named
    barrier, in order."""
    HD, BK, FC = D // NH, transenc.SIMT_BK, transenc.SIMT_FC
    prog = []

    def take(kind, idx, K):
        prog.extend(("take", kind, idx, k0) for k0 in range(0, K, BK))

    ln = [("sync",)] * 4  # layer_norm's four barriers
    for _l in range(NL):
        for h in range(NH):
            take("qkv", h, D)
            prog += [("sync",)] * 2  # hb free; q | k | v complete
        prog += [("sync",)]  # the context complete
        take("wo", 0, D)
        prog += [("sync",)] + ln  # the residual complete; LayerNorm 1
        for c0 in range(0, FF, FC):
            take("w1", c0, D)
            prog += [("sync",)] * 2  # hb free; the hidden chunk complete
            take("w2", c0, min(FC, FF - c0))
        prog += [("sync",)] + ln
    return prog


SIMT_SHAPES = [(2, 256, 4, 512), (2, 64, 4, 128), (1, 48, 4, 96), (1, 256, 8, 400),
               (1, 16, 4, 16)]


@pytest.mark.parametrize("NL,D,NH,FF", SIMT_SHAPES)
def test_simt_walk_is_the_consumers_order_and_covers_each_weight(NL, D, NH, FF):
    """The producer's slabs are the consumers' takes, one for one; each
    layer's boxes copy every element of Wqkv, Wo, W1 and W2 exactly once,
    into a slot's rows in the product's column order (q | k | v of the head,
    or the chunk's columns), each row a multiple of 16 bytes; at transencoder2s's shape a tile is 320 slabs a layer."""
    walk = simt_walk(NL, D, NH, FF)
    takes = [t[1:] for t in simt_program(NL, D, NH, FF) if t[0] == "take"]
    assert [w[1:4] for w in walk] == takes
    HD = D // NH
    shapes = {"qkv": (D, 3 * D), "wo": (D, D), "w1": (D, FF), "w2": (FF, D)}
    for l in range(NL):
        for kind, (rows, cols) in shapes.items():
            cover = torch.zeros((rows, cols), dtype=torch.int64)
            for (_l, _k, idx, k0, kn, P, copies, ws) in (w for w in walk if w[:2] == (l, kind)):
                # a box fits a slot, its rows are 16-byte multiples, P <= ws
                assert kn == transenc.SIMT_BK and P <= ws <= transenc.SIMT_WMAX
                assert ws % 4 == 0
                slot = []
                for (row, c, n, kk, sc) in copies:
                    assert n % 4 == 0 and c % 4 == 0 and sc % 4 == 0 and sc + n <= P
                    cover[row, c:c + n] += 1
                    slot.append((kk, sc, row, c))
                # slot row kk, column sc + e holds the product's pass column
                # sc + e: for q | k | v, column (sc // HD) D + h HD + e
                for kk, sc, row, c in slot:
                    if kind == "qkv":
                        assert c == (sc // HD) * D + idx * HD and row == k0 + kk
                    elif kind == "w1":
                        assert c == idx + sc and row == k0 + kk
                    else:
                        assert c == 0 and row == (idx if kind == "w2" else 0) + k0 + kk
            assert bool((cover == 1).all()), (l, kind)
    if (NL, D, NH, FF) == (2, 256, 4, 512):
        assert len(walk) == 2 * 160


@pytest.mark.parametrize("stages", [1, 2, 6])
@pytest.mark.parametrize("NL,D,NH,FF", SIMT_SHAPES[:3])
def test_simt_ring_protocol_runs_to_the_end(NL, D, NH, FF, stages):
    """A simulation of the ring on mbarriers and the consumers' named
    barriers, steps taken in random order: the producer issues slab g once
    all 8 consumer warps released slab g - stages (`empty`); a warp takes
    its next slab once it was issued (`full`) and releases it; a warp passes
    a barrier once all 8 reached it. It never deadlocks, at any ring depth,
    and every slab is issued once and released by every warp."""
    walk = simt_walk(NL, D, NH, FF)
    prog = simt_program(NL, D, NH, FF)
    n, warps = len(walk), 8
    rng = np.random.RandomState(stages + D)
    issued = 0
    released = [0] * n
    pc = [0] * warps        # each warp's next step
    taken = [0] * warps     # slabs each warp took
    synced = [0] * warps    # barriers each warp passed

    def at_sync(w):
        return pc[w] < len(prog) and prog[pc[w]][0] == "sync"

    while any(p < len(prog) for p in pc):
        moves = []
        if issued < n and (issued < stages or released[issued - stages] == warps):
            moves.append(("issue", None))
        for w in range(warps):
            if pc[w] >= len(prog):
                continue
            if prog[pc[w]][0] == "take":
                if taken[w] < issued:
                    moves.append(("take", w))
            elif all(at_sync(v) and synced[v] == synced[w] or synced[v] > synced[w]
                     for v in range(warps)):
                moves.append(("sync", w))
        assert moves, (issued, pc)
        kind, w = moves[rng.randint(len(moves))]
        if kind == "issue":
            issued += 1
        elif kind == "take":
            assert prog[pc[w]][1:] == walk[taken[w]][1:4]
            released[taken[w]] += 1
            taken[w] += 1
            pc[w] += 1
        else:
            synced[w] += 1
            pc[w] += 1
    assert issued == n and released == [warps] * n


def test_simt_walk_follows_the_kernel_source():
    """simt_walk and simt_program are the kernel's producer and consumer
    loops: the products' calls, the barriers between them, the ring's
    waits, releases and barrier counts."""
    flat = " ".join(re.sub(r"//.*", "", _simt_source()).split())
    for line in (
            "for (int h = 0; h < NH; ++h) produce(ring, &mqkv, true, h * HD, l * D, D, qkv_bytes); "
            "produce(ring, &mo, false, 0, l * D, D, d_bytes);",
            "produce(ring, &m1, false, c0, l * D, D, w1_bytes);",
            "produce(ring, &m2, false, 0, l * FF + c0, P, d_bytes);",
            "const uint32_t qkv_bytes = 3 * HD * TS_BK * sizeof(float);",
            "const uint32_t d_bytes = D * TS_BK * sizeof(float);",
            "const uint32_t w1_bytes = W1B * TS_BK * sizeof(float);",
            "const int W1B = FF < TS_FC ? FF : TS_FC;",
            "for (int k0 = 0; k0 < K; k0 += TS_BK, ++ring.g) { const int s = ring.g % TS_STAGES, "
            "use = ring.g / TS_STAGES;",
            "if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1); mbar_expect_tx(ring.full(s), bytes);",
            "tma_load_3d(dst, map, ring.full(s), col, 0, row + k0);",
            "tma_load_2d(dst, map, ring.full(s), col, row + k0);",
            "const cuuint64_t qdims[3] = {(cuuint64_t)D, 3, (cuuint64_t)NL * D};",
            "const cuuint64_t qstrides[2] = {(cuuint64_t)D * 4, (cuuint64_t)D * 12};",
            "const cuuint32_t qbox[3] = {(cuuint32_t)HD, 3, TS_BK};",
            "const cuuint32_t obox[2] = {(cuuint32_t)D, TS_BK};",
            "const cuuint32_t box1[2] = {W1B, TS_BK};",
            "const cuuint64_t dims2[2] = {(cuuint64_t)D, (cuuint64_t)NL * FF};",
            "mbar_wait(ring.full(s), (ring.g / TS_STAGES) & 1);",
            "__syncwarp(); if (lane == 0) mbar_arrive(ring.empty(s));",
            "mbar_init(smem_addr(bars + s), 1);",
            "mbar_init(smem_addr(bars + TS_STAGES + s), TS_CONSUMERS / 32);",
            "consume(ring, xs, D, 3 * HD, acc); consumer_sync(); "
            "epilogue(hb, 3 * HD, acc, bqkv, bv, store); consumer_sync(); "
            "attention(hb, ctx, h, HD, L, S, scale); } consumer_sync();",
            "consume(ring, ctx, D, D, acc); epilogue(xs, D, acc, bo, bv, add); } "
            "consumer_sync(); layer_norm(xs, D, p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D, "
            "red, stage, nullptr, nullptr);",
            "consume(ring, xs, D, W1B, acc); consumer_sync(); epilogue(hb, P, acc, b1, bv, relu);",
            "consumer_sync(); float none[8], acc[8][8]; consume(ring, hb, P, D, acc);",
            "} consumer_sync(); layer_norm(xs, D, p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D, "
            "red, stage, ctx, p.b2 + (size_t)l * D);",
            "if (active) ctx[(size_t)(h * HD + qd + 4 * n) * TS_LD + row] = c;"):
        assert line in flat, line
    # layer_norm's four barriers
    ln = flat[flat.index("__device__ __forceinline__ void layer_norm("):]
    ln = ln[:ln.index("__global__ void")]
    assert ln.count("consumer_sync();") == 4


def simt_tile(tn):
    """The consumer threads' (row, column) pairs of a 64-row product tile:
    thread t (warp w = t // 32, lane), ty = lane // 4, tx = 4 w + lane % 4,
    rows 4 ty + r and 32 + 4 ty + r (r < 4), columns 4 tx + c (c < 4) and,
    for TN = 8 / 6, 128 + 4 tx + c / 128 + 2 tx + c."""
    out = {}
    for t in range(transenc.SIMT_CONSUMERS):
        w, lane = t // 32, t % 32
        ty, tx = lane // 4, 4 * w + lane % 4
        rows = [4 * ty + r for r in range(4)] + [32 + 4 * ty + r for r in range(4)]
        cols = [4 * tx + c for c in range(4)]
        if tn > 4:
            cols += [128 + (2 if tn == 6 else 4) * tx + c for c in range(tn - 4)]
        out[t] = (rows, cols)
    return out


@pytest.mark.parametrize("tn,width", [(8, 256), (6, 192), (4, 128)])
def test_simt_thread_tiles_cover_each_product_once(tn, width):
    """The 256 consumer threads' 8 x TN tiles cover the 64 x width product
    exactly once; a warp's A reads (rows 4 ty .. + 3, then + 32) are 128
    contiguous bytes and its weight reads one run of contiguous columns per
    group."""
    tiles = simt_tile(tn)
    cover = torch.zeros((64, width), dtype=torch.int64)
    for rows, cols in tiles.values():
        for r in rows:
            for c in cols:
                cover[r, c] += 1
    assert bool((cover == 1).all())
    for w in range(8):
        lanes = [tiles[32 * w + i] for i in range(32)]
        assert sorted({rows[0] for rows, _ in lanes}) == list(range(0, 32, 4))
        first = sorted({cols[0] for _, cols in lanes})
        assert first == list(range(16 * w, 16 * w + 16, 4))


# ---- the bf16 tc design (csrc/transenc_tc.cu) on the CPU: k3_plan's rule,
# the constants held to the source, the operand images that the consumers'
# stores and the TMA boxes write and the wgmma descriptors read, the
# residual's register layout, LayerNorm's fixed-order row sums, the
# producer's tile walk and the ring's protocol, and a model of the whole
# design's order of work held to the plain version and the JAX package

TC_BOX = 8192  # TE_BOX: a 64-row block of 128-byte rows


def _tc_source():
    path = os.path.join(os.path.dirname(transenc.__file__), "csrc", transenc.TC_SRC)
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("seq_len,d,ff,nhead,smem", [
    (21, 256, 512, 4, 197_696), (21, 128, 256, 2, 99_392), (32, 256, 512, 4, 197_696),
    (1, 128, 128, 2, 99_392), (21, 256, 768, 4, 197_696), (21, 256, 1024, 4, 230_464)])
def test_k3_plan_takes_bf16_shapes_to_the_tc_design(seq_len, d, ff, nhead, smem):
    """bf16 with D = 128 or 256, FF a multiple of D, heads of width 64: the
    tc design, 64 // L samples a CTA, and the shared memory of tc_smem with
    the ring's 4 slots."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, torch.bfloat16)
    assert plan == {"design": "tc", "S": 64 // seq_len, "smem": smem}
    assert smem == transenc.tc_smem(d, ff) <= SMEM_LIMIT
    assert transenc.TC_STAGES == 4


@pytest.mark.parametrize("seq_len,d,ff,nhead,why", [
    (33, 256, 512, 4, "L > 32"),
    (21, 64, 128, 4, "D 64 is not 128 or 256"),
    (21, 384, 768, 4, "D 384 is not 128 or 256"),
    (21, 256, 640, 4, "FF 640 not a multiple of D"),
    (21, 128, 192, 4, "FF 192 not a multiple of D"),
    (21, 256, 512, 8, "head width 32.0 is not 64"),
    (21, 128, 256, 4, "head width 32.0 is not 64"),
    (21, 256, 1536, 4, "296000 bytes of shared memory"),
])
def test_k3_plan_sends_bf16_shapes_tc_refuses_to_l2(seq_len, d, ff, nhead, why):
    """A bf16 shape the tc design does not take goes to l2 with the reason
    (the first refusal in the rule's order); nothing raises."""
    plan = transenc.k3_plan(seq_len, d, ff, nhead, torch.bfloat16)
    assert plan["design"] == "l2" and why in plan["why"], plan


def test_tc_constants_follow_the_kernel_source():
    """The wrapper's copy of the design (rows, ring tile k rows, the block,
    threads, L's limit, the ring's default depth) is the source's, and
    tc_smem is the source's transenc_tc_smem."""
    src = _tc_source()
    defines = dict(re.findall(r"^#define (TE_\w+) (\d+)", src, re.M))
    want = {"TE_ROWS": transenc.TC_ROWS, "TE_BK": transenc.TC_BK, "TE_BOX": TC_BOX,
            "TE_CONSUMERS": 256, "TE_THREADS": transenc.TC_THREADS,
            "TE_LMAX": transenc.LMAX, "TE_STAGES": transenc.TC_STAGES}
    assert {k: int(defines[k]) for k in want} == want
    assert "#ifndef TE_STAGES\n#define TE_STAGES" in src
    flat = " ".join(src.split())
    for line in ("return (size_t)TE_STAGES * TE_BK * D + (size_t)TE_ROWS * (D + qw) * 2 + "
                 "4 * TE_ROWS * 4 + 16 * TE_STAGES;",
                 "const int qw = 3 * D > FF ? 3 * D : FF;",
                 "(D != 128 && D != 256) || FF < D || FF % D != 0 || NH < 1 || D != 64 * NH",
                 "const float scale = 0.125f;",
                 "S * L > TE_ROWS", "L > TE_LMAX"):
        assert line in flat, line
    assert transenc.tc_smem(256, 512) == 4 * 64 * 256 + 64 * (256 + 768) * 2 + 1024 + 64


def test_probe_marks_each_apply_once_to_the_kernel_source():
    """chip_smoke.py's k3_tc_probe builds a copy of the source with clock64
    marks put in by text replacement: each mark's anchor is in the shipped
    source exactly once, and the kernel's parts are all marked."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_marks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = _tc_source()
    for old, _new in smoke.K3_TC_PROBE_MARKS:
        assert src.count(old) == 1, old
    marked = "".join(new for _old, new in smoke.K3_TC_PROBE_MARKS)
    assert all("PROF({})".format(k) in marked for k in range(len(smoke.K3_TC_PROBE_PARTS)))


def test_simt_probe_marks_each_apply_once_to_the_kernel_source():
    """chip_smoke.py's k3_simt_probe builds a copy of the simt source with
    clock64 marks put in by text replacement: each mark's anchor is in the
    shipped source exactly once, and every part is marked."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_simt_marks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = _simt_source()
    for old, _new in smoke.K3_SIMT_PROBE_MARKS:
        assert src.count(old) == 1, old
    marked = "".join(new for _old, new in smoke.K3_SIMT_PROBE_MARKS)
    assert all("PROF({})".format(k) in marked
               for k in range(len(smoke.K3_SIMT_PROBE_PARTS)))


def test_simt_sweep_variants_apply_to_the_kernel_source():
    """chip_smoke.py's k3_simt_sweep builds variants of the simt source by
    text replacement: each replacement's anchor is in the shipped source as
    many times as the variant says, the shipped variant changes nothing,
    and the one variant left unchecked is the one without the ring's
    copies and waits."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_simt_sweep", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    src = _simt_source()
    assert smoke.K3_SIMT_SWEEP["shipped"] == []
    for name, reps in smoke.K3_SIMT_SWEEP.items():
        for old, _new, count in reps:
            assert src.count(old) == count, (name, old)
    flat = " ".join(open(path).read().split())
    assert 'checked = name != "no_copies_no_waits"' in flat


def swizzle128(addr):
    """The 128-byte swizzle (TMA's writes, wgmma's reads) of a byte address
    from a 1024-byte-aligned base: bits [7, 10) XOR into bits [4, 7)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def sw_off(r, c):
    """transenc_tc.cu's sw_off: the byte offset of (row r, column c) in a
    64-row operand image of 64-column blocks of 128-byte rows, the 16-byte
    chunks of a row XOR-swizzled by the row."""
    return (c >> 6) * TC_BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2


def operand_image(a):
    """The consumers' stores of a (64, W) operand (x, the context, q|k|v,
    the hidden layer) into its image, as flat bf16 slots."""
    R, W = a.shape
    r, c = torch.arange(R).view(-1, 1), torch.arange(W).view(1, -1)
    img = torch.zeros(R * W)
    img[sw_off(r, c) // 2] = a
    return img


def image_read(img, rows, cols):
    """An image read back at the addresses sw_off gives, the epilogues' and
    attention's stores."""
    r, c = torch.as_tensor(rows).view(-1, 1), torch.as_tensor(cols).view(1, -1)
    return img[sw_off(r, c) // 2]


def kmajor_read(img, start, rows, k):
    """(rows, k) elements of a K-major A of 128-byte rows as its descriptor
    addresses them (8-row atoms of 1,024 bytes): (r, k) at start + (r // 8)
    1024 + (r % 8) 128 + 2 k, under the swizzle of the address."""
    r, kk = torch.arange(rows).view(-1, 1), torch.arange(k).view(1, -1)
    return img[swizzle128(start + (r // 8) * 1024 + (r % 8) * 128 + 2 * kk) // 2]


def tma_tile(w2d, krow, n0, dw):
    """The ring slot's image of the weight tile at k rows [krow, krow + 64)
    and columns [n0, n0 + dw) of a stacked weight (rows, cols), as the TMA
    loads write it: box h (64 columns by 64 k rows of 128 bytes) at h
    TC_BOX, every address under the swizzle."""
    img = torch.zeros(64 * dw)
    j, i = torch.arange(64).view(-1, 1), torch.arange(64).view(1, -1)
    for h in range(dw // 64):
        addr = h * TC_BOX + j * 128 + 2 * i
        img[swizzle128(addr) // 2] = w2d[krow + j, n0 + 64 * h + i]
    return img


def mnmajor_read(img, start, n, k):
    """(n, k) elements of an MN-major B as its descriptor addresses them
    (trans-b): (n, k) at start + (n // 64) LBO + (k // 8) SBO + (k % 8) 128 +
    2 (n % 64), LBO = one box (TC_BOX), SBO = 8 k rows (1,024); each k16
    step 2,048 bytes further."""
    nn, kk = torch.arange(n).view(-1, 1), torch.arange(k).view(1, -1)
    addr = start + (nn // 64) * TC_BOX + (kk // 8) * 1024 + (kk % 8) * 128 + 2 * (nn % 64)
    return img[swizzle128(addr) // 2]


def tile_a(img, kt):
    """k tile kt (64 columns) of a K-major image, as its 4 k16 steps read it."""
    return torch.cat([kmajor_read(img, kt * TC_BOX + 32 * kk, 64, 16) for kk in range(4)], 1)


def tile_b(img, dw):
    """The ring tile (dw, 64) as its 4 k16 steps read it, B^T."""
    return torch.cat([mnmajor_read(img, 2048 * kk, dw, 16) for kk in range(4)], 1)


@pytest.mark.parametrize("width", [128, 256, 768])
def test_operand_images_are_what_wgmma_and_attention_read(width):
    """Every element of a (64, width) operand lands in its own slot, and
    the K-major descriptor's k tiles and sw_off's reads give it back."""
    a = torch.arange(64 * width, dtype=torch.float32).view(64, width)
    img = operand_image(a)
    assert torch.equal(img.sort().values, a.flatten())
    for kt in range(width // 64):
        assert torch.equal(tile_a(img, kt), a[:, 64 * kt:64 * kt + 64])
    assert torch.equal(image_read(img, range(64), range(width)), a)


@pytest.mark.parametrize("krow,col", [(0, 0), (64, 1), (448, -1), (192, 2)])
@pytest.mark.parametrize("dw", [64, 128])
def test_weight_tiles_are_what_wgmma_reads(dw, krow, col):
    """A tile of the stacked weight at (k row, column) as the TMA loads
    write it, read by the MN-major descriptor, is W[krow: krow + 64, n0: n0
    + dw]: the first tile, the next k tile and chunk, the last chunk of the
    last k rows, a middle one."""
    w = torch.arange(512 * 768, dtype=torch.float32).view(512, 768)
    n0 = col * dw if col >= 0 else 768 - dw
    img = tma_tile(w, krow, n0, dw)
    assert torch.equal(img.sort().values, w[krow:krow + 64, n0:n0 + dw].flatten().sort().values)
    assert torch.equal(tile_b(img, dw), w[krow:krow + 64, n0:n0 + dw].T)


def stmatrix_bytes(warp, col, ng):
    """store_pairs<ng> of warp ``warp`` (transenc_tc.cu) as stmatrix.x4
    writes: lane i gives the address of row i % 8 of matrix i // 8 (rows 16
    warp + i % 8 + 8 ((i // 8) % 2), columns col + 8 (jj + i // 16)); lane
    L's register m, the pair pk[2 jj + m], lands at row L // 4 of matrix m,
    4 (L % 4) bytes in. Returns {(lane, pair index): byte offset}."""
    out = {}
    for jj in range(0, ng, 2):
        rowaddr = {}
        for i in range(32):
            q = i >> 3
            rowaddr[(q, i & 7)] = sw_off(16 * warp + (i & 7) + 8 * (q & 1), col + 8 * (jj + (q >> 1)))
        for lane in range(32):
            for m in range(4):
                out[(lane, 2 * jj + m)] = rowaddr[(m, lane >> 2)] + 4 * (lane & 3)
    return out


@pytest.mark.parametrize("ng,col", [(8, 64), (16, 128), (8, 0)])
def test_stmatrix_stores_put_each_pair_where_sw_off_does(ng, col):
    """Each packed pair pk[2 jj + hh] of lane L (the fragment's row 16 warp
    + L // 4 + 8 hh, columns col + 8 jj + 2 (L % 4), + 1) lands where a
    4-byte store at sw_off would put it, for every warp of a warpgroup."""
    for warp in range(4):
        got = stmatrix_bytes(warp, col, ng)
        for lane in range(32):
            for jj in range(ng):
                for hh in (0, 1):
                    want = sw_off(16 * warp + (lane >> 2) + 8 * hh, col + 8 * jj + 2 * (lane & 3))
                    assert got[(lane, 2 * jj + hh)] == want, (warp, lane, jj, hh)


def reg_layout(dw):
    """The residual's registers: (rows, cols), each (2, 128, dw // 2), of
    warpgroup wg, thread t, register i: the wgmma accumulator's row 16 (t //
    32) + (t % 32) // 4 + 8 ((i // 2) % 2) and column wg dw + 8 (i // 4) + 2
    (t % 4) + i % 2."""
    wg = torch.arange(2).view(2, 1, 1)
    t = torch.arange(128).view(1, 128, 1)
    i = torch.arange(dw // 2).view(1, 1, -1)
    rows = 16 * (t // 32) + (t % 32) // 4 + 8 * ((i // 2) % 2) + 0 * wg
    cols = wg * dw + 8 * (i // 4) + 2 * (t % 4) + i % 2
    return rows, cols


@pytest.mark.parametrize("dw", [64, 128])
def test_residual_registers_cover_the_tile_once(dw):
    """The two warpgroups' registers hold every (row, column) of the 64 x D
    residual exactly once, warpgroup w the columns [w dw, w dw + dw): the
    out and FF2 products' own output columns."""
    rows, cols = reg_layout(dw)
    flat = (rows * 2 * dw + cols).flatten()
    assert torch.equal(flat.sort().values, torch.arange(64 * 2 * dw))
    for w in (0, 1):
        assert int(cols[w].min()) == w * dw and int(cols[w].max()) == w * dw + dw - 1


def ln_fixed_order(regs, rows, cols, gm, bt, D):
    """transenc_tc.cu's layer_norm on the registers (2, 128, NR) f32: each
    thread's sum of its two rows' values (register pairs in column order),
    the quad's by xor shuffles 1 then 2, warpgroup 0's plus 1's; the same
    for the centred squares (the kernel fuses each multiply-add); returns
    the normalised registers and the per-thread row sums of the first pass
    (2, 128, 2), which every lane of a quad holds bit for bit."""
    nr = regs.shape[2]

    def thread_sums(vals, pairs):
        s = torch.zeros(2, 128, 2)
        for jj in range(nr // 4):
            for hh in (0, 1):
                a, b = vals[..., 4 * jj + 2 * hh], vals[..., 4 * jj + 2 * hh + 1]
                s[..., hh] = s[..., hh] + (a + b) if pairs else s[..., hh] + a + b
        return s

    def quad_then_warpgroups(s):
        lane = torch.arange(128)
        s = s + s[:, lane ^ 1]
        s = s + s[:, lane ^ 2]
        r = rows[:, :, 0:4:2]  # each thread's rows r0, r0 + 8 (registers 0 and 2)
        red = torch.zeros(2, 64)
        for w in (0, 1):
            red[w, r[w, :, 0]] = s[w, :, 0]
            red[w, r[w, :, 1]] = s[w, :, 1]
        return s, (red[0] + red[1])[r]

    s0, tot = quad_then_warpgroups(thread_sums(regs, True))
    mu = tot / D
    hh = (torch.arange(nr) // 2) % 2
    d = regs - mu[..., hh]
    _, var = quad_then_warpgroups(thread_sums(d * d, False))
    rs = 1.0 / torch.sqrt(var / D + 1e-5)
    return (regs - mu[..., hh]) * rs[..., hh] * gm[cols] + bt[cols], s0


@pytest.mark.parametrize("dw", [64, 128])
def test_layer_norm_sums_rows_in_a_fixed_order(dw):
    """LayerNorm on the registers: every lane of a quad holds the same bits
    of its rows' sums, and the result is F.layer_norm's within 2e-6 (f32
    sums in another order); rows stay their own (a zero row gives beta)."""
    D = 2 * dw
    rng = np.random.RandomState(dw)
    x = torch.from_numpy(rng.randn(64, D).astype(np.float32) * 3 + 1)
    x[63] = 0.0
    gm = torch.from_numpy(rng.randn(D).astype(np.float32))
    bt = torch.from_numpy(rng.randn(D).astype(np.float32))
    rows, cols = reg_layout(dw)
    y, s0 = ln_fixed_order(x[rows, cols], rows, cols, gm, bt, D)
    quad = s0.view(2, 32, 4, 2)
    assert torch.equal(quad, quad[:, :, :1].expand_as(quad))
    got = torch.zeros(64, D)
    got[rows, cols] = y
    want = F.layer_norm(x, (D,), gm, bt, 1e-5)
    assert (got - want).abs().max().item() <= 2e-6 * max(1.0, want.abs().max().item())
    assert torch.equal(got[63], bt)


def tile_walk(NL, D, FF):
    """The producer's walk over the weight tiles (transenc_tc.cu): per layer
    the products q|k|v, out, FF1, FF2 (q 0..3), each warpgroup's chunks j,
    the k tiles k0, the warpgroups w innermost: (layer, q, w, j, k0, the
    tile's first column (2 j + w) D / 2, its row in the stacked weight)."""
    walk = []
    for l in range(NL):
        for q in range(4):
            K = FF if q == 3 else D
            nch = 3 if q == 0 else FF // D if q == 2 else 1
            for j in range(nch):
                for k0 in range(0, K, 64):
                    for w in (0, 1):
                        walk.append((l, q, w, j, k0, (2 * j + w) * (D // 2), l * K + k0))
    return walk


def consumer_order(NL, D, FF, w):
    """Warpgroup w's tiles in the order its products take them: per layer
    product(x, D / 64, 3), product(x, D / 64, 1), product(x, D / 64, FF /
    D), product(hidden, FF / 64, 1), each chunk's k tiles in turn."""
    order = []
    for l in range(NL):
        for q, (ktiles, nch) in enumerate(((D // 64, 3), (D // 64, 1), (D // 64, FF // D),
                                           (FF // 64, 1))):
            order += [(l, q, w, j, 64 * kt) for j in range(nch) for kt in range(ktiles)]
    return order


@pytest.mark.parametrize("D,FF", [(256, 512), (128, 256), (256, 1024), (128, 128)])
def test_tile_walk_is_each_warpgroups_product_order(D, FF):
    """Warpgroup w takes every second tile of the walk, starting at w, in
    its products' order; each product's tiles cover its weight once, the
    D-wide products' tiles at warpgroup w's residual columns."""
    NL = 2
    walk = tile_walk(NL, D, FF)
    assert len(walk) == NL * (3 * D * D + D * D + 2 * D * FF) // (64 * D // 2)
    for w in (0, 1):
        assert [t[:5] for t in walk[w::2]] == consumer_order(NL, D, FF, w)
    widths = {0: 3 * D, 1: D, 2: FF, 3: D}
    for l in range(NL):
        for q, width in widths.items():
            K = FF if q == 3 else D
            cover = torch.zeros(K, width, dtype=torch.int64)
            for (_l, _q, w, _j, k0, n0, krow) in (t for t in walk if t[:2] == (l, q)):
                assert krow == l * K + k0
                cover[k0:k0 + 64, n0:n0 + D // 2] += 1
                if q in (1, 3):
                    assert n0 == w * D // 2
            assert bool((cover == 1).all()), (l, q)


@pytest.mark.parametrize("stages", [2, 3, 4, 5, 6])
def test_ring_protocol_runs_to_the_end(stages):
    """A simulation of the ring on mbarriers, steps taken in random order:
    the producer issues tile g into slot g % stages once the consumers
    released tile g - stages (`empty`); tile g lands once issued (`full`); a
    warpgroup takes its next tile when it has landed and, at a product after
    one that ends in a barrier, when the other warpgroup is done with that
    product. It never deadlocks, and each tile is issued and taken once."""
    NL, D, FF = 2, 128, 256
    walk = tile_walk(NL, D, FF)
    n = len(walk)
    rng = np.random.RandomState(stages)
    issued = 0        # tiles the producer issued
    taken = [0, 0]    # tiles each warpgroup took (own count)
    released = set()  # tiles the consumers released

    def product_of(k):
        return walk[k][:2]

    while any(taken[w] < n // 2 for w in (0, 1)):
        moves = []
        if issued < n and (issued - stages < 0 or issued - stages in released):
            moves.append(("issue", 0))
        for w in (0, 1):
            i = taken[w]
            if i >= n // 2 or issued <= 2 * i + w:
                continue  # done, or not landed
            # products after q|k|v (attention), LN1, FF1 and LN2 start
            # behind a barrier of both warpgroups
            g = 2 * i + w
            ok = True
            if i > 0 and product_of(2 * (i - 1) + w) != product_of(g):
                other = taken[1 - w]
                ok = other >= n // 2 or product_of(2 * other + (1 - w)) >= product_of(g)
            if ok:
                moves.append(("take", w))
        assert moves, (issued, taken)
        kind, w = moves[rng.randint(len(moves))]
        if kind == "issue":
            issued += 1
        else:
            released.add(2 * taken[w] + w)
            taken[w] += 1
    assert issued == n and released == set(range(n))


def attention_wgmma(qimg, ximg, D, nhead, L, S, op):
    """transenc_tc.cu's attention (heads of width 64): per head h, the
    scores of all 64 rows by all 64 key rows from the q and k blocks (both
    K-major descriptors), masked to each row's own sample (rows past S L:
    every key), the bf16 probabilities written into x's block h and read
    back as the next product's K-major A, V the v block through the
    MN-major descriptor; the context over the probabilities."""
    r = torch.arange(64).view(-1, 1)
    c = torch.arange(64).view(1, -1)
    own = (r // L < S) & (c // L == r // L)
    for h in range(nhead):
        q = tile_a(qimg, h)
        k = tile_a(qimg, D // 64 + h)
        sc = torch.where(own, (q @ k.T) * (1.0 / 8.0), torch.tensor(-float("inf")))
        p = torch.where(own.any(1, keepdim=True), torch.softmax(sc, dim=-1), torch.zeros(()))
        ximg[sw_off(r, 64 * h + c) // 2] = op(p)
        v = torch.cat([mnmajor_read(qimg, (2 * D // 64 + h) * TC_BOX + 2048 * kk, 64, 16)
                       for kk in range(4)], 1)
        ximg[sw_off(r, 64 * h + c) // 2] = op(tile_a(ximg, h) @ v.T)


def tc_model(st, x, nhead, cd):
    """transenc_tc.cu's order of work in plain PyTorch: CTAs of 64 rows (S =
    64 // L samples, the last tile ragged), the products from
    the operand images and the ring tiles of the producer's walk as the
    descriptors read them, warpgroup w's chunks 2 j + w, the residual in
    the registers' layout, LayerNorm in its fixed order, attention from the
    q|k|v image on the tensor cores (``attention_wgmma``), the mean over
    each real sample's rows with t ascending. cd: the operand type (float32
    keeps every value unrounded)."""
    N, L, D = x.shape
    NL, FF = st["w1"].shape[0], st["w1"].shape[2]
    dw = D // 2
    assert D == 64 * nhead
    S = 64 // L
    ctas = -(-N // S)

    def op(t):
        return t.to(cd).float()

    w2d = {0: st["wqkv"].float().reshape(NL * D, 3 * D), 1: st["wo"].float().reshape(NL * D, D),
           2: st["w1"].float().reshape(NL * D, FF), 3: st["w2"].float().reshape(NL * FF, D)}
    walk = tile_walk(NL, D, FF)
    ring = [tile_b(tma_tile(w2d[t[1]], t[6], t[5], dw), dw) for t in walk]
    rows, cols = reg_layout(dw)
    xr = x.float().reshape(N * L, D)
    out = torch.zeros(N, D)
    for cta in range(ctas):
        n0 = cta * S
        nrows = min(S * L, (N - n0) * L)
        xa = torch.zeros(64, D)
        xa[:nrows] = xr[n0 * L:n0 * L + nrows]
        ximg = operand_image(xa)
        regs = xa[rows, cols]
        g = [0, 1]

        def product(img, q, ktiles, nch, epi):
            for w in (0, 1):
                for j in range(nch):
                    acc = torch.zeros(64, dw)
                    for kt in range(ktiles):
                        assert walk[g[w]][1:5] == (q, w, j, 64 * kt)
                        acc += tile_a(img, kt) @ ring[g[w]].T
                        g[w] += 2
                    epi(w, j, acc)

        def store(img, bias, relu):
            def epi(w, j, acc):
                c = torch.arange((2 * j + w) * dw, (2 * j + w + 1) * dw)
                v = acc + bias[c]
                v = torch.relu(v) if relu else v
                img[sw_off(torch.arange(64).view(-1, 1), c.view(1, -1)) // 2] = op(v)
            return epi

        def add_residual(bias):
            def epi(w, _j, acc):
                regs[w] += (acc + bias[w * dw:(w + 1) * dw])[rows[w], cols[w] - w * dw]
            return epi

        def layer_norm(gm, bt):
            nonlocal regs
            regs, _ = ln_fixed_order(regs, rows, cols, gm, bt, D)
            y = torch.zeros(64, D)
            y[rows, cols] = regs
            ximg[:] = operand_image(op(y))

        for li in range(NL):
            qimg = torch.zeros(64 * max(3 * D, FF))
            product(ximg, 0, D // 64, 3, store(qimg, st["bqkv"][li], False))
            attention_wgmma(qimg, ximg, D, nhead, L, S, op)
            product(ximg, 1, D // 64, 1, add_residual(st["bo"][li]))
            layer_norm(st["ln1s"][li], st["ln1b"][li])
            hid = torch.zeros(64 * max(3 * D, FF))
            product(ximg, 2, D // 64, FF // D, store(hid, st["b1"][li], True))
            product(hid, 3, FF // 64, 1, add_residual(st["b2"][li]))
            layer_norm(st["ln2s"][li], st["ln2b"][li])
        assert g == [len(walk), len(walk) + 1]
        res = torch.zeros(64, D)
        res[rows, cols] = regs
        for s in range(S):
            if n0 + s < N:
                acc = torch.zeros(D)
                for t in range(L):
                    acc = acc + res[s * L + t]
                out[n0 + s] = acc / L
    return out


TC_SMALL = dict(num_layers=2, d_model=128, nhead=2, dim_ff=256, dropout_rate=0.0)


def _tc_case(n, seed, dtype=torch.float32):
    cfg = TransEncConfig(**TC_SMALL)
    params = randomize_affine(init_transenc(seed, cfg), seed)
    x = np.random.RandomState(seed + n).randn(n, 21, 128).astype(np.float32) * 0.4
    return params, transenc.stack_layers(params["layers"], dtype), x


@pytest.mark.parametrize("reference", ["plain", "pallas", "xla"])
@pytest.mark.parametrize("n", [1, 6, 7])
def test_tc_model_matches_the_references(n, reference):
    """The tc design's order of work in f32 (no rounding: the arithmetic of
    the images, the walk and the register layout alone) at D = 128, FF =
    256, 2 heads: one sample (a tile of 3 with 2 padded), 6 samples (two
    full tiles) and 7 (tiles of 3, 3 and 1). Tolerance as
    test_simt_order_matches_the_references."""
    params, st, x = _tc_case(n, 11)
    assert transenc.k3_plan(21, 128, 256, 2)["design"] == "tc"
    got = tc_model(st, torch.from_numpy(x), 2, torch.float32)
    assert got.shape == (n, 128) and bool(torch.isfinite(got).all())
    if reference == "plain":
        want = transenc.encoder_pooled_plain(st, torch.from_numpy(x), torch.float32, 2).numpy()
    else:
        cfg = JaxTransEncConfig(**TC_SMALL)
        if reference == "pallas":
            want = encoder_pooled_pallas(params, cfg, jnp.asarray(x), interpret=True)
        else:
            want = jnp.mean(_encoder(params, cfg, jnp.asarray(x), None, False), axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("reference", ["plain", "xla"])
@pytest.mark.parametrize("n", [2, 7])
def test_tc_model_at_the_model_width_matches_the_references(n, reference):
    """D = 256, 4 heads of 64, FF 512 (transencoder2s's widths, 1 layer):
    two 64-column boxes a ring tile, two heads a warpgroup. Tolerance as
    above."""
    kw = dict(num_layers=1, d_model=256, nhead=4, dim_ff=512, dropout_rate=0.0)
    cfg = TransEncConfig(**kw)
    params = randomize_affine(init_transenc(17, cfg), 17)
    st = transenc.stack_layers(params["layers"])
    x = np.random.RandomState(n).randn(n, 21, 256).astype(np.float32) * 0.4
    got = tc_model(st, torch.from_numpy(x), 4, torch.float32)
    if reference == "plain":
        want = transenc.encoder_pooled_plain(st, torch.from_numpy(x), torch.float32, 4).numpy()
    else:
        want = jnp.mean(_encoder(params, JaxTransEncConfig(**kw), jnp.asarray(x), None, False),
                        axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("n", [4, 9])
def test_tc_model_in_bf16_matches_the_plain_version(n):
    """The model with the kernel's rounding points (bf16 x, weights, q|k|v,
    probabilities, context, hidden layer) against encoder_pooled_plain in
    bf16 within K3's bf16 tolerance, 2e-2: an f32 sum in another order can
    round a product operand to the neighbouring bf16 value."""
    _params, st, x = _tc_case(n, 13, torch.bfloat16)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tc_model(st, xb, 2, torch.bfloat16)
    want = transenc.encoder_pooled_plain(st, xb, torch.bfloat16, 2)
    assert (got - want).abs().max().item() <= 2e-2


def test_tc_model_follows_the_kernel_source():
    """The model above is the kernel's: the image and swizzle arithmetic,
    the descriptors (K-major A 32 bytes a k16 step, MN-major B with LBO one
    box and SBO 8 k rows, trans-b), the producer's walk and its boxes (64
    columns by TE_BK k rows), the warpgroups' chunk
    columns, the residual epilogues, the products' calls in a layer,
    LayerNorm's order and the mean."""
    flat = " ".join(_tc_source().split())
    for line in (
            "return (uint32_t)((c >> 6) * TE_BOX + r * 128 + ((((c >> 3) & 7) ^ (r & 7)) << 4) "
            "+ (c & 7) * 2);",
            "Wgmma<DW>::template mma<1>(acc, kmajor_desc(ak + 32 * kk, 128), "
            "mnmajor_desc(b + 2048 * kk, TE_BOX, 1024), (kt | kk) != 0);",
            "const uint32_t ak = a + kt * TE_BOX, b = base + s * SLOT;",
            "const int K = q == 3 ? FF : D;",
            "const int nch = q == 0 ? 3 : q == 2 ? FF / D : 1;",
            "for (int j = 0; j < nch; ++j) for (int k0 = 0; k0 < K; k0 += TE_BK) "
            "for (int w = 0; w < 2; ++w, ++g) {",
            "tma_load_2d(base + s * SLOT + h * TE_BOX, map, full + 8 * s, (2 * j + w) * DW + 64 * h, "
            "l * K + k0);",
            "const cuuint32_t box[2] = {64, TE_BK};",
            "int g = wg;", "for (int kt = 0; kt < ktiles; ++kt, g += 2) {",
            "const int c0 = wg * DW + 2 * t4;",
            "const int r0 = 16 * warp + (lane >> 2);",
            "res[4 * jj + 2 * hh] += acc[4 * jj + 2 * hh] + b.x;",
            "product(base + XB, D / TE_BK, 3, bqkv, [&](int j, float (&acc)[NR], "
            "float2 (&bv)[DW / 8]) { store_chunk(QB, false, j, acc, bv); });",
            "product(base + XB, D / TE_BK, 1, bo, [&](int, float (&acc)[NR], float2 (&bv)[DW / 8]) "
            "{ add_residual(acc, bv); });",
            "product(base + XB, D / TE_BK, FF / D, b1, [&](int j, float (&acc)[NR], "
            "float2 (&bv)[DW / 8]) { store_chunk(QB, true, j, acc, bv); });",
            "product(base + QB, FF / TE_BK, 1, b2, [&](int, float (&acc)[NR], float2 (&bv)[DW / 8]) "
            "{ add_residual(acc, bv); });",
            "bv[jj] = ld_nc_f2(bias + (2 * j + wg) * DW + 2 * t4 + 8 * jj);",
            "mu[hh] += res[4 * jj + 2 * hh] + res[4 * jj + 2 * hh + 1];",
            "v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 1); "
            "v[hh] += __shfl_xor_sync(0xffffffffu, v[hh], 2);",
            "v[hh] = red[2 * pass * TE_ROWS + r0 + 8 * hh] + red[(2 * pass + 1) * TE_ROWS + r0 + 8 * hh];",
            "var[hh] = fmaf(d, d, var[hh]);",
            "rs[hh] = 1.0f / sqrtf(var[hh] / (float)D + 1e-5f);",
            "sc[i] = c >= lo[hh] && c < hi[hh] ? sc[i] * scale : -INFINITY;",
            "inv[hh] = sum[hh] > 0.0f ? 1.0f / sum[hh] : 0.0f;",
            "Wgmma<64>::mma<0>(sc, kmajor_desc(qa + 32 * kk, 128), kmajor_desc(ka + 32 * kk, 128), "
            "kk != 0);",
            "Wgmma<64>::mma<1>(cx, kmajor_desc(pa + 32 * kk, 128), mnmajor_desc(va + 2048 * kk, "
            "TE_BOX, 1024), kk != 0);",
            "for (int t = 0; t < L; ++t) sum += xf[(s * L + t) * (D + 8) + c];",
            "mbar_init(empty + 8 * s, 1);", "if ((tid & 127) == 0) mbar_arrive(empty + 8 * s);",
            "const int row = 16 * ((threadIdx.x >> 5) & 3) + (lane & 7) + 8 * (q & 1);",
            "img + sw_off(row, col + 8 * (jj + (q >> 1)))), \"r\"(pk[2 * jj]), \"r\"(pk[2 * jj + 1]), "
            "\"r\"(pk[2 * jj + 2]), \"r\"(pk[2 * jj + 3])",
            "store_pairs<DW / 8>(base + dst, (2 * j + wg) * DW, pk);",
            "store_pairs<DW / 8>(base + XB, wg * DW, pk);", "store_pairs<8>(base + xb, 64 * h, pk);"):
        assert line in flat, line
