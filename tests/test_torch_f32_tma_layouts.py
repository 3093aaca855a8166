"""Numpy models of the exact-f32 products' kernel on the CPU (no card):
csrc/rnn_train_gemm.cuh's f32_tma_kernel, which runs the fp32 input
projection of K1, K2 and the simt forwards and the simt backward's dx and
weight gradients. Held to the source: its constants, the host's tensor maps
and coordinates, the TMA boxes with their swizzle and zero fill as each
thread reads them back (and the plain loads that stand in for TMA where X's
rows are no 16-byte multiple), the banks a quarter warp reads, the grid's
tiles and each CTA's walk over its k tiles, the mbarrier ring with its
last-warp refill under random interleavings, and the fmaf chains, bit for
bit gemm_simt_kernel's at every slot depth the sweep builds."""

import os
import re

import numpy as np
import pytest
import torch

from ccsmeth_tpu_torch.ops import bigru_vjp

torch.set_num_threads(1)  # one intra-op thread: the suite runs several workers at once

SRC_PATH = os.path.join(os.path.dirname(bigru_vjp.__file__), "csrc", "rnn_train_gemm.cuh")


def _src():
    with open(SRC_PATH) as f:
        return " ".join(f.read().split())


def _define(name):
    return int(re.search(r"#define {} (\d+)".format(name), _src()).group(1))


KT, STAGES, THREADS, BM128 = (_define(n) for n in ("FT_KT", "FT_STAGES", "FT_THREADS", "FT_BM"))


def ft_swz(r, kt=KT):
    """The kernel's ft_swz: the 16-byte chunk that chunk c of K-major row r
    lands in is c ^ ft_swz(r)."""
    return (r >> 1) & 3 if kt == 16 else r & 7


def tma_swizzle(offset, kt):
    """TMA's swizzle of a byte offset inside a 1024-byte aligned box:
    CU_TENSOR_MAP_SWIZZLE_64B xors address bits 4-5 with bits 7-8, _128B
    bits 4-6 with bits 7-9 (CUTLASS's Swizzle<2, 4, 3> and <3, 4, 3>)."""
    if kt == 16:
        return offset ^ (((offset >> 7) & 3) << 4)
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_box(t, box, coords, kmajor, kt=KT):
    """The image one TMA load writes: tensor t (d2, d1, d0) as a contiguous
    3-d map, a box of (b0 inner, b1) elements at (c0, c1, c2), elements
    outside the tensor (negative coordinates too) zero, laid densely row
    after row and, for a K-major box, swizzled. A float32 array of the
    box's elements in shared-memory order."""
    b0, b1 = box
    c0, c1, c2 = coords
    r, e = np.meshgrid(np.arange(b1), np.arange(b0), indexing="ij")
    i1, i0 = c1 + r, c0 + e
    inside = (0 <= c2 < t.shape[0]) & (i1 >= 0) & (i1 < t.shape[1]) & (i0 >= 0) & (i0 < t.shape[2])
    vals = np.where(inside, t[min(max(c2, 0), t.shape[0] - 1), np.clip(i1, 0, t.shape[1] - 1),
                              np.clip(i0, 0, t.shape[2] - 1)], np.float32(0.0))
    off = 4 * (r * b0 + e)
    if kmajor:
        off = tma_swizzle(off, kt)
    img = np.zeros(b0 * b1, np.float32)
    img[off.ravel() // 4] = vals.ravel()
    return img


def plain_a(x, ld, i0, M, k0, ke, bm, kmajor, kt=KT):
    """ft_plain_a: X's elements (i, k) (x[i ld + k] K-major, x[k ld + i]
    MN-major) by plain loads into the image TMA would write, zeros for i >=
    M or k >= ke."""
    img = np.full(bm * kt, np.nan, np.float32)
    for e in range(bm * kt):
        ii, kk = (e // kt, e % kt) if kmajor else (e % bm, e // bm)
        i, k = i0 + ii, k0 + kk
        v = (x[i * ld + k] if kmajor else x[k * ld + i]) if i < M and k < ke else 0.0
        if kmajor:
            img[ii * kt + (((kk >> 2) ^ ft_swz(ii, kt)) << 2) + (kk & 3)] = v
        else:
            img[kk * bm + ii] = v
    return img


def thread_reads(a_img, b_img, ak, bk, rm, tn, kt=KT):
    """Every thread's operands of one k tile as ft_tile addresses them:
    (A (128, rm, kt): thread t's rows i at k, B (128, kt, tn)); K-major rows
    ty + 16 i (A) and columns tx + 8 j (B) at ar + 16 KT i + ((c ^ ft_swz(ty))
    << 2) + e, MN-major k BN + 32 q + 4 tx + e and k 128 + 64 h + 4 ty + e."""
    ia, ib = _read_index(ak, bk, rm, tn, kt)
    return a_img[ia], b_img[ib]


_READS = {}


def _read_index(ak, bk, rm, tn, kt):
    """thread_reads' element indices: ((128, rm, kt) into A's image, (128,
    kt, tn) into B's)."""
    key = (ak, bk, rm, tn, kt)
    if key not in _READS:
        t, i, k = np.meshgrid(np.arange(THREADS), np.arange(rm), np.arange(kt), indexing="ij")
        tx, ty, c, e = t % 8, t // 8, k // 4, k % 4
        ia = (ty * kt + 16 * kt * i + ((c ^ ft_swz(ty, kt)) << 2) + e if ak else
              k * BM128 + 64 * (i // 4) + ty * 4 + i % 4)
        t, k, j = np.meshgrid(np.arange(THREADS), np.arange(kt), np.arange(tn), indexing="ij")
        tx, c, e = t % 8, k // 4, k % 4
        ib = ((tx + 8 * j) * kt + ((c ^ ft_swz(tx, kt)) << 2) + e if bk else
              k * 8 * tn + (j // 4) * 32 + tx * 4 + j % 4)
        _READS[key] = (ia, ib)
    return _READS[key]


def thread_rows_cols(ak, bk, rm, tn):
    """ft_row and the columns of each thread: (rows (128, rm), cols (128, tn))."""
    t = np.arange(THREADS)
    tx, ty = t % 8, t // 8
    i, j = np.arange(rm), np.arange(tn)
    rows = (ty[:, None] + 16 * i if ak else
            np.where(i < 4, 4 * ty[:, None] + i, 64 + 4 * ty[:, None] + i - 4))
    cols = tx[:, None] + 8 * j if bk else 32 * (j // 4) + 4 * tx[:, None] + j % 4
    return rows, cols


def launches(kind, M, C, G, H=None, L=None, N=None, S=1, rm=8):
    """The host's launch of one product, as proj_f32_run, dx_f32_run and
    wgrad_f32_run set it up: (rm, tn, ak, bk, jobs, K, nseg, Ks, grid); a
    job is (M, N, A op, B op, a_plain) with an op (map, ioff, koff, z0, z1)."""
    if kind == "projection":
        jobs = [(M, G, (0, 0, 0, 0, 0), (0, 0, 0, d, d)) for d in (0, 1)]
        return rm, 16, True, False, jobs, C, 1, C, (-(-G // 128), -(-M // (16 * rm)), 2)
    if kind == "dx":
        bn = next(b for b in (16, 32, 64, 128) if C <= b or b == 128)
        jobs = [(M, C, (0, 0, 0, 0, 1), (0, 0, 0, 0, 1))]
        return rm, bn // 8, True, True, jobs, G, 2, G, (-(-C // bn), -(-M // (16 * rm)), 1)
    LN = L * N
    jobs = [(C, G, (0, 0, 0, 0, 0), (0, 0, 0, d, d)) for d in (0, 1)]
    jobs += [(H, G, (1, d * H, -N if d == 0 else N, 0, 0), (1, 0, 0, d, d)) for d in (0, 1)]
    Ks = -(-(-(-LN // S)) // 32) * 32
    return 8, 16, False, False, jobs, LN, 1, Ks, (-(-G // 128), -(-max(C, H) // 128), 4 * S)


def cta_walk(K, nseg, Ks, slice_):
    """A CTA's k tiles: q -> (segment, k0) for q < NT."""
    kb, ke = slice_ * Ks, min(K, slice_ * Ks + Ks)
    kts = -(-(ke - kb) // KT) if ke > kb else 0
    return [(q // kts, kb + (q % kts) * KT) for q in range(kts * nseg)]


def test_constants_follow_the_source():
    """The models read the source's FT_KT, FT_STAGES, FT_THREADS and FT_BM;
    the shapes they assume are the kernel's: 128 threads of 16 thread rows
    by 8 columns, 1024-byte aligned images, K-major boxes of one swizzle
    span (64 or 128 bytes), two CTAs an SM within 227 KB."""
    src = _src()
    assert THREADS == 128 and BM128 == 128 and KT in (16, 32)
    for line in ("static constexpr uint32_t A_IMG = (A_BYTES + 1023) / 1024 * 1024;",
                 "static constexpr size_t SMEM = (size_t)FT_STAGES * STAGE + 8 * FT_STAGES + 4 * FT_STAGES;",
                 "__host__ __device__ constexpr int ft_swz(int r) { return FT_KT == 16 ? (r >> 1) & 3 : r & 7; }",
                 ": FT_KT == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;",
                 "const CUtensorMapSwizzle sw = !kmajor ? CU_TENSOR_MAP_SWIZZLE_NONE",
                 "const cuuint64_t strides[2] = {d0 * 4, d0 * d1 * 4};",
                 "if ((base & 1023) != 0) __trap();",
                 "__launch_bounds__(FT_THREADS, 2) f32_tma_kernel("):
        assert line in src, line
    stage = 2 * -(-128 * KT * 4 // 1024) * 1024
    assert 2 * (STAGES * stage + 12 * STAGES) <= 232448
    assert bigru_vjp.WGRAD_CTAS_PER_SM == 2


def test_launch_models_follow_the_host_source():
    """``launches`` is the host's set-up: each product's maps (dims, boxes,
    K-major or not), jobs, segments and grid."""
    src = _src()
    for line in (
            "CUresult r = ft_map(&maps[2], wih, G, C, 2, FT_BM, FT_KT, false);",
            "if (r == CUDA_SUCCESS && x_tma) r = ft_map(&maps[0], x, C, M, 1, FT_KT, 16 * RM, true);",
            "const dim3 grid((G + FT_BM - 1) / FT_BM, (M + 16 * RM - 1) / (16 * RM), 2);",
            "CUresult r = ft_map(&maps[0], dxg, G, M, 2, FT_KT, 16 * RM, true);",
            "if (r == CUDA_SUCCESS) r = ft_map(&maps[2], wih, G, C, 2, FT_KT, BN, true);",
            "const dim3 grid((C + BN - 1) / BN, (M + 16 * RM - 1) / (16 * RM), 1);",
            "CUresult r = ft_map(&maps[1], out, 2 * H, LN, 1, FT_BM, FT_KT, false);",
            "if (r == CUDA_SUCCESS && x_tma) r = ft_map(&maps[0], x, C, LN, 1, FT_BM, FT_KT, false);",
            "if (r == CUDA_SUCCESS) r = ft_map(&maps[2], dxg, G, LN, 2, FT_BM, FT_KT, false);",
            "if (r == CUDA_SUCCESS) r = ft_map(&maps[3], dhg, G, LN, 2, FT_BM, FT_KT, false);",
            "p.job[d] = FtJob{{0, 0, 0, 0, 0}, {0, 0, 0, d, d}, C, G, !x_tma,",
            "const dim3 grid((G + FT_BM - 1) / FT_BM, ((C > H ? C : H) + FT_BM - 1) / FT_BM, 4 * S);",
            "tma_load_3d(a, mp, bar, k0 + o.koff, m0 + o.ioff, z);",
            "tma_load_3d(a, mp, bar, m0 + o.ioff, k0 + o.koff, z);",
            "tma_load_3d(b, mp, bar, k0 + o.koff, n0 + o.ioff, z);",
            "tma_load_3d(b, mp, bar, n0 + o.ioff, k0 + o.koff, z);",
            "const bool x_tma = ft_tma_ok(x, C);",
            "return row % 4 == 0 && (uintptr_t)p % 16 == 0;"):
        assert line in src, line


def _operands(kind, rng, M, C, G, H=None, L=None, N=None):
    """Seeded tensors of one product (3-d, as the maps see them) and its
    logical operands A(job, m, k) and B(job, k, n) (segments' k
    concatenated), zero where the product reads zeros."""
    if kind == "projection":
        x = rng.randn(1, M, C).astype(np.float32)
        w = rng.randn(2, C, G).astype(np.float32)
        maps = {"a": [x, x], "b": [w, w]}
        A = [x[0], x[0]]
        B = [w[0], w[1]]
    elif kind == "dx":
        dxg = rng.randn(2, M, G).astype(np.float32)
        w = rng.randn(2, C, G).astype(np.float32)
        maps = {"a": [dxg, dxg], "b": [w, w]}
        A = [np.concatenate([dxg[0], dxg[1]], axis=1)]
        B = [np.concatenate([w[0].T, w[1].T], axis=0)]
    else:
        LN = L * N
        x = rng.randn(1, LN, C).astype(np.float32)
        out = rng.randn(1, LN, 2 * H).astype(np.float32)
        dxg = rng.randn(2, LN, G).astype(np.float32)
        dhg = rng.randn(2, LN, G).astype(np.float32)
        maps = {"a": [x, out], "b": [dxg, dhg]}
        hp0 = np.zeros((LN, H), np.float32)
        hp0[N:] = out[0, :LN - N, :H]
        hp1 = np.zeros((LN, H), np.float32)
        hp1[:LN - N] = out[0, N:, H:]
        A = [x[0].T, x[0].T, hp0.T, hp1.T]
        B = [dxg[0], dxg[1], dhg[0], dhg[1]]
    return maps, A, B


@pytest.mark.parametrize("kind,M,C,G,H,L,N", [
    ("projection", 300, 512, 768, None, None, None), ("projection", 131, 28, 96, None, None, None),
    ("projection", 77, 52, 128, None, None, None),
    ("dx", 300, 512, 768, None, None, None), ("dx", 131, 11, 96, None, None, None),
    ("dx", 77, 52, 1024, None, None, None), ("dx", 230, 28, 48, None, None, None),
    ("wgrad", None, 28, 96, 32, 5, 23), ("wgrad", None, 512, 768, 256, 3, 19),
    ("wgrad", None, 52, 128, 32, 4, 9)])
def test_tma_images_read_back_as_each_threads_operands(kind, M, C, G, H, L, N):
    """Every CTA tile's first k tiles of every segment, loaded as the host's
    maps and the kernel's coordinates place TMA's boxes (zeros outside the
    tensor: rows past M, k past the operand, h_prev's rows before a
    direction's first step) and read back with ft_tile's addresses and
    swizzle, give each thread A(its rows, k) and B(k, its columns) of the
    logical product, wherever the thread's element lies inside the matrix;
    past the contraction's end B reads zeros."""
    rng = np.random.RandomState(len(kind) * 10000 + C + G)
    if kind == "wgrad":
        M = L * N
    maps, A, B = _operands(kind, rng, M, C, G, H, L, N)
    rm, tn, ak, bk, jobs, K, nseg, Ks, grid = launches(kind, M, C, G, H, L, N,
                                                       rm=8 if kind == "wgrad" else 7)
    bm, bn = 16 * rm, 8 * tn
    rows, cols = thread_rows_cols(ak, bk, rm, tn)
    checked = 0
    for z in range(grid[2]):
        jm, jn, aop, bop = jobs[z]
        for by in range(grid[1]):
            for bx in range(grid[0]):
                m0, n0 = by * bm, bx * bn
                if m0 >= jm or n0 >= jn:
                    continue
                for seg, k0 in cta_walk(K, nseg, Ks, 0)[::max(1, K // KT // 3)]:
                    amap, bmap = maps["a"][aop[0]], maps["b"][bop[0]]
                    za, zb = (aop[3], bop[3]) if seg == 0 else (aop[4], bop[4])
                    if ak:
                        a_img = tma_box(amap, (KT, bm), (k0 + aop[2], m0 + aop[1], za), True)
                    else:
                        a_img = tma_box(amap, (128, KT), (m0 + aop[1], k0 + aop[2], za), False)
                    if bk:
                        b_img = tma_box(bmap, (KT, bn), (k0 + bop[2], n0 + bop[1], zb), True)
                    else:
                        b_img = tma_box(bmap, (128, KT), (n0 + bop[1], k0 + bop[2], zb), False)
                    ta, tb = thread_reads(a_img, b_img, ak, bk, rm, tn)
                    kg = seg * K + k0 + np.arange(KT)  # the logical k of the tile
                    kin = (k0 + np.arange(KT)) < K
                    la, lb = A[z], B[z]
                    m = m0 + rows                            # (128, rm)
                    wa = np.where(kin, la[np.minimum(m, jm - 1)[:, :, None],
                                          np.minimum(kg, la.shape[1] - 1)], np.float32(0.0))
                    # past K, A may hold data (h_prev's rows shifted by -N lie
                    # inside out) but meets B's zero rows: 0 a adds nothing
                    ok = (m < jm)[:, :, None] & kin[None, None, :]
                    assert np.array_equal(ta[ok], wa[ok]), (kind, z, seg, k0, m0)
                    assert np.isfinite(ta).all()
                    n = n0 + cols                            # (128, tn)
                    wb = np.where(kin[:, None], lb[np.minimum(kg, lb.shape[0] - 1)[None, :, None],
                                                   np.minimum(n, jn - 1)[:, None, :]],
                                  np.float32(0.0))
                    ok = np.broadcast_to((n < jn)[:, None, :], tb.shape)
                    assert np.array_equal(tb[ok], wb[ok]), (kind, seg, k0, n0)
                    checked += 1
    assert checked > 0


@pytest.mark.parametrize("kmajor,C,M,k0,ke", [(True, 11, 300, 0, 11), (True, 21, 131, 0, 21),
                                             (False, 11, 11, 64, 300), (False, 21, 21, 288, 300)])
def test_plain_loads_write_the_image_tma_would(kmajor, C, M, k0, ke):
    """Where X's rows are no 16-byte multiple (C = 11, 21), the CTA's own
    4-byte copies (ft_plain_a) write the image a TMA box of X would land
    (swizzled K-major for the projection, dense MN-major for dW_ih), zeros
    past M and ke; the source's loop is the model's."""
    rng = np.random.RandomState(C + k0)
    rows_x = 300
    x = rng.randn(rows_x * C).astype(np.float32)
    x3 = x.reshape(1, rows_x, C)
    for i0 in (0, 128):
        if i0 >= M:
            continue
        got = plain_a(x, C, i0, M, k0, ke, 128, kmajor)
        if kmajor:  # (k, i) box of X's rows; k < ke = C is all of X's k
            want = tma_box(x3[:, :M], (KT, 128), (k0, i0, 0), True)
        else:       # X^T: (i, k) box, rows k < ke, columns i < M = C
            want = tma_box(x3[:, :ke], (128, KT), (i0, k0, 0), False)
        assert np.array_equal(got, want)
    src = _src()
    for line in ("const int ii = AK ? e / kw : e % BM, kk = AK ? e % kw : e / BM;",
                 "const bool ok = i < M && k < ke;",
                 "const int slot = AK ? ii * FT_KT + (((kk >> 2) ^ ft_swz(ii)) << 2) + (kk & 3) "
                 ": kk * BM + ii;",
                 "\"l\"(ok ? x + (AK ? (size_t)i * ld + k : (size_t)k * ld + i) : x), \"r\"(ok ? 4 : 0)",
                 "cp_async_commit(); cp_async_wait<0>();",
                 "mbar_expect_tx(bar, (plain ? 0u : SH::A_BYTES) + SH::B_BYTES);",
                 "const int s = q % ST, k0 = kb + (q % KTS) * KT;",
                 "ft_plain_a<AK, BM>(as, p.x, p.ldx, m0, M, k0, ke, 4 * nc, tid); __syncthreads();"):
        assert line in src, line


@pytest.mark.parametrize("kt", [16, 32])
def test_quarter_warps_read_distinct_banks(kt):
    """A quarter warp (8 threads of consecutive tid) reads 16-byte chunks
    that lie in 8 distinct bank groups of a 128-byte line, or one chunk for
    all 8: K-major B's rows tx + 8 j under the swizzle, K-major A's row ty
    (one row a quarter: a broadcast), MN-major 4 tx + 32 q. A warp's four K-
    major A rows (4 w + q) fall in four groups too. Without the swizzle the
    rows of 64 or 128 bytes would share banks."""
    def group(off):  # the 16-byte bank group of a byte offset
        return (off // 16) % 8

    for c in range(kt // 4):
        for j in range(16):
            for q in range(4):
                tids = range(8 * q, 8 * q + 8)
                b = {group(4 * ((t % 8 + 8 * j) * kt + ((c ^ ft_swz(t % 8, kt)) << 2)))
                     for t in tids}
                assert len(b) == 8
                dense = {group(4 * ((t % 8 + 8 * j) * kt + 4 * c)) for t in tids}
                assert len(dense) < 8
        for w in range(4):
            for i in range(8):
                a = {group(4 * ((ty + 16 * i) * kt + ((c ^ ft_swz(ty, kt)) << 2)))
                     for ty in range(4 * w, 4 * w + 4)}
                assert len(a) == 4
    for k in range(kt):
        for q in range(4):
            assert len({group(4 * (k * 128 + q * 32 + 4 * tx)) for tx in range(8)}) == 8


@pytest.mark.parametrize("kind,M,C,G,H,L,N,S", [
    ("projection", 1055, 512, 768, None, None, None, 1), ("projection", 300, 11, 96, None, None, None, 1),
    ("dx", 1055, 512, 768, None, None, None, 1), ("dx", 300, 52, 128, None, None, None, 1),
    ("wgrad", None, 512, 768, 256, 21, 61, 3), ("wgrad", None, 11, 96, 32, 5, 7, 3),
    ("wgrad", None, 28, 128, 32, 3, 40, 4)])
def test_grid_and_k_walk_cover_every_tile_once(kind, M, C, G, H, L, N, S):
    """The grid's CTAs that pass the kernel's early return cover each job's
    output tiles exactly once a slice (the wgrad grid's rows sized for the
    larger of C and H); each CTA's k walk takes every k tile of each segment
    once, ascending, segment 0 first; slices of Ks rows (a multiple of 32
    and of FT_KT) partition [0, L N), so no k tile crosses a slice's end."""
    if kind == "wgrad":
        M = L * N
    for rm in ((8,) if kind == "wgrad" else (7, 8)):
        _rm, tn, ak, bk, jobs, K, nseg, Ks, grid = launches(kind, M, C, G, H, L, N, S, rm)
        bm, bn = 16 * rm, 8 * tn
        S_ = grid[2] // len(jobs)
        for j, (jm, jn, _a, _b) in enumerate(jobs):
            for s in range(S_):
                cover = np.zeros((jm, jn), np.int64)
                for by in range(grid[1]):
                    for bx in range(grid[0]):
                        m0, n0 = by * bm, bx * bn
                        if m0 >= jm or n0 >= jn:
                            continue
                        cover[m0:m0 + bm, n0:n0 + bn] += 1
                assert (cover == 1).all()
        seen = []
        for s in range(S_):
            walk = cta_walk(K, nseg, Ks, s)
            assert walk == sorted(walk)
            for seg in range(nseg):
                ks = [k0 for sg, k0 in walk if sg == seg]
                # a tile ends inside its slice, or past K (TMA's zeros)
                assert all(k0 % KT == 0 and (k0 + KT <= s * Ks + Ks or s * Ks + Ks >= K)
                           for k0 in ks)
                seen += [(seg, k0) for k0 in ks]
        want = [(seg, k0) for seg in range(nseg) for k0 in range(0, K, KT)]
        assert sorted(seen) == want
        assert Ks % KT == 0 or S_ == 1


def simulate_ring(nt, stages, plain, rng):
    """The kernel's ring, one step at a time in a random order: thread 0
    loads the first ``stages`` k tiles; each of 4 warps, for q < nt, (with
    ``plain``: writes its quarter of slot q % stages's A image, then a CTA
    barrier) waits on the slot's mbarrier for the parity of use q / stages,
    reads the slot, and arrives on the slot's count; the warp that makes it
    4 (use + 1) loads tile q + stages into the slot, whose bytes land later.
    Checks: a wait passes only on its own phase (no parity alias), a reader
    finds the slot holding its tile in both images, no load or plain write
    lands in a slot a warp still reads, every tile loads once. Returns the
    steps taken."""
    slot_b = [None] * stages           # the tile whose B image the slot holds
    slot_a = [[None] * 4 for _ in range(stages)]  # each quarter's A (plain)
    completed = [0] * stages           # phases completed
    done = [0] * stages
    pending = []                       # (slot, tile) loads in flight
    loaded = []
    reading = {}                       # warp -> (slot, tile)
    pc = [0] * 4                       # warp -> next q
    stage = [0] * 4                    # 0 write A / barrier, 1 wait, 2 read, 3 arrive
    at_barrier = set()

    def issue(q):
        s = q % stages
        assert all(r[0] != s for r in reading.values()), "refill of a slot being read"
        pending.append((s, q))
        loaded.append(q)

    for q in range(min(stages, nt)):
        issue(q)
    steps = 0
    while any(p < nt for p in pc) or pending:
        moves = []
        for w in range(4):
            if pc[w] >= nt:
                continue
            q, s = pc[w], pc[w] % stages
            if stage[w] == 0:
                if not plain:
                    moves.append(("skip", w))
                elif w not in at_barrier:
                    moves.append(("write", w))
            elif stage[w] == 1:
                if completed[s] % 2 != (q // stages) % 2:  # the parity of use q / stages flipped
                    moves.append(("wait", w))
            else:
                moves.append(("step", w))
        if plain and len(at_barrier) == sum(1 for w in range(4) if pc[w] < nt) and at_barrier:
            moves.append(("barrier", None))
        moves += [("land", i) for i in range(len(pending))]
        assert moves, "deadlock"
        kind, w = moves[rng.randint(len(moves))]
        steps += 1
        if kind == "land":
            s, q = pending.pop(w)
            assert all(r[0] != s for r in reading.values()), "bytes landed in a slot being read"
            slot_b[s] = q
            completed[s] += 1
        elif kind == "skip":
            stage[w] = 1
        elif kind == "write":
            q, s = pc[w], pc[w] % stages
            assert all(r[0] != s for r in reading.values()), "plain write into a slot being read"
            slot_a[s][w] = q
            at_barrier.add(w)
        elif kind == "barrier":
            for v in at_barrier:
                stage[v] = 1
            at_barrier.clear()
        elif kind == "wait":
            q, s = pc[w], pc[w] % stages
            assert completed[s] == q // stages + 1  # its own phase, no alias
            reading[w] = (s, q)
            stage[w] = 2
        elif stage[w] == 2:
            s, q = reading[w]
            assert slot_b[s] == q and (not plain or slot_a[s] == [q] * 4), (slot_b[s], q)
            stage[w] = 3
        else:
            s, q = reading.pop(w)
            done[s] += 1
            if done[s] == (q // stages + 1) * 4 and q + stages < nt:
                issue(q + stages)
            pc[w] += 1
            stage[w] = 0
    assert sorted(loaded) == list(range(nt))
    return steps


@pytest.mark.parametrize("nt,stages,plain", [(32, 4, False), (7, 4, False), (3, 4, False),
                                             (96, 6, False), (40, 3, False), (13, 4, True),
                                             (1, 4, True), (0, 4, False)])
def test_ring_protocol_holds_under_random_interleavings(nt, stages, plain):
    """The full/last-warp-refill ring of f32_tma_kernel under 200 random
    schedules a case (and the plain A writes with their CTA barrier), each
    completing; and the model's steps are the source's."""
    rng = np.random.RandomState(nt * 10 + stages)
    for _ in range(200 if nt < 40 else 60):
        simulate_ring(nt, stages, plain, rng)
    src = _src()
    for line in ("fence.mbarrier_init.release.cluster;\\n\" ::: \"memory\"); "
                 "for (int q = 0; q < ST && q < NT; ++q) load(q); } __syncthreads();",
                 "mbar_init(full + 8 * s, 1);",
                 "ft_wait(full + 8 * s, (q / ST) & 1);",
                 "__syncwarp(); if (lane == 0) { __threadfence_block(); "
                 "if (atomicAdd(done + s, 1) == (q / ST + 1) * 4 - 1 && q + ST < NT) { "
                 "__threadfence_block(); load(q + ST); } }"):
        assert line in src, line


@pytest.mark.parametrize("bk", [4, 16, 32])
@pytest.mark.parametrize("cin", [11, 21, 512])
def test_chains_equal_the_simt_gemm_chain_at_every_slot_depth(bk, cin):
    """Each output as one fmaf chain over k ascending from 0.0f in k tiles
    of either slot depth the sweep builds (16 or 32, zeros past the
    operand), or over the 4-k chunks that hold data (4: ft_tile's nc skips
    the rest), is bit for bit gemm_simt_kernel's chain (k tiles of 8): the
    projection with its folded bias, dx over both directions' k, and the
    weight gradients of each slice with (over whole slots) the column sums'
    residue partials."""
    from tests.test_torch_kernel_layouts import proj_chain
    from tests.test_torch_train_layouts import simt_chain, simt_colsum

    rng = np.random.RandomState(bk + cin)
    M, G = 45, 96
    x = rng.randn(M, cin).astype(np.float32)
    w = (0.3 * rng.randn(cin, G)).astype(np.float32)
    b0, b1 = rng.randn(2, G).astype(np.float32)
    assert np.array_equal(proj_chain(x, w, b0, b1, 64, bk).view(np.uint32),
                          proj_chain(x, w, b0, b1, 64, 8).view(np.uint32))
    a = rng.randn(2 * G, M).astype(np.float32)
    b = rng.randn(2 * G, cin).astype(np.float32)
    assert np.array_equal(simt_chain(a, b, bk).view(np.uint32), simt_chain(a, b, 8).view(np.uint32))
    rows = rng.randn(70, G).astype(np.float32)  # one slice's rows of dxg
    xs = rng.randn(70, min(cin, 64)).astype(np.float32)
    if bk % 8 == 0:  # the column sums run over whole slots (residues of 8)
        assert np.array_equal(simt_colsum(rows, bk).view(np.uint32),
                              simt_colsum(rows, 8).view(np.uint32))
    assert np.array_equal(simt_chain(xs, rows, bk).view(np.uint32),
                          simt_chain(xs, rows, 8).view(np.uint32))


@pytest.mark.parametrize("rows,G,tile", [(21 * 1024, 768, 112), (21 * 1024, 1024, 112),
                                         (21 * 16384, 768, 112), (21 * 16384, 1024, 128),
                                         (21 * 512, 768, 128), (5 * 211, 96, 112)])
def test_projection_tile_takes_the_fewest_wave_times(rows, G, tile):
    """The projection's rows a tile (``simt_proj_tile``, the source's
    ``ft_rows`` over 2 ceil(G / 128) column tiles, 132 SMs): at 1,024 rows
    the GRU's 2,016 tiles of 128 rows are 7.6 waves (8 x 8 = 64 wave-rows)
    where 2,304 of 112 are 8.7 (9 x 7 = 63), the LSTM's 10.2 against 11.6
    (88 against 84); at 16,384 rows the GRU 984 against 980, the LSTM 1,304
    against 1,309; one wave either way, the shorter tile."""
    assert bigru_vjp.simt_proj_tile(rows, G, 132) == (tile, 128)
    slots = 2 * 132

    def cost(bm):
        return -(-(2 * -(-G // 128) * -(-rows // bm)) // slots) * (bm // 16)
    assert cost(tile) == min(cost(112), cost(128))


def test_probe_marks_apply_once():
    """chip_smoke.py's f32_gemm_probe builds a copy of the header with clock64
    marks put in by text replacement: each anchor of ``F32_PROBE_MARKS`` is
    in the shipped header exactly once, and every part is marked."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_f32_marks", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    with open(SRC_PATH) as f:
        src = f.read()
    for old, _new in smoke.F32_PROBE_MARKS:
        assert src.count(old) == 1, old
    marked = "".join(new for _old, new in smoke.F32_PROBE_MARKS)
    assert all("F32_PROF({})".format(k) in marked for k in range(len(smoke.F32_PROBE_PARTS)))
    marked = "".join(new for _old, new in smoke.F32_PARENT_PROBE_MARKS)
    assert all("F32_PROF({})".format(k) in marked
               for k in range(len(smoke.F32_PARENT_PROBE_PARTS)))
