"""Kernels K4 and K5: one bidirectional GRU layer for training.

Counterpart of ``ccsmeth_tpu/ops/bigru_pallas_vjp.py``: K4 replaces
``_fwd_kernel`` (the forward that keeps the gate residuals) and K5 replaces
``_bwd_kernel`` (the backward); together they are ``fused_bigru_layer_tm``, a
``jax.custom_vjp``, here ``BiGRULayerFn``, a ``torch.autograd.Function``. The
source is ``csrc/bigru_train.cu`` with its products in
``csrc/rnn_train_gemm.cuh``; its header says what bounds the kernels on an
H100 and what the design does about that.

Layouts (time-major; direction 0 forward, 1 backward, both in natural time
order, unlike the TPU kernel which stores the backward half reversed):

    x      (L, N, C)       operand type (float32 or bfloat16)
    w_ih   (2, C, 3H)      operand type     b_ih (2, 3H) f32
    w_hh   (2, H, 3H)      operand type     b_hh (2, 3H) f32
    out    (L, N, 2H)      store type (= operand type)
    gates  (2, L, N, 4H)   store type: r, z, n, hg_n per direction
    dout   (L, N, 2H)      store type
    ->     dx (L, N, C), dw_ih (2, C, 3H), db_ih (2, 3H), dw_hh (2, H, 3H),
           db_hh (2, 3H), all f32

Each kernel is a few CUDA launches, one a phase: K4 the input projection
(``k4_projection``; in the tc design K1-tc's projection kernel of
``csrc/birnn_tc.cu``, the same function), then the recurrence
(``k4_recurrence``); K5 the recurrence that carries dh (``k5_recurrence``),
dx as one product (``k5_dx``), then the weight and bias gradients in fixed
row slices and the in-order sum of the slices (``k5_weight_grads``;
``bwd_cuda_launches`` counts a backward's launches). In the tc design the
recurrence stores the gate gradients as bf16 copies and each row tile's
partial bias sums, and dx and the weight gradients run on wgmma fed by TMA
(``csrc/rnn_train_gemm.cuh::wgemm_kernel``; X's rows at C % 8 != 0, which
TMA cannot address, by plain loads into the same image); ``gemm_calls``
counts those products by kernel. In the simt design on f32, the projection,
dx and the weight and bias gradients run ``f32_tma_kernel`` (exact f32
FMAs, 128 x 128 tiles, dx's by ``simt_dx_tile``; the operands by TMA into
an mbarrier ring), counted by product in ``f32_products``.
``k45_plan`` is the shape rule that picks the design of a CUDA call, for this
layer and for K6, the LSTM's (``bilstm_vjp``), whose kernels are these with
four gates: the gate count NG (3 or 4) is the only input besides H and the
dtype.

- ``tc``: bf16 on the tensor cores, for H a multiple of 32 whose cluster of
  H / U CTAs (U = 64, or 32 where 64 does not divide H or does not fit) has
  1, 2, 4 or 8 CTAs and fits in shared memory (H = 32, 64, 128, 256);
- ``simt``: exact f32 FMAs (no TF32), fp32 always and the bf16 shapes ``tc``
  refuses: U = min(H, 32) units a CTA, clusters of 1, 2, 4 or 8 CTAs
  (H = 16, 32, 64, 128, 256). Both recurrences are dataflows with no
  cluster barrier in the time loop, over two row halves of their tile, so
  that one half's data travels while the other half computes, on 72-row
  tiles at H = 256, where 15 tiles a direction fill two waves of
  15 clusters. The forward (``simt_fwd_geometry``): a thread owns one unit,
  its gates and RT rows, in two warp groups that take turns at the product
  (each half of the tile's rows), so that one group's gate math, stores and
  exchange run while the other multiplies; each group's new h goes to its
  peers as one bulk copy completing on their mbarriers. The backward
  (``simt_bwd_geometry``): a thread owns 8 units by RT rows of the partial,
  stores each half's into the owners' buffers by st.async, whose bytes
  complete on the owners' mbarriers, and issues the next gate math's
  residual loads during the product.

What neither takes raises ``ValueError`` with the reason; nothing falls back
to the plain version. The products of both layers (the projection, dx and the
weight gradients) are the C entries of ``csrc/bigru_train.cu``, which take the
gate count.

A CUDA tensor launches the kernels (or raises); a CPU tensor runs the plain
version beside them. ``launches_fwd`` and ``launches_bwd`` count K4 and K5
calls, ``design_calls`` those calls by design, ``cuda_launches`` each CUDA
launch where it is made, ``plain_calls`` runs of the plain versions. The
kernels are compiled with ``nvcc`` at first use (``nvcc.py``); nothing here
imports a GPU toolchain at import time.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.rnn import gru_cell
from . import bigru, bilstm_vjp, nvcc
from .kernel_args import (DTYPE_CODE, SMEM_LIMIT, cuda_checks, device_of, dims,
                          expect, op)

SRC = "bigru_train.cu"
TC_ROWS_FWD = 64  # TC_FWD_ROWS in csrc/rnn_train_rec.cuh: rows of a tc forward tile
TC_ROWS_BWD = 32  # TC_BWD_ROWS: rows of a tc backward tile
GEMM_TILE = 128  # FT_BM = GM_BM = GM_BN = WG_BM in csrc/rnn_train_gemm.cuh
# CTAs an SM of the product kernels of either design: f32_tma_kernel's
# (simt on f32), gemm_simt_kernel's (simt on bf16) and wgemm_kernel's (tc)
# __launch_bounds__
WGRAD_CTAS_PER_SM = 2
GATES = {"gru": 3, "lstm": 4}  # NG, the gate count of each cell
# The simt backward recurrence's rows a thread at H = 256 (K56_RT256 in
# csrc/rnn_train_rec.cuh; R = 8 RT rows a tile): the least R whose tiles
# fill the fewest waves at the train path's 1,024 rows, with 15 clusters of 8
# CTAs resident at one CTA an SM (cudaOccupancyMaxActiveClusters on the
# H100, ``bwd_rec_occupancy``): 15 tiles a direction, 30 clusters, 2 waves
# (64 rows would take 3)
SIMT_BWD_RT256 = 9
# The simt forward recurrence's rows a thread at H = 256 (K46_FWD_RT256 in
# csrc/rnn_train_rec.cuh; R = 8 RT rows a tile): by the same rule, for both
# cells, 72 rows (64 would take 3 waves at 1,024 rows; no tile that fits
# has few enough tiles for 1 wave), and one more row a thread (80) where
# that saves a wave (``simt_fwd_rows``: 512 rows in one)
SIMT_FWD_RT256 = 9
_DESIGN_CODE = {"simt": 0, "tc": 1}

launches_fwd = 0  # K4 calls since the caller last set it to 0
launches_bwd = 0  # K5 calls
plain_calls = 0  # runs of either plain version
cuda_launches = 0  # K4's and K5's CUDA launches, counted at each launch
design_calls = {"tc": 0, "simt": 0}  # K4 and K5 CUDA calls by design
# the tc design's backward products (dx, dW_ih, dW_hh of K5 and K6, each one
# job) by kernel: all on wgmma (csrc/rnn_train_gemm.cuh's wgemm_kernel)
gemm_calls = {"wgmma": 0}
# the exact-f32 products' launches (csrc/rnn_train_gemm.cuh's f32_tma_kernel)
# by product: the fp32 projections of K1, K2 and the simt forwards (also
# ``bigru.simt_projection``'s), and the simt backward's dx and weight gradients
f32_products = {"projection": 0, "dx": 0, "wgrad": 0}

_lib = None
_lock = threading.Lock()
# cell -> clusters of the simt forward at H = 256 (fp32) that the card held
# at once when the cell's library was loaded (``resident_fwd_clusters``)
fwd_clusters = {}


def build() -> str:
    """Compile ``csrc/bigru_train.cu`` if its library is missing; returns the
    library path. Raises with nvcc's output when the build fails."""
    return nvcc.build(SRC)[0]


def bind(path: str):
    """The library at ``path`` (a build of ``csrc/bigru_train.cu``, or of a
    copy of it) with its C entries' argument types set."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (
            ("k4_proj_launch", [i] + [p] * 5 + [i] * 4 + [p, i]),
            ("k4_rec_launch", [i, i] + [p] * 5 + [i] * 5 + [p, i]),
            ("k4_rec_occupancy", [i] * 4 + [p] * 3 + [i]),
            ("k5_rec_launch", [i, i] + [p] * 7 + [i] * 5 + [p, i]),
            ("k5_rec_occupancy", [i] * 4 + [p] * 3 + [i]),
            ("k5_dx_launch", [i, i] + [p] * 3 + [i] * 4 + [p, i]),
            ("k5_wgrad_launch", [i, i] + [p] * 5 + [i] * 6 + [p, i]),
            ("k5_sum_launch", [p, p, ctypes.c_longlong, i, p, p,
                               ctypes.c_longlong, i, p, i])):
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
                fwd_clusters["gru"] = resident_fwd_clusters(lib, "gru")
                _lib = lib
    return _lib


def k5_smem(design: str, H: int, U: int, R: int, ng: int = 3) -> int:
    """Shared memory of a backward recurrence CTA (``bwd_smem`` in
    ``csrc/rnn_train_rec.cuh``), NG = ng gates. simt: the W_hh slice NG U x H
    f32, the partials received (CN x R x U f32), the gate-gradient operand of
    one row half (R0 x (NG U + 4) f32; R0 = the first half's rows) and four
    mbarriers. tc: the partials 2 x CN x R x U f32, dh R x U f32 (the LSTM
    keeps dc there), the W_hh slice H x (NG U + 8) bf16 and the operand
    R x (NG U + 8) bf16."""
    cn, ug = H // U, ng * U
    if design != "tc":
        g = simt_bwd_geometry(H)
        rt = R // g["NR"]
        r0 = g["NR"] * ((rt + 1) // 2 if rt > 1 else rt)
        return ug * H * 4 + cn * R * U * 4 + r0 * (ug + 4) * 4 + 32
    return 2 * cn * R * U * 4 + R * U * 4 + H * (ug + 8) * 2 + R * (ug + 8) * 2


def simt_bwd_geometry(H: int) -> dict:
    """The simt backward recurrence's thread layout at H (16, 32, 64, 128 or
    256; ``SimtBwdGeom`` in ``csrc/rnn_train_rec.cuh``): 256 threads, 8 warps
    as NJW along the units by NRW along the rows; a warp's lanes JL unit
    groups by 32 / JL row groups; a thread owns the partial of RT rows by 8
    units, R = NR RT rows a tile. The tile runs as NH row halves (2 where
    RT > 1), RT0 of a thread's rows and R0 = NR RT0 rows in the first; a
    thread does the gate math of at most QM quads (4 units of a row) of a
    half."""
    U = min(H, 32)
    jg = H // 8
    jl = min(jg, 8)
    njw = jg // jl
    nrw = 8 // njw
    nr = nrw * (32 // jl)
    rt = SIMT_BWD_RT256 if H == 256 else H // U
    nh = 2 if rt > 1 else 1
    rt0 = (rt + 1) // 2 if nh == 2 else rt
    rmax = nr * max(rt0, rt - rt0)
    return {"U": U, "CN": H // U, "JL": jl, "NJW": njw, "NRW": nrw, "NR": nr, "RT": rt,
            "R": nr * rt, "NH": nh, "RT0": rt0, "R0": nr * rt0, "QM": -(-rmax * U // 4 // 256)}


def simt_fwd_geometry(H: int, rt: int = 0) -> dict:
    """The simt forward recurrence's thread layout at H (16, 32, 64, 128 or
    256; ``SimtFwdGeom`` in ``csrc/rnn_train_rec.cuh``) and RT rows a thread
    (``rt``, or the default tile's: 8, ``SIMT_FWD_RT256`` at H = 256): U =
    min(H, 32) units a CTA; 256 threads in NGR = 2 warp groups of 4 warps,
    a warp's lanes the U units by SW = 32 / U row slots, NQ = 4 SW slots a
    group; a thread owns one unit, its gates and RT rows, a group RG = NQ RT
    rows, R = NGR RG rows a tile."""
    U = min(H, 32)
    sw = 32 // U
    ngr = 2
    nq = 8 // ngr * sw
    rt = rt or (SIMT_FWD_RT256 if H == 256 else 8)
    return {"U": U, "CN": H // U, "SW": sw, "NGR": ngr, "NQ": nq, "RT": rt, "RG": nq * rt,
            "R": ngr * nq * rt}


def k4_smem(design: str, H: int, U: int, R: int, ng: int = 3) -> int:
    """Shared memory of a forward recurrence CTA (``fwd_smem`` in
    ``csrc/rnn_train_rec.cuh``), NG = ng gates. simt: the W_hh slice H x NG
    x U f32, h H x R f32 and four mbarriers. tc: the W_hh slice NG U x
    (H + 8) and h 2 x R x (H + 8), bf16."""
    if design == "tc":
        return (ng * U + 2 * R) * (H + 8) * 2
    return H * ng * U * 4 + H * R * 4 + 32


def simt_fwd_rows(plan: dict, rows: int, clusters: int) -> int:
    """The rows a tile of the forward for a call of ``rows`` rows, its
    clusters ``clusters`` resident at once: of the plan's tiles
    (``tiles_fwd``: in simt at H = 256 the default and the tile of one more
    row a thread, the kernel's two instantiations there; else one) the one
    that takes the least time, waves x rows a tile (the smaller on a tie):
    72 at the train path's 1,024 rows (2 waves of 15 clusters; 80 rows
    would take the same 2), 80 at 512 (1 wave; 72 would take 2, the second
    holding one cluster)."""
    return min(plan["tiles_fwd"], key=lambda r: (rec_waves(r, rows, clusters) * r, r))


def rec_waves(R: int, rows: int, clusters: int) -> int:
    """Waves of a recurrence (forward or backward): its clusters (one a row
    tile of R rows and direction) over the clusters the card holds at
    once."""
    return -(-2 * -(-rows // R) // clusters)


def bwd_rec_occupancy(plan: dict, compute_dtype, device: int = 0) -> dict:
    """The backward recurrence of ``plan`` (either design) on compute_dtype
    operands as the bound library launches it: {"clusters": how many the
    card holds at once (cudaOccupancyMaxActiveClusters), "smem": its shared
    memory a CTA, "rows": its rows a tile}. Launches nothing."""
    return _occupancy(plan, compute_dtype, device, ("k5_rec_occupancy",
                                                    "k6_bwd_rec_occupancy"))


def fwd_rec_occupancy(plan: dict, compute_dtype, device: int = 0) -> dict:
    """The forward recurrence of ``plan`` at its default tile, as
    ``bwd_rec_occupancy`` reads the backward's: {"clusters", "smem",
    "rows"}. Launches nothing."""
    return _occupancy(plan, compute_dtype, device, ("k4_rec_occupancy",
                                                    "k6_rec_occupancy"))


def resident_fwd_clusters(lib, cell: str) -> int:
    """How many clusters of the simt forward of ``cell`` at H = 256 in fp32
    (the one plan with two tiles) the current card holds at once, through
    ``lib``, the cell's library: read once, when the library is loaded, for
    ``fwd_rows`` (the tile it picks changes the time, never the bits)."""
    fn = "k4_rec_occupancy" if cell == "gru" else "k6_rec_occupancy"
    return _occupancy_in(lib, fn, k45_plan(256, torch.float32, cell), torch.float32,
                         torch.cuda.current_device())["clusters"]


def _occupancy(plan, compute_dtype, device, fns):
    """The C entry ``fns[0]`` (the GRU's, in ``csrc/bigru_train.cu``) or
    ``fns[1]`` (the LSTM's, ``csrc/bilstm_train.cu``) for ``plan``."""
    lib, fn = ((_load(), fns[0]) if plan["cell"] == "gru"
               else (bilstm_vjp._load(), fns[1]))
    return _occupancy_in(lib, fn, plan, compute_dtype, device)


def _occupancy_in(lib, fn, plan, compute_dtype, device):
    H = plan["U"] * plan["CN"]
    out = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        rc = getattr(lib, fn)(*_codes(plan, compute_dtype), H, plan["U"],
                              *map(ctypes.byref, out), device)
    if rc != 0:
        raise RuntimeError("{} failed: cudaError {}".format(fn, rc))
    return dict(zip(("clusters", "smem", "rows"), (v.value for v in out)))


def _tc_plan(H: int, ng: int):
    """The tc design's geometry for H and NG gates, or the reason it refuses
    H (the first reason, where U = 64 and 32 both fail)."""
    if H % 32 != 0:
        return "tc: H % 32 != 0"
    why = None
    for U in (64, 32):
        if H % U != 0:
            continue
        cn = H // U
        smem_fwd = k4_smem("tc", H, U, TC_ROWS_FWD, ng)
        smem_bwd = k5_smem("tc", H, U, TC_ROWS_BWD, ng)
        if cn not in (1, 2, 4, 8):
            why = why or "tc: a cluster of {} CTAs".format(cn)
        elif max(smem_fwd, smem_bwd) > SMEM_LIMIT:
            why = why or "tc: {} bytes of shared memory a CTA".format(max(smem_fwd, smem_bwd))
        else:
            return {"design": "tc", "U": U, "CN": cn, "rows_fwd": TC_ROWS_FWD,
                    "tiles_fwd": (TC_ROWS_FWD,), "rows_bwd": TC_ROWS_BWD,
                    "smem_fwd": smem_fwd, "smem_bwd": smem_bwd}
    return why


def simt_plan(H: int, ng: int):
    """The simt design's geometry for H and NG gates, or the reason it
    refuses H; K1's and K2's simt design (``bigru.k1_plan``) takes the same
    H, and runs this forward recurrence with this geometry on bf16
    operands. The forward's tile is ``simt_fwd_geometry(H)``'s, the
    backward's ``simt_bwd_geometry(H)``'s: 72 rows each at H = 256 (a
    forward thread owns 9 rows x 1 unit x NG gates, a backward thread 9 rows
    x 8 units of the partial); 64 or 128 below."""
    U = min(H, 32)
    if U % 16 != 0 or H % U != 0:
        return "simt: H must be 16 or a multiple of 32 (H={})".format(H)
    cn = H // U
    if cn not in (1, 2, 4, 8):
        return "simt: a cluster of {} CTAs".format(cn)
    rows_fwd = simt_fwd_geometry(H)["R"]
    rows_bwd = simt_bwd_geometry(H)["R"]
    smem = (k4_smem("simt", H, U, rows_fwd, ng), k5_smem("simt", H, U, rows_bwd, ng))
    if max(smem) > SMEM_LIMIT:
        return "simt: {} bytes of shared memory a CTA".format(max(smem))
    tiles_fwd = (rows_fwd, rows_fwd + 8) if H == 256 else (rows_fwd,)
    return {"design": "simt", "U": U, "CN": cn, "rows_fwd": rows_fwd,
            "tiles_fwd": tiles_fwd, "rows_bwd": rows_bwd, "smem_fwd": smem[0],
            "smem_bwd": smem[1]}


def k45_plan(H: int, compute_dtype=torch.float32, cell: str = "gru") -> dict:
    """The shape rule that picks the design of a CUDA call of K4/K5 (cell
    'gru') or K6 ('lstm'), whose kernels differ only in the gate count
    (module docstring); it reads H, the dtype and the cell only, and any row
    count and C take the design it picks. Returns {"design", "U", "CN",
    "rows_fwd", "rows_bwd", "smem_fwd", "smem_bwd", "cell", "gates"}, for
    simt also "why" (why not tc). Raises ValueError, naming both designs'
    reasons, for an H neither takes."""
    if compute_dtype not in DTYPE_CODE:
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if cell not in GATES:
        raise ValueError("cell must be gru or lstm, got {!r}".format(cell))
    ng = GATES[cell]
    if compute_dtype == torch.bfloat16:
        tc = _tc_plan(H, ng)
        if isinstance(tc, dict):
            return dict(tc, cell=cell, gates=ng)
        why = tc
    else:
        why = "fp32 keeps exact f32 arithmetic"
    simt = simt_plan(H, ng)
    if isinstance(simt, str):
        raise ValueError("{} no design for H={}: {}; {}".format(
            "K4/K5 take" if cell == "gru" else "K6 takes", H, simt, why))
    return dict(simt, why=why, cell=cell, gates=ng)


def k5_wgrad_slices(rows: int, C: int, H: int, n_sms: int, ng: int = 3) -> int:
    """Row slices S of the weight-gradient launch (NG = ng gates, G = NG H
    columns): the S in 1 .. 32 (each slice at least 256 rows) with the least
    waves / S, the time of S x tiles 128 x 128 output tiles in waves of
    ``WGRAD_CTAS_PER_SM`` x n_sms blocks, each tile 1/S of the rows;
    the least S on a tie (the fewest partials)."""
    t = GEMM_TILE
    G = ng * H
    tiles = 2 * -(-G // t) * (-(-C // t) + -(-H // t))
    slots = WGRAD_CTAS_PER_SM * n_sms
    best = min(range(1, max(1, min(32, rows // 256)) + 1),
               key=lambda S: (-(-S * tiles // slots) / S, S))
    return best


def f32_tile_rows(rows: int, col_tiles: int, n_sms: int) -> int:
    """Rows of a tile of ``csrc/rnn_train_gemm.cuh``'s f32_tma_kernel where A
    is K-major (the projection, dx; ``ft_rows``): 112 or 128, whichever
    takes the fewer wave-times (waves of ``WGRAD_CTAS_PER_SM`` x n_sms
    tiles, times the tile's rows) over ``col_tiles`` column tiles, 128 on a
    tie."""
    slots = WGRAD_CTAS_PER_SM * n_sms

    def cost(rm):
        return -(-(col_tiles * -(-rows // (16 * rm))) // slots) * rm
    return 112 if cost(7) < cost(8) else 128


def simt_dx_tile(rows: int, C: int, n_sms: int) -> tuple:
    """The fp32 dx product's tile (rows, columns) in f32_tma_kernel
    (``dx_cols``, ``ft_rows``): the least of 16, 32, 64 and 128 columns
    that holds C, and ``f32_tile_rows`` rows."""
    bn = next(b for b in (16, 32, 64, 128) if C <= b or b == 128)
    return f32_tile_rows(rows, -(-C // bn), n_sms), bn


def simt_proj_tile(rows: int, G: int, n_sms: int) -> tuple:
    """The fp32 projection's tile (rows, columns) in f32_tma_kernel: 128
    columns of G a direction, both directions, and ``f32_tile_rows`` rows."""
    return f32_tile_rows(rows, 2 * -(-G // GEMM_TILE), n_sms), GEMM_TILE


def _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 3 * H), compute_dtype, dev)
    expect("b_ih", b_ih, (2, 3 * H), torch.float32, dev)
    expect("w_hh", w_hh, (2, H, 3 * H), compute_dtype, dev)
    expect("b_hh", b_hh, (2, 3 * H), torch.float32, dev)
    return L, N, C, H


def _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype):
    L, N, C, H = dims(x, w_hh, compute_dtype)
    dev = x.device
    expect("x", x, (L, N, C), compute_dtype, dev)
    expect("w_ih", w_ih, (2, C, 3 * H), compute_dtype, dev)
    expect("w_hh", w_hh, (2, H, 3 * H), compute_dtype, dev)
    expect("dout", dout, (L, N, 2 * H), compute_dtype, dev)
    expect("out", out, (L, N, 2 * H), compute_dtype, dev)
    expect("gates", gates, (2, L, N, 4 * H), compute_dtype, dev)
    return L, N, C, H


def bigru_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh,
                                compute_dtype=torch.float32):
    """The plain version of K4: step by step with ``models/rnn.py``'s gate
    math. Returns (out (L, N, 2H), gates (2, L, N, 4H)) in the store type."""
    global plain_calls
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    plain_calls += 1
    flat = op(x, compute_dtype).reshape(L * N, C)
    outs, gates = [], []
    for d in (0, 1):
        xg = (flat @ op(w_ih[d], compute_dtype) + b_ih[d]).reshape(L, N, 3 * H)
        w = op(w_hh[d], compute_dtype)
        h = torch.zeros((N, H), dtype=torch.float32, device=x.device)
        ys, gs = [None] * L, [None] * L
        for s in range(L):
            t = s if d == 0 else L - 1 - s
            hg = op(h, compute_dtype) @ w + b_hh[d]
            h, r, z, n = gru_cell(xg[t], hg, h)
            ys[t] = h
            gs[t] = torch.cat([r, z, n, hg[:, 2 * H:]], dim=1)
        outs.append(torch.stack(ys))
        gates.append(torch.stack(gs))
    return (torch.cat(outs, dim=-1).to(compute_dtype),
            torch.stack(gates).to(compute_dtype))


def bigru_layer_bwd_plain(dout, x, w_ih, w_hh, out, gates,
                          compute_dtype=torch.float32):
    """The plain version of K5: the formulas of ``bigru_pallas_vjp.py:10-16``
    step by step on tensors, without autograd. Time walks in reverse per
    direction; h_prev is the stored output one step earlier in the
    direction's own time (zero at its first step). With bf16 operands dxg
    and dhg are rounded to bf16 for the four products and not for the bias
    sums."""
    global plain_calls
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    plain_calls += 1
    dev = x.device
    f32 = torch.float32
    dx = torch.zeros((L, N, C), dtype=f32, device=dev)
    dw_ih = torch.empty((2, C, 3 * H), dtype=f32, device=dev)
    dw_hh = torch.empty((2, H, 3 * H), dtype=f32, device=dev)
    db_ih = torch.empty((2, 3 * H), dtype=f32, device=dev)
    db_hh = torch.empty((2, 3 * H), dtype=f32, device=dev)
    xs = x.float().reshape(L * N, C)
    for d in (0, 1):
        g = gates[d].float()
        r, z, n, hgn = (g[..., k * H:(k + 1) * H] for k in range(4))
        o = out[..., d * H:(d + 1) * H].float()
        do = dout[..., d * H:(d + 1) * H].float()
        h_prev = torch.zeros_like(o)
        if d == 0:
            h_prev[1:] = o[:-1]
        else:
            h_prev[:-1] = o[1:]
        w_ihT = op(w_ih[d], compute_dtype).T
        w_hhT = op(w_hh[d], compute_dtype).T
        dxg_all = torch.empty((L, N, 3 * H), dtype=f32, device=dev)
        dhg_all = torch.empty((L, N, 3 * H), dtype=f32, device=dev)
        dh = torch.zeros((N, H), dtype=f32, device=dev)
        for s in range(L):
            t = L - 1 - s if d == 0 else s
            dt = do[t] + dh
            dz = dt * (h_prev[t] - n[t]) * z[t] * (1.0 - z[t])
            dn = dt * (1.0 - z[t]) * (1.0 - n[t] * n[t])
            dr = dn * hgn[t] * r[t] * (1.0 - r[t])
            dxg = torch.cat([dr, dz, dn], dim=1)
            dhg = torch.cat([dr, dz, dn * r[t]], dim=1)
            dh = dt * z[t] + op(dhg, compute_dtype) @ w_hhT
            dx[t] += op(dxg, compute_dtype) @ w_ihT
            dxg_all[t] = dxg
            dhg_all[t] = dhg
        dxg_all = dxg_all.reshape(L * N, 3 * H)
        dhg_all = dhg_all.reshape(L * N, 3 * H)
        dw_ih[d] = xs.T @ op(dxg_all, compute_dtype)
        dw_hh[d] = h_prev.reshape(L * N, H).T @ op(dhg_all, compute_dtype)
        db_ih[d] = dxg_all.sum(0)
        db_hh[d] = dhg_all.sum(0)
    return dx, dw_ih, db_ih, dw_hh, db_hh


def _launch(fn, plan, ref, *args, lib=None):
    """One CUDA launch through the C entry ``fn`` (of ``csrc/bigru_train.cu``
    unless ``lib`` is given) on ``ref``'s device and current stream; raises
    unless it returns 0, and counts it in the ``cuda_launches`` of the
    layer the plan is for: this module's (K4/K5) or ``bilstm_vjp``'s (K6)."""
    global cuda_launches
    stream = torch.cuda.current_stream(ref.device).cuda_stream
    with torch.cuda.device(ref.device):
        rc = getattr(lib or _load(), fn)(*args, stream, ref.device.index)
    if rc != 0:
        raise RuntimeError("{} failed: cudaError {}".format(fn, rc))
    if plan["cell"] == "lstm":
        bilstm_vjp.cuda_launches += 1
    else:
        cuda_launches += 1


def _codes(plan, compute_dtype):
    return _DESIGN_CODE[plan["design"]], DTYPE_CODE[compute_dtype]


def k4_projection(x, w_ih, b_ih, b_hh, plan, compute_dtype):
    """The input projection, one CUDA launch (K4 (a), and K6's forward (a)
    with the LSTM's plan): xg (2, L*N, G) f32 = x w_ih[d] + b_ih[d] + b_hh[d]
    outside the GRU's reset product (its r and z columns; all of the LSTM's).
    simt: ``rnn_train_gemm.cuh``; tc: K1-tc's projection kernel as it stands
    (``csrc/birnn_tc.cu::rnn_proj_kernel``, the same function for both cells)."""
    L, N, C = x.shape
    G, ng = w_ih.shape[2], plan["gates"]
    xg = torch.empty((2, L * N, G), dtype=torch.float32, device=x.device)
    args = (x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(), b_hh.data_ptr(),
            xg.data_ptr(), L * N, C, G // ng)
    if plan["design"] == "tc":
        _launch("birnn_tc_proj_launch", plan, x, int(ng == 4), *args, lib=bigru._load_tc())
    else:
        _launch("k4_proj_launch", plan, x, DTYPE_CODE[compute_dtype], *args, ng)
        if compute_dtype == torch.float32:
            f32_products["projection"] += 1
    return xg


def fwd_rows(plan, N) -> int:
    """The forward recurrence's rows a tile for a call of N rows: the plan's
    one tile, or of its two (simt at H = 256) the one ``simt_fwd_rows``
    picks with the cell's ``fwd_clusters``."""
    tiles = plan["tiles_fwd"]
    if len(tiles) == 1:
        return tiles[0]
    (_load if plan["cell"] == "gru" else bilstm_vjp._load)()
    return simt_fwd_rows(plan, N, fwd_clusters[plan["cell"]])


def k4_recurrence(xg, w_hh, b_hh, L, N, plan, compute_dtype):
    """K4 (b), one CUDA launch: both directions from xg to out (L, N, 2H) and
    gates (2, L, N, 4H) in the store type, ``fwd_rows``' rows a tile."""
    H = w_hh.shape[1]
    out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=xg.device)
    gates = torch.empty((2, L, N, 4 * H), dtype=compute_dtype, device=xg.device)
    _launch("k4_rec_launch", plan, xg, *_codes(plan, compute_dtype), xg.data_ptr(),
            w_hh.data_ptr(), b_hh.data_ptr(), out.data_ptr(), gates.data_ptr(), L, N, H,
            plan["U"], fwd_rows(plan, N))
    return out, gates


def gate_grad_buffers(L, N, G, plan, device, two=True):
    """The backward recurrence's outputs: the gate gradients (2, L*N, G),
    one tensor or two (``two``: the GRU's dxg and dhg), f32 in simt and bf16
    in tc, where the products read them through TMA; and in tc the row tiles'
    bias-gradient partials (tiles, 1 or 2, 2, G) f32 (None in simt)."""
    tc = plan["design"] == "tc"
    dt = torch.bfloat16 if tc else torch.float32
    grads = [torch.empty((2, L * N, G), dtype=dt, device=device) for _ in range(1 + two)]
    part = (torch.empty((-(-N // plan["rows_bwd"]), 1 + two, 2, G), dtype=torch.float32,
                        device=device) if tc else None)
    return grads, part


def _ptr(t):
    return None if t is None else t.data_ptr()


def k5_recurrence(dout, out, gates, w_hh, plan, compute_dtype):
    """K5 (a), one CUDA launch: the gate gradients dxg = [dr, dz, dn] and
    dhg = [dr, dz, dn r], both (2, L*N, 3H) (f32 in simt, bf16 in tc), and in
    tc the row tiles' partial sums of both for the bias gradients
    (``gate_grad_buffers``). Returns (dxg, dhg, bias partials or None)."""
    L, N, H2 = out.shape
    H = H2 // 2
    (dxg, dhg), part = gate_grad_buffers(L, N, 3 * H, plan, out.device)
    _launch("k5_rec_launch", plan, out, *_codes(plan, compute_dtype), dout.data_ptr(),
            out.data_ptr(), gates.data_ptr(), w_hh.data_ptr(), dxg.data_ptr(),
            dhg.data_ptr(), _ptr(part), L, N, H, plan["U"], plan["rows_bwd"])
    return dxg, dhg, part


def k5_dx(dxg, w_ih, plan, compute_dtype):
    """dx, one CUDA launch (K5 (b), and K6's backward (b) on its da): dx
    (L*N, C) f32 = sum_d op(dxg[d]) w_ih[d]^T, reading w_ih in its own
    layout; simt on f32 dxg, tc on wgmma from the bf16 dxg."""
    M = dxg.shape[1]
    C, G = w_ih.shape[1:]
    ng = plan["gates"]
    dx = torch.empty((M, C), dtype=torch.float32, device=dxg.device)
    _launch("k5_dx_launch", plan, dxg, *_codes(plan, compute_dtype), dxg.data_ptr(),
            w_ih.data_ptr(), dx.data_ptr(), M, C, G // ng, ng)
    if plan["design"] == "tc":
        gemm_calls["wgmma"] += 1
    elif compute_dtype == torch.float32:
        f32_products["dx"] += 1
    return dx


def k5_weight_grads(x, out, dxg, dhg, plan, compute_dtype, bias_part=None):
    """The weight and bias gradients (K5 (c), and K6's backward (c), which
    passes its one gate gradient da as both dxg and dhg): dW_ih[d] = x^T
    op(dxg[d]), dW_hh[d] = h_prev^T op(dhg[d]) over S fixed row slices, and
    the bias gradients (of da once, db_hh then the same tensor as db_ih).
    simt: one launch with the column sums of dxg and dhg beside the products,
    then the S partials added in slice order (a second one when S > 1). tc
    (dxg, dhg bf16): one wgmma launch for both products of both directions,
    then one launch that adds the S partials in slice order and the
    recurrence's ``bias_part`` in tile order. Returns (dw_ih, db_ih, dw_hh,
    db_hh), f32."""
    L, N, C = x.shape
    H = out.shape[2] // 2
    G, ng = dxg.shape[2], plan["gates"]
    one = dhg is dxg
    dev = x.device
    tc = plan["design"] == "tc"
    if tc and bias_part is None:
        raise ValueError("the tc design's weight gradients need the recurrence's bias partials")
    # [dW_ih | dW_hh | db_ih | db_hh (two gate gradients only)] in one buffer,
    # returned as views
    sizes = (2 * C * G, 2 * H * G, 2 * G) + (() if one else (2 * G,))
    grads = torch.empty(sum(sizes), dtype=torch.float32, device=dev)
    S = k5_wgrad_slices(L * N, C, H, torch.cuda.get_device_properties(
        dev).multi_processor_count, ng)
    # a slice holds every gradient in simt, the weights' in tc
    per = sizes[0] + sizes[1] if tc else grads.numel()
    part = torch.empty(S * per, dtype=torch.float32, device=dev) if S > 1 else grads
    _launch("k5_wgrad_launch", plan, x, *_codes(plan, compute_dtype), x.data_ptr(),
            out.data_ptr(), dxg.data_ptr(), dhg.data_ptr(), part.data_ptr(), L, N, C, H,
            ng, S)
    if tc:
        gemm_calls["wgmma"] += 2  # dW_ih, dW_hh
        _launch("k5_sum_launch", plan, x, part.data_ptr(), grads.data_ptr(), per, S,
                bias_part.data_ptr(), grads[per:].data_ptr(), grads.numel() - per,
                bias_part.shape[0])
    else:
        if compute_dtype == torch.float32:
            f32_products["wgrad"] += 1
        if S > 1:
            _launch("k5_sum_launch", plan, x, part.data_ptr(), grads.data_ptr(),
                    grads.numel(), S, None, None, 0, 0)
    dw_ih, dw_hh, db_ih, *rest = grads.split(sizes)
    db_hh = rest[0] if rest else db_ih
    return dw_ih.view(2, C, G), db_ih.view(2, G), dw_hh.view(2, H, G), db_hh.view(2, G)


def bwd_cuda_launches(plan, rows: int, C: int, n_sms: int) -> int:
    """CUDA launches of one K5 or K6 backward call (``plan`` from
    ``k45_plan``, ``rows`` = L*N): the recurrence, dx, the weight gradients
    and the sum of slices and tiles; simt sums only when S > 1, tc always
    (the bias partials)."""
    if plan["design"] == "tc":
        return 4
    H = plan["U"] * plan["CN"]
    return 3 + (k5_wgrad_slices(rows, C, H, n_sms, plan["gates"]) > 1)


def bigru_layer_train_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype=torch.float32):
    """K4 on CUDA (two launches: ``k4_projection``, ``k4_recurrence``), the
    plain version on CPU: (out, gates) in the store type."""
    global launches_fwd
    L, N, C, H = _check_fwd(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    if device_of(x) == "cpu":
        return bigru_layer_train_fwd_plain(x, w_ih, b_ih, w_hh, b_hh, compute_dtype)
    plan = k45_plan(H, compute_dtype)
    cuda_checks((x, w_ih, b_ih, w_hh, b_hh), H)
    xg = k4_projection(x, w_ih, b_ih, b_hh, plan, compute_dtype)
    out, gates = k4_recurrence(xg, w_hh, b_hh, L, N, plan, compute_dtype)
    launches_fwd += 1
    design_calls[plan["design"]] += 1
    return out, gates


def bigru_layer_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype=torch.float32):
    """K5 on CUDA (``bwd_cuda_launches``: ``k5_recurrence``, ``k5_dx``,
    ``k5_weight_grads``), the plain version on CPU: (dx, dw_ih, db_ih, dw_hh,
    db_hh), all f32. Every sum has one owner and a fixed order, no atomics,
    so two runs on the same inputs give bit-equal results. The weights are
    read in the layer's own layout, with no transposed copy."""
    global launches_bwd
    L, N, C, H = _check_bwd(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    if device_of(x) == "cpu":
        return bigru_layer_bwd_plain(dout, x, w_ih, w_hh, out, gates, compute_dtype)
    plan = k45_plan(H, compute_dtype)
    cuda_checks((dout, x, w_ih, w_hh, out, gates), H)
    dxg, dhg, part = k5_recurrence(dout, out, gates, w_hh, plan, compute_dtype)
    dx = k5_dx(dxg, w_ih, plan, compute_dtype)
    dw_ih, db_ih, dw_hh, db_hh = k5_weight_grads(x, out, dxg, dhg, plan, compute_dtype, part)
    launches_bwd += 1
    design_calls[plan["design"]] += 1
    return dx.view(L, N, C), dw_ih, db_ih, dw_hh, db_hh


class BiGRULayerFn(torch.autograd.Function):
    """One differentiable BiGRU layer, zero h0: the contract of JAX's
    ``fused_bigru_layer_tm``. Takes x (L, N, C) in compute_dtype and f32
    weights in the stacked layout (w_ih (2, C, 3H), b_ih (2, 3H),
    w_hh (2, H, 3H), b_hh (2, 3H)); returns out (L, N, 2H) f32. The weights
    are rounded to compute_dtype for the kernels and their gradients come
    back in f32, as on the TPU."""

    @staticmethod
    def forward(ctx, x, w_ih, b_ih, w_hh, b_hh, compute_dtype):
        wih = w_ih.detach().to(compute_dtype).contiguous()
        whh = w_hh.detach().to(compute_dtype).contiguous()
        out, gates = bigru_layer_train_fwd(
            x.detach().contiguous(), wih, b_ih.detach().float().contiguous(),
            whh, b_hh.detach().float().contiguous(), compute_dtype)
        ctx.compute_dtype = compute_dtype
        ctx.save_for_backward(x, wih, whh, out, gates)
        return out.float()

    @staticmethod
    def backward(ctx, g):
        x, wih, whh, out, gates = ctx.saved_tensors
        dout = g.to(out.dtype).contiguous()  # the TPU rounds dout alike (:531)
        dx, dw_ih, db_ih, dw_hh, db_hh = bigru_layer_bwd(
            dout, x.contiguous(), wih, whh, out, gates, ctx.compute_dtype)
        return dx, dw_ih, db_ih, dw_hh, db_hh, None


def dropout(x: torch.Tensor, rate: float, generator) -> torch.Tensor:
    """Inverted dropout as the JAX package's (``attrnn.py:53-57``): keep with
    probability 1 - rate and scale kept entries by 1/(1 - rate). The mask is
    drawn from ``generator``; without one, or at rate 0, x passes through."""
    if rate <= 0.0 or generator is None:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def birnn_apply_trainable(layers, x: torch.Tensor, compute_dtype=torch.float32,
                          dropout_rate: float = 0.0, generator=None,
                          cell: str = "gru"):
    """Differentiable multi-layer BiGRU on K4/K5 (cell 'gru') or BiLSTM on K6
    ('lstm'), zero h0 (and c0): the port's ``birnn_apply_pallas_trainable``
    (``bigru_pallas_vjp.py:577-616``).

    layers: ``BiRNN.stacked()`` (f32, differentiable). x: (N, L, C). Inter-
    layer dropout (every layer's output but the last) is applied between the
    kernel launches. Returns (out (N, L, 2H) f32, h_n (2*NL, N, H) f32)."""
    layer_fns = {"gru": BiGRULayerFn, "lstm": bilstm_vjp.BiLSTMLayerFn}
    if cell not in layer_fns:
        raise ValueError("cell must be gru or lstm, got {!r}".format(cell))
    H = layers[0][2].shape[1]
    x_tm = x.transpose(0, 1).to(compute_dtype).contiguous()
    h_ns = []
    for li, (wih, bih, whh, bhh) in enumerate(layers):
        out = layer_fns[cell].apply(x_tm, wih, bih, whh, bhh, compute_dtype)
        h_ns += [out[-1, :, :H], out[0, :, H:]]
        x_tm = out
        if li < len(layers) - 1:
            x_tm = dropout(x_tm, dropout_rate, generator)
        x_tm = x_tm.to(compute_dtype)
    return x_tm.transpose(0, 1).float(), torch.stack(h_ns)


def train_fwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K4 for one layer: per row, step and direction the
    input projection and the recurrent product, 2 (C + H) 3H."""
    return 2 * L * N * 2 * (C + H) * 3 * H


def train_bwd_flops(L: int, N: int, C: int, H: int) -> int:
    """Matrix FLOPs of K5 for one layer: dx and dh (as K4's two products) and
    the two weight gradients of the same sizes: twice K4."""
    return 2 * train_fwd_flops(L, N, C, H)
