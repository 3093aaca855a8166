"""Kernel K1: the whole bidirectional GRU or LSTM stack; kernel K2: one layer.

Counterpart of ``ccsmeth_tpu/ops/bigru_pallas.py`` (``_make_stack_kernel``,
GRU and LSTM cells, reached through ``birnn_apply_pallas_stacked``).

``birnn_stack`` takes time-major input and the ``_layer_weights`` layout of the
JAX package (``bigru_pallas.py:411-420``), G = 3H (cell 'gru') or 4H ('lstm'):

    x      (L, N, C)   operand type (float32 or bfloat16), contiguous
    layers [(w_ih (2, C, G) operand type, b_ih (2, G) f32,
             w_hh (2, H, G) operand type, b_hh (2, G) f32), ...]
    ->     out (L, N, 2H) operand type, h_n (2*NL, N, H) f32 (torch order)

A CUDA tensor launches the kernels (or raises); a CPU tensor takes the plain
version, ``models/rnn.py``'s ``birnn_tm`` with zero h0 (and c0). ``launches``
counts K1 calls, one per ``birnn_stack`` call; ``cuda_launches`` counts the
CUDA launches they made, each where it is made. The kernels are compiled with
``nvcc`` at first use into ``build/kernels/`` beside the package
(``nvcc.py``); nothing here imports a GPU toolchain at import time.

Kernel K2, the per-layer counterpart (``bigru_pallas.py``: ``_fused_kernel
:87``, ``_fused_lstm_kernel :36``, launched by ``_fused_layer_call :143``),
runs one layer of K1's design: ``bigru_layer_tm``. ``birnn_layers`` (the
counterpart of ``birnn_apply_pallas :447``) calls it once per layer and keeps
the contract of ``birnn_stack``, except that h_n is rebuilt from the stored
outputs as the JAX entry does (``:473``): the last forward step and the first
backward step, in the operand type, widened to f32 (the recurrence's own f32
h_n is scratch there). ``bigru_layer`` is the batch-major one-layer GRU entry
(``bigru_layer_pallas :423``). K2 counts apart from K1: ``layer_launches``
(one a layer), ``layer_cuda_launches``, ``layer_design_calls`` and
``layer_plain_calls``.

``k1_plan`` is the shape rule of both: it picks one of four designs from H,
the cell, the dtype and the row count (``design_calls`` counts K1's calls by
design):

- ``tc`` (``csrc/birnn_tc.cu``), bf16 on Hopper's wgmma: per layer one
  input-projection kernel (TMA + wgmma for Cin % 8 == 0, else the mma.sync
  GEMM; counted by kernel in ``tc_projection_calls``) and one recurrence
  kernel whose clusters of CN = H / U CTAs keep W_hh in shared memory and
  run the step's product on wgmma, U = the largest of 64, 32, 16 that
  divides H; the geometry (U, MR row blocks of 64 a CTA, WN warpgroups
  across the units) is ``TC_GEOMETRY`` at H = 256 and ``TC_BY_U`` below.
  It takes bf16 with H % 16 == 0, CN in {1, 2, 4, 8} and a CTA within the
  227 KB of shared memory (H = 16, 32, 64, 128, 256). Layer 0 (Cin <= 64,
  where its slice of W_ih fits beside W_hh: ``tc_fused_kx``) runs its
  projection inside the recurrence kernel, one launch and no xg in device
  memory. The recurrence kernel stages its own W_hh slice, gate-interleaved:
  row (ub*NG + gate)*8 + i of CTA c holds column gate*H + c*U + 8*ub + i,
  so a thread's accumulators hold every gate of its units;
- ``simt`` (``csrc/birnn_simt.cu``), exact f32 FMAs (no TF32): per layer
  K4's simt projection (``bigru_train.cu``'s ``k4_proj_launch``: the f32
  GEMM ``f32_tma_kernel`` of ``rnn_train_gemm.cuh``, 8 x 16 outputs a
  thread, operands by TMA into an mbarrier ring; counted in
  ``bigru_vjp.f32_products``) and a cluster recurrence written for
  inference: four product warps, each thread RT rows by 2 units of every
  gate, and four warps that
  share the gate math with them, whose CTAs pass h to each other
  by bulk copies that complete on barriers in shared memory; its geometry
  (U units a CTA, clusters of CN = H / U CTAs, R rows a tile: 72 at H =
  256, two full waves at 1,024 rows) is ``SIMT_GEOMETRY`` at H = 256 and
  ``SIMT_SMALL`` below. It takes fp32
  and the bf16 shapes that ``tc`` refuses, at H = 16 or a multiple of 32
  with clusters of 1, 2, 4 or 8 CTAs of min(H, 32) units (H = 16, 32, 64,
  128, 256); the bf16 ones run the inference instantiation of the training
  forward's recurrence (``rnn_train_rec.cuh``) with ``k45_plan``'s simt
  geometry;
- ``rows`` (``csrc/birnn_rows.cu``), fp32 at H = 256 from ``ROWS_CROSSOVER``
  rows up (both cells), and at 64 rows a CTA in ``ROWS_SMALL_WINDOW``
  (``ROWS_SMALL_GEOMETRY``: one wave): simt's projection, then a
  recurrence in which one
  CTA owns a block of R rows (``ROWS_GEOMETRY``) with every unit and gate,
  each step a local product streamed from W_hh in L2 through a TMA ring; no
  cluster, so the grid runs in whole waves. Its bits are simt's;
- ``l2`` (``csrc/bigru_stack.cu``), the first f32-FMA kernel: the whole stack
  in one launch (K2: ``bigru_layer_launch``, one layer), weights streamed
  from L2. It takes what none of the others takes (H = 20, 48, 80, 512);
  its own limits (H % 4 == 0, H <= 1024, NL <= 8) raise.

A simt or rows call of K1 is two CUDA launches a layer; a tc call is two a layer
less one for a fused layer 0 (5 for the models' 3 layers at Cin = 11); an
l2 call one."""

from __future__ import annotations

import ctypes
import threading

import torch

from ..models.rnn import birnn_tm, n_gates
from . import bigru_vjp, nvcc
from .kernel_args import DTYPE_CODE, SMEM_LIMIT, THREADS, tile_shape

SRC = "bigru_stack.cu"  # the l2 design
TC_SRC = "birnn_tc.cu"  # the bf16 tensor-core design
SIMT_SRC = "birnn_simt.cu"  # the simt design's recurrence
ROWS_SRC = "birnn_rows.cu"  # the rows design's recurrence
# the bf16 recurrence's geometry (U, MR, WN): U units a CTA, MR row blocks
# of 64 (a tile of 64 MR rows), WN warpgroups across the units; instantiated
# in csrc/birnn_tc.cu (TC_GEOMETRIES): at H = 256 per cell; otherwise by U,
# the largest of 64, 32, 16 that divides H
TC_GEOMETRY = {"gru": (64, 2, 2), "lstm": (64, 2, 2)}
TC_BY_U = {16: (16, 2, 1), 32: (32, 2, 2), 64: (64, 2, 2)}
TC_FUSED_KX = (16, 32, 64)  # k extents of a fused layer-0 projection
# the f32 recurrence's geometry (U, R): U units a CTA, R rows a tile,
# instantiated in csrc/birnn_simt.cu (GRU_GEOMETRIES, LSTM_GEOMETRIES): at
# H = 256 per cell; below, by U = min(H, 32)
SIMT_GEOMETRY = {"gru": (32, 72), "lstm": (32, 72)}
SIMT_SMALL = {16: (16, 64), 32: (32, 32)}
SIMT_PRODUCT_THREADS = 128  # the f32 recurrence's product threads; a CTA has twice as many
# the rows design: fp32 at H = 256 from this many rows up (K1_ROWS_CROSSOVER
# in csrc/birnn_rows.cu), measured on an H100 by chip_smoke.py's
# k1_rows_sweep; its geometry (R rows a CTA, ring slots), instantiated in
# csrc/birnn_rows.cu (ROWS_GEOMETRIES); a pass is ROWS_UNITS units, a ring
# slab ROWS_KB k rows
ROWS_CROSSOVER = 6144
ROWS_GEOMETRY = {"gru": (128, 4), "lstm": (128, 3)}
# and below the crossover, in this window of rows, the rows design's
# 64-row geometry: 2 ceil(N / 64) <= 132 CTAs, one wave of one CTA an SM on
# an H100, where simt needs 7 or 8 waves of its clusters (k1_rows_sweep)
ROWS_SMALL_WINDOW = (3584, 4224)
ROWS_SMALL_GEOMETRY = {"gru": (64, 2), "lstm": (64, 2)}
ROWS_UNITS = 64
ROWS_KB = 32
_CELL_CODE = {"gru": 0, "lstm": 1}

launches = 0  # K1 calls (one per birnn_stack call) since the caller last set it to 0
cuda_launches = 0  # K1's CUDA launches, counted at each launch
plain_calls = 0  # plain-version runs (CPU tensors, or birnn_stack_plain)
design_calls = {"tc": 0, "simt": 0, "rows": 0, "l2": 0}  # birnn_stack's CUDA calls by design
layer_launches = 0  # K2 calls (one per layer)
layer_cuda_launches = 0  # K2's CUDA launches, counted at each launch
layer_plain_calls = 0  # K2 plain-version runs (one per layer)
layer_design_calls = {"tc": 0, "simt": 0, "rows": 0, "l2": 0}  # K2's CUDA calls by design
# the tc design's projection launches (K1's and K2's) by kernel: TMA + wgmma,
# or the mma.sync GEMM for Cin % 8 != 0
tc_projection_calls = {"wgmma": 0, "mma": 0}

_lib = None
_tc_lib = None
_simt_lib = None
_rows_lib = None
_lock = threading.Lock()


def build(src: str = SRC) -> str:
    """Compile ``csrc/<src>`` (``SRC``, ``TC_SRC``, ``SIMT_SRC`` or ``ROWS_SRC``) if its
    library is missing; returns the library path. Raises with nvcc's output
    when the build fails."""
    return nvcc.build(src)[0]


def _load_simt():
    global _simt_lib
    with _lock:
        if _simt_lib is None:
            lib = ctypes.CDLL(build(SIMT_SRC))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.birnn_simt_rec_launch.restype = i
            lib.birnn_simt_rec_launch.argtypes = [i, i] + [p] * 5 + [i] * 5 + [p, i]
            lib.birnn_simt_rec_occupancy.restype = i
            lib.birnn_simt_rec_occupancy.argtypes = [i] * 4 + [p, p, i]
            _simt_lib = lib
    return _simt_lib


def _load_rows():
    global _rows_lib
    with _lock:
        if _rows_lib is None:
            lib = ctypes.CDLL(build(ROWS_SRC))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.birnn_rows_rec_launch.restype = i
            lib.birnn_rows_rec_launch.argtypes = [i] + [p] * 5 + [i] * 5 + [p, i]
            lib.birnn_rows_rec_occupancy.restype = i
            lib.birnn_rows_rec_occupancy.argtypes = [i] * 4 + [p] * 3 + [i]
            lib.birnn_rows_sigmoid_check.restype = i
            lib.birnn_rows_sigmoid_check.argtypes = [p, p, i]
            _rows_lib = lib
    return _rows_lib


def _load_tc():
    global _tc_lib
    with _lock:
        if _tc_lib is None:
            lib = ctypes.CDLL(build(TC_SRC))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.birnn_tc_proj_launch.restype = i
            lib.birnn_tc_proj_launch.argtypes = [i] + [p] * 5 + [i] * 3 + [p, i]
            lib.birnn_tc_gemm_launch.restype = i
            lib.birnn_tc_gemm_launch.argtypes = [i] + [p] * 5 + [i] * 3 + [p, i]
            lib.birnn_tc_rec_launch.restype = i
            lib.birnn_tc_rec_launch.argtypes = [i] + [p] * 8 + [i] * 8 + [p, i]
            lib.birnn_tc_rec_occupancy.restype = i
            lib.birnn_tc_rec_occupancy.argtypes = [i] * 6 + [p, p, i]
            _tc_lib = lib
    return _tc_lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.bigru_stack_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_int])
            fn = lib.bigru_layer_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 6
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p, ctypes.c_int])
            _lib = lib
    return _lib


def _check(layers, x: torch.Tensor, compute_dtype, cell: str) -> int:
    """Raise on anything the kernel does not take; returns H."""
    ng = n_gates(cell)
    if compute_dtype not in DTYPE_CODE:
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if x.dim() != 3:
        raise ValueError("x must be (L, N, C), got {}".format(tuple(x.shape)))
    if x.dtype != compute_dtype:
        raise TypeError("x is {}, expected {}".format(x.dtype, compute_dtype))
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if not layers:
        raise ValueError("at least one layer is required")
    H = layers[0][2].shape[1]
    cin = x.shape[2]
    for li, (wih, bih, whh, bhh) in enumerate(layers):
        want = {"w_ih": ((2, cin, ng * H), compute_dtype, wih),
                "b_ih": ((2, ng * H), torch.float32, bih),
                "w_hh": ((2, H, ng * H), compute_dtype, whh),
                "b_hh": ((2, ng * H), torch.float32, bhh)}
        for name, (shape, dt, t) in want.items():
            if tuple(t.shape) != shape or t.dtype != dt:
                raise ValueError("layer {} {}: got {} {}, expected {} {}".format(
                    li, name, tuple(t.shape), t.dtype, shape, dt))
            if t.device != x.device:
                raise ValueError("layer {} {} is on {}, x on {}".format(
                    li, name, t.device, x.device))
            if not t.is_contiguous():
                raise ValueError("layer {} {} must be contiguous".format(li, name))
        cin = 2 * H
    return H


def birnn_stack_plain(layers, x: torch.Tensor, compute_dtype=torch.float32,
                      cell: str = "gru"):
    """The plain version of K1 on any device: same contract as birnn_stack."""
    global plain_calls
    _check(layers, x, compute_dtype, cell)
    plain_calls += 1
    return birnn_tm(layers, x, None, compute_dtype, cell)


def _shared_bytes(C0: int, H: int, bt: int, cell: str = "gru") -> int:
    """K1's dynamic shared memory for a tile of bt rows: h twice, the staged
    x_t, and (LSTM) c, all f32."""
    h_arrays = 2 if cell == "gru" else 3
    return (h_arrays * H + max(C0, 2 * H)) * bt * 4


def simt_geometry(H: int, cell: str, geometry=None) -> dict:
    """The f32 recurrence's geometry for H (16, or a multiple of 32 with a
    cluster of 1, 2, 4 or 8 CTAs of min(H, 32) units) and the cell, or the
    (U, R) given, as csrc/birnn_simt.cu launches it: {"U", "CN", "rows" (R,
    a tile), "threads" (256: 128 product threads, U / 2 unit pairs by 256 /
    U row slots, and 128 gate threads), "rows_a_thread" (RT = R U / 256),
    "smem" ((H NG U + H R + RT NG 128) f32 and 32 bytes of barriers a
    CTA)}."""
    if geometry is None:
        geometry = SIMT_GEOMETRY[cell] if H == 256 else SIMT_SMALL[min(H, 32)]
    U, R = geometry
    ng, rt = n_gates(cell), R * U // (2 * SIMT_PRODUCT_THREADS)
    return {"U": U, "CN": H // U, "rows": R, "threads": 2 * SIMT_PRODUCT_THREADS,
            "rows_a_thread": rt,
            "smem": (H * ng * U + H * R + rt * ng * SIMT_PRODUCT_THREADS) * 4 + 32}


def rows_geometry(H: int, cell: str, geometry=None) -> dict:
    """The rows design's geometry for H (a multiple of ``ROWS_UNITS``) and
    the cell, or the (R, stages) given, as csrc/birnn_rows.cu launches it:
    {"rows" (R, a CTA's block), "stages" (ring slots), "threads" (2 R, 8
    rows x 4 units x every gate each), "passes" (H / ROWS_UNITS a step),
    "smem" (the ring's slots of ROWS_KB x NG x ROWS_UNITS f32, h's H x R
    f32, and a slot's barrier and count in 16 bytes)}."""
    R, stages = geometry or ROWS_GEOMETRY[cell]
    ng = n_gates(cell)
    return {"rows": R, "stages": stages, "threads": 2 * R, "passes": H // ROWS_UNITS,
            "smem": (stages * ROWS_KB * ng * ROWS_UNITS + H * R) * 4 + 16 * stages}


def tc_smem(H: int, cell: str, U: int, rows: int, kx: int = 0) -> int:
    """Shared memory a CTA of the bf16 recurrence (csrc/birnn_tc.cu's
    tc_rec_smem): W_hh's slice and h, each H / 64 K blocks (at least one) of
    128-byte rows; with a fused projection (kx), W_ih's slice, the GRU's
    n-gate W_ih and x_t, each in 1024-byte units; 16 bytes of barriers and
    the f32 bias tables."""
    ng = n_gates(cell)
    kbh, nc = -(-H // 64), ng * U

    def r1024(v):
        return -(-v // 1024) * 1024

    fused = 0
    if kx:
        fused = r1024(nc * 2 * kx) + (r1024(U * 2 * kx) if ng == 3 else 0) + r1024(rows * 2 * kx)
    return kbh * nc * 128 + kbh * rows * 128 + fused + 16 + 4 * nc + 4 * U


def tc_units(H: int) -> int:
    """U of the bf16 design: the largest of 64, 32, 16 that divides H."""
    return next(u for u in (64, 32, 16) if H % u == 0)


def tc_geometry(H: int, cell: str, geometry=None) -> dict:
    """The bf16 recurrence's geometry for H and the cell, or the (U, MR, WN)
    given, as csrc/birnn_tc.cu launches it: {"U", "CN", "MR", "WN", "rows"
    (64 MR, a tile), "threads" (128 MR WN), "smem" (unfused: ``tc_smem``)}."""
    if geometry is None:
        geometry = TC_GEOMETRY[cell] if H == 256 else TC_BY_U[tc_units(H)]
    U, MR, WN = geometry
    rows = 64 * MR
    return {"U": U, "CN": H // U, "MR": MR, "WN": WN, "rows": rows,
            "threads": 128 * MR * WN, "smem": tc_smem(H, cell, U, rows)}


def tc_fused_kx(plan: dict, C: int, cell: str, H: int) -> int:
    """The k extent (16, 32 or 64) with which a tc plan runs a layer of
    input width C with its projection inside the recurrence kernel, or 0:
    C <= 64, a fused instantiation of the geometry (not the GRU's U = 128)
    and room in shared memory."""
    kx = next((k for k in TC_FUSED_KX if C <= k), 0)
    if not kx or plan["U"] > 64:
        return 0
    return kx if tc_smem(H, cell, plan["U"], plan["rows"], kx) <= SMEM_LIMIT else 0


def _forced_plan(H: int, cell: str, compute_dtype, design: str) -> dict:
    """``design`` ("simt" or "rows") on an fp32 shape it takes, or raise
    naming the shape."""
    if compute_dtype != torch.float32 or design not in ("simt", "rows"):
        raise ValueError("design= forces simt or rows in float32, not {} in {}".format(
            design, compute_dtype))
    if design == "rows":
        geo = rows_geometry(H, cell)
        if H % ROWS_UNITS != 0 or geo["smem"] > SMEM_LIMIT:
            raise ValueError("the rows design does not take H = {} ({})".format(H, cell))
        return dict(geo, design="rows", why="design=rows")
    if isinstance(bigru_vjp.simt_plan(H, n_gates(cell)), str):
        raise ValueError("the simt design does not take H = {} ({})".format(H, cell))
    return dict(simt_geometry(H, cell), design="simt", why="design=simt")


def k1_plan(H: int, cell: str = "gru", compute_dtype=torch.bfloat16, rows=None,
            design=None) -> dict:
    """The shape rule that picks the design of a CUDA call of K1 or K2
    (module docstring) from H, the cell, the dtype and the row count (``rows``:
    N of the call; None leaves the rows design out). ``design`` ("simt" or
    "rows") forces that design on an fp32 shape it takes, and raises on
    another. Returns {"design": "tc", "U", "CN", "MR", "WN", "rows",
    "threads", "smem" (bytes a CTA of the unfused recurrence):
    ``tc_geometry``}, {"design": "simt", "U", "CN", "rows" (a recurrence
    tile), "smem", "why"} (fp32 also "threads", "rows_a_thread":
    ``simt_geometry``), {"design": "rows", "rows" (a CTA's block), "stages",
    "threads", "passes", "smem", "why"} (``rows_geometry``) or {"design":
    "l2", "why", "why_not_simt"}; "why" says why not tc. A bf16 simt plan
    holds the training forward's geometry."""
    if design is not None:
        return _forced_plan(H, cell, compute_dtype, design)
    ng = n_gates(cell)
    if compute_dtype != torch.bfloat16:
        why = "fp32 keeps exact f32 arithmetic"
    elif H % 16 != 0:
        why = "H % 16 != 0"
    else:
        cn = H // tc_units(H)
        if cn not in (1, 2, 4, 8):
            why = "a cluster of {} CTAs".format(cn)
        else:
            geo = tc_geometry(H, cell)
            if geo["smem"] > SMEM_LIMIT:
                why = "{} bytes of shared memory a CTA".format(geo["smem"])
            else:
                return dict(geo, design="tc")
    simt = bigru_vjp.simt_plan(H, ng)
    if isinstance(simt, str):
        return {"design": "l2", "why": why, "why_not_simt": simt}
    if compute_dtype == torch.bfloat16:
        return {"design": "simt", "U": simt["U"], "CN": simt["CN"],
                "rows": simt["rows_fwd"], "smem": simt["smem_fwd"], "why": why}
    if H == 256 and rows is not None and rows >= ROWS_CROSSOVER:
        return dict(rows_geometry(H, cell), design="rows", why=why)
    if H == 256 and rows is not None and ROWS_SMALL_WINDOW[0] <= rows <= ROWS_SMALL_WINDOW[1]:
        return dict(rows_geometry(H, cell, ROWS_SMALL_GEOMETRY[cell]), design="rows", why=why)
    return dict(simt_geometry(H, cell), design="simt", why=why)


def _stack_l2(layers, x, compute_dtype, cell, H):
    """K1's l2 design: the whole stack in one launch of ``bigru_stack.cu``."""
    global launches, cuda_launches
    L, N, C0 = x.shape
    NL = len(layers)
    if H % 4 != 0 or H // 4 > THREADS or NL > 8:
        raise ValueError("kernel takes H % 4 == 0, H <= 1024 and <= 8 layers "
                         "(H={}, NL={})".format(H, NL))
    props = torch.cuda.get_device_properties(x.device)
    r, ty = tile_shape(N, H, props.multi_processor_count)
    while r > 1 and _shared_bytes(C0, H, ty * r, cell) > SMEM_LIMIT:
        r //= 2
    if _shared_bytes(C0, H, ty * r, cell) > SMEM_LIMIT:
        raise ValueError("tile does not fit in shared memory (C={}, H={})"
                         .format(C0, H))
    lib = _load()
    out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=x.device)
    scratch = torch.empty_like(out) if NL > 1 else out
    hn = torch.empty((2 * NL, N, H), dtype=torch.float32, device=x.device)
    wih, bih, whh, bhh = _ptr_arrays(layers)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.bigru_stack_launch(
            _CELL_CODE[cell], DTYPE_CODE[compute_dtype], x.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), hn.data_ptr(), ctypes.addressof(wih),
            ctypes.addressof(bih), ctypes.addressof(whh), ctypes.addressof(bhh),
            NL, L, N, C0, H, r, ty, stream, x.device.index)
    if rc != 0:
        raise RuntimeError("bigru_stack launch failed: cudaError {}".format(rc))
    cuda_launches += 1
    launches += 1
    design_calls["l2"] += 1
    return out, hn


def _launched(name: str, rc: int, layer: bool):
    """Raise unless a C entry returned 0; count the launch as K2's (layer)
    or K1's."""
    global cuda_launches, layer_cuda_launches
    if rc != 0:
        raise RuntimeError("{} failed: cudaError {}".format(name, rc))
    if layer:
        layer_cuda_launches += 1
    else:
        cuda_launches += 1


def tc_projection(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                  b_hh: torch.Tensor, cell: str = "gru", xg=None,
                  layer: bool = False) -> torch.Tensor:
    """Phase (a) of the tc design, one layer: x (M, K) bf16, w_ih (2, K, G)
    bf16, biases (2, G) f32 -> xg (2, M, G) f32 = x w_ih[d] + b_ih[d] + the
    b_hh[d] columns outside the reset product (GRU: r, z; LSTM: all). K % 8
    == 0 runs the TMA + wgmma GEMM, other K the mma.sync one (TMA needs
    16-byte row strides). The launch counts as K2's when ``layer``, else as
    K1's."""
    M, K = x.shape
    G = w_ih.shape[2]
    H = G // n_gates(cell)
    if xg is None:
        xg = torch.empty((2, M, G), dtype=torch.float32, device=x.device)
    kernel = "wgmma" if K % 8 == 0 else "mma"
    entry = "birnn_tc_gemm_launch" if kernel == "wgmma" else "birnn_tc_proj_launch"
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(_load_tc(), entry)(
            _CELL_CODE[cell], x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), xg.data_ptr(), M, K, H, stream, x.device.index)
    _launched(entry, rc, layer)
    tc_projection_calls[kernel] += 1
    return xg


def tc_recurrence(xg, w_hh: torch.Tensor, b_hh: torch.Tensor, L: int, N: int, plan: dict,
                  cell: str = "gru", out=None, hn=None, layer: bool = False,
                  fused=None):
    """Phase (b) of the tc design, one layer, both directions, zero h0 (and
    c0): xg (2, L*N, G) f32, w_hh (2, H, G) bf16, b_hh (2, G) f32 -> out
    (L, N, 2H) bf16, hn (2, N, H) f32, at ``plan``'s geometry (U, MR, WN:
    ``k1_plan`` or ``tc_geometry``). ``fused`` = (x (L, N, C), w_ih (2, C,
    G), b_ih (2, G)) runs the layer's projection inside the kernel instead
    (xg unread, may be None; C within ``tc_fused_kx``)."""
    H = w_hh.shape[1]
    dev = w_hh.device
    if out is None:
        out = torch.empty((L, N, 2 * H), dtype=torch.bfloat16, device=dev)
    if hn is None:
        hn = torch.empty((2, N, H), dtype=torch.float32, device=dev)
    x = w_ih = b_ih = None
    C = kx = 0
    if fused is not None:
        x, w_ih, b_ih = fused
        C = x.shape[2]
        kx = tc_fused_kx(plan, C, cell, H)
        if not kx:
            raise ValueError("the tc recurrence does not fuse a projection of width {} "
                             "at U = {}, {} rows".format(C, plan["U"], plan["rows"]))

    def ptr(t):
        return None if t is None else t.data_ptr()

    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = _load_tc().birnn_tc_rec_launch(
            _CELL_CODE[cell], ptr(xg), ptr(x), ptr(w_ih), ptr(b_ih), w_hh.data_ptr(),
            b_hh.data_ptr(), out.data_ptr(), hn.data_ptr(), L, N, H, C, plan["U"],
            plan["MR"], plan["WN"], kx, stream, dev.index)
    _launched("birnn_tc recurrence", rc, layer)
    return out, hn


def tc_occupancy(H: int, cell: str, plan: dict, kx: int = 0, device=None) -> int:
    """Clusters of the bf16 recurrence at ``plan``'s geometry (and a fused
    projection of k extent ``kx``) that the card holds at once
    (cudaOccupancyMaxActiveClusters for the kernel, block and shared memory
    that ``tc_recurrence`` launches); launches nothing."""
    device = torch.device(device or "cuda")
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _load_tc().birnn_tc_rec_occupancy(
            _CELL_CODE[cell], H, plan["U"], plan["MR"], plan["WN"], kx,
            ctypes.addressof(clusters), ctypes.addressof(smem),
            device.index if device.index is not None else torch.cuda.current_device())
    if rc != 0:
        raise RuntimeError("birnn_tc_rec_occupancy failed: cudaError {}".format(rc))
    want = tc_smem(H, cell, plan["U"], plan["rows"], kx)
    if smem.value != want:
        raise RuntimeError("shared memory {} != the plan's {}".format(smem.value, want))
    return clusters.value


def simt_projection(x: torch.Tensor, w_ih: torch.Tensor, b_ih: torch.Tensor,
                    b_hh: torch.Tensor, cell: str = "gru", xg=None,
                    layer: bool = False) -> torch.Tensor:
    """Phase (a) of the simt design, one layer: ``tc_projection``'s function
    in exact f32 on x (M, K) and w_ih (2, K, G) in the operand type, by
    K4's projection kernel (``bigru_train.cu``'s ``k4_proj_launch``)."""
    M, K = x.shape
    G = w_ih.shape[2]
    ng = n_gates(cell)
    if xg is None:
        xg = torch.empty((2, M, G), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = bigru_vjp._load().k4_proj_launch(
            DTYPE_CODE[x.dtype], x.data_ptr(), w_ih.data_ptr(), b_ih.data_ptr(),
            b_hh.data_ptr(), xg.data_ptr(), M, K, G // ng, ng, stream, x.device.index)
    _launched("k4_proj_launch", rc, layer)
    if x.dtype == torch.float32:
        bigru_vjp.f32_products["projection"] += 1
    return xg


def simt_recurrence(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    L: int, N: int, plan: dict, cell: str = "gru", out=None, hn=None,
                    layer: bool = False):
    """Phase (b) of the simt design, one layer, both directions, zero h0
    (and c0): xg (2, L*N, G) f32, w_hh (2, H, G) and out (L, N, 2H) in the
    operand type, b_hh (2, G) f32 -> out, hn (2, N, H) f32; the cluster
    geometry (U, rows) of ``k1_plan``. bf16 operands run the training
    forward's recurrence at its own geometry (``k45_plan``'s simt U and
    forward rows), whatever ``plan`` holds."""
    H = w_hh.shape[1]
    if w_hh.dtype == torch.bfloat16:
        geo = bigru_vjp.simt_plan(H, n_gates(cell))
        plan = {"U": geo["U"], "rows": geo["rows_fwd"]}
    if out is None:
        out = torch.empty((L, N, 2 * H), dtype=w_hh.dtype, device=xg.device)
    if hn is None:
        hn = torch.empty((2, N, H), dtype=torch.float32, device=xg.device)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    with torch.cuda.device(xg.device):
        rc = _load_simt().birnn_simt_rec_launch(
            _CELL_CODE[cell], DTYPE_CODE[w_hh.dtype], xg.data_ptr(), w_hh.data_ptr(),
            b_hh.data_ptr(), out.data_ptr(), hn.data_ptr(), L, N, H, plan["U"],
            plan["rows"], stream, xg.device.index)
    _launched("birnn_simt recurrence", rc, layer)
    return out, hn


def simt_occupancy(H: int, cell: str, plan: dict, device=None) -> int:
    """Clusters of the f32 recurrence at ``plan``'s geometry that the card
    holds at once (cudaOccupancyMaxActiveClusters for the kernel, block and
    shared memory that ``simt_recurrence`` launches); launches nothing."""
    device = torch.device(device or "cuda")
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _load_simt().birnn_simt_rec_occupancy(
            _CELL_CODE[cell], H, plan["U"], plan["rows"],
            ctypes.addressof(clusters), ctypes.addressof(smem),
            device.index if device.index is not None else torch.cuda.current_device())
    if rc != 0:
        raise RuntimeError("birnn_simt_rec_occupancy failed: cudaError {}".format(rc))
    if smem.value != plan["smem"]:
        raise RuntimeError("shared memory {} != the plan's {}".format(smem.value, plan["smem"]))
    return clusters.value


def rows_recurrence(xg: torch.Tensor, w_hh: torch.Tensor, b_hh: torch.Tensor,
                    L: int, N: int, plan: dict, cell: str = "gru", out=None, hn=None,
                    layer: bool = False):
    """Phase (b) of the rows design, one layer, both directions, zero h0
    (and c0): xg (2, L*N, G) f32, w_hh (2, H, G) f32, b_hh (2, G) f32 -> out
    (L, N, 2H) f32, hn (2, N, H) f32 (the LSTM's c between steps); at the
    geometry (rows, stages) of ``plan``. Raises, naming the shape, on a
    failed build or launch."""
    H = w_hh.shape[1]
    if out is None:
        out = torch.empty((L, N, 2 * H), dtype=torch.float32, device=xg.device)
    if hn is None:
        hn = torch.empty((2, N, H), dtype=torch.float32, device=xg.device)
    stream = torch.cuda.current_stream(xg.device).cuda_stream
    with torch.cuda.device(xg.device):
        rc = _load_rows().birnn_rows_rec_launch(
            _CELL_CODE[cell], xg.data_ptr(), w_hh.data_ptr(), b_hh.data_ptr(),
            out.data_ptr(), hn.data_ptr(), L, N, H, plan["rows"], plan["stages"], stream,
            xg.device.index)
    _launched("birnn_rows recurrence ({}, H {}, {} rows, R {}, {} slots)".format(
        cell, H, N, plan["rows"], plan["stages"]), rc, layer)
    return out, hn


def rows_occupancy(H: int, cell: str, plan: dict, device=None) -> dict:
    """The rows recurrence at ``plan``'s geometry: {"ctas_an_sm"
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor for the kernel, block
    and shared memory that ``rows_recurrence`` launches), "registers" (a
    thread)}; launches nothing."""
    device = torch.device(device or "cuda")
    ctas, regs, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = _load_rows().birnn_rows_rec_occupancy(
            _CELL_CODE[cell], H, plan["rows"], plan["stages"], ctypes.addressof(ctas),
            ctypes.addressof(regs), ctypes.addressof(smem),
            device.index if device.index is not None else torch.cuda.current_device())
    if rc != 0:
        raise RuntimeError("birnn_rows_rec_occupancy failed: cudaError {}".format(rc))
    if smem.value != plan["smem"]:
        raise RuntimeError("shared memory {} != the plan's {}".format(smem.value, plan["smem"]))
    return {"ctas_an_sm": ctas.value, "registers": regs.value}


def _run_layer(plan, ly, x, cell, xg, out, hn, layer=False):
    """One layer in the tc, simt or rows design: the projection of x (L, N, C)
    into xg, then the recurrence into out and hn; a tc layer whose width
    ``tc_fused_kx`` takes runs both in the recurrence kernel (xg unused)."""
    L, N, C = x.shape
    wih, bih, whh, bhh = ly
    if plan["design"] == "tc":
        if tc_fused_kx(plan, C, cell, whh.shape[1]):
            tc_recurrence(None, whh, bhh, L, N, plan, cell, out, hn, layer, (x, wih, bih))
        else:
            tc_projection(x.view(L * N, C), wih, bih, bhh, cell, xg, layer)
            tc_recurrence(xg, whh, bhh, L, N, plan, cell, out, hn, layer)
    else:
        simt_projection(x.view(L * N, C), wih, bih, bhh, cell, xg, layer)
        rec = rows_recurrence if plan["design"] == "rows" else simt_recurrence
        rec(xg, whh, bhh, L, N, plan, cell, out, hn, layer)


def _xg_for(plan, widths, L, N, H, cell, device):
    """The f32 projection buffer (2, L*N, G) that layers of input widths
    ``widths`` need, or None when every one fuses its projection (tc)."""
    if plan["design"] == "tc" and all(tc_fused_kx(plan, c, cell, H) for c in widths):
        return None
    return torch.empty((2, L * N, n_gates(cell) * H), dtype=torch.float32, device=device)


def _stack_layers(layers, x, compute_dtype, cell, H, plan):
    """K1's tc, simt and rows designs: per layer the projection, then the
    recurrence; one xg for all layers, the layers' outputs alternating
    between two buffers, the last is ``out``."""
    global launches
    L, N, C0 = x.shape
    NL = len(layers)
    bufs = [torch.empty((L, N, 2 * H), dtype=compute_dtype, device=x.device)
            for _ in range(min(NL, 2))]
    hn = torch.empty((2 * NL, N, H), dtype=torch.float32, device=x.device)
    # the input projection of one layer, both directions, in f32
    xg = _xg_for(plan, [C0] + [2 * H] * (NL - 1), L, N, H, cell, x.device)
    inp = x
    for li, ly in enumerate(layers):
        out = bufs[(NL - 1 - li) % 2]
        _run_layer(plan, ly, inp, cell, xg, out, hn[2 * li:2 * li + 2])
        inp = out
    launches += 1
    design_calls[plan["design"]] += 1
    return inp, hn


def _ptr_arrays(layers):
    """Host arrays of the layers' device pointers: w_ih, b_ih, w_hh, b_hh."""
    return [(ctypes.c_uint64 * len(layers))(*[ly[i].data_ptr() for ly in layers])
            for i in range(4)]


def birnn_stack(layers, x: torch.Tensor, compute_dtype=torch.float32,
                cell: str = "gru", design=None):
    """Whole-stack BiGRU or BiLSTM, zero h0 (and c0): kernel K1 on CUDA, the
    plain version on CPU.

    See the module docstring for shapes and for ``k1_plan``, which picks the
    design (``design`` forces simt or rows on an fp32 shape it takes). No
    fallback: a CUDA input that the chosen design cannot take, or a failed
    build or launch, raises."""
    H = _check(layers, x, compute_dtype, cell)
    if x.device.type == "cpu":
        return birnn_stack_plain(layers, x, compute_dtype, cell)
    if x.device.type != "cuda":
        raise ValueError("birnn_stack runs on cuda or cpu, not {}".format(
            x.device.type))
    if any(t.data_ptr() % 16 for ly in layers for t in ly) or x.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    plan = k1_plan(H, cell, compute_dtype, x.shape[1], design)
    if plan["design"] == "l2":
        return _stack_l2(layers, x, compute_dtype, cell, H)
    return _stack_layers(layers, x, compute_dtype, cell, H, plan)


def bigru_layer_tm_plain(layer, x: torch.Tensor, compute_dtype=torch.float32,
                         cell: str = "gru") -> torch.Tensor:
    """The plain version of K2 on any device: same contract as
    bigru_layer_tm."""
    global layer_plain_calls
    _check([layer], x, compute_dtype, cell)
    layer_plain_calls += 1
    return birnn_tm([layer], x, None, compute_dtype, cell)[0]


def _layer_l2(layer, x, compute_dtype, cell, H):
    """K2 in the l2 design: ``bigru_stack.cu``'s ``bigru_layer_launch``, the
    two directions in separate blocks."""
    global layer_cuda_launches
    L, N, C = x.shape
    if H % 4 != 0 or H // 4 > THREADS:
        raise ValueError("kernel takes H % 4 == 0 and H <= 1024 (H={})".format(H))
    props = torch.cuda.get_device_properties(x.device)
    # two blocks per row tile (one per direction): size the tiles for half
    # the SMs
    r, ty = tile_shape(N, H, max(1, props.multi_processor_count // 2))
    while r > 1 and _shared_bytes(C, H, ty * r, cell) > SMEM_LIMIT:
        r //= 2
    if _shared_bytes(C, H, ty * r, cell) > SMEM_LIMIT:
        raise ValueError("tile does not fit in shared memory (C={}, H={})"
                         .format(C, H))
    lib = _load()
    out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=x.device)
    wih, bih, whh, bhh = layer
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = lib.bigru_layer_launch(
            _CELL_CODE[cell], DTYPE_CODE[compute_dtype], x.data_ptr(),
            out.data_ptr(), wih.data_ptr(), bih.data_ptr(), whh.data_ptr(),
            bhh.data_ptr(), L, N, C, H, r, ty, stream, x.device.index)
    _launched("bigru_layer launch", rc, True)
    return out


def bigru_layer_tm(layer, x: torch.Tensor, compute_dtype=torch.float32,
                   cell: str = "gru", design=None) -> torch.Tensor:
    """One bidirectional GRU or LSTM layer, zero h0 (and c0): kernel K2 on
    CUDA, the plain version on CPU. layer: (w_ih (2, C, G), b_ih (2, G) f32,
    w_hh (2, H, G), b_hh (2, G) f32), weights in compute_dtype; x (L, N, C)
    contiguous in compute_dtype -> out (L, N, 2H) in compute_dtype, both
    directions in time order. ``k1_plan`` picks the design from the rows
    too, as for K1 (``design`` forces simt or rows in fp32): simt and rows
    are two CUDA launches, tc two or (a fused projection, C <= 64) one, l2
    one."""
    global layer_launches
    H = _check([layer], x, compute_dtype, cell)
    if x.device.type == "cpu":
        return bigru_layer_tm_plain(layer, x, compute_dtype, cell)
    if x.device.type != "cuda":
        raise ValueError("bigru_layer_tm runs on cuda or cpu, not {}".format(
            x.device.type))
    if any(t.data_ptr() % 16 for t in layer) or x.data_ptr() % 16:
        raise ValueError("kernel operands must be 16-byte aligned")
    plan = k1_plan(H, cell, compute_dtype, x.shape[1], design)
    if plan["design"] == "l2":
        out = _layer_l2(layer, x, compute_dtype, cell, H)
    else:
        L, N, C = x.shape
        out = torch.empty((L, N, 2 * H), dtype=compute_dtype, device=x.device)
        xg = _xg_for(plan, [C], L, N, H, cell, x.device)
        hn = torch.empty((2, N, H), dtype=torch.float32, device=x.device)  # scratch
        _run_layer(plan, layer, x, cell, xg, out, hn, layer=True)
    layer_launches += 1
    layer_design_calls[plan["design"]] += 1
    return out


def birnn_layers(layers, x: torch.Tensor, compute_dtype=torch.float32,
                 cell: str = "gru", design=None):
    """The stack one layer per launch (K2 on CUDA, its plain version on
    CPU): the contract of birnn_stack, out (L, N, 2H) in compute_dtype and
    h_n (2*NL, N, H) f32 rebuilt from the outputs."""
    h_ns = []
    for ly in layers:
        x = bigru_layer_tm(ly, x, compute_dtype, cell, design)
        H = x.shape[2] // 2
        h_ns += [x[-1, :, :H].float(), x[0, :, H:].float()]
    return x, torch.stack(h_ns)


def bigru_layer(layer, x: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """One bidirectional GRU layer, batch-major: x (B, L, C) -> (B, L, 2H)
    f32 (``bigru_layer_pallas :423``)."""
    x_tm = x.transpose(0, 1).to(compute_dtype).contiguous()
    return bigru_layer_tm(layer, x_tm, compute_dtype, "gru").transpose(0, 1).float()


def stack_flops(L: int, N: int, C0: int, H: int, NL: int, cell: str = "gru") -> int:
    """Matrix FLOPs of the stack: per row, layer and direction, L steps of
    2*(Cin + H)*G (the input projection and the recurrent product)."""
    total = 0
    for li in range(NL):
        cin = C0 if li == 0 else 2 * H
        total += 2 * L * 2 * (cin + H) * n_gates(cell) * H
    return total * N
