"""Kernel K3: the whole transencoder2s encoder plus the mean over positions.

Counterpart of ``ccsmeth_tpu/ops/transenc_pallas.py`` (``_make_encoder_kernel
:144``, launched by ``_encoder_call :335``, entry ``encoder_pooled_pallas
:393``). The kernel sources are ``csrc/transenc_simt.cu``,
``csrc/transenc_tc.cu`` and ``csrc/transenc_encoder.cu``, one a design
(below); each header says what bounds it on an H100 and what its design does
about that.

``encoder_pooled(stacked, x, compute_dtype, nhead)`` takes the weight layout
of the JAX package's ``_stack_layer_params`` (``transenc_pallas.py:74-92``):

    x       (N, L, D)       operand type (float32 or bfloat16), contiguous
    stacked {wqkv (NL, D, 3D), wo (NL, D, D), w1 (NL, D, FF), w2 (NL, FF, D)
             in the operand type, columns of wqkv q | k | v;
             bqkv (NL, 3D), bo, b1, b2, ln1s, ln1b, ln2s, ln2b f32}
    ->      (N, D) f32: NL post-LayerNorm layers, then the mean over L

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the plain
version, ``encoder_pooled_plain``: the JAX package's ``_encoder`` + mean
(``models/transenc.py:96-126``) in PyTorch, rounding every product operand to
the operand type as the kernel does. ``launches`` and ``plain_calls`` count
the two; ``cuda_launches`` counts the CUDA launches (one a call), where each
is made. The kernel is compiled with ``nvcc`` at first use (``nvcc.py``).

K3 has three designs, and ``k3_plan`` is the shape rule that picks one for
a CUDA call (``design_calls`` counts the calls each design took):

- ``simt`` (``csrc/transenc_simt.cu``), fp32 on the CUDA cores (exact f32
  FMAs, no TF32): 64 rows a CTA (S = 64 // L samples), 8 consumer warps
  and one producer thread that streams every product's weight slabs
  (``SIMT_BK`` k rows, one TMA box each) through a ring of ``SIMT_STAGES``
  slots on mbarriers, in the consumers' order across products and layers;
  8 x TN outputs a consumer thread, its weights read a float4 at a time;
  one head's q | k | v at a time, the feed-forward in 192-column chunks of
  its hidden layer. It takes fp32 with L <= 32, D a multiple of 16 up to
  256, a head width that is a multiple of 4 up to 64, FF a multiple of 16;
- ``tc`` (``csrc/transenc_tc.cu``), bf16 on Hopper's wgmma fed by TMA: 64
  rows a CTA (S = 64 // L samples), one producer warp streaming every
  product's weight tiles (64 k rows x D / 2 columns, as stored) through one
  ring of ``TC_STAGES`` slots on mbarriers, in the consumers' order, across
  products and layers; two consumer warpgroups, each owning D / 2 columns
  of the f32 residual in its wgmma accumulator registers; attention on
  wgmma too, a head one 64-column block. It
  takes bf16 with L <= 32, D = 128 or 256 (a warpgroup's residual is one
  wgmma tile of D / 2 columns), FF a multiple of D (the hidden layer's
  chunks split evenly between the warpgroups), heads of width 64, and
  ``tc_smem`` within 227 KB;
- ``l2`` (``csrc/transenc_encoder.cu``), the first f32-FMA kernel (42 rows
  a CTA at L = 21, each warp reading the weights from L2): every shape that
  the other two refuse, in fp32 or bf16 (x and the weights in the operand
  type). Its own limits (L <= 32, D and FF multiples of 4) raise.
"""

from __future__ import annotations

import ctypes
import threading

import torch
import torch.nn.functional as F

from . import nvcc
from .kernel_args import DTYPE_CODE, SMEM_LIMIT

SRC = "transenc_encoder.cu"  # K3's l2 design
TC_SRC = "transenc_tc.cu"  # K3's bf16 tensor-core design
SIMT_SRC = "transenc_simt.cu"  # K3's fp32 design
# the kernel's argument order
NAMES = ("wqkv", "wo", "w1", "w2", "bqkv", "bo", "b1", "b2",
         "ln1s", "ln1b", "ln2s", "ln2b")
WARPS = 8  # ENC_WARPS in csrc/transenc_encoder.cu
LMAX = 32  # ENC_LMAX
# TE_* in csrc/transenc_tc.cu: rows a CTA, k rows a ring tile, threads (two
# consumer warpgroups and a producer warp), ring slots
TC_ROWS, TC_BK, TC_THREADS, TC_STAGES = 64, 64, 288, 4
# TS_* in csrc/transenc_simt.cu: threads (8 consumer warps and a producer
# warp), consumer threads, rows a CTA, the rows' k-major stride, ring slab k
# rows (D and FF are multiples of it), ring slots, a slot's row width, FF
# hidden columns a chunk, the largest D and head width
SIMT_THREADS, SIMT_CONSUMERS, SIMT_ROWS, SIMT_LD = 288, 256, 64, 68
SIMT_BK, SIMT_STAGES, SIMT_WMAX = 16, 2, 256
SIMT_FC, SIMT_DMAX, SIMT_HDMAX = 192, 256, 64

launches = 0  # kernel launches since the caller last set it to 0
cuda_launches = 0  # K3's CUDA launches, counted at each launch
plain_calls = 0  # plain-version runs (CPU tensors, or encoder_pooled_plain)
design_calls = {"simt": 0, "tc": 0, "l2": 0}  # encoder_pooled's CUDA calls by design

_lib = None
_tc_lib = None
_simt_lib = None
_lock = threading.Lock()


def build(src: str = SRC) -> str:
    """Compile ``csrc/<src>`` (``SRC``, ``TC_SRC`` or ``SIMT_SRC``) if its
    library is missing; returns the library path. Raises with nvcc's output
    when the build fails."""
    return nvcc.build(src)[0]


def bind_tc(path: str):
    """The library at ``path``, a build of ``csrc/transenc_tc.cu``, with its
    entries' argument types set."""
    lib = ctypes.CDLL(path)
    fn = lib.transenc_tc_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_int])
    occ = lib.transenc_tc_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] * 2 + [ctypes.c_int]
    return lib


def _load_tc():
    global _tc_lib
    with _lock:
        if _tc_lib is None:
            _tc_lib = bind_tc(build(TC_SRC))
    return _tc_lib


def bind_simt(path: str):
    """The library at ``path``, a build of ``csrc/transenc_simt.cu``, with
    its entries' argument types set."""
    lib = ctypes.CDLL(path)
    fn = lib.transenc_simt_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p, ctypes.c_int])
    occ = lib.transenc_simt_occupancy
    occ.restype = ctypes.c_int
    occ.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)] * 3 + [ctypes.c_int]
    return lib


def _load_simt():
    global _simt_lib
    with _lock:
        if _simt_lib is None:
            _simt_lib = bind_simt(build(SIMT_SRC))
    return _simt_lib


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.transenc_encoder_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 14
                           + [ctypes.c_int] * 9 + [ctypes.c_void_p, ctypes.c_int])
            _lib = lib
    return _lib


def stack_layers(layers, compute_dtype=torch.float32, device=None) -> dict:
    """The JAX package's per-layer params ({wq, bq, wk, bk, wv, bv, wo, bo,
    lin1 {w, b}, lin2 {w, b}, ln1 {scale, bias}, ln2}, input-major; numpy
    arrays or tensors) -> the kernel's stacked dict, weights in compute_dtype
    and the rest f32 (``_stack_layer_params``)."""
    def t(a):
        return torch.as_tensor(a, device=device).float()

    def stack(fn, dt=torch.float32):
        return torch.stack([fn(lp) for lp in layers]).to(dt).contiguous()

    cd = compute_dtype
    return {
        "wqkv": stack(lambda lp: torch.cat([t(lp["wq"]), t(lp["wk"]), t(lp["wv"])], 1), cd),
        "bqkv": stack(lambda lp: torch.cat([t(lp["bq"]), t(lp["bk"]), t(lp["bv"])])),
        "wo": stack(lambda lp: t(lp["wo"]), cd),
        "bo": stack(lambda lp: t(lp["bo"])),
        "w1": stack(lambda lp: t(lp["lin1"]["w"]), cd),
        "b1": stack(lambda lp: t(lp["lin1"]["b"])),
        "w2": stack(lambda lp: t(lp["lin2"]["w"]), cd),
        "b2": stack(lambda lp: t(lp["lin2"]["b"])),
        "ln1s": stack(lambda lp: t(lp["ln1"]["scale"])),
        "ln1b": stack(lambda lp: t(lp["ln1"]["bias"])),
        "ln2s": stack(lambda lp: t(lp["ln2"]["scale"])),
        "ln2b": stack(lambda lp: t(lp["ln2"]["bias"])),
    }


def _check(stacked, x: torch.Tensor, compute_dtype, nhead: int):
    """Raise on anything the kernel does not take; returns (NL, L, D, FF)."""
    if compute_dtype not in DTYPE_CODE:
        raise ValueError("compute_dtype must be float32 or bfloat16")
    if x.dim() != 3:
        raise ValueError("x must be (N, L, D), got {}".format(tuple(x.shape)))
    if x.dtype != compute_dtype:
        raise TypeError("x is {}, expected {}".format(x.dtype, compute_dtype))
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    _N, L, D = x.shape
    NL, FF = stacked["w1"].shape[0], stacked["w1"].shape[2]
    if nhead < 1 or D % nhead != 0:
        raise ValueError("d_model {} is not a multiple of nhead {}".format(D, nhead))
    want = {"wqkv": (NL, D, 3 * D), "wo": (NL, D, D), "w1": (NL, D, FF),
            "w2": (NL, FF, D), "bqkv": (NL, 3 * D), "bo": (NL, D),
            "b1": (NL, FF), "b2": (NL, D), "ln1s": (NL, D), "ln1b": (NL, D),
            "ln2s": (NL, D), "ln2b": (NL, D)}
    for name in NAMES:
        t = stacked[name]
        dt = compute_dtype if name.startswith("w") else torch.float32
        if tuple(t.shape) != want[name] or t.dtype != dt:
            raise ValueError("{}: got {} {}, expected {} {}".format(
                name, tuple(t.shape), t.dtype, want[name], dt))
        if t.device != x.device:
            raise ValueError("{} is on {}, x on {}".format(name, t.device, x.device))
        if not t.is_contiguous():
            raise ValueError("{} must be contiguous".format(name))
    return NL, L, D, FF


def encoder_pooled_plain(stacked, x: torch.Tensor, compute_dtype=torch.float32,
                         nhead: int = 4) -> torch.Tensor:
    """The plain version of K3 on any device: same contract as
    encoder_pooled. Every product operand is rounded to compute_dtype (x, the
    weights, q, k, v, the attention weights, the context, the hidden layer);
    products sum in f32; softmax, LayerNorm, residuals and the mean are f32."""
    global plain_calls
    NL, L, D, _FF = _check(stacked, x, compute_dtype, nhead)
    plain_calls += 1
    N = x.shape[0]
    HD = D // nhead

    def op(t):
        return t.to(compute_dtype).float()

    h = x.float().reshape(N * L, D)
    for li in range(NL):
        def w(name):
            return op(stacked[name][li])

        qkv = op(op(h) @ w("wqkv") + stacked["bqkv"][li])
        q, k, v = (qkv[:, i * D:(i + 1) * D].reshape(N, L, nhead, HD).transpose(1, 2)
                   for i in range(3))
        p = torch.softmax((q @ k.transpose(2, 3)) * (1.0 / HD ** 0.5), dim=-1)
        ctx = (op(p) @ v).transpose(1, 2).reshape(N * L, D)
        a = op(ctx) @ w("wo") + stacked["bo"][li]
        h = F.layer_norm(h + a, (D,), stacked["ln1s"][li], stacked["ln1b"][li], 1e-5)
        f = torch.relu(op(h) @ w("w1") + stacked["b1"][li])
        f = op(f) @ w("w2") + stacked["b2"][li]
        h = F.layer_norm(h + f, (D,), stacked["ln2s"][li], stacked["ln2b"][li], 1e-5)
    return h.reshape(N, L, D).mean(dim=1)


def tile_shape(L: int, D: int, FF: int) -> tuple[int, int, int]:
    """(S samples per block, R rows per warp, shared row stride ld): the most
    samples whose rows fit 8 warps of at most 8 rows and whose f32 tiles
    (x: D columns; q|k|v or the hidden layer: max(3D, FF) columns) fit the
    block's shared memory."""
    for S in range(WARPS * 8 // L, 0, -1):
        R = next(r for r in (2, 4, 6, 8) if WARPS * r >= S * L)
        ld = WARPS * R + (4 if R % 4 == 0 else 2)
        if (D + max(3 * D, FF)) * ld * 4 <= SMEM_LIMIT:
            return S, R, ld
    raise ValueError("one sample does not fit in shared memory (L={}, D={}, "
                     "FF={})".format(L, D, FF))


def simt_smem(L: int, D: int, FF: int, nhead: int) -> int:
    """Shared memory a CTA of the simt design takes, in bytes: x and the
    context (D columns each) and one head's q | k | v or a chunk of the
    hidden layer (max(3 HD, SIMT_FC) columns), k-major with stride SIMT_LD;
    the ring (SIMT_STAGES slots of SIMT_BK x SIMT_WMAX); LayerNorm's partial
    sums (2 x SIMT_CONSUMERS) and parameters (3 x SIMT_DMAX); the ring's 2
    SIMT_STAGES mbarriers. ``transenc_simt_smem`` in the source."""
    hb = max(3 * (D // nhead), SIMT_FC)
    return ((2 * D + hb) * SIMT_LD + SIMT_STAGES * SIMT_BK * SIMT_WMAX + 2 * SIMT_CONSUMERS
            + 3 * SIMT_DMAX) * 4 + 16 * SIMT_STAGES


def _why_not_simt(L, D, FF, nhead):
    """Why the simt design does not take an fp32 shape, or None."""
    if L > LMAX:
        return "L > {}".format(LMAX)
    if D % SIMT_BK or D > SIMT_DMAX or FF % SIMT_BK:
        return "D or FF not a multiple of {}, or D > {}".format(SIMT_BK, SIMT_DMAX)
    hd = D // nhead if nhead >= 1 and D % nhead == 0 else 0
    if hd < 4 or hd % 4 or hd > SIMT_HDMAX:
        return "head width {} not a multiple of 4 up to {}".format(hd, SIMT_HDMAX)
    smem = simt_smem(L, D, FF, nhead)
    if smem > SMEM_LIMIT:
        return "{} bytes of shared memory a CTA".format(smem)
    return None


def tc_smem(D: int, FF: int) -> int:
    """Shared memory a CTA of the tc design takes, in bytes: the ring
    (TC_STAGES tiles of TC_BK k rows x D / 2 bf16 columns), the x operand
    (64 x D bf16), q | k | v or the hidden layer (64 x max(3D, FF) bf16),
    LayerNorm's row sums (2 x 2 x 64 f32) and the 2 TC_STAGES mbarriers.
    ``transenc_tc_smem`` in the source."""
    return (TC_STAGES * TC_BK * D + TC_ROWS * (D + max(3 * D, FF)) * 2 + 4 * TC_ROWS * 4
            + 16 * TC_STAGES)


def _why_not_tc(L, D, FF, nhead):
    """Why the tc design does not take a bf16 shape, or None."""
    if L > LMAX:
        return "L > {}".format(LMAX)
    if D not in (128, 256):
        return "D {} is not 128 or 256 (D / 2 columns a warpgroup: one wgmma tile " \
               "of 64 or 128)".format(D)
    if FF % D:
        return "FF {} not a multiple of D".format(FF)
    if nhead < 1 or D != 64 * nhead:
        return "head width {} is not 64".format(D / nhead if nhead >= 1 else None)
    smem = tc_smem(D, FF)
    if smem > SMEM_LIMIT:
        return "{} bytes of shared memory a CTA".format(smem)
    return None


def k3_plan(L: int, D: int, FF: int, nhead: int, compute_dtype=torch.bfloat16) -> dict:
    """The shape rule that picks K3's design for a CUDA call (module
    docstring). Returns {"design": "tc", "S" (samples a CTA), "smem" (bytes
    a CTA)}, {"design": "simt", "S", "smem", "why"} or {"design": "l2",
    "why"}; "why" says why not tc (and, for l2 in fp32, why not simt)."""
    if compute_dtype != torch.bfloat16:
        why = "fp32 keeps exact f32 arithmetic"
        no_simt = _why_not_simt(L, D, FF, nhead)
        if no_simt is None:
            return {"design": "simt", "S": SIMT_ROWS // L,
                    "smem": simt_smem(L, D, FF, nhead), "why": why}
        return {"design": "l2", "why": "{}; simt: {}".format(why, no_simt)}
    why = _why_not_tc(L, D, FF, nhead)
    if why is None:
        return {"design": "tc", "S": TC_ROWS // L, "smem": tc_smem(D, FF)}
    return {"design": "l2", "why": why}


def tc_occupancy(D: int, FF: int, device: int = 0) -> int:
    """CTAs of the tc design at (D, FF) that an SM holds at once
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor); builds the kernel,
    launches nothing."""
    lib = _load_tc()
    n, smem = ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.transenc_tc_occupancy(D, FF, ctypes.byref(n), ctypes.byref(smem), device)
    if rc != 0:
        raise RuntimeError("transenc_tc_occupancy failed: cudaError {}".format(rc))
    return n.value


def simt_occupancy(L: int, D: int, FF: int, nhead: int, device: int = 0) -> dict:
    """The simt design at (L, D, FF, nhead): its registers a thread, the CTAs
    an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and
    its shared memory a CTA; builds the kernel, launches nothing."""
    lib = _load_simt()
    n, regs, smem = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    rc = lib.transenc_simt_occupancy(L, D, nhead, FF, ctypes.byref(n), ctypes.byref(regs),
                                     ctypes.byref(smem), device)
    if rc != 0:
        raise RuntimeError("transenc_simt_occupancy failed: cudaError {}".format(rc))
    return {"ctas_an_sm": n.value, "registers": regs.value, "smem": smem.value}


def _launch(design, plan, stacked, x, compute_dtype, nhead, dims):
    """One CUDA launch of K3 in ``design`` (x and the weights checked by
    ``_check``); counts it. Raises when the launch fails."""
    global launches, cuda_launches
    NL, L, D, FF = dims
    if x.data_ptr() % 16 or any(stacked[n].data_ptr() % 16 for n in NAMES):
        raise ValueError("kernel operands must be 16-byte aligned")
    N = x.shape[0]
    out = torch.empty((N, D), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [stacked[n].data_ptr() for n in NAMES]
    if design == "tc":
        with torch.cuda.device(x.device):
            rc = _load_tc().transenc_tc_launch(
                x.data_ptr(), out.data_ptr(), *ptrs, N, L, D, nhead, FF, NL, plan["S"],
                stream, x.device.index)
    elif design == "simt":
        with torch.cuda.device(x.device):
            rc = _load_simt().transenc_simt_launch(
                x.data_ptr(), out.data_ptr(), *ptrs, N, L, D, nhead, FF, NL, plan["S"],
                stream, x.device.index)
    else:
        if L > LMAX or D % 4 != 0 or FF % 4 != 0:
            raise ValueError("kernel takes L <= 32 and D, FF multiples of 4 "
                             "(L={}, D={}, FF={})".format(L, D, FF))
        S, R, ld = tile_shape(L, D, FF)
        lib = _load()
        with torch.cuda.device(x.device):
            rc = lib.transenc_encoder_launch(
                DTYPE_CODE[compute_dtype], x.data_ptr(), out.data_ptr(), *ptrs,
                N, L, D, nhead, FF, NL, S, R, ld, stream, x.device.index)
    if rc != 0:
        raise RuntimeError("transenc_{} launch failed: cudaError {}".format(design, rc))
    # every design is one CUDA launch
    cuda_launches += 1
    launches += 1
    design_calls[design] += 1
    return out


def _encoder_l2(stacked, x: torch.Tensor, compute_dtype=torch.float32,
                nhead: int = 4) -> torch.Tensor:
    """The l2 design on a CUDA input, whatever ``k3_plan`` would pick: the
    kept first kernel, called directly to hold it against the plain
    version."""
    dims = _check(stacked, x, compute_dtype, nhead)
    if x.device.type != "cuda":
        raise ValueError("the l2 design runs on cuda, not {}".format(x.device.type))
    return _launch("l2", None, stacked, x, compute_dtype, nhead, dims)


def encoder_pooled(stacked, x: torch.Tensor, compute_dtype=torch.float32,
                   nhead: int = 4) -> torch.Tensor:
    """The encoder stack and the mean over positions: kernel K3 on CUDA, the
    plain version on CPU. See the module docstring for shapes and for
    ``k3_plan``, which picks the design. No fallback: a CUDA input that the
    chosen design cannot take, or a failed build or launch, raises."""
    dims = _check(stacked, x, compute_dtype, nhead)
    if x.device.type == "cpu":
        return encoder_pooled_plain(stacked, x, compute_dtype, nhead)
    if x.device.type != "cuda":
        raise ValueError("encoder_pooled runs on cuda or cpu, not {}".format(
            x.device.type))
    _NL, L, D, FF = dims
    plan = k3_plan(L, D, FF, nhead, compute_dtype)
    return _launch(plan["design"], plan, stacked, x, compute_dtype, nhead, dims)


def encoder_flops(N: int, L: int, D: int, FF: int, NL: int) -> int:
    """Matrix FLOPs of the encoder: per sample and layer, the q|k|v product
    (2*L*D*3D), scores and context (2 * 2*L*L*D over all heads), the output
    projection (2*L*D*D) and the feed-forward pair (2 * 2*L*D*FF)."""
    per_layer = 2 * L * D * 3 * D + 2 * 2 * L * L * D + 2 * L * D * D + 2 * 2 * L * D * FF
    return per_layer * NL * N
