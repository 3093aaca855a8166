#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ccsmeth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; every failed check raises, so the script exits non-zero and
does not print its last line:

  1. the card: nvidia-smi name and power limit, torch's device name; TF32 off;
  2. build: every kernel source of the main paths is compiled from the
     checkout, one nvcc per source, all started together;
  3. kernels: kernel K1, GRU cell and LSTM cell, at the call_mods path's
     shapes (attbigru2s / attbilstm2s: NL=3, H=256, L=21, C=11; 2B = 1024
     and 16384 rows, fp32 and bf16) against its plain PyTorch version on the
     card, timed with CUDA events beside the plain version, cuDNN's nn.GRU /
     nn.LSTM and the card's bound, with the design that the wrapper's shape
     rule picked (fp32: simt, K4's projection kernel in
     ops/csrc/bigru_train.cu and the inference cluster recurrence of
     ops/csrc/birnn_simt.cu; bf16: the tensor-core design
     ops/csrc/birnn_tc.cu), its CUDA launches per call (two a layer), a rerun
     for bit-equal outputs and each phase's time (projections, recurrence,
     the recurrence on 1 and 15 row tiles); kernel K3
     (transencoder2s: 6 layers, d_model 256, 4 heads, FF 512, L=21; fp32:
     the simt design ops/csrc/transenc_simt.cu, bf16: the tensor-core design
     ops/csrc/transenc_tc.cu) at 2B = 1024 and 16384 samples, fp32 and
     bf16, beside its plain version, nn.TransformerEncoder + mean and the
     bound, with one CTA alone and one full wave timed at 1024 samples; and
     K3's l2 design (ops/csrc/transenc_encoder.cu, the first f32 kernel,
     the shapes the other two refuse; no model's path runs it) called
     directly, against the plain version;
     kernel K2 (one layer of K1's design: simt in fp32, tc in bf16), one
     layer of each cell at C = 11 and 512, 1024 rows, beside a one-layer
     cuDNN nn.GRU / nn.LSTM, with its phases; and the l2 design
     (ops/csrc/bigru_stack.cu, the shapes the other two refuse; no model's
     path runs it), K1's stack and K2's layer called directly, against the
     plain version;
  4. training kernels: K4 and K5 (ops/csrc/bigru_train.cu, GRU) and K6
     (ops/csrc/bilstm_train.cu, LSTM), both on ops/csrc/rnn_train_rec.cuh
     and ops/csrc/rnn_train_gemm.cuh, at the train paths' shapes (one layer,
     H=256, L=21, 2B = 1024 rows, C = 11 and 512, fp32 and bf16) against
     their plain versions, each backward run twice for bit-equal gradients,
     timed beside the plain versions, cuDNN's one-layer bidirectional
     nn.GRU / nn.LSTM (forward in training mode, and backward) and the
     bound, with the design that ``k45_plan`` picked, the CUDA launches a
     call (asserted) and each phase's time, each recurrence also on one row
     tile;
     kernel K1 at call_freqb's aggregate shape (NL 1, H 32, L 11, C 21,
     1,024 rows, fp32: simt with U = 32, one CTA a cluster), both cells,
     against its plain version, a rerun, cuDNN's nn.GRU / nn.LSTM(21, 32,
     bidirectional=True) and the bound;
     the training kernels again at the single-strand families' shapes (512
     rows, H 256, C = 11 and 512) and at the aggregate trainer's (NL 1, H
     32, C 21, L 11, 512 rows), fp32 and bf16, as above;
  5. model: full-width attbigru2s, attbilstm2s and transencoder2s with
     numpy-seeded weights, probs through K1 (K3) against probs through the
     plain version; transencoder2s once more with cuDNN's TF32 allowed, which
     must change nothing;
     model2s2: the embedded-kinetics families attbigru2s2 and attbilstm2s2,
     whose BiRNN input is C = 28 (52 with stds, sn and map): K1 at C = 28
     (fp32 and bf16) and 52 (fp32), K2's layer 0 at the same widths, and
     K4/K5 or K6 on layer 0 at C = 28 (fp32 and bf16), 1024 rows, each
     against its plain version beside cuDNN and the bound; then the seeded
     full-width model through K1, and through K2 under pallas_layer, against
     the plain version (probs to 1e-5 in fp32, 1e-2 in bf16);
  6. call_mods end to end, once per model: the port's CLI ``call_mods --mode
     align --device cuda [--model_type attbilstm2s|transencoder2s]`` on a
     simulated aligned BAM, in fp32 and bf16, with K1's (K3's) launch count
     read around the runs; then each RNN model once more in fp32 and bf16
     with ``--rnn_backend pallas_layer``, through K2 and not K1;
     call_freqb: call_mods on a ~33x simulated modbam (1,000 reads x 2 kb on
     60 kb), HP tags, count mode, then ``call_freqb --call_mode aggregate
     --device cuda`` with a seeded full-width aggregate model of each cell,
     its K1 launches read around the run, against the same run with
     ``--device cpu`` (raw outputs to 1e-5, rows within the aggregate
     allowance); the text path: ``extract`` on the call_mods input,
     ``call_mods`` on that features TSV (attbigru2s through K1,
     transencoder2s through K3) against ``--device cpu`` on its first rows,
     then ``call_freqt``;
     e2e2s2: ``call_mods --model_type attbigru2s2|attbilstm2s2`` in fp32
     and bf16 through K1, then under ``--rnn_backend pallas_layer`` through
     K2, the fp32 ML bytes against ``--device cpu``'s on the reads of the
     first 2,048 sites;
     flags (attbigru2s fp32): ``--h0_mode randn`` through the plain BiRNN
     once a batch and K1 never, its ML bytes against ``--device cpu``'s
     with the same --tseed; ``--num_processes 2`` as two runs whose records
     together equal the single run's; ``--profile_dir``, whose trace names
     K1's kernels;
  7. train end to end, once per model: the port's CLI ``train --device cuda``
     at its defaults (3x256, batch 512, dropout 0.5, Adam) on a separable
     synthetic features TSV, with the training kernels' and K1's launch
     counts, the training kernels' calls by design and CUDA launches read
     around the run (fp32: simt only), then a few bf16 steps (tc only);
     the same for attbigru2s2 and attbilstm2s2 (layer 0 at C = 28);
     determinism: two steps of attbigru2s in two fresh processes, every
     gradient and parameter diffed leaf by leaf (bit-equal), then the train
     path twice with the same seeds (equal losses, an equal sha256 of the
     final parameters), and the repair's cost a step (the fixed-order
     embedding backward against F.embedding's);
     train1s: ``trainm`` of attbigru1s and attbilstm1s at the defaults on
     single-strand rows (K4/K5 or K6 at 512 rows, K1 validating);
     train_te: ``train`` of transencoder2s in fp32 and bf16 (the encoder in
     PyTorch ops, K3 on validation only, TF32 off);
     transfer: attbigru2s with ``--train_transfer bf16`` and ``packed``, a
     batch unpacked on the card bit for bit the host's quantized values, the
     first step's loss against the fp32 wire's, the bytes of a row;
     aggr_train: the aggregate trainer's script for both cells (K4/K5, K6
     at H = 32), its best checkpoint through ``call_freqb --call_mode
     aggregate``; wrappers: ``call_hifi`` and ``align_hifi`` raise their
     named errors;
  8. profile: torch.profiler over a few full-width training steps of each
     model: the step's host and device ms, the device's idle share and the
     device time per kernel;
  9. one ``kernels`` JSON line, then the ``ok`` line.

It needs a CUDA device and the repository checkout around it; without either it
exits with an error and prints no result. It writes only under build/ of the
checkout.

    python3 chip_smoke.py --ab PARENT_TREE

times K1 and K2 (both cells) and K3 at the kernel phase's shapes, and K4,
K5 and K6 (forward and backward) at the train-kernel phase's, in four turns in one
process each: the checkout at PARENT_TREE (another commit, unpacked
under a git-ignored directory), this checkout, this checkout, the parent.
Each turn prints one JSON line; the last line compares the medians.

    python3 chip_smoke.py --only determinism,train1s,...

runs the card, the build and the named phases of the one-card training paths
(``main_only``), and prints no result line.
"""

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
SEED = 20261016

# attbigru2s / attbilstm2s at full width (ccsmeth_tpu/models/config.py
# defaults)
NL, H, L, C = 3, 256, 21, 11
MODELS = {"gru": "attbigru2s", "lstm": "attbilstm2s"}
TRANSENC = "transencoder2s"  # 6 layers, d_model 256, 4 heads, FF 512
ROWS = (1024, 16384)  # 2B for batch 512 (the CLI default) and batch 8192
REPS = 11
AB_REPS = 31  # --ab turns: more timings a median, for ratios near 1
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the simt design of K1 and K2 projects with K4's kernel
SIMT_PROJECTION = "ccsmeth_tpu_torch/ops/csrc/bigru_train.cu"
# K3's pooled output: fp32 1e-4 (six layers of products summed in another
# order than cuBLAS's); bf16 2e-2, since an f32 sum in another order can
# round a product operand to the neighbouring bf16 value and six layers
# carry that on
K3_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# E2E input: ~62k CpG sites on 330 HiFi-like 2 kb reads
E2E_READS, E2E_READ_LEN, E2E_REF_LEN = 330, 2000, 300_000
# train input: separable synthetic features, 32 steps of batch 512 an epoch
TRAIN_ROWS, VALID_ROWS, STEP_INTERVAL = 16384, 4096, 8
TRAIN_EPOCHS = {"gru": 2, "lstm": 2}
TRAIN2S2_EPOCHS = {"gru": 3, "lstm": 3}
BF16_TRAIN_ROWS = 2048
# call_freqb input: HiFi's usual ~30x coverage, 1,000 reads x 2 kb on a 60 kb
# contig (~33x); the aggregate model at its full width (ccsmeth_tpu/cli.py:
# 457-464 defaults): a 1-layer x 32 BiRNN over 11-site windows of 20
# histogram bins + the offset, batches of 1,024 windows
FREQ_READS, FREQ_READ_LEN, FREQ_REF_LEN = 1000, 2000, 60_000
AGGR_CELLS = {"gru": "attbigru", "lstm": "attbilstm"}
AGGR_H, AGGR_L, AGGR_C, AGGR_ROWS = 32, 11, 21, 1024
# the text path: the card runs the whole features TSV of the e2e input, the
# CPU its first rows (full-width models in plain PyTorch on the host are slow)
TEXT_CPU_ROWS = 2048
# the embedded-kinetics families: their BiRNN input is C = 28 at the
# defaults (8 + 2 x 8 + 4) and 52 with stds, sn and map (+ 16 + 4 + 4)
MODELS2S2 = {"gru": "attbigru2s2", "lstm": "attbilstm2s2"}
C2S2, C2S2_WIDE = 28, 52
WIDE = {"is_stds": True, "is_sn": True, "is_map": True}
# --device cpu runs the e2e input's reads of its first HEAD_SITES sites
HEAD_SITES = 2048
# trainm's single-strand families, on single-strand rows of the train input's
# sizes; transencoder2s's training; the train batch's wires (attbigru2s);
# the first step's loss of a bf16 or packed wire against the fp32 wire's
MODELS1S = {"gru": "attbigru1s", "lstm": "attbilstm1s"}
TRAIN1S_EPOCHS, TE_EPOCHS, TRANSFER_EPOCHS = 2, 2, 1
# between the two wires' readings (8.9e-7 bf16, 1.8e-5 packed, PERF.md) and
# the loss moves of a mis-scaled or dropped channel
WIRE_TOL = 1e-4
# the aggregate trainer: simulated windows, 32 steps of batch 512 an epoch
AGGR_TRAIN_ROWS, AGGR_VALID_ROWS, AGGR_EPOCHS = 16384, 4096, 3


def log(msg):
    print(msg, flush=True)


def emit(obj):
    print(json.dumps(obj), flush=True)


def time_ms(fn, torch, reps=REPS):
    """Median of ``reps`` CUDA-event timings of fn(), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e))
    return statistics.median(ts)


def phase_card(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log("torch {} cuda {} device {}".format(torch.__version__, torch.version.cuda,
                                           name))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi, name


def phase_build():
    """One nvcc per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp, nvcc, transenc

    def build(src):
        t0 = time.time()
        so, log = nvcc.build(src)
        return so, log, time.time() - t0

    srcs = (bigru.SRC, bigru.TC_SRC, bigru.SIMT_SRC, bigru_vjp.SRC, bilstm_vjp.SRC,
            transenc.SRC, transenc.TC_SRC, transenc.SIMT_SRC)
    t0 = time.time()
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(build, srcs))
    for so, blog, secs in built:
        log("build: {} in {:.1f} s".format(os.path.relpath(so, REPO), secs))
        for ln in blog.splitlines():
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
                log("  ptxas: " + ln.strip())
    secs = time.time() - t0
    log("build: all kernels in {:.1f} s".format(secs))
    return secs


def _layers(torch, dtype, device, cell, cin=C):
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights

    rng = np.random.RandomState(SEED)
    layers_np = init_rnn_params(rng, cin, H, NL, cell)
    return layers_np, [layer_weights(ld, dtype, device) for ld in layers_np]


def _cudnn(torch, cell, cin, n_layers, layers_np, dt, hidden=H):
    """cuDNN's bidirectional nn.GRU / nn.LSTM with the port's weights: the
    yardstick, never used by the port. Built on the card in its dtype, the
    weights copied in, then flattened into cuDNN's one weight buffer. In
    bf16 ``flatten_parameters`` does nothing (torch.backends.cudnn does not
    list bf16 as a cuDNN type) while the forward still runs cuDNN, which
    then warns and compacts the weights at every call; so bf16 flattens
    through the call that ``flatten_parameters`` makes for the other types.
    ``mod.weights_warning`` tells whether a forward still warns."""
    import warnings

    cls = torch.nn.GRU if cell == "gru" else torch.nn.LSTM
    mod = cls(cin, hidden, n_layers, bidirectional=True, device="cuda", dtype=dt)
    with torch.no_grad():
        for k, ld in enumerate(layers_np):
            for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                  ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                    getattr(mod, "{}_l{}{}".format(name, k, suf)).copy_(
                        torch.from_numpy(ld[d][key]))
    mod.flatten_parameters()
    mod.flatten_error = None
    if dt == torch.bfloat16 and torch._use_cudnn_rnn_flatten_weight():
        import torch.backends.cudnn.rnn as cudnn_rnn

        try:  # the yardstick only: a refusal is reported, the timing still runs
            with torch.no_grad():
                torch._cudnn_rnn_flatten_weight(
                    mod._flat_weights, 4, cin, cudnn_rnn.get_cudnn_mode(mod.mode), hidden,
                    0, n_layers, False, True)
        except RuntimeError as e:
            mod.flatten_error = str(e).splitlines()[0][:200]
    probe = torch.zeros((2, 1, cin), device="cuda", dtype=dt)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        mod(probe)
    mod.weights_warning = any("contiguous chunk" in str(w.message) for w in caught)
    return mod


def _phase_fns(plan, ly, cell, Lx, layer=False):
    """One layer's two phases in K1's tc or simt design: (projection(x2d,
    xg=None), recurrence(xg, rows, out=None), rows of a recurrence tile);
    ``layer`` counts the launches as K2's."""
    from ccsmeth_tpu_torch.ops import bigru

    wih, bih, whh, bhh = ly
    if plan["design"] == "tc":
        def proj(x2, xg=None):
            return bigru.tc_projection(x2, wih, bih, bhh, cell, xg, layer)

        def rec(xg, rows, out=None):
            return bigru.tc_recurrence(xg, whh, bhh, Lx, rows, plan["U"], cell, out,
                                       None, layer)
        return proj, rec, bigru.TC_ROWS

    def proj(x2, xg=None):
        return bigru.simt_projection(x2, wih, bih, bhh, cell, xg, layer)

    def rec(xg, rows, out=None):
        return bigru.simt_recurrence(xg, whh, bhh, Lx, rows, plan, cell, out, None, layer)
    return proj, rec, plan["rows"]


def _k1_phases_ms(torch, ly, x, cell, plan):
    """Device time of each phase of K1's tc or simt design on the stack's
    inputs: the projection of layer 0 (C = 11, or the cell's C) and of a later layer
    (C = 2H), and one layer's recurrence, also on 1 and 15 row tiles a
    direction; medians of CUDA-event timings."""
    Lx, N, _C = x.shape
    proj, rec, rows_tile = _phase_fns(plan, ly[0], cell, Lx)
    proj1 = _phase_fns(plan, ly[1], cell, Lx)[0]
    x0 = x.view(Lx * N, -1)
    xg = proj(x0)
    out, _hn = rec(xg, N)
    x1 = out.view(Lx * N, -1)
    # 1 row tile (a cluster a direction): the serial chain's latency alone;
    # 15 (30 clusters): where the time doubles against one tile, the card no
    # longer holds every cluster at once
    by_tiles = {}
    for tiles in (1, 15):
        rows = tiles * rows_tile
        xg_t = torch.randn((2, Lx * rows, xg.shape[2]), device="cuda")
        by_tiles[str(tiles)] = time_ms(lambda: rec(xg_t, rows), torch)
    return {"rows_a_tile": rows_tile, "recurrence_by_row_tiles": by_tiles,
            "projection_c{}".format(x.shape[2]): time_ms(lambda: proj(x0, xg), torch),
            "projection_c512": time_ms(lambda: proj1(x1, xg), torch),
            "recurrence": time_ms(lambda: rec(xg, N, out), torch)}


def phase_kernels(torch, smi, cell):
    import numpy as np

    cells = []
    for rows in ROWS:
        x_np = np.random.RandomState(SEED + rows).randn(L, rows, C).astype(np.float32)
        for dname in ("float32", "bfloat16"):
            cells.append(_k1_cell(torch, smi, cell, x_np, dname))
    return cells


def _k1_cell(torch, smi, cell, x_np, dname, phases=True):
    """K1 (the cell's whole 3 x 256 stack) on the input x_np (L, rows, C):
    the design ``k1_plan`` picks, its CUDA launches a call, a bit-equal
    rerun, the error against the plain version (``TOL``), and the kernel's,
    the plain version's and cuDNN's times beside the bound, with each
    phase's time when ``phases``."""
    from ccsmeth_tpu_torch.ops import bigru

    rows, cin = x_np.shape[1], x_np.shape[2]
    dt = getattr(torch, dname)
    plan = bigru.k1_plan(H, cell, dt)
    layers_np, ly = _layers(torch, dt, "cuda", cell, cin)
    x = torch.from_numpy(x_np).to("cuda", dt).contiguous()
    before = dict(bigru.design_calls)
    bigru.cuda_launches = 0
    out, hn = bigru.birnn_stack(ly, x, dt, cell)
    cuda_per_call = bigru.cuda_launches
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell)
    torch.cuda.synchronize()
    assert bigru.design_calls[plan["design"]] == before[plan["design"]] + 2
    # tc and simt: a projection and a recurrence a layer
    assert cuda_per_call == 2 * NL, (plan, cuda_per_call)
    rerun_equal = bool(torch.equal(out, out2) and torch.equal(hn, hn2))
    assert rerun_equal, (cell, rows, cin, dname, "rerun differs")
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.shape == (L, rows, 2 * H) and hn.shape == (2 * NL, rows, H)
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(hn).all())
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_hn = (hn - ref_hn).abs().max().item()
    assert max(err_out, err_hn) <= TOL[dname], (cell, rows, cin, dname, err_out, err_hn)

    lib = _cudnn(torch, cell, cin, NL, layers_np, dt)
    with torch.inference_mode():
        kernel_ms = time_ms(lambda: bigru.birnn_stack(ly, x, dt, cell), torch)
        plain_ms = time_ms(lambda: bigru.birnn_stack_plain(ly, x, dt, cell), torch)
        library_ms = time_ms(lambda: lib(x), torch)
        phase_ms = _k1_phases_ms(torch, ly, x, cell, plan) if phases else None
    flops = bigru.stack_flops(L, rows, cin, H, NL, cell)
    nbytes = (x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for lyr in ly for t in lyr)
              + out.numel() * out.element_size() + hn.numel() * 4)
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    res = {"phase": "kernel", "name": "bigru_stack", "cell": cell,
           "rows": rows, "C": cin, "dtype": dname, "design": plan["design"],
           "cuda_launches_per_call": cuda_per_call,
           "max_abs_err_out": err_out,
           "max_abs_err_hn": err_hn, "tol": TOL[dname],
           "rerun_bit_equal": rerun_equal,
           "kernel_ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_weights_warning": lib.weights_warning,
           "library_flatten_error": lib.flatten_error,
           "gflop": flops / 1e9,
           "tflops_achieved": flops / kernel_ms / 1e9, "phases_ms": phase_ms,
           "card": smi}
    emit(res)
    return res


def _bound(flops, nbytes, dname):
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _torch_encoder(torch, params, dt):
    """nn.TransformerEncoder (6 post-LN ReLU layers, batch_first) with the
    port's weights, in eval mode: the yardstick, never used by the port."""
    from ccsmeth_tpu_torch.models import TransEncConfig, transenc_state_dict_from_params

    cfg = TransEncConfig()
    layer = torch.nn.TransformerEncoderLayer(
        cfg.d_model, cfg.nhead, cfg.dim_ff, dropout=0.0, activation="relu",
        batch_first=True, norm_first=False)
    enc = torch.nn.TransformerEncoder(layer, cfg.num_layers, enable_nested_tensor=False)
    prefix = "transformer_encoder."
    enc.load_state_dict({k[len(prefix):]: v for k, v in
                         transenc_state_dict_from_params(params).items()
                         if k.startswith(prefix)})
    return enc.to("cuda", dt).eval()


def _k3_waves(torch, fn, x, S):
    """One CTA (S samples), and one CTA on every SM: a CTA's time alone and
    in a full wave. About equal: the CTA's own chain sets the pace; a wave
    much slower: what the CTAs share (L2) does."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return {"samples_a_cta": S, "sms": n_sm,
            "one_cta_ms": time_ms(lambda: fn(x[:S]), torch),
            "one_wave_ms": time_ms(lambda: fn(x[:S * n_sm]), torch)}


def _k3_inputs(torch, rows, dname):
    """K3's cell: transencoder2s's seeded weights (random biases and
    LayerNorm parameters, so each of K3's operands counts) stacked in the
    operand type, and a random normal input, the scale of the embedded,
    positioned encoder input."""
    import numpy as np

    from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
    from ccsmeth_tpu_torch.models.transenc import randomize_affine
    from ccsmeth_tpu_torch.ops import transenc

    cfg = TransEncConfig()
    dt = getattr(torch, dname)
    params = randomize_affine(init_transenc(SEED, cfg), SEED)
    st = transenc.stack_layers(params["layers"], dt, "cuda")
    x_np = np.random.RandomState(SEED + rows).randn(rows, L, cfg.d_model).astype(np.float32)
    return cfg, params, st, torch.from_numpy(x_np).to("cuda", dt)


def phase_k3_kernels(torch, smi):
    """K3 at the call_mods path's shapes (transencoder2s at full width,
    2B = 1024 and 16384 samples) in the design ``k3_plan`` picks (fp32:
    simt, bf16: tc) against its plain version, timed beside it,
    nn.TransformerEncoder + mean and the bound; at 1024 samples also one CTA
    alone and one full wave."""
    from ccsmeth_tpu_torch.ops import transenc

    cells = []
    for rows in ROWS:
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            cfg, params, st, x = _k3_inputs(torch, rows, dname)
            D, FF, NH, NLT = cfg.d_model, cfg.dim_ff, cfg.nhead, cfg.num_layers
            plan = transenc.k3_plan(L, D, FF, NH, dt)
            before = dict(transenc.design_calls)
            transenc.cuda_launches = 0
            got = transenc.encoder_pooled(st, x, dt, NH)
            cuda_per_call = transenc.cuda_launches
            again = transenc.encoder_pooled(st, x, dt, NH)
            torch.cuda.synchronize()
            assert transenc.design_calls[plan["design"]] == before[plan["design"]] + 2
            assert plan["design"] == ("simt" if dname == "float32" else "tc"), plan
            assert cuda_per_call == 1, cuda_per_call
            assert torch.equal(got, again), (rows, dname, "rerun differs")
            ref = transenc.encoder_pooled_plain(st, x, dt, NH)
            assert got.shape == (rows, D) and bool(torch.isfinite(got).all())
            err = (got - ref).abs().max().item()
            assert err <= K3_TOL[dname], (rows, dname, err)
            lib = _torch_encoder(torch, params, dt)
            with torch.inference_mode():
                lib_err = (lib(x).float().mean(1) - ref).abs().max().item()
                kernel_ms = time_ms(lambda: transenc.encoder_pooled(st, x, dt, NH), torch)
                plain_ms = time_ms(
                    lambda: transenc.encoder_pooled_plain(st, x, dt, NH), torch)
                library_ms = time_ms(lambda: lib(x).float().mean(1), torch)
                waves = None
                if rows == ROWS[0]:
                    waves = _k3_waves(torch, lambda xs: transenc.encoder_pooled(
                        st, xs, dt, NH), x, plan["S"])
            flops = transenc.encoder_flops(rows, L, D, FF, NLT)
            bms, bby = _bound(flops, _nbytes(x, got, *st.values()), dname)
            res = {"phase": "kernel", "name": "transenc_encoder", "rows": rows,
                   "dtype": dname, "design": plan["design"],
                   "cuda_launches_per_call": cuda_per_call, "rerun_bit_equal": True,
                   "max_abs_err": err, "tol": K3_TOL[dname],
                   "library_max_abs_diff": lib_err,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bms, "bound_by": bby,
                   "gflop": flops / 1e9, "tflops_achieved": flops / kernel_ms / 1e9,
                   "card": smi}
            if waves is not None:
                res["waves"] = waves
            emit(res)
            cells.append(res)
            del lib, got, again, ref
    return cells


def phase_k3_l2(torch, smi, k3_cells):
    """K3's l2 design (ops/csrc/transenc_encoder.cu, the first f32 kernel),
    which the shape rule keeps for the shapes that simt and tc refuse and
    which no model's path runs since fp32 moved to the simt design: called
    directly at the kernel phase's fp32 cells (and bf16 at 1024 samples),
    against the plain version, timed, with the one-CTA and one-wave probe at
    1024 samples. nn.TransformerEncoder's time is the kernel phase's on the
    same inputs."""
    from ccsmeth_tpu_torch.ops import transenc

    cells = []
    for rows, dname in ((ROWS[0], "float32"), (ROWS[1], "float32"),
                        (ROWS[0], "bfloat16")):
        dt = getattr(torch, dname)
        cfg, _params, st, x = _k3_inputs(torch, rows, dname)
        D, FF, NH, NLT = cfg.d_model, cfg.dim_ff, cfg.nhead, cfg.num_layers
        before = transenc.design_calls["l2"]
        transenc.cuda_launches = 0
        got = transenc._encoder_l2(st, x, dt, NH)
        cuda_per_call = transenc.cuda_launches
        again = transenc._encoder_l2(st, x, dt, NH)
        torch.cuda.synchronize()
        assert transenc.design_calls["l2"] == before + 2
        assert cuda_per_call == 1, ("l2", rows, dname, cuda_per_call)
        assert torch.equal(got, again), (rows, dname, "l2 rerun differs")
        ref = transenc.encoder_pooled_plain(st, x, dt, NH)
        assert got.shape == (rows, D) and bool(torch.isfinite(got).all())
        err = (got - ref).abs().max().item()
        assert err <= K3_TOL[dname], ("l2", rows, dname, err)
        with torch.inference_mode():
            kernel_ms = time_ms(lambda: transenc._encoder_l2(st, x, dt, NH), torch)
            plain_ms = time_ms(lambda: transenc.encoder_pooled_plain(st, x, dt, NH),
                               torch)
            waves = None
            if rows == ROWS[0] and dname == "float32":
                waves = _k3_waves(torch, lambda xs: transenc._encoder_l2(st, xs, dt, NH),
                                  x, transenc.tile_shape(L, D, FF)[0])
        flops = transenc.encoder_flops(rows, L, D, FF, NLT)
        bms, bby = _bound(flops, _nbytes(x, got, *st.values()), dname)
        mc = next(c for c in k3_cells if c["rows"] == rows and c["dtype"] == dname)
        res = {"phase": "kernel", "name": "transenc_encoder_l2", "rows": rows,
               "dtype": dname, "design": "l2", "cuda_launches_per_call": cuda_per_call,
               "rerun_bit_equal": True,
               "max_abs_err": err, "tol": K3_TOL[dname], "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": mc["library_ms"], "bound_ms": bms,
               "bound_by": bby, "tflops_achieved": flops / kernel_ms / 1e9,
               "card": smi}
        if waves is not None:
            res["waves"] = waves
        emit(res)
        cells.append(res)
    return cells


def phase_k2_kernels(torch, smi, cell, cins=(C, 2 * H), dtypes=("float32", "bfloat16")):
    """K2, one bidirectional layer of the cell, at the call_mods path's
    shapes (1024 rows; C = 11 for layer 0, 2H for layers 1 and 2; or the
    ``cins`` given) against
    its plain version, timed beside it, cuDNN's one-layer bidirectional
    nn.GRU / nn.LSTM (inference) and the bound, with the design ``k1_plan``
    picked (simt in fp32, tc in bf16), its CUDA launches a call (K2's own
    count; K1's stays), a rerun for bit-equal outputs and each phase's time.
    Tolerances as K1's."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru

    rows = ROWS[0]
    cells = []
    for cin in cins:
        rng = np.random.RandomState(SEED + cin)
        ld = init_rnn_params(rng, cin, H, 1, cell)[0]
        x_np = rng.randn(L, rows, cin).astype(np.float32)
        for dname in dtypes:
            dt = getattr(torch, dname)
            plan = bigru.k1_plan(H, cell, dt)
            ly = layer_weights(ld, dt, "cuda")
            x = torch.from_numpy(x_np).to("cuda", dt)
            k1_before = (bigru.launches, bigru.cuda_launches)
            before = dict(bigru.layer_design_calls)
            bigru.layer_cuda_launches = 0
            out = bigru.bigru_layer_tm(ly, x, dt, cell)
            cuda_per_call = bigru.layer_cuda_launches
            again = bigru.bigru_layer_tm(ly, x, dt, cell)
            torch.cuda.synchronize()
            assert cuda_per_call == 2, (cell, cin, dname, cuda_per_call)
            assert bigru.layer_design_calls[plan["design"]] == before[plan["design"]] + 2
            assert (bigru.launches, bigru.cuda_launches) == k1_before  # nothing of K1's
            assert torch.equal(out, again), (cell, cin, dname, "rerun differs")
            ref = bigru.bigru_layer_tm_plain(ly, x, dt, cell)
            assert out.shape == (L, rows, 2 * H) and bool(torch.isfinite(out.float()).all())
            err = (out.float() - ref.float()).abs().max().item()
            assert err <= TOL[dname], (cell, cin, dname, err)
            lib = _cudnn(torch, cell, cin, 1, [ld], dt)
            with torch.inference_mode():
                kernel_ms = time_ms(lambda: bigru.bigru_layer_tm(ly, x, dt, cell), torch)
                plain_ms = time_ms(lambda: bigru.bigru_layer_tm_plain(ly, x, dt, cell),
                                   torch)
                library_ms = time_ms(lambda: lib(x), torch)
                phases = _k2_phases_ms(torch, ly, x, cell, plan)
            bms, bby = _bound(bigru.stack_flops(L, rows, cin, H, 1, cell),
                              _nbytes(x, out, *ly), dname)
            res = {"phase": "kernel", "name": "bigru_layer", "cell": cell,
                   "rows": rows, "C": cin, "dtype": dname, "design": plan["design"],
                   "cuda_launches_per_call": cuda_per_call, "rerun_bit_equal": True,
                   "max_abs_err": err, "tol": TOL[dname], "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
                   "bound_by": bby, "phases_ms": phases,
                   "library_weights_warning": lib.weights_warning, "card": smi}
            emit(res)
            cells.append(res)
            del lib, out, again, ref
    return cells


def _k2_phases_ms(torch, ly, x, cell, plan):
    """K2's two phases on its inputs: the projection and the recurrence
    (CUDA-event medians)."""
    Lx, N, _C = x.shape
    proj, rec, _rows = _phase_fns(plan, ly, cell, Lx, layer=True)
    x2 = x.view(Lx * N, -1)
    xg = proj(x2)
    return {"projection": time_ms(lambda: proj(x2, xg), torch),
            "recurrence": time_ms(lambda: rec(xg, N), torch)}


def phase_l2_kernels(torch, smi, cell):
    """The l2 design (ops/csrc/bigru_stack.cu), which the shape rule keeps
    for the shapes that tc and simt refuse and which no model's path runs
    since fp32 K1 and K2 moved to the simt design: K1's whole-stack launch
    and K2's one-layer launch (C = 2H) called directly at the kernel phase's
    shapes (1024 rows), fp32 and bf16, against the plain version, timed."""
    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru

    rows = ROWS[0]
    x_np = np.random.RandomState(SEED + rows).randn(L, rows, C).astype(np.float32)
    for dname in ("float32", "bfloat16"):
        dt = getattr(torch, dname)
        _np_layers, ly = _layers(torch, dt, "cuda", cell)
        x = torch.from_numpy(x_np).to("cuda", dt).contiguous()
        out, hn = bigru._stack_l2(ly, x, dt, cell, H)
        x1 = out  # a layer input of width 2H
        out1 = bigru._layer_l2(ly[1], x1, dt, cell, H)
        torch.cuda.synchronize()
        ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
        ref1 = bigru.bigru_layer_tm_plain(ly[1], x1, dt, cell)
        errs = {"stack_out": (out.float() - ref_out.float()).abs().max().item(),
                "stack_hn": (hn - ref_hn).abs().max().item(),
                "layer_out": (out1.float() - ref1.float()).abs().max().item()}
        assert max(errs.values()) <= TOL[dname], (cell, dname, errs)
        with torch.inference_mode():
            stack_ms = time_ms(lambda: bigru._stack_l2(ly, x, dt, cell, H), torch)
            layer_ms = time_ms(lambda: bigru._layer_l2(ly[1], x1, dt, cell, H), torch)
        res = {"phase": "kernel", "name": "bigru_stack_l2", "cell": cell, "rows": rows,
               "dtype": dname, "design": "l2", "max_abs_err": errs, "tol": TOL[dname],
               "stack_ms": stack_ms, "layer_c512_ms": layer_ms, "card": smi}
        emit(res)


def _bwd_cuda_launches(rows, cin, dt, cell, hidden=H, seq_len=L):
    """K5's (cell 'gru') or K6's backward ('lstm') CUDA launches a call:
    recurrence, dx, weight gradients, and the sum of the row slices when
    there is more than one."""
    import torch

    from ccsmeth_tpu_torch.ops import bigru_vjp

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bigru_vjp.k45_plan(hidden, dt, cell)
    return 3 + (bigru_vjp.k5_wgrad_slices(seq_len * rows, cin, hidden, n_sm,
                                          plan["design"], plan["gates"]) > 1)


def _train_phases_ms(torch, x, wih, bih, whh, bhh, dout, dt, cell):
    """Device time of each phase of the training kernels on one layer's
    inputs: the forward's projection and recurrence, the backward's
    recurrence, dx and weight gradients (with the slice sum); and each
    recurrence on one row tile a direction (one cluster each), its serial
    chain alone, against which the full recurrence's time counts the waves of
    clusters; medians of CUDA-event timings. Returns (forward phases,
    backward phases), named k4_* / k5_* (cell 'gru') or k6_* ('lstm')."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    Lx, N, _C = x.shape
    plan = V.k45_plan(whh.shape[1], dt, cell)
    r4, r5 = plan["rows_fwd"], plan["rows_bwd"]
    xg = V.k4_projection(x, wih, bih, bhh, plan, dt)
    xg4 = torch.randn((2, Lx * r4, xg.shape[2]), device="cuda")
    xg5 = torch.randn((2, Lx * r5, xg.shape[2]), device="cuda")
    dout5 = torch.randn((Lx, r5, dout.shape[2]), device="cuda").to(dt)
    if cell == "gru":
        out, gates = V.k4_recurrence(xg, whh, bhh, Lx, N, plan, dt)
        dxg, dhg = V.k5_recurrence(dout, out, gates, whh, plan, dt)
        out5, gates5 = V.k4_recurrence(xg5, whh, bhh, Lx, r5, plan, dt)
        fwd = {"k4_projection": lambda: V.k4_projection(x, wih, bih, bhh, plan, dt),
               "k4_recurrence_one_tile": lambda: V.k4_recurrence(xg4, whh, bhh, Lx, r4,
                                                                 plan, dt),
               "k4_recurrence": lambda: V.k4_recurrence(xg, whh, bhh, Lx, N, plan, dt)}
        bwd = {"k5_recurrence_one_tile": lambda: V.k5_recurrence(dout5, out5, gates5, whh,
                                                                 plan, dt),
               "k5_recurrence": lambda: V.k5_recurrence(dout, out, gates, whh, plan, dt),
               "k5_dx": lambda: V.k5_dx(dxg, wih, plan, dt),
               "k5_weight_grads": lambda: V.k5_weight_grads(x, out, dxg, dhg, plan, dt)}
    else:
        out, c, gates = V6.k6_recurrence(xg, whh, Lx, N, plan, dt)
        da = V6.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
        _o5, c5, gates5 = V6.k6_recurrence(xg5, whh, Lx, r5, plan, dt)
        fwd = {"k6_projection": lambda: V.k4_projection(x, wih, bih, bhh, plan, dt),
               "k6_recurrence_one_tile": lambda: V6.k6_recurrence(xg4, whh, Lx, r4, plan, dt),
               "k6_recurrence": lambda: V6.k6_recurrence(xg, whh, Lx, N, plan, dt)}
        bwd = {"k6_bwd_recurrence_one_tile": lambda: V6.k6_bwd_recurrence(
                   dout5, c5, gates5, whh, plan, dt),
               "k6_bwd_recurrence": lambda: V6.k6_bwd_recurrence(dout, c, gates, whh,
                                                                 plan, dt),
               "k6_dx": lambda: V.k5_dx(da, wih, plan, dt),
               "k6_weight_grads": lambda: V.k5_weight_grads(x, out, da, da, plan, dt)}
    return ({k: time_ms(f, torch) for k, f in fwd.items()},
            {k: time_ms(f, torch) for k, f in bwd.items()})


def phase_train_kernels(torch, smi, cell, cins=(C, 2 * H), rows=ROWS[0], hidden=H,
                        seq_len=L):
    """One layer's training kernels at the train path's shapes (C = 11 and
    2H, or the ``cins`` given; 1024 rows, H 256 and L 21, or the ``rows``,
    ``hidden`` and ``seq_len`` given) against their
    plain versions: K4/K5 (cell 'gru') or K6's forward and backward
    ('lstm'). Tolerances: fp32 outputs, residuals and dx 1e-5; dW and db
    1e-5 * max|ref| + 1e-5, since they sum L * 2B = 21,504 rows in another
    order. bf16 (against the plain version with bf16 operands): outputs and
    residuals 1e-2 (times max|ref| where that exceeds 1, as the LSTM's cell
    state may), one bf16 ulp on [0.5, 1) where an f32 sum in another order
    rounds the other way; dx, dW and db 1e-2 * max|ref| + 1e-5, since a
    gate-gradient operand rounded to bf16 the other way moves one product by
    2^-8 of it."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    if cell == "gru":
        V, fwd, fwd_plain = (bigru_vjp, bigru_vjp.bigru_layer_train_fwd,
                             bigru_vjp.bigru_layer_train_fwd_plain)
        bwd, bwd_plain = bigru_vjp.bigru_layer_bwd, bigru_vjp.bigru_layer_bwd_plain
        res_names, kname = ("out", "gates"), "bigru_train"
    else:
        V, fwd, fwd_plain = (bilstm_vjp, bilstm_vjp.bilstm_layer_train_fwd,
                             bilstm_vjp.bilstm_layer_train_fwd_plain)
        bwd, bwd_plain = bilstm_vjp.bilstm_layer_bwd, bilstm_vjp.bilstm_layer_bwd_plain
        res_names, kname = ("out", "c", "gates"), "bilstm_train"
    cells = []
    for cin in cins:
        rng = np.random.RandomState(SEED + cin)
        ld = init_rnn_params(rng, cin, hidden, 1, cell)[0]
        x_np = rng.randn(seq_len, rows, cin).astype(np.float32)
        dout_np = rng.randn(seq_len, rows, 2 * hidden).astype(np.float32)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            f32 = dt == torch.float32
            wih, bih, whh, bhh = layer_weights(ld, dt, "cuda")
            x = torch.from_numpy(x_np).to("cuda", dt)
            dout = torch.from_numpy(dout_np).to("cuda", dt)
            design = bigru_vjp.k45_plan(hidden, dt, cell)["design"]
            V.cuda_launches = 0
            res = fwd(x, wih, bih, whh, bhh, dt)
            fwd_cuda = V.cuda_launches
            ref_res = fwd_plain(x, wih, bih, whh, bhh, dt)
            # both backward versions get the same residuals
            args = (dout, x, wih, whh) + tuple(ref_res) + (dt,)
            V.cuda_launches = 0
            got = bwd(*args)
            bwd_cuda = V.cuda_launches
            again = bwd(*args)
            torch.cuda.synchronize()
            # forward: projection, recurrence; backward: 3, + the slice sum
            assert fwd_cuda == 2 and bwd_cuda == _bwd_cuda_launches(
                rows, cin, dt, cell, hidden, seq_len), (cell, fwd_cuda, bwd_cuda)
            ref = bwd_plain(*args)
            names = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                "{} backward is not bit-equal across two runs".format(kname)
            errs, tols = {}, {}
            for nm, a, r in zip(res_names, res, ref_res):
                errs[nm] = (a.float() - r.float()).abs().max().item()
                tols[nm] = 1e-5 if f32 else 1e-2 * max(1.0, r.float().abs().max().item())
            for nm, a, r in zip(names, got, ref):
                assert bool(torch.isfinite(a).all()), nm
                errs[nm] = (a - r).abs().max().item()
                scale = r.abs().max().item()
                tols[nm] = (1e-5 if (f32 and nm == "dx") else
                            (1e-5 if f32 else 1e-2) * scale + 1e-5)
            bad = {k: (errs[k], tols[k]) for k in errs if errs[k] > tols[k]}
            assert not bad, (cell, cin, dname, bad)

            # cuDNN's one-layer bidirectional GRU / LSTM with the same weights
            lib = _cudnn(torch, cell, cin, 1, [ld], dt, hidden)
            lib.train()
            xg = x.detach().clone().requires_grad_(True)
            lib_fwd_ms = time_ms(lambda: lib(xg), torch)
            y = lib(xg)[0]
            lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                y, [xg] + list(lib.parameters()), dout, retain_graph=True), torch)
            f_ms = time_ms(lambda: fwd(x, wih, bih, whh, bhh, dt), torch)
            b_ms = time_ms(lambda: bwd(*args), torch)
            pf_ms = time_ms(lambda: fwd_plain(x, wih, bih, whh, bhh, dt), torch)
            pb_ms = time_ms(lambda: bwd_plain(*args), torch)
            phases = _train_phases_ms(torch, x, wih, bih, whh, bhh, dout, dt, cell)
            weights = (wih, bih, whh, bhh)
            bf, byf = _bound(V.train_fwd_flops(seq_len, rows, cin, hidden),
                             _nbytes(x, *weights, *res), dname)
            # db_hh is a copy of db_ih for the LSTM: written once
            outs = got if cell == "gru" else got[:4]
            bb, byb = _bound(V.train_bwd_flops(seq_len, rows, cin, hidden),
                             _nbytes(dout, x, wih, whh, *res, *outs), dname)
            for name, ms, pms, lms, bms, bby, keys, ncuda, ph in (
                    (kname + "_fwd", f_ms, pf_ms, lib_fwd_ms, bf, byf, res_names, fwd_cuda,
                     phases[0]),
                    (kname + "_bwd", b_ms, pb_ms, lib_bwd_ms, bb, byb, names, bwd_cuda,
                     phases[1])):
                c = {"phase": "train_kernel", "name": name, "rows": rows,
                     "C": cin, "H": hidden, "L": seq_len, "dtype": dname,
                     "design": design,
                     "cuda_launches_per_call": ncuda,
                     "max_abs_err": {k: errs[k] for k in keys},
                     "tol": {k: tols[k] for k in keys},
                     "max_abs_err_max": max(errs[k] for k in keys),
                     "kernel_ms": ms, "plain_ms": pms, "library_ms": lms,
                     "bound_ms": bms, "bound_by": bby,
                     "library_weights_warning": lib.weights_warning, "card": smi,
                     "phases_ms": ph}
                if name.endswith("_bwd"):
                    c["bit_equal_rerun"] = True
                emit(c)
                cells.append(c)
            del lib, xg, y, got, again, ref, res, ref_res
    return cells


def _model_feats(B, seed, optional=False):
    """Seeded feats of both strands: kmer, kpass and z-scored kinetics
    means; with ``optional`` also the stds, sn and map channels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 4, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(3, 25, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = rng.randn(B, L).astype(np.float32)
        feats["pw_means" + s] = rng.randn(B, L).astype(np.float32)
    for s in ("", "2") if optional else ():
        feats["ipd_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["pw_stds" + s] = rng.rand(B, L).astype(np.float32)
        feats["sns" + s] = (rng.rand(B, 4) * 10).astype(np.float32)
        feats["maps" + s] = rng.randint(0, 8, (B, L)).astype(np.float32)
    return feats


def _config_params(model_type):
    """(config, numpy-seeded params) at full width; transencoder2s with
    random biases, LayerNorm and BatchNorm parameters (``randomize_affine``)."""
    from ccsmeth_tpu_torch.models import (AttRNNConfig, TransEncConfig, init_attrnn,
                                          init_transenc)
    from ccsmeth_tpu_torch.models.transenc import randomize_affine

    if model_type == TRANSENC:
        return TransEncConfig(), randomize_affine(init_transenc(SEED, TransEncConfig()), SEED)
    cfg = AttRNNConfig(model_type=model_type)
    return cfg, init_attrnn(SEED, cfg)


def phase_model(torch, model_type):
    """Full-width probs through the model's kernel (K1, or K3 for
    transencoder2s) against the plain version's. transencoder2s runs its fp32
    check once more with cuDNN's TF32 allowed: the port's SrcEmbed conv is a
    float32 matmul of its own accord, so nothing may change."""
    from ccsmeth_tpu_torch.ops import bigru, transenc
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model

    cfg, params = _config_params(model_type)
    model = build_model(params, cfg, "cuda")
    feats = {k: torch.from_numpy(v).cuda() for k, v in _model_feats(512, SEED).items()}
    if model_type == TRANSENC:
        plain = {"encoder_fn": transenc.encoder_pooled_plain}
    else:
        plain = {"rnn_fn": bigru.birnn_stack_plain}
    res = {}
    for dname, tol in (("float32", 1e-4), ("bfloat16", 2.0 / 256)):
        dt = getattr(torch, dname)
        with torch.inference_mode():
            _l, p_k = model(feats, compute_dtype=dt)
            _l, p_p = model(feats, compute_dtype=dt, **plain)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(p_k).all())
        err = (p_k - p_p).abs().max().item()
        assert err < tol, (model_type, dname, err)
        res[dname] = err
        line = {"phase": "model", "model": model_type + " full width", "batch": 512,
                "dtype": dname, "max_abs_err_probs": err, "tol": tol}
        if model_type == TRANSENC and dname == "float32":
            prev = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = True
            try:
                with torch.inference_mode():
                    _l, p_tf = model(feats)
                torch.cuda.synchronize()
            finally:
                torch.backends.cudnn.allow_tf32 = prev
            line["cudnn_tf32_on_max_abs_err_probs"] = (p_tf - p_p).abs().max().item()
            line["cudnn_tf32_on_vs_off"] = (p_tf - p_k).abs().max().item()
            assert line["cudnn_tf32_on_max_abs_err_probs"] < tol, line
            assert line["cudnn_tf32_on_vs_off"] == 0.0, line
        emit(line)
    return res


def phase_model2s2(torch, smi, cell):
    """The embedded-kinetics family of the cell (attbigru2s2 or
    attbilstm2s2) at full width: K1 on its BiRNN's input widths, C = 28
    (fp32 and bf16) and 52 (fp32, stds, sn and map on), 1024 rows; K2's
    layer 0 at the same widths; K4/K5 or K6 on layer 0 at C = 28 (fp32 and
    bf16): each against its plain version, timed beside it, cuDNN and the
    bound (``_k1_cell``, ``phase_k2_kernels``, ``phase_train_kernels``).
    Then the seeded model (batch 512, 1024 rows) through K1, and through K2
    under pallas_layer, against the same model through the plain version:
    probs within 1e-5 in fp32 and 1e-2 in bf16."""
    import numpy as np

    from ccsmeth_tpu_torch.models import AttRNNConfig, init_attrnn
    from ccsmeth_tpu_torch.models.attrnn import rnn_input_size
    from ccsmeth_tpu_torch.ops import bigru
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model

    model_type = MODELS2S2[cell]
    res = {"k1": [], "k2": [], "train": [], "model": []}
    for cin, dnames in ((C2S2, ("float32", "bfloat16")), (C2S2_WIDE, ("float32",))):
        x_np = np.random.RandomState(SEED + cin).randn(L, ROWS[0], cin).astype(np.float32)
        for dname in dnames:
            res["k1"].append(_k1_cell(torch, smi, cell, x_np, dname, phases=cin == C2S2))
        res["k2"] += phase_k2_kernels(torch, smi, cell, (cin,), dnames)
    res["train"] = phase_train_kernels(torch, smi, cell, (C2S2,))
    feats = {k: torch.from_numpy(v).cuda()
             for k, v in _model_feats(512, SEED, optional=True).items()}
    for flags, dnames in (({}, ("float32", "bfloat16")), (WIDE, ("float32",))):
        cfg = AttRNNConfig(model_type=model_type, **flags)
        params = init_attrnn(SEED, cfg)
        for backend in ("xla", "pallas_layer"):
            model = build_model(params, cfg, "cuda", backend)
            for dname in dnames:
                dt = getattr(torch, dname)
                _zero_counts()
                with torch.inference_mode():
                    _l, p_k = model(feats, compute_dtype=dt)
                    torch.cuda.synchronize()
                    counts = _all_counts()
                    _l, p_p = model(feats, compute_dtype=dt, rnn_fn=bigru.birnn_stack_plain)
                torch.cuda.synchronize()
                want = {"k1": 1} if backend == "xla" else {"k2": NL}
                assert {k: v for k, v in counts.items() if v} == want, counts
                assert bool(torch.isfinite(p_k).all())
                err = (p_k - p_p).abs().max().item()
                tol = 1e-5 if dname == "float32" else 1e-2
                assert err <= tol, (model_type, flags, backend, dname, err)
                line = {"phase": "model2s2", "model": model_type + " full width",
                        "C": rnn_input_size(cfg), "rnn_backend": backend, "batch": 512,
                        "dtype": dname, "max_abs_err_probs": err, "tol": tol,
                        "launches": counts}
                emit(line)
                res["model"].append(line)
    return res


def _read_tags(path):
    import numpy as np

    from ccsmeth_tpu_torch.bamio import BamReader

    out = {}
    for rec in BamReader(path):
        out[rec.qname] = (rec.get_tag("MM") if rec.has_tag("MM") else None,
                          np.asarray(rec.get_tag("ML"), np.int64)
                          if rec.has_tag("ML") else None)
    return out


def _e2e_input():
    from ccsmeth_tpu_torch.utils.simulate import make_synth_bam, write_fasta

    os.makedirs(WORK, exist_ok=True)
    bam = os.path.join(WORK, "reads.bam")
    fasta = os.path.join(WORK, "ref.fa")
    if not (os.path.exists(bam) and os.path.exists(fasta)):
        t0 = time.time()
        refseq, _ = make_synth_bam(bam, n_reads=E2E_READS, read_len=E2E_READ_LEN,
                                   ref_len=E2E_REF_LEN, seed=SEED)
        write_fasta(fasta, {"chrS": refseq})
        log("e2e input: {} reads x {} bp, simulated in {:.1f} s".format(
            E2E_READS, E2E_READ_LEN, time.time() - t0))
    return bam, fasta


def _zero_counts():
    from ccsmeth_tpu_torch.models import attrnn
    from ccsmeth_tpu_torch.ops import bigru, transenc

    attrnn.h0_plain_calls = 0
    bigru.launches = bigru.plain_calls = 0
    bigru.layer_launches = bigru.layer_plain_calls = bigru.layer_cuda_launches = 0
    transenc.launches = transenc.plain_calls = 0
    for mod in (bigru, transenc):
        mod.cuda_launches = 0
    for calls in (bigru.design_calls, bigru.layer_design_calls, transenc.design_calls):
        for k in calls:
            calls[k] = 0


def _cuda_launches():
    """K1's, K2's and K3's CUDA launches since the last _zero_counts."""
    from ccsmeth_tpu_torch.ops import bigru, transenc

    return {"k1": bigru.cuda_launches, "k2": bigru.layer_cuda_launches,
            "k3": transenc.cuda_launches}


def _design_counts():
    """K1's, K2's and K3's calls by design since the last _zero_counts."""
    from ccsmeth_tpu_torch.ops import bigru, transenc

    return {"k1": dict(bigru.design_calls), "k2": dict(bigru.layer_design_calls),
            "k3": dict(transenc.design_calls)}


def _all_counts():
    """Every inference path's calls since the last _zero_counts: K1, K2 and
    K3 and their plain versions, and the plain BiRNN with explicit initial
    states (``--h0_mode randn``)."""
    from ccsmeth_tpu_torch.models import attrnn
    from ccsmeth_tpu_torch.ops import bigru, transenc

    return {"k1": bigru.launches, "k1_plain": bigru.plain_calls,
            "k2": bigru.layer_launches, "k2_plain": bigru.layer_plain_calls,
            "k3": transenc.launches, "k3_plain": transenc.plain_calls,
            "h0_plain": attrnn.h0_plain_calls}


def _call_mods(model_type, prec, tag, extra=(), bam=None, device="cuda"):
    """The CLI's call_mods of the model's seeded checkpoint on the e2e input
    (or ``bam``): (LAST_RUN, tags by read)."""
    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.pipeline import call_mods

    e2e_bam, fasta = _e2e_input()
    ckpt = os.path.join(WORK, model_type + "_full.ckpt.npz")
    prefix = os.path.join(WORK, "mods_{}_{}_{}".format(model_type, prec, tag))
    cli.main(["call_mods", "-i", bam or e2e_bam, "-o", prefix, "-m", ckpt,
              "--model_type", model_type, "--mode", "align", "--ref", fasta,
              "--device", device, "--precision", prec] + list(extra))
    return dict(call_mods.LAST_RUN), _read_tags(prefix + ".modbam.bam")


class _RecordedProbs:
    """Within the block, call_mods' tagger also records each read's
    6-decimal probs in ML order: ``self.probs[qname]``."""

    def __enter__(self):
        from ccsmeth_tpu_torch.pipeline import call_mods

        self.tag = call_mods.add_mm_ml_to_record
        self.probs = {}

        def recording(rec, locs_probs, rm_pulse=True):
            self.probs[rec.qname] = [p for _loc, p in sorted(locs_probs)]
            return self.tag(rec, locs_probs, rm_pulse)

        call_mods.add_mm_ml_to_record = recording
        return self

    def __exit__(self, *exc):
        from ccsmeth_tpu_torch.pipeline import call_mods

        call_mods.add_mm_ml_to_record = self.tag


def _head_bam(tags, n_sites=HEAD_SITES):
    """The e2e input's first reads, up to the one that brings the sites
    (the ML bytes of ``tags``, a card run's) to ``n_sites``, as a BAM; and
    the reads that lie wholly inside the first ``n_sites`` sites. A run on
    it dispatches the same first n_sites // batch full batches as the whole
    input's run (one holebatch of 50 reads holds ~9k sites)."""
    from ccsmeth_tpu_torch.bamio import BamReader, BamWriter

    bam, _fasta = _e2e_input()
    out = os.path.join(WORK, "head_{}.bam".format(n_sites))
    reader = BamReader(bam)
    writer = BamWriter(out, reader.header)
    total, inside = 0, []
    for rec in reader:
        writer.write(rec)
        ml = tags[rec.qname][1]
        n = 0 if ml is None else ml.size
        if total + n <= n_sites:
            inside.append(rec.qname)
        total += n
        if total >= n_sites:
            break
    writer.close()
    reader.close()
    assert total >= n_sites, total
    return out, inside


def _ml_vs_cpu(card_tags, cpu_tags, cpu_probs, qnames):
    """Gate of the card's fp32 ML bytes against --device cpu's on
    ``qnames``: MM strings equal, ML bytes equal but where one differs by 1
    and the byte boundary between the two lies within 1e-6 of the CPU's
    6-decimal prob (ROADMAP Queue 3, "ML byte rounding": floor(p * 256)
    after rounding p to 6 decimals)."""
    import numpy as np

    n_sites = n_off = 0
    for q in qnames:
        (mm, a), (mm_c, b) = card_tags[q], cpu_tags[q]
        assert mm == mm_c, q
        assert (a is None) == (b is None), q
        if a is None:
            continue
        n_sites += a.size
        for i in np.flatnonzero(a != b):
            edge = max(a[i], b[i]) / 256.0
            assert abs(a[i] - b[i]) == 1 and abs(cpu_probs[q][i] - edge) <= 1e-6, \
                (q, i, a[i], b[i], cpu_probs[q][i])
            n_off += 1
    assert n_sites >= 0.8 * HEAD_SITES, n_sites
    return {"sites": n_sites, "reads": len(qnames), "ml_equal": 1.0 - n_off / n_sites,
            "off_by_one_at_a_boundary": n_off}


def _ml_shares(tags_a, tags_b):
    """(sites, share of ML bytes equal, share within 2) of two runs' tags;
    the MM strings must be equal."""
    import numpy as np

    n_sites = n_equal = n_close = 0
    for q, (mm, ml) in tags_a.items():
        mm_b, ml_b = tags_b[q]
        assert mm == mm_b, q
        if ml is None:
            continue
        n_sites += ml.size
        n_equal += int((ml == ml_b).sum())
        n_close += int((np.abs(ml - ml_b) <= 2).sum())
    return n_sites, n_equal / n_sites, n_close / n_sites


def phase_e2e(torch, smi, model_type):
    """call_mods in fp32 and bf16 through the CLI. Every kernel's counts are
    set to 0 just before each run and read just after: the model's kernel
    (K1, or K3 for transencoder2s) launches once a batch, nothing else
    launches and no plain version runs. For attbigru2s and attbilstm2s the
    bf16 ML bytes stay within 2 of fp32's on >= 99.9% of sites. For
    transencoder2s and the 2s2 families that share is reported and not
    gated: on the bf16 path the kinetics travel as int8 before the
    truncating embedding lookup, so a value near an integer can land on
    another row (the JAX package does the same); their numerics are gated at
    the kernel and model phases."""
    from ccsmeth_tpu_torch.models.params_io import save_params

    _cfg, params = _config_params(model_type)
    os.makedirs(WORK, exist_ok=True)
    save_params(os.path.join(WORK, model_type + "_full.ckpt.npz"), params)
    name = "k3" if model_type == TRANSENC else "k1"
    tags, runs = {}, {}
    total_launches = 0
    for prec in ("fp32", "bf16"):
        _zero_counts()
        run, tags[prec] = _call_mods(model_type, prec, "default")
        torch.cuda.synchronize()
        counts = _all_counts()
        cuda = _cuda_launches()
        n = counts[name]
        total_launches += n
        designs = _design_counts()[name]
        assert run["batches"] > 0 and n == run["batches"], (prec, counts, run)
        assert sum(counts.values()) == n, counts  # no other kernel, no plain run
        # the shape rule: bf16 through the tensor-core design, fp32 the f32 one
        design = "tc" if prec == "bf16" else "simt"
        assert designs[design] == n, (prec, designs)
        # K1 (tc and simt): a projection and a recurrence a layer; K3 one launch
        per_call = 2 * NL if name == "k1" else 1
        assert cuda[name] == per_call * n and sum(cuda.values()) == cuda[name], cuda
        n_tagged = sum(1 for mm, ml in tags[prec].values() if ml is not None)
        assert n_tagged >= 0.9 * len(tags[prec]), (prec, n_tagged)
        run.update(phase="e2e", model=model_type, precision=prec, launches=counts,
                   designs=designs, cuda_launches=cuda, sites_per_s=run["sites"] / run["seconds"],
                   reads_with_mm_ml=n_tagged, card=smi)
        emit(run)
        runs[prec] = run
    assert runs["fp32"]["sites"] >= 50_000, runs["fp32"]["sites"]
    n_sites, equal, within2 = _ml_shares(tags["fp32"], tags["bf16"])
    emit({"phase": "e2e", "model": model_type, "fp32_vs_bf16_ml_equal": equal,
          "fp32_vs_bf16_ml_within_2": within2, "sites": n_sites})
    if model_type in MODELS.values():
        assert within2 >= 0.999, within2
    designs = list(runs["fp32"]["designs"])  # every design of the kernel
    return {"launches": total_launches, "runs": runs, "tags": tags,
            "launches_by_design": {d: sum(r["designs"][d] for r in runs.values())
                                   for d in designs},
            "cuda_launches_by_design": {d: sum(r["cuda_launches"][name] for r in
                                               runs.values() if r["designs"][d])
                                        for d in designs}}


def phase_e2e_layer(torch, smi, model_type, k1_tags):
    """call_mods --rnn_backend pallas_layer in fp32 and bf16: K2 launches once
    a layer and batch (its design's two CUDA launches each: simt in fp32, tc
    in bf16), K1 and K3 never, no plain version runs. In fp32 K2 runs K1's
    launches a layer at a time, so the ML bytes equal the K1 run's; in bf16
    K2's h_n is rebuilt from the bf16 outputs where K1's is the f32 state,
    so the bytes stay within 2 of the K1 bf16 run's on >= 99.9% of sites."""
    runs = {}
    for prec in ("fp32", "bf16"):
        _zero_counts()
        run, tags = _call_mods(model_type, prec, "pallas_layer",
                               ["--rnn_backend", "pallas_layer"])
        torch.cuda.synchronize()
        counts = _all_counts()
        cuda = _cuda_launches()
        designs = _design_counts()["k2"]
        design = "tc" if prec == "bf16" else "simt"
        n = NL * run["batches"]
        assert run["batches"] > 0 and counts["k2"] == n, (counts, run)
        assert sum(counts.values()) == counts["k2"], counts
        assert designs == dict({d: 0 for d in designs}, **{design: n}), designs
        assert cuda == {"k1": 0, "k2": 2 * n, "k3": 0}, cuda  # no K1, no K3
        n_sites, equal, within2 = _ml_shares(k1_tags[prec], tags)
        run.update(phase="e2e", model=model_type, precision=prec,
                   rnn_backend="pallas_layer", launches=counts, designs=designs,
                   cuda_launches=cuda, sites_per_s=run["sites"] / run["seconds"],
                   ml_equal_to_k1_run=equal, ml_within_2_of_k1_run=within2,
                   sites_compared=n_sites, card=smi)
        emit(run)
        if prec == "fp32":
            assert equal >= 0.999, equal
        else:
            assert within2 >= 0.999, within2
        runs[prec] = run
    return runs


def phase_e2e2s2(torch, smi, cell):
    """call_mods of the cell's embedded-kinetics family (attbigru2s2 or
    attbilstm2s2, seeded, full width) on the e2e input: fp32 and bf16
    through K1 (``phase_e2e``: launches, designs and CUDA launches asserted
    a batch; bf16 against fp32 reported), then fp32 and bf16 under
    ``--rnn_backend pallas_layer`` through K2 (``phase_e2e_layer``), and the
    fp32 run's ML bytes against ``--device cpu``'s on the reads of the first
    HEAD_SITES sites (``_ml_vs_cpu``)."""
    model_type = MODELS2S2[cell]
    t0 = time.time()
    e2e = phase_e2e(torch, smi, model_type)
    layer = phase_e2e_layer(torch, smi, model_type, e2e["tags"])
    head, inside = _head_bam(e2e["tags"]["fp32"])
    with _RecordedProbs() as rec:
        _zero_counts()
        _run, cpu_tags = _call_mods(model_type, "fp32", "cpu", bam=head, device="cpu")
    counts = _all_counts()
    assert counts["k1"] == 0 and counts["k1_plain"] > 0, counts  # the CPU: plain only
    vs_cpu = _ml_vs_cpu(e2e["tags"]["fp32"], cpu_tags, rec.probs, inside)
    emit({"phase": "e2e2s2", "model": model_type, "fp32_vs_cpu": vs_cpu,
          "wall_s": time.time() - t0, "card": smi})
    return {"e2e": e2e, "layer": layer, "vs_cpu": vs_cpu}


def phase_flags(torch, smi, single_tags):
    """call_mods' flags on the e2e input, attbigru2s fp32, each run's counts
    set to 0 just before it and read just after:
    ``--h0_mode randn`` runs the plain BiRNN with the replayed initial
    states once a batch and K1 never (its launches, CUDA launches and calls
    by design stay 0), and its ML bytes equal ``--device cpu``'s with the
    same --tseed on the reads of the first HEAD_SITES sites (the CPU run on
    those reads dispatches the same first batches, so draws the same
    states); ``--num_processes 2`` as two runs, each through K1 once a
    batch, whose records together equal the single run's (``single_tags``,
    the fp32 e2e run); ``--profile_dir``: one trace file, whose kernel
    events name K1's two kernels (the simt design: K4's projection
    ``gemm_simt_kernel`` and the recurrence ``fwd_rec_simt_kernel``)."""
    import glob
    import shutil

    import numpy as np

    model_type = MODELS["gru"]
    res = {"phase": "flags", "model": model_type, "precision": "fp32", "card": smi}
    randn = ["--h0_mode", "randn", "--tseed", "4321"]
    _zero_counts()
    run, tags = _call_mods(model_type, "fp32", "randn", randn)
    torch.cuda.synchronize()
    counts, cuda, designs = _all_counts(), _cuda_launches(), _design_counts()["k1"]
    assert run["batches"] > 0 and counts["h0_plain"] == run["batches"], (counts, run)
    assert sum(counts.values()) == counts["h0_plain"], counts  # no kernel, no other plain
    assert sum(cuda.values()) == 0 and sum(designs.values()) == 0, (cuda, designs)
    head, inside = _head_bam(tags)
    with _RecordedProbs() as rec:
        _run, cpu_tags = _call_mods(model_type, "fp32", "randn_cpu", randn, bam=head,
                                    device="cpu")
    moved = _ml_shares(tags, single_tags)[1]
    res["randn"] = {"batches": run["batches"], "launches": counts, "cuda_launches": cuda,
                    "designs": designs, "sites_per_s": run["sites"] / run["seconds"],
                    "vs_cpu": _ml_vs_cpu(tags, cpu_tags, rec.probs, inside),
                    "ml_equal_to_zero_h0_run": moved}
    assert moved < 0.99, moved  # the states reached the model

    merged, shards = {}, []
    for pid in (0, 1):
        _zero_counts()
        run, tags = _call_mods(model_type, "fp32", "p{}".format(pid),
                               ["--num_processes", "2", "--process_id", str(pid)])
        torch.cuda.synchronize()
        counts = _all_counts()
        assert run["batches"] > 0 and counts["k1"] == run["batches"], (counts, run)
        assert sum(counts.values()) == counts["k1"], counts
        assert 0 < len(tags) < len(single_tags) and not set(tags) & set(merged)
        merged.update(tags)
        shards.append({"reads": len(tags), "sites": run["sites"], "batches": run["batches"],
                       "launches": counts["k1"], "sites_per_s": run["sites"] / run["seconds"]})
    assert merged.keys() == single_tags.keys()
    for q, (mm, ml) in single_tags.items():
        mm2, ml2 = merged[q]
        assert mm == mm2 and (ml is None) == (ml2 is None), q
        assert ml is None or np.array_equal(ml, ml2), q
    res["processes"] = {"shards": shards, "union_equals_single_run": True}

    tdir = os.path.join(WORK, "trace")
    shutil.rmtree(tdir, ignore_errors=True)
    _zero_counts()
    run, tags = _call_mods(model_type, "fp32", "profiled", ["--profile_dir", tdir])
    torch.cuda.synchronize()
    counts = _all_counts()
    assert counts["k1"] == run["batches"] > 0, counts
    traces = glob.glob(os.path.join(tdir, "trace_*.json"))
    assert len(traces) == 1, traces
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    k1 = {name: sum(n for k, n in kernels.items() if name in k)
          for name in ("gemm_simt_kernel", "fwd_rec_simt_kernel")}
    assert all(n > 0 for n in k1.values()), sorted(kernels)[:20]
    assert _ml_shares(tags, single_tags)[1] == 1.0  # the trace changes no output
    res["profile"] = {"trace_bytes": os.path.getsize(traces[0]), "events": len(events),
                      "kernel_events": sum(kernels.values()), "k1_kernel_events": k1,
                      "batches": run["batches"]}
    emit(res)
    return res


def phase_k1_aggr(torch, smi):
    """K1 at call_freqb's aggregate shape (NL 1, H 32, L 11, C 21, 1,024
    rows, fp32; the simt design with U = 32, one CTA a cluster), both cells,
    against its plain version, with a bit-equal rerun, beside a one-layer
    cuDNN nn.GRU / nn.LSTM(21, 32, bidirectional=True) and the bound."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru

    f32 = torch.float32
    cells = {}
    for cell in MODELS:
        rng = np.random.RandomState(SEED + AGGR_C)
        layers_np = init_rnn_params(rng, AGGR_C, AGGR_H, 1, cell)
        ly = [layer_weights(ld, f32, "cuda") for ld in layers_np]
        # the model's input: normalized histogram bins in [0, 1] and the
        # offset (a distance in bases) as the last channel
        x_np = rng.rand(AGGR_L, AGGR_ROWS, AGGR_C).astype(np.float32)
        x_np[..., -1] = rng.randint(0, 400, (AGGR_L, AGGR_ROWS))
        x = torch.from_numpy(x_np).cuda()
        plan = bigru.k1_plan(AGGR_H, cell, f32)
        assert (plan["design"], plan["U"], plan["CN"]) == ("simt", 32, 1), plan
        before = bigru.cuda_launches
        out, hn = bigru.birnn_stack(ly, x, f32, cell)
        per_call = bigru.cuda_launches - before
        out2, hn2 = bigru.birnn_stack(ly, x, f32, cell)
        torch.cuda.synchronize()
        assert per_call == 2, per_call
        rerun_equal = bool(torch.equal(out, out2) and torch.equal(hn, hn2))
        assert rerun_equal, (cell, "rerun differs")
        ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, f32, cell)
        assert bool(torch.isfinite(out).all()) and bool(torch.isfinite(hn).all())
        err = max((out - ref_out).abs().max().item(), (hn - ref_hn).abs().max().item())
        assert err <= TOL["float32"], (cell, err)
        lib = _cudnn(torch, cell, AGGR_C, 1, layers_np, f32, AGGR_H).eval()
        proj, rec, _rows = _phase_fns(plan, ly[0], cell, AGGR_L)
        x2 = x.view(AGGR_L * AGGR_ROWS, AGGR_C)
        xg = proj(x2)
        with torch.inference_mode():
            kernel_ms = time_ms(lambda: bigru.birnn_stack(ly, x, f32, cell), torch)
            plain_ms = time_ms(lambda: bigru.birnn_stack_plain(ly, x, f32, cell), torch)
            library_ms = time_ms(lambda: lib(x), torch)
            phases = {"projection": time_ms(lambda: proj(x2, xg), torch),
                      "recurrence": time_ms(lambda: rec(xg, AGGR_ROWS), torch)}
        flops = bigru.stack_flops(AGGR_L, AGGR_ROWS, AGGR_C, AGGR_H, 1, cell)
        bound_ms, bound_by = _bound(flops, _nbytes(x, *ly[0], out, hn), "float32")
        res = {"phase": "kernel", "name": "bigru_stack aggregate", "cell": cell,
               "rows": AGGR_ROWS, "L": AGGR_L, "C": AGGR_C, "H": AGGR_H, "layers": 1,
               "dtype": "float32", "design": plan["design"], "U": plan["U"],
               "CN": plan["CN"], "cuda_launches_per_call": per_call,
               "max_abs_err": err, "tol": TOL["float32"], "rerun_bit_equal": rerun_equal,
               "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
               "bound_ms": bound_ms, "bound_by": bound_by, "gflop": flops / 1e9,
               "phases_ms": phases, "card": smi}
        emit(res)
        cells[cell] = res
    return cells


def _freq_input():
    from ccsmeth_tpu_torch.utils.simulate import make_synth_bam, write_fasta

    d = os.path.join(WORK, "freq")
    os.makedirs(d, exist_ok=True)
    bam, fasta = os.path.join(d, "reads.bam"), os.path.join(d, "ref.fa")
    if not (os.path.exists(bam) and os.path.exists(fasta)):
        t0 = time.time()
        refseq, _ = make_synth_bam(bam, n_reads=FREQ_READS, read_len=FREQ_READ_LEN,
                                   ref_len=FREQ_REF_LEN, seed=SEED + 1)
        write_fasta(fasta, {"chrS": refseq})
        log("freq input: {} reads x {} bp on {} bp ({:.1f}x), simulated in {:.1f} s"
            .format(FREQ_READS, FREQ_READ_LEN, FREQ_REF_LEN,
                    FREQ_READS * FREQ_READ_LEN / FREQ_REF_LEN, time.time() - t0))
    return bam, fasta


def _hp_tagged(src, dst):
    """HP tags drawn as tests/make_goldens.py:108-117 draws them."""
    import numpy as np

    from ccsmeth_tpu_torch.bamio import BamReader, BamWriter

    rd = BamReader(src)
    recs = list(rd)
    rng = np.random.RandomState(1)
    for rec in recs:
        hap = int(rng.randint(0, 3))
        if hap:
            rec.set_tag("HP", "i", hap)
    with BamWriter(dst, rd.header) as w:
        for rec in recs:
            w.write(rec)


def _freq_rows(prefix, mode):
    """{group: lines} of a call_freqb run's freq.txt outputs."""
    out = {}
    for tag in ("all", "hp1", "hp2"):
        path = "{}.{}.{}.freq.txt".format(prefix, mode, tag)
        with open(path) as f:
            out[tag] = f.read().splitlines()
    return out


def phase_freq(torch, smi):
    """call_freqb on a realistic-coverage modbam through the CLI: call_mods
    (attbigru2s, fp32) on the freq input, HP tags, count mode (host only,
    no kernel launches), then aggregate mode for each cell with a
    numpy-seeded full-width AggrAttRNN on the card and again with --device
    cpu. The counts are set to 0 just before each run and read just after:
    on the card K1 launches once a batch (2 CUDA launches, simt) and no plain
    version runs. Gates: the model's raw outputs on the same windows to
    1e-5, and the rows of the three outputs equal except at most max(1,
    rows // 200), the JAX package's own allowance."""
    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import AggrConfig, init_aggr_attrnn
    from ccsmeth_tpu_torch.models.params_io import save_params
    from ccsmeth_tpu_torch.pipeline import call_freq_bam, call_mods

    t_phase = time.time()
    bam, fasta = _freq_input()
    d = os.path.join(WORK, "freq")
    _zero_counts()
    cli.main(["call_mods", "-i", bam, "-o", os.path.join(d, "mods"), "-m",
              os.path.join(WORK, MODELS["gru"] + "_full.ckpt.npz"), "--mode", "align",
              "--ref", fasta, "--device", "cuda"])
    torch.cuda.synchronize()
    mods_run, counts = dict(call_mods.LAST_RUN), _all_counts()
    assert counts["k1"] == mods_run["batches"] > 0 == counts["k1_plain"], counts
    tagged = os.path.join(d, "mods.hp.bam")
    _hp_tagged(os.path.join(d, "mods.modbam.bam"), tagged)
    base = ["call_freqb", "-i", tagged, "--ref", fasta]

    _zero_counts()
    cli.main(base + ["-o", os.path.join(d, "count")])
    count_run = dict(call_freq_bam.LAST_RUN)
    assert sum(_all_counts().values()) == 0  # count mode is host code
    count_rows = _freq_rows(os.path.join(d, "count"), "count")
    assert count_run["sites"] == len(count_rows["all"]) > 0
    res = {"phase": "freq", "input": {"reads": FREQ_READS, "read_len": FREQ_READ_LEN,
                                      "ref_len": FREQ_REF_LEN,
                                      "coverage": FREQ_READS * FREQ_READ_LEN / FREQ_REF_LEN},
           "call_mods_sites": mods_run["sites"],
           "call_mods_sites_per_s": mods_run["sites"] / mods_run["seconds"],
           "count": {"sites": count_run["sites"], "seconds": count_run["seconds"],
                     "sites_per_s": count_run["sites"] / count_run["seconds"]},
           "card": smi}

    recorded = []  # (offsets, histos, raw) of every model call of a run
    raw = call_freq_bam.AggrPredictor.raw

    def recording_raw(self, offsets, histos):
        out = raw(self, offsets, histos)
        recorded.append((offsets.copy(), histos.copy(), out.copy()))
        return out

    call_freq_bam.AggrPredictor.raw = recording_raw
    try:
        for cell, model_type in AGGR_CELLS.items():
            npz = os.path.join(d, model_type + "_aggr.npz")
            save_params(npz, init_aggr_attrnn(SEED, AggrConfig(model_type=model_type)))
            runs, rows, by_dev = {}, {}, {}
            for dev in ("cuda", "cpu"):
                prefix = os.path.join(d, "{}_{}".format(model_type, dev))
                del recorded[:]
                _zero_counts()
                cli.main(base + ["-o", prefix, "--call_mode", "aggregate", "-m", npz,
                                 "--model_type", model_type, "--device", dev])
                torch.cuda.synchronize()
                by_dev[dev] = list(recorded)
                run = dict(call_freq_bam.LAST_RUN, launches=_all_counts(),
                           cuda_launches=_cuda_launches()["k1"],
                           designs=_design_counts()["k1"])
                n = run["batches"]
                assert n > 0 and run["rows"] == AGGR_ROWS * n, run
                if dev == "cuda":
                    assert run["launches"]["k1"] == n, run
                    assert sum(run["launches"].values()) == n, run  # no plain run
                    assert run["cuda_launches"] == 2 * n, run
                    assert run["designs"]["simt"] == n == sum(run["designs"].values())
                else:
                    assert run["launches"]["k1_plain"] == n, run
                    assert run["launches"]["k1"] == 0 == run["cuda_launches"], run
                run["sites_per_s"] = run["sites"] / run["seconds"]
                runs[dev] = run
                rows[dev] = _freq_rows(prefix, "aggregate")
            assert len(by_dev["cuda"]) == len(by_dev["cpu"]) > 0
            raw_err = 0.0
            for (oa, ha, ra), (ob, hb, rb) in zip(by_dev["cuda"], by_dev["cpu"]):
                assert np.array_equal(oa, ob) and np.array_equal(ha, hb)
                raw_err = max(raw_err, float(np.abs(ra - rb).max()))
            assert raw_err <= 1e-5, (model_type, raw_err)
            n_rows = sum(len(v) for v in rows["cpu"].values())
            n_diff = 0
            for tag in rows["cpu"]:
                a, b = rows["cuda"][tag], rows["cpu"][tag]
                assert len(a) == len(b) > 0, tag
                n_diff += sum(x != y for x, y in zip(a, b))
            assert n_diff <= max(1, n_rows // 200), (model_type, n_diff, n_rows)
            res[model_type] = {
                "sites": runs["cuda"]["sites"], "rows_written": n_rows,
                "rows_through_model": runs["cuda"]["rows"],
                "windows": sum(r[2].size for r in by_dev["cuda"]),
                "k1_calls": runs["cuda"]["launches"]["k1"],
                "cuda_launches": runs["cuda"]["cuda_launches"],
                "cuda_launches_per_call": runs["cuda"]["cuda_launches"]
                / runs["cuda"]["launches"]["k1"],
                "design": "simt", "designs": runs["cuda"]["designs"],
                "sites_per_s": runs["cuda"]["sites_per_s"],
                "sites_per_s_cpu": runs["cpu"]["sites_per_s"],
                "seconds": runs["cuda"]["seconds"], "raw_max_abs_err": raw_err,
                "rows_differing_from_cpu": n_diff, "allowed": max(1, n_rows // 200)}
    finally:
        call_freq_bam.AggrPredictor.raw = raw
    res["wall_s"] = time.time() - t_phase
    emit(res)
    return res


def _per_readsite(path):
    with open(path) as f:
        return [ln.split("\t") for ln in f.read().splitlines()]


def _ml_share_text(rows, tags):
    """Share of per_readsite rows whose floor(p1 * 256) equals the BAM path's
    ML byte of the same site: per read, the rows in read-position order
    against the ML bytes in tag order (reads whose site counts differ are
    counted apart)."""
    import numpy as np

    by_read = {}
    for w in rows:
        by_read.setdefault(w[3], []).append((int(w[4]), float(w[7])))
    n = n_equal = skipped = 0
    for q, sites in by_read.items():
        ml = tags.get(q, (None, None))[1]
        if ml is None or ml.size != len(sites):
            skipped += 1
            continue
        p1 = np.asarray([p for _loc, p in sorted(sites)])
        n += ml.size
        n_equal += int((np.clip(np.floor(p1 * 256.0), 0, 255) == ml).sum())
    return {"sites": n, "ml_equal_share": n_equal / n if n else None,
            "reads_skipped": skipped}


def phase_text(torch, smi, k1_tags):
    """The text path through the CLI: extract on the e2e BAM gives a
    features TSV; call_mods on it with attbigru2s (fp32, K1) and
    transencoder2s (fp32, K3) on the card, counts set to 0 just before each
    run and read just after; the same models with --device cpu on the
    TSV's first TEXT_CPU_ROWS rows; then call_freqt on the card's output.
    Gate: the printed probabilities of those rows to 1e-5, every other field
    equal. Reported, not gated: how often floor(p1 * 256) equals the BAM
    path's ML byte of the same site (attbigru2s fp32 e2e run)."""
    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.pipeline import call_mods

    t_phase = time.time()
    bam, fasta = _e2e_input()
    d = os.path.join(WORK, "text")
    os.makedirs(d, exist_ok=True)
    feats = os.path.join(d, "features.tsv")
    t0 = time.time()
    cli.main(["extract", "-i", bam, "-o", feats, "--mode", "align", "--ref", fasta])
    extract_s = time.time() - t0
    head = os.path.join(d, "features_head.tsv")
    with open(feats) as f, open(head, "w") as h:
        lines = f.readlines()
        h.writelines(lines[:TEXT_CPU_ROWS])
    res = {"phase": "text", "extract": {"sites": len(lines), "seconds": extract_s,
                                        "sites_per_s": len(lines) / extract_s},
           "cpu_rows": TEXT_CPU_ROWS, "card": smi}
    for model_type in (MODELS["gru"], TRANSENC):
        name = "k3" if model_type == TRANSENC else "k1"
        ckpt = os.path.join(WORK, model_type + "_full.ckpt.npz")
        args = ["call_mods", "-m", ckpt, "--model_type", model_type]
        _zero_counts()
        cli.main(args + ["-i", feats, "-o", os.path.join(d, model_type),
                         "--device", "cuda"])
        torch.cuda.synchronize()
        run, counts = dict(call_mods.LAST_RUN), _all_counts()
        cuda, designs = _cuda_launches(), _design_counts()[name]
        n = run["batches"]
        assert run["sites"] == len(lines) and n > 0 and counts[name] == n, (run, counts)
        assert sum(counts.values()) == n, counts  # no other kernel, no plain run
        assert designs["simt"] == n, designs
        assert cuda[name] == (2 * NL if name == "k1" else 1) * n, cuda
        cli.main(args + ["-i", head, "-o", os.path.join(d, model_type + "_cpu"),
                         "--device", "cpu"])
        card = _per_readsite(os.path.join(d, model_type + ".per_readsite.tsv"))
        cpu = _per_readsite(os.path.join(d, model_type + "_cpu.per_readsite.tsv"))
        assert len(card) == len(lines) and len(cpu) == TEXT_CPU_ROWS
        err = 0.0
        for a, b in zip(card, cpu):
            assert a[:6] + a[8:] == b[:6] + b[8:], (a, b)
            err = max(err, abs(float(a[6]) - float(b[6])), abs(float(a[7]) - float(b[7])))
        assert err <= 1e-5, (model_type, err)
        t0 = time.time()
        freq = os.path.join(d, model_type + ".freq.txt")
        cli.main(["call_freqt", "-i", os.path.join(d, model_type + ".per_readsite.tsv"),
                  "-o", freq])
        freqt_s = time.time() - t0
        with open(freq) as f:
            n_freq = len(f.read().splitlines())
        assert n_freq > 0
        line = {"sites": run["sites"], "batches": n, "launches": counts[name],
                "cuda_launches": cuda[name], "designs": designs,
                "sites_per_s": run["sites"] / run["seconds"],
                "max_abs_err_vs_cpu": err,
                "call_freqt": {"sites": n_freq, "seconds": freqt_s}}
        if model_type == MODELS["gru"]:
            line["vs_bam_path"] = _ml_share_text(card, k1_tags)
        res[model_type] = line
    res["wall_s"] = time.time() - t_phase
    emit(res)
    return res


def _csv6(values):
    """Comma-joined values rounded to 6 decimals (the same numbers as
    ``str(round(x, 6))``, formatted faster)."""
    return ",".join(map("{:.6f}".format, values.tolist()))


def _write_feature_tsv(path, n, seed, seq_len=21):
    """Separable synthetic features: label-1 rows get an ipd shift at the
    center (the writer of tests/test_training.py:18-39)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    bases = "ACGT"
    with open(path, "w") as f:
        for i in range(n):
            label = i % 2
            kmer = "".join(rng.choice(list(bases), seq_len))
            kmer = kmer[:10] + "CG" + kmer[12:]
            ipd = rng.randn(seq_len)
            pw = rng.randn(seq_len)
            if label:
                ipd[8:13] += 2.0
            row = [
                "chr1", str(1000 + i), "+", "read/{}/ccs".format(i), str(50 + i),
                kmer, "10", _csv6(ipd), ".", _csv6(pw), ".", ".", ".",
                kmer[::-1], "9", _csv6(rng.randn(seq_len)),
                ".", _csv6(rng.randn(seq_len)), ".", ".",
                ".", str(label),
            ]
            f.write("\t".join(row) + "\n")


def _train_cli(cli, model_type, tr, va, mdir, prec, epochs, interval):
    cli.main(["train", "--train_file", tr, "--valid_file", va, "--model_dir", mdir,
              "--model_type", model_type, "--device", "cuda", "--precision", prec,
              "--max_epoch_num", str(epochs), "--min_epoch_num", str(epochs),
              "--step_interval", str(interval), "--tseed", str(SEED % 10000)])


def _train_input():
    os.makedirs(WORK, exist_ok=True)
    tr, va = os.path.join(WORK, "train.tsv"), os.path.join(WORK, "valid.tsv")
    tr16 = os.path.join(WORK, "train_bf16.tsv")
    if not all(os.path.exists(p) for p in (tr, va, tr16)):
        t0 = time.time()
        _write_feature_tsv(tr, TRAIN_ROWS, SEED)
        _write_feature_tsv(va, VALID_ROWS, SEED + 1)
        _write_feature_tsv(tr16, BF16_TRAIN_ROWS, SEED + 2)
        log("train input: {} + {} rows, {:.1f} + {:.1f} MB, written in {:.1f} s"
            .format(TRAIN_ROWS, VALID_ROWS, os.path.getsize(tr) / 1e6,
                    os.path.getsize(va) / 1e6, time.time() - t0))
    return tr, va, tr16


def phase_train(torch, smi, cell, epochs, models=MODELS):
    """The train path at full width: the CLI at its defaults (3x256, batch
    512, dropout 0.5, Adam 1e-3, StepLR) for attbigru2s (cell 'gru': kernels
    K4/K5) or attbilstm2s ('lstm': K6), or with ``models=MODELS2S2`` their
    embedded-kinetics siblings (layer 0 at C = 28), K1 validating. The
    launch counts of every training kernel and of K1 are set to 0 just
    before the run and read just after it."""
    import math

    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import AttRNNConfig
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, bilstm_vjp
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model, load_model_params
    from ccsmeth_tpu_torch.training.train import LAST_RUN

    from ccsmeth_tpu_torch.models.attrnn import rnn_input_size

    model_type = models[cell]
    mine, other = ((bigru_vjp, bilstm_vjp) if cell == "gru"
                   else (bilstm_vjp, bigru_vjp))
    tr, va, tr16 = _train_input()
    log("train cut ({}): {} epochs of {} steps (a real run trains up to 50 "
        "epochs on millions of rows)".format(model_type, epochs, TRAIN_ROWS // 512))

    for V in (bigru_vjp, bilstm_vjp):
        V.launches_fwd = V.launches_bwd = V.plain_calls = 0
    _zero_k45_designs()
    bigru.launches = bigru.plain_calls = 0
    t0 = time.time()
    _train_cli(cli, model_type, tr, va, os.path.join(WORK, model_type + "_fp32"),
               "fp32", epochs, STEP_INTERVAL)
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = dict(LAST_RUN)
    counts = {"fwd": mine.launches_fwd, "bwd": mine.launches_bwd,
              "k1": bigru.launches, "plain_vjp": mine.plain_calls,
              "plain_k1": bigru.plain_calls,
              "other_cell": other.launches_fwd + other.launches_bwd + other.plain_calls}
    steps = run["steps"]
    n_valid = len(run["valid_losses"])
    assert steps == epochs * (TRAIN_ROWS // 512), steps
    assert counts["fwd"] == counts["bwd"] == 3 * steps, counts
    assert counts["k1"] == n_valid * math.ceil(VALID_ROWS / 512) > 0, counts
    assert counts["plain_vjp"] == counts["plain_k1"] == counts["other_cell"] == 0, \
        counts
    # fp32 trains the cell's kernels (K4/K5 or K6) through the simt design
    # only, each call's CUDA launches counted where they are made, and
    # launches nothing of the other cell's
    designs, k45_cuda = dict(mine.design_calls), mine.cuda_launches
    cin0 = rnn_input_size(AttRNNConfig(model_type=model_type))
    per_step = sum(2 + _bwd_cuda_launches(2 * 512, cin, torch.float32, cell)
                   for cin in (cin0, 2 * H, 2 * H))
    assert designs == {"tc": 0, "simt": counts["fwd"] + counts["bwd"]}, designs
    assert k45_cuda == per_step * steps, (k45_cuda, per_step, steps)
    assert other.cuda_launches == sum(other.design_calls.values()) == 0
    assert np.all(np.isfinite(run["train_losses"] + run["valid_losses"])), run
    assert run["best_accuracy"] >= 0.9, run["best_accuracy"]
    # the checkpoint loads into the port's call_mods model
    cfg = AttRNNConfig(dropout_rate=0.0, model_type=model_type)
    model = build_model(load_model_params(run["ckpts"][-1], cfg), cfg, "cuda")
    feats = {k: torch.from_numpy(v).cuda() for k, v in _model_feats(512, SEED).items()}
    with torch.inference_mode():
        _l, probs = model(feats)
    assert probs.shape == (512, 2) and bool(torch.isfinite(probs).all())
    # and into the port's call_mods model: fp32 probs through K1 equal the
    # plain version's
    with torch.inference_mode():
        _l, plain = model(feats, rnn_fn=bigru.birnn_stack_plain)
    assert (probs - plain).abs().max().item() <= 1e-5

    per_epoch = steps / epochs
    steady = float(np.mean(run["epoch_wall_s"][1:]))
    res = {"phase": "train", "precision": "fp32", "model": model_type + " 3x256",
           "C": cin0,
           "batch": 512, "steps": steps, "epochs": epochs,
           "validations": n_valid, "launches": counts, "k45_designs": designs,
           "k45_cuda_launches": k45_cuda,
           "best_accuracy": run["best_accuracy"],
           "train_losses": run["train_losses"], "valid_losses": run["valid_losses"],
           "epoch_wall_s": run["epoch_wall_s"], "wall_s": wall,
           "steps_per_s_steady": per_epoch / steady,
           "samples_per_s_steady": per_epoch * 512 / steady,
           "steps_per_s_first_epoch": per_epoch / run["epoch_wall_s"][0],
           "card": smi}
    emit(res)

    # a few steps in bf16: K4/K5 or K6 through the tc design only
    before = (mine.launches_fwd, mine.launches_bwd)
    _zero_k45_designs()
    _train_cli(cli, model_type, tr16, va, os.path.join(WORK, model_type + "_bf16"),
               "bf16", 1, BF16_TRAIN_ROWS // 512)
    torch.cuda.synchronize()
    run16 = dict(LAST_RUN)
    n16 = (mine.launches_fwd - before[0], mine.launches_bwd - before[1])
    assert n16[0] == n16[1] == 3 * run16["steps"] > 0, n16
    assert np.all(np.isfinite(run16["train_losses"] + run16["valid_losses"])), run16
    assert mine.plain_calls == 0
    designs16 = dict(mine.design_calls)
    assert designs16 == {"tc": sum(n16), "simt": 0}, designs16
    res["bf16_launches"] = {"fwd": n16[0], "bwd": n16[1], "k45_designs": designs16,
                            "k45_cuda_launches": mine.cuda_launches}
    emit({"phase": "train", "precision": "bf16", "model": model_type + " 3x256",
          "steps": run16["steps"], "launches": res["bf16_launches"],
          "train_losses": run16["train_losses"],
          "valid_losses": run16["valid_losses"],
          "best_accuracy": run16["best_accuracy"], "card": smi})
    return res


def _design_calls(launches, designs, key, design):
    """A run's ``key`` calls ('fwd' or 'bwd') of its cell's training kernels
    that took ``design``, from the run's own counters: ``launches`` holds its
    fwd and bwd calls, ``designs`` the same calls by design. Every run's
    calls take one design, so they are all of ``design``'s or none."""
    total = launches["fwd"] + launches["bwd"]
    assert designs[design] in (0, total), (launches, designs)
    return launches[key] if designs[design] else 0


def _zero_k45_designs():
    """The training kernels' (K4/K5 and K6) CUDA launches and calls by
    design, set to 0."""
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    for V in (bigru_vjp, bilstm_vjp):
        V.cuda_launches = 0
        for k in V.design_calls:
            V.design_calls[k] = 0


def phase_profile(torch, smi, cell, steps=5):
    """Where a full-width training step's time goes: torch.profiler over
    ``steps`` steps (attbigru2s or attbilstm2s 3x256, batch 512, fp32,
    dropout 0.5, Adam)
    after two warm-up steps; device time per kernel name, the device's busy
    time against the host clock, and the step time. Launches here are not
    the train path's and are read nowhere."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig
    from ccsmeth_tpu_torch.training import build_optimizer
    from ccsmeth_tpu_torch.training.train import make_train_step

    model = AttRNN(AttRNNConfig(model_type=MODELS[cell])).cuda()
    opt = build_optimizer("Adam", 1e-3)
    opt.init(model.parameters())
    step = make_train_step(model, opt, 1.0)
    feats = {k: torch.from_numpy(v).cuda() for k, v in _model_feats(512, SEED).items()}
    labels = torch.from_numpy(np.random.RandomState(SEED).randint(0, 2, 512)).cuda()
    mask = torch.ones(512, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    for _ in range(2):
        step(feats, labels, mask, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(steps):
            step(feats, labels, mask, gen)
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3 / steps
    rows = []  # device-side events only: kernels and copies
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if dev_us > 0 and str(e.device_type).endswith("CUDA"):
            rows.append((dev_us / steps / 1e3, e.count / steps, e.key))
    rows.sort(reverse=True)
    device_ms = sum(r[0] for r in rows)
    res = {"phase": "profile",
           "what": "train step, {} 3x256, batch 512, fp32".format(MODELS[cell]),
           "steps": steps, "step_ms_host": wall_ms, "device_ms_per_step": device_ms,
           "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms else None,
           "top": [{"kernel": k[:90], "ms_per_step": ms, "calls_per_step": n}
                   for ms, n, k in rows[:12]], "card": smi}
    if not rows:
        log("profile: torch.profiler recorded no device time")
    log("profile {}: {:.2f} ms a step on the host, {:.2f} ms on the device, idle "
        "share {}".format(MODELS[cell], wall_ms, device_ms, res["device_idle_share"]))
    emit(res)
    return res


def _train_digest(out_path, model_type, precision):
    """Child of the determinism phase, a process of its own: two full-width
    training steps (batch 512, dropout 0.5, Adam) from seeded weights on
    seeded batches. Writes, for each step, the loss, the gradient of every
    hooked activation in the order the backward reached it, every parameter's
    gradient and every parameter after the update, to ``out_path`` (npz)."""
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig,
                                          attrnn_state_dict_from_params, init_attrnn)
    from ccsmeth_tpu_torch.training import build_optimizer
    from ccsmeth_tpu_torch.training.train import weighted_ce

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = AttRNNConfig(model_type=model_type)
    model = AttRNN(cfg)
    model.load_state_dict(attrnn_state_dict_from_params(init_attrnn(SEED, cfg)))
    model.cuda()
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = build_optimizer("Adam", 1e-3)
    opt.init(params)
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    acts = []

    def hook(name):
        def fwd(_mod, inputs, output):
            ts = [("out", output)] if torch.is_tensor(output) else []
            ts += [("in{}".format(i), t) for i, t in enumerate(inputs)
                   if torch.is_tensor(t)]
            for tag, t in ts:
                if t.requires_grad:
                    t.register_hook(lambda g, key="{}.{}".format(name, tag):
                                    acts.append((key, g.detach().float().cpu().numpy())))
        return fwd

    for name, mod in model.named_modules():
        if name and not list(mod.children()):
            mod.register_forward_hook(hook(name))
    rec = {}
    for s in range(2):
        feats = {k: torch.from_numpy(v).cuda() for k, v in
                 _model_feats(512, SEED + s).items()}
        labels = torch.from_numpy(
            np.random.RandomState(SEED + s).randint(0, 2, 512)).cuda()
        mask = torch.ones(512, device="cuda")
        acts.clear()
        logits, _ = model(feats, dt, train=True, generator=gen)
        loss = weighted_ce(logits, labels, mask,
                           torch.tensor([1.0, 1.0], device="cuda"))
        grads = torch.autograd.grad(loss, params)
        rec["s{}/loss".format(s)] = np.float64(loss.item())
        rec["s{}/logits".format(s)] = logits.detach().cpu().numpy()
        for i, (k, g) in enumerate(acts):
            rec["s{}/act{:02d}/{}".format(s, i, k)] = g
        for n, g in zip(names, grads):
            rec["s{}/grad/{}".format(s, n)] = g.cpu().numpy()
        opt.step(params, grads)
        for n, p in zip(names, params):
            rec["s{}/param/{}".format(s, n)] = p.detach().cpu().numpy()
    np.savez(out_path, **rec)


def _digest_diff(a, b):
    """Keys of two ``_train_digest`` files whose arrays differ, in the order
    they were recorded within each step, with each key's max |a - b|."""
    import numpy as np

    diffs = []
    for k in a.files:
        x, y = a[k], b[k]
        if x.shape != y.shape or x.tobytes() != y.tobytes():
            d = float(np.max(np.abs(x.astype(np.float64) - y.astype(np.float64))))
            diffs.append((k, d))
    return diffs


def _digest_runs(tags):
    """``_train_digest`` of attbigru2s fp32 in a fresh process for each tag,
    the processes side by side on the card; {tag: npz}."""
    import numpy as np

    paths = {tag: os.path.join(WORK, "digest_{}.npz".format(tag)) for tag in tags}
    procs = {tag: subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                    "--train-digest", path, MODELS["gru"], "fp32"],
                                   stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                   text=True)
             for tag, path in paths.items()}
    errs = {tag: p.communicate()[1] for tag, p in procs.items()}
    for tag, p in procs.items():
        assert p.returncode == 0, (tag, errs[tag][-3000:])
    return {tag: np.load(path) for tag, path in paths.items()}


# the embedding lookups of one training step (batch 512, both strands of
# 512 x 21 positions each): (rows, width) of each table
STEP_TABLES = {"attbigru2s": [(5, 8)],
               "attbigru2s2": [(5, 8), (953, 8), (953, 8), (31, 4)]}


def _lookup_ms(torch, rows, width, native):
    """Device ms of one lookup's forward and backward at a step's shape
    (512 x 21 indices): ``embed_rows`` (the fixed-order backward) or
    ``F.embedding`` (``native``)."""
    import torch.nn.functional as F

    from ccsmeth_tpu_torch.models.attrnn import embed_rows

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    table = torch.randn(rows, width, device="cuda", requires_grad=True)
    idx = torch.randint(0, rows, (512, L), device="cuda", generator=g)
    up = torch.randn(512, L, width, device="cuda", generator=g)
    lookup = (lambda: F.embedding(idx, table)) if native else (
        lambda: embed_rows(table, idx))
    return time_ms(lambda: torch.autograd.grad(lookup(), table, up), torch)


def phase_determinism(torch, smi):
    """Two identical training runs give the same bits on the card.
    (1) Two steps of attbigru2s at full width (``_train_digest``) in two
    fresh processes: every activation gradient, parameter gradient and
    parameter after each step bit-equal. (2) The train path twice in this process:
    ``train`` at its defaults for one epoch, the same seeds, equal losses
    and an equal sha256 of the final parameters. (3) The repair's cost a
    step: the device time of a step's embedding lookups (forward and
    backward, both strands) with the fixed-order backward against
    ``F.embedding``'s, attbigru2s and attbigru2s2."""
    import hashlib
    import importlib

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.training.train import LAST_RUN

    t0 = time.time()
    files = _digest_runs(("a", "b"))
    differ = _digest_diff(files["a"], files["b"])
    assert not differ, differ[:10]
    tr, va, _tr16 = _train_input()
    runs = []
    train_mod = importlib.import_module("ccsmeth_tpu_torch.training.train")
    for i in range(2):
        models = []
        make_eval = train_mod.make_eval_step

        def capture(model, pos_weight):  # the trained model, read after the run
            models.append(model)
            return make_eval(model, pos_weight)

        train_mod.make_eval_step = capture
        try:
            _train_cli(cli, MODELS["gru"], tr, va, os.path.join(WORK, "det{}".format(i)),
                       "fp32", 1, STEP_INTERVAL)
        finally:
            train_mod.make_eval_step = make_eval
        run = dict(LAST_RUN)
        h = hashlib.sha256()
        for k, v in models[0].state_dict().items():
            h.update(k.encode())
            h.update(v.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
        runs.append((run["train_losses"], run["valid_losses"], h.hexdigest()))
    assert runs[0] == runs[1], runs
    cost = {}
    for model_type, tables in STEP_TABLES.items():
        ms = {k: 2 * sum(_lookup_ms(torch, rows, width, k == "native")
                         for rows, width in tables) for k in ("fixed", "native")}
        cost[model_type] = dict(ms, repair_ms_per_step=ms["fixed"] - ms["native"])
    res = {"phase": "determinism", "card": smi,
           "digest": {"leaves": len(files["a"].files), "a_vs_b_differ": len(differ)},
           "train_twice": {"steps": len(runs[0][0]) * STEP_INTERVAL,
                           "train_losses": runs[0][0], "final_params_sha256": runs[0][2],
                           "equal": True},
           "repair_cost": cost, "wall_s": time.time() - t0}
    emit(res)
    return res


def _write_ss_tsv(path, n, seed, seq_len=21):
    """Separable single-strand features (14 columns, the FeaData3ss rows
    trainm reads for the *1s families): label-1 rows get an ipd shift at
    the centre, as ``_write_feature_tsv``."""
    import numpy as np

    rng = np.random.RandomState(seed)
    with open(path, "w") as f:
        for i in range(n):
            label = i % 2
            kmer = "".join(rng.choice(list("ACGT"), seq_len))
            kmer = kmer[:10] + "CG" + kmer[12:]
            ipd = rng.randn(seq_len)
            if label:
                ipd[8:13] += 2.0
            f.write("\t".join([
                "chr1", str(1000 + i), "+", "read/{}/ccs".format(i), str(50 + i), kmer,
                "10", _csv6(ipd), ".", _csv6(rng.randn(seq_len)), ".", ".", ".",
                str(label)]) + "\n")


def _zero_train_counts():
    """The training kernels' calls, plain runs, CUDA launches and designs,
    K1's and K3's calls and plain runs, set to 0."""
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    for V in (bigru_vjp, bilstm_vjp):
        V.launches_fwd = V.launches_bwd = V.plain_calls = 0
    _zero_k45_designs()
    _zero_counts()


def _train_counts(cell):
    """(the cell's training kernels, the other cell's, K1's / K3's) calls
    since ``_zero_train_counts``."""
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    mine, other = ((bigru_vjp, bilstm_vjp) if cell == "gru"
                   else (bilstm_vjp, bigru_vjp))
    return ({"fwd": mine.launches_fwd, "bwd": mine.launches_bwd,
             "plain": mine.plain_calls, "cuda_launches": mine.cuda_launches,
             "designs": dict(mine.design_calls)},
            other.launches_fwd + other.launches_bwd + other.plain_calls
            + other.cuda_launches, _all_counts())


def phase_train1s(torch, smi, cell, epochs):
    """trainm for attbigru1s (cell 'gru': K4/K5) or attbilstm1s ('lstm':
    K6) at the CLI defaults (3 x 256, batch 512, dropout 0.5, Adam) on
    separable single-strand rows: one strand of 512 rows through each
    kernel call, 3 calls of each a step, simt only, no plain run and
    nothing of the other cell's; K1 on every validation batch."""
    import math

    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import AttRNNConfig
    from ccsmeth_tpu_torch.models.attrnn import rnn_input_size
    from ccsmeth_tpu_torch.training.train import LAST_RUN

    model_type = MODELS1S[cell]
    d = os.path.join(WORK, "train1s")
    os.makedirs(d, exist_ok=True)
    tr, va = os.path.join(d, "train.tsv"), os.path.join(d, "valid.tsv")
    if not (os.path.exists(tr) and os.path.exists(va)):
        _write_ss_tsv(tr, TRAIN_ROWS, SEED + 3)
        _write_ss_tsv(va, VALID_ROWS, SEED + 4)
    _zero_train_counts()
    t0 = time.time()
    cli.main(["trainm", "--train_file", tr, "--valid_file", va, "--model_dir",
              os.path.join(d, model_type), "--model_type", model_type, "--device", "cuda",
              "--max_epoch_num", str(epochs), "--min_epoch_num", str(epochs),
              "--step_interval", str(STEP_INTERVAL), "--tseed", str(SEED % 10000)])
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = dict(LAST_RUN)
    mine, other, inf = _train_counts(cell)
    steps, n_valid = run["steps"], len(run["valid_losses"])
    assert steps == epochs * (TRAIN_ROWS // 512), steps
    assert mine["fwd"] == mine["bwd"] == 3 * steps and mine["plain"] == 0 == other, \
        (mine, other)
    assert mine["designs"] == {"tc": 0, "simt": 6 * steps}, mine
    cin0 = rnn_input_size(AttRNNConfig(model_type=model_type))
    per_step = sum(2 + _bwd_cuda_launches(512, cin, torch.float32, cell)
                   for cin in (cin0, 2 * H, 2 * H))
    assert mine["cuda_launches"] == per_step * steps, (mine, per_step)
    assert inf["k1"] == n_valid * math.ceil(VALID_ROWS / 512) > 0 == inf["k1_plain"], inf
    assert np.all(np.isfinite(run["train_losses"] + run["valid_losses"])), run
    assert run["best_accuracy"] >= 0.9, run["best_accuracy"]
    steady = float(np.mean(run["epoch_wall_s"][1:]))
    res = {"phase": "train1s", "model": model_type + " 3x256", "batch": 512,
           "rows_per_kernel_call": 512, "steps": steps, "epochs": epochs,
           "validations": n_valid, "launches": mine, "k1_launches": inf["k1"],
           "best_accuracy": run["best_accuracy"], "train_losses": run["train_losses"],
           "valid_losses": run["valid_losses"], "epoch_wall_s": run["epoch_wall_s"],
           "wall_s": wall, "samples_per_s_steady": steps / epochs * 512 / steady,
           "card": smi}
    emit(res)
    return res


def phase_train_te(torch, smi, epochs):
    """train --model_type transencoder2s at the defaults (6 layers, d_model
    256, 4 heads, FF 512, batch 512, dropout 0.5, Adam) in fp32 and in bf16
    on the separable set: the training forward in PyTorch ops (no kernel),
    K3 on every validation batch and nowhere else, no K1 or training
    kernel, TF32 off around and after the fp32 run. Gates: finite losses,
    the last interval's train loss under half the first's, and the trained
    model's accuracy on the validation set through the training forward
    (the SrcEmbed BatchNorms on the batch's statistics, dropout off) >= 0.9.
    The trainer's own validation normalises with the running statistics,
    which training leaves as loaded in both packages (nothing written back,
    as the JAX package's trainer), so its accuracy is reported, not gated
    (ROADMAP.md Queue 3)."""
    import math

    import numpy as np

    import importlib

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.ops import transenc
    from ccsmeth_tpu_torch.training.data import FeatureDataset

    train_mod = importlib.import_module("ccsmeth_tpu_torch.training.train")
    tr, va, _tr16 = _train_input()
    valid = FeatureDataset.from_tsv(va, 21)
    out = {}
    for prec in ("fp32", "bf16"):
        models = []
        make_eval = train_mod.make_eval_step

        def capture(model, pos_weight):  # the trained model, read after the run
            models.append(model)
            return make_eval(model, pos_weight)

        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        _zero_train_counts()
        train_mod.make_eval_step = capture
        t0 = time.time()
        try:
            _train_cli(cli, TRANSENC, tr, va, os.path.join(WORK, "te_" + prec), prec,
                       epochs, STEP_INTERVAL)
        finally:
            train_mod.make_eval_step = make_eval
        torch.cuda.synchronize()
        wall = time.time() - t0
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        run = dict(train_mod.LAST_RUN)
        counts = _all_counts()
        n_valid = len(run["valid_losses"])
        steps = run["steps"]
        assert steps == epochs * (TRAIN_ROWS // 512), steps
        assert counts["k3"] == n_valid * math.ceil(VALID_ROWS / 512) > 0, counts
        assert counts["k3_plain"] == counts["k1"] == counts["k1_plain"] == 0, counts
        assert transenc.design_calls["simt"] == counts["k3"], transenc.design_calls
        mine, other, _inf = _train_counts("gru")
        assert mine["fwd"] + mine["bwd"] + mine["plain"] + other == 0
        tl = run["train_losses"]
        assert np.all(np.isfinite(tl + run["valid_losses"])), run
        assert tl[-1] < 0.5 * tl[0], tl
        model = models[0]
        correct = n = 0
        with torch.no_grad():
            for feats, labels, nv in valid.batches(512, False, np.random.RandomState(0)):
                ft = {k: torch.from_numpy(v).cuda() for k, v in feats.items()}
                _l, probs = model(ft, getattr(torch, {"fp32": "float32",
                                                      "bf16": "bfloat16"}[prec]),
                                  train=True, generator=None)
                pred = probs.argmax(1).cpu().numpy()[:nv]
                correct += int((pred == np.asarray(labels)[:nv]).sum())
                n += nv
        acc_batch_stats = correct / n
        assert acc_batch_stats >= 0.9, acc_batch_stats
        steady = float(np.mean(run["epoch_wall_s"][1:]))
        out[prec] = {"phase": "train_te", "model": TRANSENC + " 6x256", "precision": prec,
                     "batch": 512, "steps": steps, "epochs": epochs,
                     "validations": n_valid, "k3_launches": counts["k3"],
                     "k3_designs": dict(transenc.design_calls),
                     "accuracy_batch_statistics": acc_batch_stats,
                     "trainer_best_accuracy_running_statistics": run["best_accuracy"],
                     "train_losses": tl, "valid_losses": run["valid_losses"],
                     "epoch_wall_s": run["epoch_wall_s"], "wall_s": wall,
                     "samples_per_s_steady": steps / epochs * 512 / steady, "card": smi}
        emit(out[prec])
    return out


def _bf16_round_np(v):
    """float32 -> the nearest bfloat16 (ties to even), widened back to
    float32, by its bits (no NaN in the features)."""
    import numpy as np

    bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
    bits = (bits + (((bits >> 16) & 1) + 0x7FFF)) & 0xFFFF0000
    return bits.view(np.float32)


def _wire_host_values(model_cfg, feats, labels, mask, wire):
    """What one batch's device unpack must give, bit for bit, computed on
    the host in numpy from the fp32 batch: the features rounded to bf16
    (``bf16``), or (``packed``) the base codes, npass rounded, the kinetics
    as round(x * 16) / 16 clipped to int8, sn rounded to bf16, the map
    fractions as round(x * 255) / 255, and zeros for the channels the wire
    drops; labels and mask exact."""
    import numpy as np

    from ccsmeth_tpu_torch.training.train import _batch_layout, _q_fields

    B = np.asarray(labels).shape[0]
    out = {}
    for k, n in _batch_layout(model_cfg):
        v = np.asarray(feats[k], np.float32).reshape(B, n)
        out[k] = _bf16_round_np(v) if wire == "bf16" else np.zeros_like(v)
    if wire == "packed":
        for k, kind, _nb in _q_fields(model_cfg):
            v = np.asarray(feats[k], np.float32).reshape(B, -1)
            # through the integer each byte holds (a rounded -0.0 widens to +0.0)
            if kind == "kmer4":
                q = v.astype(np.uint8).astype(np.float32)
            elif kind == "u16s":
                q = np.broadcast_to(np.clip(np.rint(v[:, :1]), 0, 65535).astype(np.int32)
                                    .astype(np.float32), v.shape)
            elif kind == "i8q":
                q = (np.clip(np.rint(v * np.float32(16)), -128, 127).astype(np.int8)
                     .astype(np.float32) * np.float32(1 / 16))
            elif kind == "bf16":
                q = _bf16_round_np(v)
            else:  # u8frac
                q = (np.clip(np.rint(v * np.float32(255)), 0, 255).astype(np.uint8)
                     .astype(np.float32) * np.float32(1 / 255))
            out[k] = np.ascontiguousarray(q, np.float32)
    return out, np.asarray(labels, np.int64), np.asarray(mask, np.float32)


def phase_transfer(torch, smi, epochs):
    """attbigru2s with --train_transfer bf16 and packed: (1) one batch in
    each wire unpacked on the card, bit for bit the host's quantized values
    (``_wire_host_values``); (2) the first step's loss on that batch from
    the same weights and seeds against the fp32 wire's, within WIRE_TOL;
    (3) the CLI for ``epochs`` in each wire, K4/K5 3 calls a step on the
    simt design, best accuracy >= 0.9; the bytes a row of each wire."""
    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import (AttRNN, AttRNNConfig,
                                          attrnn_state_dict_from_params, init_attrnn)
    from ccsmeth_tpu_torch.training import build_optimizer
    from ccsmeth_tpu_torch.training.data import FeatureDataset
    from ccsmeth_tpu_torch.training.train import (LAST_RUN, _batch_layout, _q_fields,
                                                  make_train_step)

    tr, va, _tr16 = _train_input()
    cfg = AttRNNConfig(model_type=MODELS["gru"])
    ncol = sum(n for _k, n in _batch_layout(cfg)) + 2
    row_bytes = {"fp32": 4 * ncol, "bf16": 2 * ncol,
                 "packed": sum(nb for _k, _kind, nb in _q_fields(cfg)) + 2}
    data = FeatureDataset.from_tsv(tr, 21)
    feats, labels, nv = next(iter(data.batches(512, True, np.random.RandomState(SEED),
                                               pad_to=512)))
    mask = np.zeros(512, np.float32)
    mask[:nv] = 1.0
    first, unpacked = {}, {}
    for wire in ("fp32", "bf16", "packed"):
        model = AttRNN(cfg)
        model.load_state_dict(attrnn_state_dict_from_params(init_attrnn(SEED, cfg)))
        model.cuda()
        opt = build_optimizer("Adam", 1e-3)
        opt.init(model.parameters())
        step = make_train_step(model, opt, 1.0, torch.float32, wire)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        flat = torch.from_numpy(step.pack_batch(feats, labels, mask)).cuda()
        assert flat.element_size() * flat.shape[1] == row_bytes[wire], wire
        if wire != "fp32":
            got_f, got_l, got_m = step.unpack(flat)
            want_f, want_l, want_m = _wire_host_values(cfg, feats, labels, mask, wire)
            differ = sorted(k for k in want_f if got_f[k].shape != want_f[k].shape
                            or got_f[k].cpu().numpy().tobytes() != want_f[k].tobytes())
            assert not differ, (wire, differ)
            assert np.array_equal(got_l.cpu().numpy(), want_l), wire
            assert got_m.cpu().numpy().tobytes() == want_m.tobytes(), wire
            unpacked[wire] = {"channels_bit_equal": sorted(want_f), "labels_mask_equal": True}
        first[wire] = step.packed(flat, gen).item()
    res = {"phase": "transfer", "model": MODELS["gru"] + " 3x256", "batch": 512,
           "row_bytes": row_bytes, "unpacked_vs_host": unpacked,
           "first_step_loss": first, "tol": WIRE_TOL, "card": smi}
    for wire in ("bf16", "packed"):
        assert abs(first[wire] - first["fp32"]) <= WIRE_TOL, first
        _zero_train_counts()
        t0 = time.time()
        cli.main(["train", "--train_file", tr, "--valid_file", va, "--model_dir",
                  os.path.join(WORK, "wire_" + wire), "--device", "cuda",
                  "--train_transfer", wire, "--max_epoch_num", str(epochs),
                  "--min_epoch_num", str(epochs), "--step_interval", str(STEP_INTERVAL),
                  "--tseed", str(SEED % 10000)])
        torch.cuda.synchronize()
        run = dict(LAST_RUN)
        mine, other, _inf = _train_counts("gru")
        steps = run["steps"]
        assert mine["fwd"] == mine["bwd"] == 3 * steps > 0 == mine["plain"] + other, mine
        assert mine["designs"] == {"tc": 0, "simt": 6 * steps}, mine
        per_step = sum(2 + _bwd_cuda_launches(2 * 512, cin, torch.float32, "gru")
                       for cin in (C, 2 * H, 2 * H))
        assert mine["cuda_launches"] == per_step * steps, (mine, per_step)
        assert np.all(np.isfinite(run["train_losses"] + run["valid_losses"])), run
        assert run["best_accuracy"] >= 0.9, (wire, run["best_accuracy"])
        res[wire] = {"steps": steps, "launches": mine,
                     "best_accuracy": run["best_accuracy"],
                     "train_losses": run["train_losses"], "wall_s": time.time() - t0,
                     "samples_per_s_epoch": [steps / epochs * 512 / w
                                             for w in run["epoch_wall_s"]]}
    emit(res)
    return res


def _write_aggre_tsv(path, n, seed):
    """Aggregate training windows (``scripts/generate_aggre_train_data.py``'s
    AggreFeaData rows: chrom, pos, strand, offsets, 11 histograms of 20
    bins ;-joined, coverages, label), simulated: the window's sites lie
    1-60 bp apart (offsets: the distance to the centre site, as the
    generator takes them); the centre's methylation level p is the label,
    each neighbour's level is p moved by N(0, 0.15) (CpG methylation is
    correlated over short distances), and each site's histogram holds ~33
    reads' probabilities drawn around its level (HiFi's usual coverage)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    Lw, nb = AGGR_L, AGGR_C - 1
    centres = np.arange(nb) / (nb - 1)
    with open(path, "w") as f:
        for i in range(n):
            pos = np.cumsum(rng.randint(1, 60, Lw))
            offsets = np.abs(pos - pos[Lw // 2])
            p = rng.rand()
            levels = np.clip(p + rng.randn(Lw) * 0.15, 0, 1)
            levels[Lw // 2] = p
            hist = np.stack([rng.multinomial(rng.randint(20, 46), w / w.sum())
                             for w in np.exp(-((centres[None] - levels[:, None]) ** 2)
                                             / 0.02)]).astype(np.float64)
            hist = hist / np.maximum(np.linalg.norm(hist, axis=1, keepdims=True), 1.0)
            f.write("\t".join([
                "chrS", str(1000 + 10 * i), "+", ",".join(str(int(o)) for o in offsets),
                ";".join(_csv6(row) for row in hist),
                ",".join(str(c) for c in rng.randint(4, 40, Lw)),
                "{:.4f}".format(p)]) + "\n")


def phase_aggr_train(torch, smi):
    """The aggregate trainer (``python -m
    ccsmeth_tpu_torch.scripts.train_aggregate_model --device cuda``) for
    attbigru (K4/K5) and attbilstm (K6) at the full width (1 x 32 over 11
    windows of 20 bins + the offset, batch 512) on simulated windows: the
    training kernels at H = 32 on every step (simt), K1 on every validation
    batch, no plain run; the RMSE falls below the first epoch's; the best
    .ckpt.npz runs in ``call_freqb --call_mode aggregate --device cuda`` on
    the freq phase's modbam, through K1."""
    import math

    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.pipeline import call_freq_bam
    from ccsmeth_tpu_torch.scripts import train_aggregate_model
    from ccsmeth_tpu_torch.training.aggregate import LAST_RUN

    d = os.path.join(WORK, "aggr_train")
    os.makedirs(d, exist_ok=True)
    tr, va = os.path.join(d, "train.tsv"), os.path.join(d, "valid.tsv")
    if not (os.path.exists(tr) and os.path.exists(va)):
        _write_aggre_tsv(tr, AGGR_TRAIN_ROWS, SEED + 5)
        _write_aggre_tsv(va, AGGR_VALID_ROWS, SEED + 6)
    bam, fasta = _freq_input()
    tagged = os.path.join(WORK, "freq", "mods.hp.bam")
    if not os.path.exists(tagged):  # the freq phase did not run (--only)
        from ccsmeth_tpu_torch.models.params_io import save_params

        ckpt = os.path.join(WORK, MODELS["gru"] + "_full.ckpt.npz")
        save_params(ckpt, _config_params(MODELS["gru"])[1])
        cli.main(["call_mods", "-i", bam, "-o", os.path.join(WORK, "freq", "mods"), "-m",
                  ckpt, "--mode", "align", "--ref", fasta, "--device", "cuda"])
        _hp_tagged(os.path.join(WORK, "freq", "mods.modbam.bam"), tagged)
    res = {"phase": "aggr_train", "rows": {"train": AGGR_TRAIN_ROWS,
                                           "valid": AGGR_VALID_ROWS},
           "shape": {"NL": 1, "H": AGGR_H, "C": AGGR_C, "L": AGGR_L, "batch": 512},
           "card": smi}
    for cell, model_type in AGGR_CELLS.items():
        _zero_train_counts()
        t0 = time.time()
        assert train_aggregate_model.main([
            "--train_file", tr, "--valid_file", va, "--model_dir",
            os.path.join(d, model_type), "--model_type", model_type, "--device", "cuda",
            "--max_epoch_num", str(AGGR_EPOCHS), "--min_epoch_num", str(AGGR_EPOCHS),
            "--tseed", str(SEED % 10000)]) == 0
        torch.cuda.synchronize()
        run = dict(LAST_RUN)
        mine, other, inf = _train_counts(cell)
        steps = run["steps"]
        epochs = len(run["rmses"])
        assert steps == epochs * math.ceil(AGGR_TRAIN_ROWS / 512), run
        assert mine["fwd"] == mine["bwd"] == steps > 0 == mine["plain"] + other, mine
        assert mine["designs"] == {"tc": 0, "simt": 2 * steps}, mine
        assert inf["k1"] == epochs * math.ceil(AGGR_VALID_ROWS / 512) > 0, inf
        assert inf["k1_plain"] == 0, inf
        assert min(run["rmses"][1:]) < run["rmses"][0], run["rmses"]
        npz = run["ckpts"][-1]
        _zero_counts()
        prefix = os.path.join(d, model_type + "_freq")
        cli.main(["call_freqb", "-i", tagged, "--ref", fasta, "-o", prefix,
                  "--call_mode", "aggregate", "-m", npz, "--model_type", model_type,
                  "--device", "cuda"])
        freq = dict(call_freq_bam.LAST_RUN)
        counts = _all_counts()
        assert freq["batches"] > 0 and counts["k1"] == freq["batches"], (freq, counts)
        assert len(_freq_rows(prefix, "aggregate")["all"]) > 0
        res[model_type] = {"steps": steps, "epochs": epochs, "launches": mine,
                           "k1_validation_launches": inf["k1"], "rmses": run["rmses"],
                           "best_rmse": run["best_rmse"], "best_epoch": run["best_epoch"],
                           "epoch_wall_s": run["epoch_wall_s"],
                           "wall_s": time.time() - t0,
                           "call_freqb_sites": freq["sites"],
                           "call_freqb_k1_calls": counts["k1"]}
    emit(res)
    return res


def phase_wrappers():
    """call_hifi and align_hifi through the port's CLI raise their named
    errors: a bad input's ValueError, a missing file's IOError, and a
    missing binary's RuntimeError on a real input (the card's machine has
    no pbccs or aligner, so nothing is run)."""
    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.utils.simulate import make_synth_bam, write_fasta

    d = os.path.join(WORK, "wrappers")
    os.makedirs(d, exist_ok=True)
    bam, fasta = os.path.join(d, "x.subreads.bam"), os.path.join(d, "ref.fa")
    refseq, _ = make_synth_bam(bam, n_reads=2, read_len=200, ref_len=2000, seed=SEED)
    write_fasta(fasta, {"chrS": refseq})
    cases = [(["call_hifi", "-i", "x.fastq"], ValueError, "bam format"),
             (["call_hifi", "-i", os.path.join(d, "nope.bam")], IOError, "does not exist"),
             (["call_hifi", "-i", bam, "--path_to_ccs", os.path.join(d, "no_ccs")],
              RuntimeError, "ccs failed"),
             (["align_hifi", "-i", "x.txt", "--ref", fasta], ValueError, "bam/sam/fastq"),
             (["align_hifi", "-i", bam, "--ref", os.path.join(d, "nope.fa")], IOError,
              "does not exist"),
             (["align_hifi", "-i", bam, "--ref", fasta, "--path_to_pbmm2",
               os.path.join(d, "no_pbmm2")], RuntimeError, "alignment failed")]
    seen = []
    for argv, exc, text in cases:
        try:
            cli.main(argv)
        except exc as e:
            assert text in str(e), (argv, e)
            seen.append([argv[0], type(e).__name__, str(e)])
        else:
            raise AssertionError("{} did not raise".format(argv))
    res = {"phase": "wrappers", "raised": seen}
    emit(res)
    return res


def _time_tree(tree):
    """One turn of ``--ab``: K1 and K2 (both cells) and K3 of the checkout at
    ``tree`` at the kernel phase's shapes and inputs, and K4, K5 and K6
    (forward and backward) at the train-kernel phase's (1024 rows, C = 11
    and 512), fp32 and bf16, through the tree's own wrappers; medians of
    CUDA-event timings, one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ccsmeth_tpu_torch.models import TransEncConfig, init_transenc
    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.models.transenc import randomize_affine
    from ccsmeth_tpu_torch.ops import bigru, transenc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"phase": "ab_turn", "tree": os.path.abspath(tree),
           "package": os.path.dirname(os.path.dirname(bigru.__file__)), "ms": {}}
    with torch.inference_mode():
        for cell in MODELS:
            for rows in ROWS:
                x_np = np.random.RandomState(SEED + rows).randn(L, rows, C).astype(np.float32)
                for dname in ("float32", "bfloat16"):
                    dt = getattr(torch, dname)
                    ly = [layer_weights(ld, dt, "cuda") for ld in
                          init_rnn_params(np.random.RandomState(SEED), C, H, NL, cell)]
                    x = torch.from_numpy(x_np).to("cuda", dt).contiguous()
                    res["ms"]["k1 {} {} {}".format(cell, rows, dname)] = time_ms(
                        lambda: bigru.birnn_stack(ly, x, dt, cell), torch, AB_REPS)
            # K2 at the K2 phase's cells: one layer, 1024 rows, C = 11 and 2H
            for cin in (C, 2 * H):
                rng = np.random.RandomState(SEED + cin)
                ld = init_rnn_params(rng, cin, H, 1, cell)[0]
                x_np = rng.randn(L, ROWS[0], cin).astype(np.float32)
                for dname in ("float32", "bfloat16"):
                    dt = getattr(torch, dname)
                    lyr = layer_weights(ld, dt, "cuda")
                    x = torch.from_numpy(x_np).to("cuda", dt)
                    res["ms"]["k2 {} C={} {}".format(cell, cin, dname)] = time_ms(
                        lambda: bigru.bigru_layer_tm(lyr, x, dt, cell), torch, AB_REPS)
        cfg = TransEncConfig()
        params = randomize_affine(init_transenc(SEED, cfg), SEED)
        for rows in ROWS:
            x_np = np.random.RandomState(SEED + rows).randn(rows, L, cfg.d_model)
            for dname in ("float32", "bfloat16"):
                dt = getattr(torch, dname)
                st = transenc.stack_layers(params["layers"], dt, "cuda")
                x = torch.from_numpy(x_np.astype(np.float32)).to("cuda", dt)
                res["ms"]["k3 {} {}".format(rows, dname)] = time_ms(
                    lambda: transenc.encoder_pooled(st, x, dt, cfg.nhead), torch, AB_REPS)
        # the training kernels at the train-kernel phase's cells: K6 and
        # K4/K5 (the control), forward and backward
        from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

        train = {"gru": ("k4", "k5", bigru_vjp.bigru_layer_train_fwd,
                         bigru_vjp.bigru_layer_bwd),
                 "lstm": ("k6f", "k6b", bilstm_vjp.bilstm_layer_train_fwd,
                          bilstm_vjp.bilstm_layer_bwd)}
        rows = ROWS[0]
        for cell, (kf, kb, fwd, bwd) in train.items():
            for cin in (C, 2 * H):
                rng = np.random.RandomState(SEED + cin)
                ld = init_rnn_params(rng, cin, H, 1, cell)[0]
                x_np = rng.randn(L, rows, cin).astype(np.float32)
                dout_np = rng.randn(L, rows, 2 * H).astype(np.float32)
                for dname in ("float32", "bfloat16"):
                    dt = getattr(torch, dname)
                    wih, bih, whh, bhh = layer_weights(ld, dt, "cuda")
                    x = torch.from_numpy(x_np).to("cuda", dt)
                    dout = torch.from_numpy(dout_np).to("cuda", dt)
                    kept = fwd(x, wih, bih, whh, bhh, dt)
                    args = (dout, x, wih, whh) + tuple(kept) + (dt,)
                    res["ms"]["{} C={} {}".format(kf, cin, dname)] = time_ms(
                        lambda: fwd(x, wih, bih, whh, bhh, dt), torch, AB_REPS)
                    res["ms"]["{} C={} {}".format(kb, cin, dname)] = time_ms(
                        lambda: bwd(*args), torch, AB_REPS)
    emit(res)


def main_ab(parent):
    """Parent, change, change, parent: one process a turn (``_time_tree``);
    the last line holds each shape's two medians per tree and their ratio."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False")
    smi = phase_card(torch)[0]
    turns = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--time-tree", tree], capture_output=True, text=True)
        if proc.returncode != 0:
            sys.exit("turn on {} failed:\n{}".format(tree, proc.stderr[-4000:]))
        line = json.loads(proc.stdout.strip().splitlines()[-1])
        log(json.dumps(line))
        turns.append(line["ms"])
    summary = {}
    for key in turns[0]:
        parent_ms, change_ms = [turns[0][key], turns[3][key]], [turns[1][key], turns[2][key]]
        summary[key] = {"parent_ms": parent_ms, "change_ms": change_ms,
                        "change_over_parent": statistics.mean(change_ms)
                        / statistics.mean(parent_ms)}
    emit({"phase": "ab", "order": "parent, change, change, parent",
          "parent": os.path.abspath(parent), "card": smi, "ms": summary})


def main_only(names):
    """``--only a,b,...``: the card, the build, then only the named phases of
    the one-card training paths (train_kernels_small, determinism, train1s,
    train_te, transfer, aggr_train, wrappers), for a short call after a
    change to one of them; prints no kernels line and no ok line."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    smi = phase_card(torch)[0]
    phase_build()
    phases = {
        "train_kernels_small": lambda: [
            phase_train_kernels(torch, smi, cell, rows=512) for cell in MODELS] + [
            phase_train_kernels(torch, smi, cell, cins=(AGGR_C,), rows=512,
                                hidden=AGGR_H, seq_len=AGGR_L) for cell in MODELS],
        "determinism": lambda: phase_determinism(torch, smi),
        "train1s": lambda: [phase_train1s(torch, smi, cell, TRAIN1S_EPOCHS)
                            for cell in MODELS],
        "train_te": lambda: phase_train_te(torch, smi, TE_EPOCHS),
        "transfer": lambda: phase_transfer(torch, smi, TRANSFER_EPOCHS),
        "aggr_train": lambda: phase_aggr_train(torch, smi),
        "wrappers": phase_wrappers}
    unknown = [n for n in names if n not in phases]
    if unknown:
        sys.exit("unknown phases {}; known: {}".format(unknown, sorted(phases)))
    for name in names:
        t0 = time.time()
        phases[name]()
        log("phase {}: {:.1f} s".format(name, time.time() - t0))


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--time-tree":
        return _time_tree(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--ab":
        return main_ab(sys.argv[2])
    if len(sys.argv) == 5 and sys.argv[1] == "--train-digest":
        return _train_digest(*sys.argv[2:])
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        return main_only(sys.argv[2].split(","))
    if len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py [--ab PARENT_TREE | --only PHASE,...]")
    if not os.path.isdir(os.path.join(REPO, "ccsmeth_tpu_torch")):
        sys.exit("chip_smoke.py: the ccsmeth_tpu_torch package is not beside "
                 "this script; run it from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "smoke test needs a CUDA device")
    sys.path.insert(0, REPO)
    t_start = time.time()
    laps, t_lap = {}, [t_start]

    def lap(name):  # the wall seconds since the last lap, under ``name``
        now = time.time()
        laps[name] = now - t_lap[0]
        t_lap[0] = now

    smi, name = phase_card(torch)
    phase_build()
    lap("card_build")
    k1_cells = {cell: phase_kernels(torch, smi, cell) for cell in MODELS}
    k3_cells = phase_k3_kernels(torch, smi)
    k3_l2 = phase_k3_l2(torch, smi, k3_cells)
    k1_aggr = phase_k1_aggr(torch, smi)
    k2_cells = {cell: phase_k2_kernels(torch, smi, cell) for cell in MODELS}
    for cell in MODELS:
        phase_l2_kernels(torch, smi, cell)
    lap("kernels_k1_k2_k3")
    t_cells = {cell: phase_train_kernels(torch, smi, cell) for cell in MODELS}
    # the training kernels at the 1s families' shapes (one strand of batch
    # 512) and at the aggregate trainer's (NL 1, H 32, C 21, L 11)
    t1s_cells = {cell: phase_train_kernels(torch, smi, cell, rows=512) for cell in MODELS}
    taggr_cells = {cell: phase_train_kernels(torch, smi, cell, cins=(AGGR_C,), rows=512,
                                             hidden=AGGR_H, seq_len=AGGR_L)
                   for cell in MODELS}
    lap("train_kernels")
    for model_type in list(MODELS.values()) + [TRANSENC]:
        phase_model(torch, model_type)
    m2s2 = {cell: phase_model2s2(torch, smi, cell) for cell in MODELS}
    lap("model")
    e2e = {cell: phase_e2e(torch, smi, MODELS[cell]) for cell in MODELS}
    e2e_k3 = phase_e2e(torch, smi, TRANSENC)
    lap("e2e")
    freq = phase_freq(torch, smi)
    lap("freq")
    text = phase_text(torch, smi, e2e["gru"]["tags"]["fp32"])
    lap("text")
    e2e_k2 = {cell: phase_e2e_layer(torch, smi, MODELS[cell], e2e[cell]["tags"])
              for cell in MODELS}
    e2e2s2 = {cell: phase_e2e2s2(torch, smi, cell) for cell in MODELS}
    flags = phase_flags(torch, smi, e2e["gru"]["tags"]["fp32"])
    lap("e2e_layer_2s2_flags")
    train_runs = {cell: phase_train(torch, smi, cell, TRAIN_EPOCHS[cell])
                  for cell in MODELS}
    train2s2 = {cell: phase_train(torch, smi, cell, TRAIN2S2_EPOCHS[cell], MODELS2S2)
                for cell in MODELS}
    lap("train")
    phase_determinism(torch, smi)
    lap("determinism")
    train1s = {cell: phase_train1s(torch, smi, cell, TRAIN1S_EPOCHS) for cell in MODELS}
    lap("train1s")
    train_te = phase_train_te(torch, smi, TE_EPOCHS)
    lap("train_te")
    transfer = phase_transfer(torch, smi, TRANSFER_EPOCHS)
    lap("transfer")
    aggr_train = phase_aggr_train(torch, smi)
    lap("aggr_train")
    phase_wrappers()
    for cell in MODELS:
        phase_profile(torch, smi, cell)
    lap("wrappers_profile")
    emit({"phase": "walls", "s": laps, "total_s": time.time() - t_start})
    k1_keys = ("rows", "C", "dtype", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "max_abs_err_out", "max_abs_err_hn")

    kernels = []
    for cell, kname, line in (("gru", "bigru_stack", 198),
                              ("lstm", "bigru_stack_lstm", 238)):
        for design, src, dname in (("simt", "birnn_simt.cu", "float32"),
                                   ("tc", "birnn_tc.cu", "bfloat16")):
            cells = [c for c in k1_cells[cell] if c["design"] == design]
            mc = next(c for c in cells if c["rows"] == ROWS[0] and c["dtype"] == dname)
            entry = {
                "name": kname + ("_tc" if design == "tc" else ""), "route": "cuda",
                "design": design, "cuda_launches_per_call": mc["cuda_launches_per_call"],
                "source": "ccsmeth_tpu_torch/ops/csrc/" + src,
                "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:{}".format(line),
                "launches": e2e[cell]["launches_by_design"][design],
                "cuda_launches": e2e[cell]["cuda_launches_by_design"][design],
                "max_abs_err": max(max(c["max_abs_err_out"], c["max_abs_err_hn"])
                                   for c in cells),
                "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
                "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
                "library_ms": mc["library_ms"], "phases_ms": mc["phases_ms"],
                "cell": "{} rows={} {}".format(MODELS[cell], ROWS[0], dname),
                "cells": [{k: c[k] for k in ("rows", "dtype", "kernel_ms", "plain_ms",
                                             "library_ms", "bound_ms", "bound_by",
                                             "max_abs_err_out", "max_abs_err_hn")}
                          for c in cells]}
            # the 2s2 family's cells (C = 28, and 52 in fp32) and paths
            entry["cells_2s2"] = [{k: c[k] for k in k1_keys} for c in m2s2[cell]["k1"]
                                  if c["design"] == design]
            entry["launches_2s2"] = e2e2s2[cell]["e2e"]["launches_by_design"][design]
            entry["cuda_launches_2s2"] = \
                e2e2s2[cell]["e2e"]["cuda_launches_by_design"][design]
            if design == "simt":  # the train paths validate in fp32
                entry["launches_train_path"] = train_runs[cell]["launches"]["k1"]
                entry["launches_train_path_2s2"] = train2s2[cell]["launches"]["k1"]
                entry["launches_train_path_1s"] = train1s[cell]["k1_launches"]
                entry["projection_source"] = SIMT_PROJECTION
                if cell == "gru":
                    entry["launches_text_path"] = text[MODELS[cell]]["launches"]
                    entry["launches_flags"] = (
                        sum(sh["launches"] for sh in flags["processes"]["shards"])
                        + flags["profile"]["batches"])
            kernels.append(entry)
        # the same kernel at call_freqb's aggregate shape
        mc, run = k1_aggr[cell], freq[AGGR_CELLS[cell]]
        kernels.append({
            "name": kname + "_aggr", "route": "cuda", "design": mc["design"],
            "cuda_launches_per_call": mc["cuda_launches_per_call"],
            "source": "ccsmeth_tpu_torch/ops/csrc/birnn_simt.cu",
            "projection_source": SIMT_PROJECTION,
            "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:{}".format(line),
            "launches": run["k1_calls"], "cuda_launches": run["cuda_launches"],
            "launches_aggr_train": (
                aggr_train[AGGR_CELLS[cell]]["k1_validation_launches"]
                + aggr_train[AGGR_CELLS[cell]]["call_freqb_k1_calls"]),
            "max_abs_err": mc["max_abs_err"], "ms": mc["kernel_ms"],
            "plain_ms": mc["plain_ms"], "bound_ms": mc["bound_ms"],
            "bound_by": mc["bound_by"], "library_ms": mc["library_ms"],
            "phases_ms": mc["phases_ms"],
            "cell": "call_freqb aggregate {} 1x{} rows={} L={} C={} float32".format(
                AGGR_CELLS[cell], AGGR_H, AGGR_ROWS, AGGR_L, AGGR_C)})
    def calls(runs, key, design):
        # each (launches, designs) pair is one run's own counters
        return sum(_design_calls(la, de, key, design) for la, de in runs)

    def both(r):  # a train phase's fp32 run and its bf16 steps
        return [(r["launches"], r["k45_designs"]),
                (r["bf16_launches"], r["bf16_launches"]["k45_designs"])]

    def own(la):  # a run's counters from _train_counts
        return la, la["designs"]

    for cell, kname, src, key, line in (
            ("gru", "bigru_train_fwd", "bigru_train.cu", "fwd", 31),
            ("gru", "bigru_train_bwd", "bigru_train.cu", "bwd", 63),
            ("lstm", "bilstm_train_fwd", "bilstm_train.cu", "fwd", 122),
            ("lstm", "bilstm_train_bwd", "bilstm_train.cu", "bwd", 167)):
        mine = [c for c in t_cells[cell] if c["name"] == kname]
        for design, dname in (("simt", "float32"), ("tc", "bfloat16")):
            cells = [c for c in mine if c["design"] == design]
            # the main cell: layers 1 and 2 of the stack (C = 2H)
            mc = next(c for c in cells if c["C"] == 2 * H and c["dtype"] == dname)
            kernels.append({
                "name": kname + ("_tc" if design == "tc" else ""), "route": "cuda",
                "design": design, "cuda_launches_per_call": mc["cuda_launches_per_call"],
                "source": "ccsmeth_tpu_torch/ops/csrc/" + src,
                "replaces": "ccsmeth_tpu/ops/bigru_pallas_vjp.py:{}".format(line),
                "launches": calls(both(train_runs[cell]), key, design),
                "max_abs_err": max(c["max_abs_err_max"] for c in cells),
                "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
                "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
                "library_ms": mc["library_ms"], "phases_ms": mc["phases_ms"],
                "cell": "{} rows={} C={} {}".format(MODELS[cell], mc["rows"], mc["C"], dname),
                "cells": [{k: c[k] for k in ("rows", "C", "dtype", "cuda_launches_per_call",
                                             "kernel_ms", "plain_ms", "library_ms",
                                             "bound_ms", "bound_by", "max_abs_err_max",
                                             "phases_ms")} for c in cells],
                "cells_2s2": [{k: c[k] for k in ("rows", "C", "dtype", "kernel_ms",
                                                 "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "max_abs_err_max")}
                              for c in m2s2[cell]["train"]
                              if c["name"] == kname and c["design"] == design],
                "launches_2s2": calls(both(train2s2[cell]), key, design),
                "cells_1s": [{k: c[k] for k in ("rows", "C", "dtype", "kernel_ms",
                                                "plain_ms", "library_ms", "bound_ms",
                                                "bound_by", "max_abs_err_max")}
                             for c in t1s_cells[cell]
                             if c["name"] == kname and c["design"] == design],
                "launches_1s": calls([own(train1s[cell]["launches"])], key, design),
                "cells_aggr": [{k: c[k] for k in ("rows", "C", "H", "L", "dtype",
                                                  "kernel_ms", "plain_ms", "library_ms",
                                                  "bound_ms", "bound_by",
                                                  "max_abs_err_max")}
                               for c in taggr_cells[cell]
                               if c["name"] == kname and c["design"] == design],
                "launches_aggr": calls([own(aggr_train[AGGR_CELLS[cell]]["launches"])],
                                       key, design),
                "launches_transfer": (calls([own(transfer[w]["launches"])
                                             for w in ("bf16", "packed")], key, design)
                                      if cell == "gru" else 0)})
    # K3: simt (fp32) and tc (bf16) on the main path; l2, which no model's
    # path takes (0 launches there), called directly
    for design, src, dname in (("simt", "transenc_simt.cu", "float32"),
                               ("tc", "transenc_tc.cu", "bfloat16"),
                               ("l2", "transenc_encoder.cu", "float32")):
        cells = [c for c in k3_cells + k3_l2
                 if c["design"] == design and c["dtype"] == dname]
        mc = next(c for c in cells if c["rows"] == ROWS[0] and c["dtype"] == dname)
        kernels.append({
            "name": "transenc_encoder" + ("" if design == "simt" else "_" + design),
            "route": "cuda", "design": design,
            "cuda_launches_per_call": mc["cuda_launches_per_call"],
            "source": "ccsmeth_tpu_torch/ops/csrc/" + src,
            "replaces": "ccsmeth_tpu/ops/transenc_pallas.py:144",
            "launches": e2e_k3["launches_by_design"][design],
            "cuda_launches": e2e_k3["cuda_launches_by_design"][design],
            "max_abs_err": max(c["max_abs_err"] for c in cells),
            "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
            "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
            "library_ms": mc["library_ms"], "waves": mc.get("waves"),
            "launches_text_path": text[TRANSENC]["launches"] if design == "simt" else 0,
            "launches_train_te": (sum(r["k3_launches"] for r in train_te.values())
                                  if design == "simt" else 0),
            "cell": "{} rows={} {}".format(TRANSENC, ROWS[0], dname),
            "cells": [{k: c[k] for k in ("rows", "dtype", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by",
                                         "max_abs_err")} for c in cells]})
    for cell, kname, line in (("gru", "bigru_layer", 87),
                              ("lstm", "bigru_layer_lstm", 36)):
        for design, src, prec in (("simt", "birnn_simt.cu", "fp32"),
                                  ("tc", "birnn_tc.cu", "bf16")):
            cells = [c for c in k2_cells[cell] if c["design"] == design]
            # the main cell: layers 1 and 2 of the stack (C = 2H)
            mc = next(c for c in cells if c["C"] == 2 * H)
            kernels.append({
                "name": kname + ("_tc" if design == "tc" else ""), "route": "cuda",
                "design": design, "cuda_launches_per_call": mc["cuda_launches_per_call"],
                "source": "ccsmeth_tpu_torch/ops/csrc/" + src,
                "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:{}".format(line),
                "launches": e2e_k2[cell][prec]["launches"]["k2"],
                "cuda_launches": e2e_k2[cell][prec]["cuda_launches"]["k2"],
                "max_abs_err": max(c["max_abs_err"] for c in cells),
                "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
                "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
                "library_ms": mc["library_ms"], "phases_ms": mc["phases_ms"],
                "projection_source": (SIMT_PROJECTION if design == "simt"
                                      else "ccsmeth_tpu_torch/ops/csrc/" + src),
                "cell": "{} rows={} C={} {}".format(MODELS[cell], mc["rows"], mc["C"],
                                                    mc["dtype"]),
                "cells": [{k: c[k] for k in ("rows", "C", "dtype", "kernel_ms", "plain_ms",
                                             "library_ms", "bound_ms", "bound_by",
                                             "max_abs_err", "phases_ms")} for c in cells],
                "cells_2s2": [{k: c[k] for k in ("rows", "C", "dtype", "kernel_ms",
                                                 "plain_ms", "library_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}
                              for c in m2s2[cell]["k2"] if c["design"] == design],
                "launches_2s2": e2e2s2[cell]["layer"][prec]["launches"]["k2"],
                "cuda_launches_2s2": e2e2s2[cell]["layer"][prec]["cuda_launches"]["k2"]})
    emit({"kernels": kernels})
    log("chip_smoke: {:.1f} s on {}".format(time.time() - t_start, smi))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
