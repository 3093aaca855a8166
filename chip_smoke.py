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
     rule picked (fp32: simt, K4's projection kernel (f32_tma_kernel of
     ops/csrc/rnn_train_gemm.cuh through ops/csrc/bigru_train.cu) and the
     inference cluster recurrence of ops/csrc/birnn_simt.cu, with its
     geometry, the clusters the card holds at once, the waves, the
     projection's TFLOP/s beside torch.mm's at both row counts, the
     recurrence's step on one tile, on one full wave and on a wave of each
     row count, and the product's FMA rate; from the crossover up, so at
     16,384 rows, the rows design: the same projection and the row-owner
     recurrence of ops/csrc/birnn_rows.cu, with its R, passes, ring slots,
     registers, CTAs an SM, waves and TFLOP/s; each fp32 cell also in the
     other fp32 design, forced, bit for bit the same; bf16: the tensor-core
     design ops/csrc/birnn_tc.cu on wgmma, with its geometry, resident clusters,
     waves, the fused layer 0, the TMA + wgmma projection's TFLOP/s beside
     torch.mm's and the step on one tile and one wave), its CUDA launches
     per call (two a layer, one for a tc layer 0 whose projection fuses), a
     rerun for bit-equal outputs and each phase's time (projections,
     recurrence, the recurrence on 1 and 15 row tiles); kernel K3
     (transencoder2s: 6 layers, d_model 256, 4 heads, FF 512, L=21; fp32:
     the simt design ops/csrc/transenc_simt.cu, bf16: the design on wgmma
     fed by TMA, ops/csrc/transenc_tc.cu) at 2B = 1024 and 16384 samples,
     fp32 and bf16, beside its plain version, nn.TransformerEncoder + mean
     and the bound, with one CTA alone and one full wave timed at 1024
     samples (tc: its ring stages and resident CTAs an SM); and
     K3's l2 design (ops/csrc/transenc_encoder.cu, the first f32 kernel,
     the shapes the other two refuse; no model's path runs it) called
     directly, against the plain version;
     kernel K2 (one layer of K1's design: simt in fp32, tc in bf16), one
     layer of each cell at C = 11 and 512, 1024 rows (and in fp32 at C =
     512, 16,384 rows: the rows design, beside simt forced), beside a one-layer
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
     f32_products: the exact-f32 product kernel (f32_tma_kernel of
     ops/csrc/rnn_train_gemm.cuh) alone through its wrappers, one layer at
     C = 512 of each cell: the projection at 1,024 and 16,384 rows, dx and
     the weight gradients at 1,024, against their plain PyTorch products,
     timed beside them, torch.mm and the bound;
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
     with ``--rnn_backend pallas_layer``, through K2 and not K1; then
     attbigru2s and attbilstm2s in fp32 at ``--batch_size 8192`` (16,384
     rows a batch), through K1 and under pallas_layer through K2: the rows
     design on every batch, ML bytes against the batch-512 run's;
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
     K1's kernels (and, at ``--batch_size 8192``, the rows design's);
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
     aggregate``; dist: two ranks of this script (``--dist-rank``) sharing
     the card over gloo, at full width: ``trainm`` one step at dropout 0
     against one process at the global batch of 1,024 (every leaf), two
     epochs at the defaults (best accuracy >= 0.9, the same validation lines
     on both ranks, K4/K5 3 times a step on each, checkpoints on rank 0
     only), ``call_freqb --dist_coordinator`` in count mode (byte-equal to
     one process) and aggregate mode (K1 on rank 0, rows equal), with the
     collectives' calls, bytes and ms; wrappers: ``call_hifi`` and
     ``align_hifi`` raise their named errors;
  8. profile: torch.profiler over a few full-width training steps of each
     model: the step's host and device ms, the device's idle share and the
     device time per kernel;
  9. one ``kernels`` JSON line, then the ``ok`` line.

It needs a CUDA device and the repository checkout around it; without either it
exits with an error and prints no result. It writes only under build/ of the
checkout.

    python3 chip_smoke.py --ab PARENT_TREE

times K1 and K2 (both cells) and K3 at the kernel phase's shapes (and K3's
l2 design at 1024 fp32 samples; K1 fp32 also at call_freqb's aggregate
shape, K2 fp32 also at the 2s2 family's C = 28 and 52 and at 16,384 rows,
C = 512), and K4,
K5 and K6 (forward and backward) at the train-kernel phase's (C = 11 and
512, and the 2s2 family's 28 in fp32; K4's and K6's fp32 forwards also at
512 rows and the aggregate trainer's shape), and the exact-f32 products
alone (the projection at C = 512, 1,024 and 16,384 rows; dx and the
weight gradients at 1,024 rows), in four turns in one process each: the checkout at PARENT_TREE (another commit, unpacked
under a git-ignored directory), this checkout, this checkout, the parent.
Each turn prints one JSON line; the last line compares the medians.

    python3 chip_smoke.py --ab-step PARENT_TREE

times, in 10 pairs of turns (one process a turn, the parent first in every
other pair), the profile phase's fp32 training step of attbigru2s and
attbilstm2s (host and device ms) and K6's bf16 backward at C = 11 phase by
phase; the last line gives each key's median and quartiles per tree.

    python3 chip_smoke.py --ab-small PARENT_TREE [TREE ...]

times K4's to K6's fp32 forward and backward at 512 rows (C = 11, 28, 512)
and at the aggregate trainer's shape (there also the forward recurrence
alone) in 10 rounds of turns as ``--ab-step`` runs them, over the parent,
any other checkouts given and this one.

    python3 chip_smoke.py --only determinism,train1s,...

runs the card, the build and the named phases of the one-card training paths
(``train_kernels_2s2``: the train-kernel phase at C = 28 and K2's LSTM
there; ``profile``), ``dist``, ``k56_bwd_simt_sweep`` (K5's and K6's fp32
backward at each candidate tile of the simt recurrence, built in copies of
their sources), ``k56_bwd_simt_probe`` (that recurrence's step split into
its parts by clock marks in a copy of its header), ``k46_fwd_simt_sweep`` and
``k46_fwd_simt_probe`` (the same for K4's and K6's fp32 forward: its rows a
tile and warp groups; its step's parts), ``k1_simt_sweep`` (K1's fp32 recurrence at each candidate
geometry), ``k1_tc_sweep`` (K1's bf16 design at each candidate geometry
of its recurrence), ``k1_tc_probe`` (the bf16 recurrence's step split
into its parts by clock marks in a copy of its source), ``k3_kernels``
(the K3 kernel phase), ``k1_rows_sweep`` (K1 fp32 in the simt design and
the rows design at each candidate geometry, at 1,024 to 16,384 rows in
alternating rounds: the crossover), ``k3_tc_sweep`` (K3's bf16 design at each ring depth,
built in copies of its source), ``k3_tc_probe`` (a layer of
K3's bf16 design split into its parts by clock marks in a copy of its
source), ``k3_simt_probe`` (the same for K3's fp32 simt design: a layer's
ring waits, products, epilogues, attention, LayerNorm and barriers, and
the producer's waits), ``k3_simt_sweep`` (K3's fp32 design beside
variants built in copies of its source: 8-row slabs in 4 slots, and no
ring synchronization at all), ``f32_products`` (the phase above),
``f32_gemm_probe`` (the exact-f32 products' tile split into ring waits,
FMAs, refills and epilogue by clock marks in a copy of their header, and,
with a parent tree unpacked in build/parent, the parent's kernels split
the same way; the SM clock under each product and torch.mm, the SASS mix,
the kernels torch.mm runs) or ``f32_gemm_sweep`` (the products at each
ring geometry of ``F32_SWEEP``, built with -D flags, in alternating
rounds beside torch.mm)
(``main_only``), and prints no result line.
"""

import json
import os
import re
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
E2E_ROWS_BATCH = 8192  # call_mods --batch_size of the rows design's e2e runs
REPS = 11
AB_REPS = 31  # --ab turns: more timings a median, for ratios near 1
# K1 fp32's row counts in --ab beside the default batch's: the 72-row
# tiles' last count in one wave and the first in two, a ragged default
# batch, and about ROWS_SMALL_WINDOW's ends and ROWS_CROSSOVER
AB_CROSSOVER_ROWS = (504, 505, 1031, 3583, 3584, 4096, 4224, 4225, 6143, 6144)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the simt design of K1 and K2 projects with K4's kernel (f32_tma_kernel,
# launched through bigru_train.cu's k4_proj_launch)
SIMT_PROJECTION = "ccsmeth_tpu_torch/ops/csrc/rnn_train_gemm.cuh"
# the tc design's kernels and the header of its wgmma, TMA and mbarrier pieces
TC_SOURCES = ("ccsmeth_tpu_torch/ops/csrc/birnn_tc.cu",
              "ccsmeth_tpu_torch/ops/csrc/wgmma_tile.cuh")
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
# the dist phase: two ranks on the card, batch 512 a rank (the global batch
# 1,024); the one-step comparison's leaf gate (2 x 512 rows summed against
# 1,024 rows in one product: rounding, ~1e-7 of a gradient, times lr 0.1);
# a rank that outlives DIST_TIMEOUT seconds fails the phase
DIST_RANKS, DIST_BATCH, DIST_TOL, DIST_TIMEOUT = 2, 512, 1e-5, 600
# best accuracy of the training at the defaults, in DIST_EPOCHS epochs of
# 16 global steps (one epoch reached 0.841: half the updates of the train
# phase's 32-step epoch)
DIST_ACC, DIST_EPOCHS = 0.9, 2


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

    srcs = (bigru.SRC, bigru.TC_SRC, bigru.SIMT_SRC, bigru.ROWS_SRC, bigru_vjp.SRC,
            bilstm_vjp.SRC, transenc.SRC, transenc.TC_SRC, transenc.SIMT_SRC)
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
    """One layer's two phases in K1's tc, simt or rows design: (projection(x2d,
    xg=None), recurrence(xg, rows, out=None), rows of a recurrence tile);
    ``layer`` counts the launches as K2's."""
    from ccsmeth_tpu_torch.ops import bigru

    wih, bih, whh, bhh = ly
    if plan["design"] == "tc":
        def proj(x2, xg=None):
            return bigru.tc_projection(x2, wih, bih, bhh, cell, xg, layer)

        def rec(xg, rows, out=None):
            return bigru.tc_recurrence(xg, whh, bhh, Lx, rows, plan, cell, out, None, layer)
        return proj, rec, plan["rows"]

    def proj(x2, xg=None):
        return bigru.simt_projection(x2, wih, bih, bhh, cell, xg, layer)

    recurrence = bigru.rows_recurrence if plan["design"] == "rows" else bigru.simt_recurrence

    def rec(xg, rows, out=None):
        return recurrence(xg, whh, bhh, Lx, rows, plan, cell, out, None, layer)
    return proj, rec, plan["rows"]


def _fused_fn(plan, ly, cell, x, layer=False):
    """The tc design's layer whose projection runs inside the recurrence
    (``tc_fused_kx``), as a function of its output buffer, or None."""
    from ccsmeth_tpu_torch.ops import bigru

    wih, bih, whh, bhh = ly
    Lx, N, C = x.shape
    if plan["design"] != "tc" or not bigru.tc_fused_kx(plan, C, cell, whh.shape[1]):
        return None
    return lambda out=None: bigru.tc_recurrence(None, whh, bhh, Lx, N, plan, cell, out, None,
                                                layer, (x, wih, bih))


def _per_call(plan, cell, widths, hidden=H):
    """CUDA launches of one K1 call over layers of input widths ``widths``
    (or K2's over as many calls): l2 one; simt and rows two a layer; tc two
    a layer, one where the layer's projection is fused (``tc_fused_kx``)."""
    from ccsmeth_tpu_torch.ops import bigru

    if plan["design"] == "l2":
        return 1
    if plan["design"] in ("simt", "rows"):
        return 2 * len(widths)
    return sum(1 if bigru.tc_fused_kx(plan, c, cell, hidden) else 2 for c in widths)


def _k1_phases_ms(torch, ly, x, cell, plan):
    """Device time of each phase of K1's tc or simt design on the stack's
    inputs: layer 0 (its projection at C = 11, or the cell's C, and in tc
    the fused layer where it fuses), the projection of a later layer (C =
    2H), and one layer's recurrence, also on 1 and 15 row tiles a
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
    res = {"rows_a_tile": rows_tile, "recurrence_by_row_tiles": by_tiles,
           "projection_c{}".format(x.shape[2]): time_ms(lambda: proj(x0, xg), torch),
           "projection_c512": time_ms(lambda: proj1(x1, xg), torch),
           "recurrence": time_ms(lambda: rec(xg, N, out), torch)}
    fused = _fused_fn(plan, ly[0], cell, x)
    if fused is not None:
        res["fused_layer0"] = time_ms(lambda: fused(out), torch)
    return res


def phase_kernels(torch, smi, cell):
    """K1 at both row counts in fp32 and bf16, each in the design
    ``k1_plan`` picks; in fp32 also in the other fp32 design, forced (simt
    at 16,384 rows, rows at 1,024), whose out and h_n must equal the
    picked design's bit for bit."""
    import numpy as np

    cells = []
    for rows in ROWS:
        x_np = np.random.RandomState(SEED + rows).randn(L, rows, C).astype(np.float32)
        for dname in ("float32", "bfloat16"):
            cells.append(_k1_cell(torch, smi, cell, x_np, dname))
            if dname == "float32":
                other = "simt" if cells[-1]["design"] == "rows" else "rows"
                cells.append(_k1_cell(torch, smi, cell, x_np, dname, design=other,
                                      same_as=cells[-1]["digest"]))
    return cells


def _rows_report(torch, cell, plan, rows, rec_ms):
    """The rows design's geometry at ``rows``: R, passes a step, ring
    slots, threads, shared memory and registers a CTA, the CTAs an SM
    holds, the grid's CTAs and waves; the recurrence's ms a layer, its
    TFLOP/s and its step a wave (ms / (waves L))."""
    import math

    from ccsmeth_tpu_torch.models.rnn import n_gates
    from ccsmeth_tpu_torch.ops import bigru

    occ = bigru.rows_occupancy(H, cell, plan)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    ctas = 2 * math.ceil(rows / plan["rows"])
    waves = math.ceil(ctas / (occ["ctas_an_sm"] * n_sm))
    return {"R": plan["rows"], "passes": plan["passes"], "stages": plan["stages"],
            "threads": plan["threads"], "smem": plan["smem"], "registers": occ["registers"],
            "ctas_an_sm": occ["ctas_an_sm"], "ctas": ctas, "waves": waves,
            "recurrence_ms": rec_ms,
            "recurrence_tflops": 4 * L * rows * H * n_gates(cell) * H / rec_ms / 1e9,
            "step_us_a_wave": rec_ms * 1e3 / (waves * L)}


def _k1_digest(torch, *tensors):
    """sha256 over the tensors' bytes."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _k1_cell(torch, smi, cell, x_np, dname, phases=True, design=None, same_as=None):
    """K1 (the cell's whole 3 x 256 stack) on the input x_np (L, rows, C):
    the design ``k1_plan`` picks (or ``design``, forced), its CUDA launches
    a call, a bit-equal rerun (and, given ``same_as``, the sha256 of out
    and h_n equal to it), the error against the plain version (``TOL``),
    and the kernel's, the plain version's and cuDNN's times beside the
    bound, with each phase's time when ``phases`` (fp32: the recurrence's
    TFLOP/s; the rows design: its geometry, ``_rows_report``)."""
    from ccsmeth_tpu_torch.models.rnn import n_gates
    from ccsmeth_tpu_torch.ops import bigru

    rows, cin = x_np.shape[1], x_np.shape[2]
    dt = getattr(torch, dname)
    plan = bigru.k1_plan(H, cell, dt, rows, design)
    layers_np, ly = _layers(torch, dt, "cuda", cell, cin)
    x = torch.from_numpy(x_np).to("cuda", dt).contiguous()
    before = dict(bigru.design_calls)
    bigru.cuda_launches = 0
    out, hn = bigru.birnn_stack(ly, x, dt, cell, design)
    cuda_per_call = bigru.cuda_launches
    out2, hn2 = bigru.birnn_stack(ly, x, dt, cell, design)
    torch.cuda.synchronize()
    assert bigru.design_calls[plan["design"]] == before[plan["design"]] + 2
    # simt: a projection and a recurrence a layer; tc: layer 0 in one launch
    # where its projection fuses
    assert cuda_per_call == _per_call(plan, cell, [cin] + [2 * H] * (NL - 1)), (
        plan, cuda_per_call)
    rerun_equal = bool(torch.equal(out, out2) and torch.equal(hn, hn2))
    assert rerun_equal, (cell, rows, cin, dname, "rerun differs")
    digest = _k1_digest(torch, out, hn)
    assert same_as is None or digest == same_as, (cell, rows, cin, plan["design"],
                                                   "bits differ from the other design's")
    ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt, cell)
    assert out.shape == (L, rows, 2 * H) and hn.shape == (2 * NL, rows, H)
    assert bool(torch.isfinite(out.float()).all())
    assert bool(torch.isfinite(hn).all())
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_hn = (hn - ref_hn).abs().max().item()
    assert max(err_out, err_hn) <= TOL[dname], (cell, rows, cin, dname, err_out, err_hn)

    lib = _cudnn(torch, cell, cin, NL, layers_np, dt)
    with torch.inference_mode():
        kernel_ms = time_ms(lambda: bigru.birnn_stack(ly, x, dt, cell, design), torch)
        plain_ms = time_ms(lambda: bigru.birnn_stack_plain(ly, x, dt, cell), torch)
        library_ms = time_ms(lambda: lib(x), torch)
        phase_ms = _k1_phases_ms(torch, ly, x, cell, plan) if phases else None
        rec_tflops = (4 * L * rows * H * n_gates(cell) * H / phase_ms["recurrence"] / 1e9
                      if phases and dname == "float32" else None)
        rows_rep = (_rows_report(torch, cell, plan, rows, phase_ms["recurrence"])
                    if phases and plan["design"] == "rows" else None)
        simt = (_simt_report(torch, cell, plan, ly) if phases and plan["design"] == "simt"
                and (rows, cin) == (ROWS[0], C) else None)
        tc = (_tc_report(torch, cell, plan, ly, x) if phases and plan["design"] == "tc"
              and (rows, cin) == (ROWS[0], C) else None)
    flops = bigru.stack_flops(L, rows, cin, H, NL, cell)
    nbytes = (x.numel() * x.element_size()
              + sum(t.numel() * t.element_size() for lyr in ly for t in lyr)
              + out.numel() * out.element_size() + hn.numel() * 4)
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    res = {"phase": "kernel", "name": "bigru_stack", "cell": cell,
           "rows": rows, "C": cin, "dtype": dname, "design": plan["design"],
           "forced": design is not None, "digest": digest,
           "bit_equal_to_the_other_design": None if same_as is None else True,
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
           "recurrence_tflops": rec_tflops,
           "simt": simt, "tc": tc, "rows_design": rows_rep, "card": smi}
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


def _k3_tiles(rows, S, n_sm):
    """The grid of K3 at ``rows`` samples, S a CTA: CTAs (one tile each),
    waves of n_sm (one CTA an SM), the wave-times the grid takes and the
    share of the last wave's SMs that work."""
    tiles = -(-rows // S)
    waves = tiles / n_sm
    return {"tiles": tiles, "waves": waves, "wave_times": -(-tiles // n_sm),
            "last_wave_share": (tiles - (-(-tiles // n_sm) - 1) * n_sm) / n_sm}


def _k3_product_flops(rows, D, FF, NL):
    """The encoder's product FLOPs (q|k|v, the output projection, the
    feed-forward pair; attention's scores and context left out)."""
    return (2 * L * D * 3 * D + 2 * L * D * D + 2 * 2 * L * D * FF) * NL * rows


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
    alone and one full wave; at both, the grid's tiles, waves and the last
    wave's working share (``_k3_tiles``), and for simt its registers, CTAs
    an SM, ring and the products' TFLOP/s over the kernel's time."""
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
                    if plan["design"] == "tc":
                        waves.update(stages=transenc.TC_STAGES,
                                     ctas_an_sm=transenc.tc_occupancy(D, FF))
            flops = transenc.encoder_flops(rows, L, D, FF, NLT)
            n_sm = torch.cuda.get_device_properties(0).multi_processor_count
            grid = _k3_tiles(rows, plan["S"], n_sm)
            if plan["design"] == "simt":
                grid.update(transenc.simt_occupancy(L, D, FF, NH), stages=transenc.SIMT_STAGES,
                            slab_rows=transenc.SIMT_BK,
                            product_tflops=_k3_product_flops(rows, D, FF, NLT) / kernel_ms / 1e9)
            bms, bby = _bound(flops, _nbytes(x, got, *st.values()), dname)
            res = {"phase": "kernel", "name": "transenc_encoder", "rows": rows,
                   "dtype": dname, "design": plan["design"],
                   "cuda_launches_per_call": cuda_per_call, "rerun_bit_equal": True,
                   "max_abs_err": err, "tol": K3_TOL[dname],
                   "library_max_abs_diff": lib_err,
                   "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": library_ms, "bound_ms": bms, "bound_by": bby,
                   "gflop": flops / 1e9, "tflops_achieved": flops / kernel_ms / 1e9,
                   "grid": grid, "card": smi}
            if waves is not None:
                res["waves"] = waves
            emit(res)
            cells.append(res)
            del lib, got, again, ref
    return cells


K3_TC_SWEEP_STAGES = (3, 4, 5, 6)  # ring depths the sweep builds
K3_TC_SWEEP_ROUNDS = 12  # timed rounds of every variant, in turns


def _build_tc_copy(path, defines=()):
    """A build of the K3 tc source at ``path`` (csrc/transenc_tc.cu or a
    copy of it) with ``defines`` into WORK, bound by ``transenc.bind_tc``;
    returns (library, nvcc's -Xptxas -v report)."""
    import subprocess as sp

    from ccsmeth_tpu_torch.ops import nvcc, transenc

    os.makedirs(WORK, exist_ok=True)
    tag = "".join("_" + d.replace("=", "") for d in defines)
    so = os.path.join(WORK, os.path.basename(path)[:-3] + tag + ".so")
    proc = sp.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-D" + d for d in defines]
                  + ["-I", nvcc.CSRC, "-o", so, path], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return transenc.bind_tc(so), proc.stdout + proc.stderr


def phase_k3_tc_sweep(torch, smi):
    """K3's bf16 tc design at each ring depth of ``K3_TC_SWEEP_STAGES``
    (builds of csrc/transenc_tc.cu with -DTE_STAGES=n in WORK) at
    transencoder2s's width, 1,024 and 16,384 samples: each depth's pooled
    output against the plain version (``K3_TOL``), bit-equal to the other
    depths' and to its rerun; then ``K3_TC_SWEEP_ROUNDS`` rounds of timings,
    the depths in turn (forward, then reverse order), so that each pair is
    compared round by round under one clock; nn.TransformerEncoder + mean
    on the same inputs beside them."""
    import ctypes
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import nvcc, transenc

    src = os.path.join(nvcc.CSRC, transenc.TC_SRC)
    with ThreadPoolExecutor(len(K3_TC_SWEEP_STAGES)) as pool:
        libs = list(pool.map(lambda n: _build_tc_copy(src, ["TE_STAGES={}".format(n)])[0],
                             K3_TC_SWEEP_STAGES))
    dt = torch.bfloat16
    shipped = transenc._tc_lib
    try:
        for rows in ROWS:
            cfg, params, st, x = _k3_inputs(torch, rows, "bfloat16")
            D, FF, NH = cfg.d_model, cfg.dim_ff, cfg.nhead
            ref = transenc.encoder_pooled_plain(st, x, dt, NH)
            lib = _torch_encoder(torch, params, dt)
            variants, first = [], None
            for stages, so in zip(K3_TC_SWEEP_STAGES, libs):
                def fn(so=so):
                    transenc._tc_lib = so
                    return transenc.encoder_pooled(st, x, dt, NH)

                got, again = fn(), fn()
                torch.cuda.synchronize()
                first = got if first is None else first
                err = (got - ref).abs().max().item()
                equal = bool(torch.equal(got, again)) and bool(torch.equal(got, first))
                assert err <= K3_TOL["bfloat16"] and equal, (rows, stages, err, equal)
                ctas, smem = ctypes.c_int(0), ctypes.c_int(0)
                assert so.transenc_tc_occupancy(D, FF, ctypes.byref(ctas), ctypes.byref(smem),
                                                0) == 0
                variants.append(({"stages": stages, "smem": smem.value,
                                  "ctas_an_sm": ctas.value, "max_abs_err": err,
                                  "bit_equal": equal, "ms_by_round": []}, fn))
            lib_ms = []
            with torch.inference_mode():
                for r in range(K3_TC_SWEEP_ROUNDS):
                    for res, fn in (variants if r % 2 == 0 else variants[::-1]):
                        res["ms_by_round"].append(time_ms(fn, torch))
                    lib_ms.append(time_ms(lambda: lib(x).float().mean(1), torch))
            del lib
            for res, _fn in variants:
                res["median_ms"] = statistics.median(res["ms_by_round"])
            emit({"phase": "k3_tc_sweep", "rows": rows, "rounds": K3_TC_SWEEP_ROUNDS,
                  "default_stages": transenc.TC_STAGES,
                  "variants": [res for res, _fn in variants],
                  "library_ms": statistics.median(lib_ms), "card": smi})
    finally:
        transenc._tc_lib = shipped


# The probe of the bf16 tc design's layer: marks put into a copy of
# csrc/transenc_tc.cu (never into the shipped kernel), each adding the
# clock64 cycles since the last mark to a per-part sum, for consumer threads
# 0 and 128 (one of each warpgroup) of CTA 0. Parts: 0 the waits on the
# ring's `full` barriers, 1 the products (wgmma issue and waits, the slots'
# release), 2 the epilogues, 3 attention, 4 the two LayerNorms (their
# exchange barriers inside), 5 the fences and barriers between the phases,
# 6 x's load before the first layer, 7 the mean after the last.
K3_TC_PROBE_PARTS = ("ring_waits", "products", "epilogues", "attention", "layer_norm",
                     "barriers", "x_load", "mean")
K3_TC_PROBE_MARKS = [
    ('#include "entry_device.cuh"\n',
     '#include "entry_device.cuh"\n__device__ unsigned long long g_prof[2][8];\n'
     '#define PROF(k) if ((tid == 0 || tid == 128) && blockIdx.x == 0) '
     '{ const unsigned long long now = clock64(); g_prof[tid >> 7][k] += now - tprev; '
     'tprev = now; }\n'),
    ("  const int rows = min(p.S * L, (p.N - n0) * L);  // its real rows\n",
     "  const int rows = min(p.S * L, (p.N - n0) * L);  // its real rows\n"
     "  unsigned long long tprev = clock64();\n"),
    ("        mbar_wait(full + 8 * s, (g / STAGES) & 1);\n",
     "        PROF(1)\n        mbar_wait(full + 8 * s, (g / STAGES) & 1);\n        PROF(0)\n"),
    ("      epi(j, acc, bv);\n", "      PROF(1)\n      epi(j, acc, bv);\n      PROF(2)\n"),
    ("  for (int l = 0; l < NL; ++l) {\n", "  PROF(6)\n  for (int l = 0; l < NL; ++l) {\n"),
    ("    consumer_sync();  // q|k|v complete\n",
     "    consumer_sync();  // q|k|v complete\n    PROF(5)\n"),
    ("    attention(base, QB, XB, D, p.NH, L, p.S, scale, wg, r0, t4);\n",
     "    attention(base, QB, XB, D, p.NH, L, p.S, scale, wg, r0, t4);\n    PROF(3)\n"),
    ("    consumer_sync();  // the context complete\n",
     "    consumer_sync();  // the context complete\n    PROF(5)\n"),
    ("    layer_norm(p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D);\n",
     "    layer_norm(p.ln1s + (size_t)l * D, p.ln1b + (size_t)l * D);\n    PROF(4)\n"),
    ("    consumer_sync();  // LayerNorm 1's operand complete\n",
     "    consumer_sync();  // LayerNorm 1's operand complete\n    PROF(5)\n"),
    ("    consumer_sync();  // the hidden layer complete\n",
     "    consumer_sync();  // the hidden layer complete\n    PROF(5)\n"),
    ("    layer_norm(p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D);\n",
     "    layer_norm(p.ln2s + (size_t)l * D, p.ln2b + (size_t)l * D);\n    PROF(4)\n"),
    ("    consumer_sync();  // LayerNorm 2's operand complete\n",
     "    consumer_sync();  // LayerNorm 2's operand complete\n    PROF(5)\n"),
    ("    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;\n  }\n}\n",
     "    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;\n  }\n  PROF(7)\n}\n"),
    ("}  // extern \"C\"\n",
     "void tc_probe(unsigned long long* out, int reset) {\n"
     "  unsigned long long z[16] = {0};\n"
     "  if (reset) cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
     "  else cudaMemcpyFromSymbol(out, g_prof, sizeof(z));\n}\n}  // extern \"C\"\n"),
]


def phase_k3_tc_probe(torch, smi):
    """K3's bf16 tc design split into a layer's parts (``K3_TC_PROBE_MARKS``)
    on one tile of samples alone, one full wave and 1,024 samples: us a
    layer for each part (x's load and the mean: us a call), at the card's
    clock, beside the call's CUDA-event time."""
    import ctypes

    from ccsmeth_tpu_torch.ops import nvcc, transenc

    src = open(os.path.join(nvcc.CSRC, transenc.TC_SRC)).read()
    for old, new in K3_TC_PROBE_MARKS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "transenc_tc_probe.cu")
    with open(path, "w") as f:
        f.write(src)
    lib, _ = _build_tc_copy(path)
    p = ctypes.c_void_p
    lib.tc_probe.argtypes = [p, ctypes.c_int]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shipped, transenc._tc_lib = transenc._tc_lib, lib
    buf = (ctypes.c_ulonglong * 16)()
    dt = torch.bfloat16
    try:
        cfg, _params, st, x = _k3_inputs(torch, ROWS[0], "bfloat16")
        D, FF, NH, NLT = cfg.d_model, cfg.dim_ff, cfg.nhead, cfg.num_layers
        S = transenc.k3_plan(L, D, FF, NH)["S"]
        for rows in (S, S * n_sm, ROWS[0]):
            xs = x[:rows]

            def fn():
                return transenc.encoder_pooled(st, xs, dt, NH)

            fn()
            torch.cuda.synchronize()
            lib.tc_probe(None, 1)
            ms = time_ms(fn, torch)
            lib.tc_probe(ctypes.cast(buf, p), 0)
            runs = REPS + 1  # the warm-up and the timed runs
            parts = {}
            for w in (0, 1):
                per = [buf[8 * w + k] / runs / mhz for k in range(8)]
                parts["thread{}".format(128 * w)] = {
                    name: (v if name in ("x_load", "mean") else v / NLT)
                    for name, v in zip(K3_TC_PROBE_PARTS, per)}
            emit({"phase": "k3_tc_probe", "rows": rows, "stages": transenc.TC_STAGES,
                  "kernel_ms": ms, "layer_us_by_part": parts, "clock_mhz": mhz,
                  "card": smi})
    finally:
        transenc._tc_lib = shipped


# Variants of K3's fp32 simt design for ``k3_simt_sweep``: text replacements
# on a copy of csrc/transenc_simt.cu (never on the shipped kernel), each
# (old, new, count) applied to ``count`` places. "shipped" is the source as
# it is; "slabs_8_rows_4_slots" streams
# 8-row slabs through 4 slots (the same bytes in flight, twice the barrier
# waits); "no_copies_no_waits" issues no TMA load and no ring wait or
# arrival at all: its output is wrong and unchecked, its time the bound
# that the ring's synchronization leaves.
K3_SIMT_SWEEP = {
    "shipped": [],
    "slabs_8_rows_4_slots": [
        ("#define TS_BK 16      // k rows of a ring slab\n", "#define TS_BK 8\n", 1),
        ("#define TS_STAGES 2   // ring slots\n", "#define TS_STAGES 4\n", 1)],
    "no_copies_no_waits": [
        ("    if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1);\n", "", 1),
        ("    mbar_expect_tx(ring.full(s), bytes);\n", "", 1),
        ("    if (three_d)\n      tma_load_3d(dst, map, ring.full(s), col, 0, row + k0);\n"
         "    else\n      tma_load_2d(dst, map, ring.full(s), col, row + k0);\n", "", 1),
        ("    mbar_wait(ring.full(s), (ring.g / TS_STAGES) & 1);\n", "", 1),
        ("    if (lane == 0) mbar_arrive(ring.empty(s));\n", "", 1)],
}
K3_SIMT_SWEEP_ROUNDS = 6  # timed rounds of every variant, in turns


def phase_k3_simt_sweep(torch, smi):
    """K3's fp32 simt design and its ``K3_SIMT_SWEEP`` variants (builds of
    copies of csrc/transenc_simt.cu in WORK, one nvcc each, all started
    together) at transencoder2s's width, 1,024 and 16,384 samples: each
    checked variant's output bit-equal to the shipped build's; then
    ``K3_SIMT_SWEEP_ROUNDS`` rounds of timings, the variants in turn
    (forward, then reverse order), medians beside nn.TransformerEncoder +
    mean on the same inputs."""
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import nvcc, transenc

    src = open(os.path.join(nvcc.CSRC, transenc.SIMT_SRC)).read()
    os.makedirs(WORK, exist_ok=True)

    def build(name):
        text = src
        for old, new, count in K3_SIMT_SWEEP[name]:
            assert text.count(old) == count, (name, old)
            text = text.replace(old, new)
        path = os.path.join(WORK, "transenc_simt_{}.cu".format(name))
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        proc = subprocess.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-I", nvcc.CSRC, "-o", so, path],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return transenc.bind_simt(so)

    with ThreadPoolExecutor(len(K3_SIMT_SWEEP)) as pool:
        libs = dict(zip(K3_SIMT_SWEEP, pool.map(build, K3_SIMT_SWEEP)))
    dt = torch.float32
    shipped = transenc._simt_lib
    try:
        for rows in ROWS:
            cfg, params, st, x = _k3_inputs(torch, rows, "float32")
            NH = cfg.nhead
            lib = _torch_encoder(torch, params, dt)
            variants, want = [], None
            for name, so in libs.items():
                def fn(so=so):
                    transenc._simt_lib = so
                    return transenc.encoder_pooled(st, x, dt, NH)

                got = fn()
                torch.cuda.synchronize()
                want = got if want is None else want
                checked = name != "no_copies_no_waits"
                equal = bool(torch.equal(got, want))
                assert equal or not checked, (rows, name)
                variants.append(({"variant": name, "checked": checked, "bit_equal": equal,
                                  "ms_by_round": []}, fn))
            lib_ms = []
            with torch.inference_mode():
                for r in range(K3_SIMT_SWEEP_ROUNDS):
                    for res, fn in (variants if r % 2 == 0 else variants[::-1]):
                        res["ms_by_round"].append(time_ms(fn, torch))
                    lib_ms.append(time_ms(lambda: lib(x).float().mean(1), torch))
            del lib
            for res, _fn in variants:
                res["median_ms"] = statistics.median(res["ms_by_round"])
            emit({"phase": "k3_simt_sweep", "rows": rows, "rounds": K3_SIMT_SWEEP_ROUNDS,
                  "variants": [res for res, _fn in variants],
                  "library_ms": statistics.median(lib_ms), "card": smi})
    finally:
        transenc._simt_lib = shipped


# The probe of the fp32 simt design: marks put into a copy of
# csrc/transenc_simt.cu (never into the shipped kernel), each adding the
# clock64 cycles since the thread's last mark to a per-part sum in shared
# memory (flushed to device memory once, at the thread's end), for
# consumer threads 0 and 128 (warps 0 and 4) and the producer thread of CTA
# 0. Consumers' parts: 0 the waits on the ring's `full` barriers, 1 the
# products' slab loops (with the bias loads before them), 2 the epilogues
# (q | k | v, the hidden chunk, the residual and the sum), 3 attention, 4
# the two LayerNorms (their barriers inside), 5 the named barriers between
# the phases, 6 x's load and the set-up before the first layer, 7 the mean
# after the last. The producer's: 0 its waits on `empty`, 1 the rest.
K3_SIMT_PROBE_PARTS = ("ring_waits", "products", "epilogues", "attention", "layer_norm",
                       "barriers", "x_load", "mean")
K3_SIMT_PROBE_MARKS = [
    ('#include "entry_device.cuh"\n',
     '#include "entry_device.cuh"\n__device__ unsigned long long g_prof[3][8];\n'
     '__shared__ unsigned long long prof_acc[3][8], prof_prev[3];\n'
     '__device__ __forceinline__ int prof_who() {\n'
     '  const int t = threadIdx.x;\n'
     '  return blockIdx.x != 0 ? -1 : t == 0 ? 0 : t == 128 ? 1 : t == 256 ? 2 : -1;\n}\n'
     '__device__ __forceinline__ void prof_mark(int k) {\n'
     '  const int w = prof_who();\n'
     '  if (w < 0) return;\n'
     '  const unsigned long long now = clock64();\n'
     '  if (k >= 0) prof_acc[w][k] += now - prof_prev[w];\n'
     '  else for (int i = 0; i < 8; ++i) prof_acc[w][i] = 0;\n'
     '  prof_prev[w] = now;\n}\n'
     '__device__ __forceinline__ void prof_flush() {\n'
     '  const int w = prof_who();\n'
     '  if (w >= 0) for (int i = 0; i < 8; ++i) g_prof[w][i] += prof_acc[w][i];\n}\n'
     '#define PROF(k) prof_mark(k);\n'),
    ("  extern __shared__ __align__(128) float smem[];\n",
     "  extern __shared__ __align__(128) float smem[];\n  PROF(-1)\n"),
    ("  __syncthreads();\n  Ring ring{slots, bars, 0u};\n",
     "  __syncthreads();\n  PROF(6)\n  Ring ring{slots, bars, 0u};\n"),
    ("    mbar_wait(ring.full(s), (ring.g / TS_STAGES) & 1);\n",
     "    PROF(1)\n    mbar_wait(ring.full(s), (ring.g / TS_STAGES) & 1);\n    PROF(0)\n"),
    ("    if (lane == 0) mbar_arrive(ring.empty(s));\n  }\n}\n",
     "    if (lane == 0) mbar_arrive(ring.empty(s));\n  }\n  PROF(1)\n}\n"),
    ("        bias != nullptr ? add4(v, bv[c]) : v);\n    }\n  }\n}\n",
     "        bias != nullptr ? add4(v, bv[c]) : v);\n    }\n  }\n  PROF(2)\n}\n"),
    ("    if (active) ctx[(size_t)(h * HD + qd + 4 * n) * TS_LD + row] = c;\n  }\n}\n",
     "    if (active) ctx[(size_t)(h * HD + qd + 4 * n) * TS_LD + row] = c;\n  }\n  PROF(3)\n}\n"),
    ("    *px = (*px - mu) * rs * stage[c] + stage[TS_DMAX + c];\n  }\n  consumer_sync();\n}\n",
     "    *px = (*px - mu) * rs * stage[c] + stage[TS_DMAX + c];\n  }\n  consumer_sync();\n"
     "  PROF(4)\n}\n"),
    ("      consumer_sync();  // the last head's attention done with hb\n",
     "      consumer_sync();  // the last head's attention done with hb\n      PROF(5)\n"),
    ("      consumer_sync();  // q | k | v complete\n",
     "      consumer_sync();  // q | k | v complete\n      PROF(5)\n"),
    ("    consumer_sync();  // the context complete\n",
     "    consumer_sync();  // the context complete\n    PROF(5)\n"),
    ("    consumer_sync();  // the residual complete\n",
     "    consumer_sync();  // the residual complete\n    PROF(5)\n"),
    ("        consumer_sync();  // the last chunk's hidden columns read\n",
     "        consumer_sync();  // the last chunk's hidden columns read\n        PROF(5)\n"),
    ("        consumer_sync();\n        epilogue(hb, P, acc, b1, bv, relu);\n      }\n",
     "        consumer_sync();\n        PROF(5)\n        epilogue(hb, P, acc, b1, bv, relu);\n"
     "      }\n"),
    ("      consumer_sync();  // the hidden chunk complete\n",
     "      consumer_sync();  // the hidden chunk complete\n      PROF(5)\n"),
    ("    consumer_sync();  // the feed-forward's sum complete\n",
     "    consumer_sync();  // the feed-forward's sum complete\n    PROF(5)\n"),
    ("    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;\n  }\n}\n",
     "    p.out[(size_t)(n0 + s) * D + c] = sum / (float)L;\n  }\n  PROF(7)\n  prof_flush();\n}\n"),
    ("    if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1);\n",
     "    PROF(1)\n    if (use > 0) mbar_wait(ring.empty(s), (use - 1) & 1);\n    PROF(0)\n"),
    ("    return;\n  }\n", "    PROF(1)\n    prof_flush();\n    return;\n  }\n"),
    ("}  // extern \"C\"\n",
     "void simt_probe(unsigned long long* out, int reset) {\n"
     "  unsigned long long z[24] = {0};\n"
     "  if (reset) cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
     "  else cudaMemcpyFromSymbol(out, g_prof, sizeof(z));\n}\n}  // extern \"C\"\n"),
]


def phase_k3_simt_probe(torch, smi):
    """K3's fp32 simt design split into its parts (``K3_SIMT_PROBE_MARKS``)
    on one tile of samples alone, one full wave and 1,024 samples: k cycles
    a layer for each part (x's load and the mean: a call) of warps 0 and 4
    and of the producer, the products' FMA rate (the tile's FMAs over 128 a
    clock, against the products' and the ring waits' cycles), beside the
    call's CUDA-event time."""
    import ctypes

    from ccsmeth_tpu_torch.ops import nvcc, transenc

    src = open(os.path.join(nvcc.CSRC, transenc.SIMT_SRC)).read()
    for old, new in K3_SIMT_PROBE_MARKS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "transenc_simt_probe.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    proc = subprocess.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-I", nvcc.CSRC, "-o", so, path],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = transenc.bind_simt(so)
    p = ctypes.c_void_p
    lib.simt_probe.argtypes = [p, ctypes.c_int]
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    shipped, transenc._simt_lib = transenc._simt_lib, lib
    buf = (ctypes.c_ulonglong * 24)()
    dt = torch.float32
    try:
        cfg, _params, st, x = _k3_inputs(torch, ROWS[0], "float32")
        D, FF, NH, NLT = cfg.d_model, cfg.dim_ff, cfg.nhead, cfg.num_layers
        S = transenc.k3_plan(L, D, FF, NH, dt)["S"]
        tile_fmas = _k3_product_flops(S, D, FF, NLT) / 2 * (transenc.SIMT_ROWS / (S * L))
        for rows in (S, S * n_sm, ROWS[0]):
            xs = x[:rows]

            def fn():
                return transenc.encoder_pooled(st, xs, dt, NH)

            fn()
            torch.cuda.synchronize()
            lib.simt_probe(None, 1)
            ms = time_ms(fn, torch)
            lib.simt_probe(ctypes.cast(buf, p), 0)
            runs = REPS + 1  # the warm-up and the timed runs
            parts = {}
            for w, name in ((0, "warp0"), (1, "warp4")):
                per = [buf[8 * w + k] / runs for k in range(8)]
                parts[name] = {part: (v if part in ("x_load", "mean") else v / NLT) / 1e3
                               for part, v in zip(K3_SIMT_PROBE_PARTS, per)}
                parts[name]["fma_rate_in_products"] = tile_fmas / 128 / (per[1])
                parts[name]["fma_rate_in_products_and_waits"] = tile_fmas / 128 / (per[0] + per[1])
                parts[name]["tile_kcycles"] = sum(per) / 1e3
            parts["producer"] = {"empty_waits": buf[16] / runs / NLT / 1e3,
                                 "issue": buf[17] / runs / NLT / 1e3}
            emit({"phase": "k3_simt_probe", "rows": rows, "stages": transenc.SIMT_STAGES,
                  "slab_rows": transenc.SIMT_BK, "kernel_ms": ms,
                  "layer_kcycles_by_part": parts, "tile_fma_kcycles": tile_fmas / 128 / 1e3,
                  "card": smi})
    finally:
        transenc._simt_lib = shipped


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


def phase_k2_kernels(torch, smi, cell, cins=(C, 2 * H), dtypes=("float32", "bfloat16"),
                     rows=ROWS[0]):
    """K2, one bidirectional layer of the cell, at the call_mods path's
    shapes (1024 rows, or ``rows``; C = 11 for layer 0, 2H for layers 1 and
    2; or the ``cins`` given) against
    its plain version, timed beside it, cuDNN's one-layer bidirectional
    nn.GRU / nn.LSTM (inference) and the bound, with the design ``k1_plan``
    picked (simt in fp32, rows from its crossover up, tc in bf16), its CUDA
    launches a call (K2's own count; K1's stays), a rerun for bit-equal
    outputs and each phase's time; in the rows design also the simt design
    forced on the same input (bit-equal, its time beside). Tolerances as
    K1's."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru

    cells = []
    for cin in cins:
        rng = np.random.RandomState(SEED + cin)
        ld = init_rnn_params(rng, cin, H, 1, cell)[0]
        x_np = rng.randn(L, rows, cin).astype(np.float32)
        for dname in dtypes:
            dt = getattr(torch, dname)
            plan = bigru.k1_plan(H, cell, dt, rows)
            ly = layer_weights(ld, dt, "cuda")
            x = torch.from_numpy(x_np).to("cuda", dt)
            k1_before = (bigru.launches, bigru.cuda_launches)
            before = dict(bigru.layer_design_calls)
            bigru.layer_cuda_launches = 0
            out = bigru.bigru_layer_tm(ly, x, dt, cell)
            cuda_per_call = bigru.layer_cuda_launches
            again = bigru.bigru_layer_tm(ly, x, dt, cell)
            torch.cuda.synchronize()
            assert cuda_per_call == _per_call(plan, cell, [cin]), (cell, cin, dname,
                                                                   cuda_per_call)
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
                simt_forced = None
                if plan["design"] == "rows":
                    forced = bigru.bigru_layer_tm(ly, x, dt, cell, "simt")
                    torch.cuda.synchronize()
                    assert torch.equal(forced, out), (cell, cin, rows, "rows != simt")
                    simt_forced = {"bit_equal": True, "kernel_ms": time_ms(
                        lambda: bigru.bigru_layer_tm(ly, x, dt, cell, "simt"), torch)}
                    del forced
            bms, bby = _bound(bigru.stack_flops(L, rows, cin, H, 1, cell),
                              _nbytes(x, out, *ly), dname)
            res = {"phase": "kernel", "name": "bigru_layer", "cell": cell,
                   "rows": rows, "C": cin, "dtype": dname, "design": plan["design"],
                   "simt": (_simt_geometry(cell, plan) if plan["design"] == "simt"
                            and dname == "float32" else None),
                   "rows_design": (_rows_report(torch, cell, plan, rows, phases["recurrence"])
                                   if plan["design"] == "rows" else None),
                   "simt_forced": simt_forced,
                   "cuda_launches_per_call": cuda_per_call, "rerun_bit_equal": True,
                   "max_abs_err": err, "tol": TOL[dname], "kernel_ms": kernel_ms,
                   "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bms,
                   "bound_by": bby, "phases_ms": phases,
                   "library_weights_warning": lib.weights_warning, "card": smi}
            emit(res)
            cells.append(res)
            del lib, out, again, ref
    return cells


def _chain_fwd(torch, ly, x, cell):
    """A chain of the training forwards (K4 for the GRU, K6 for the LSTM),
    layer by layer: (out, h_n), which K1's fp32 out and h_n equal bit for
    bit."""
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    fwd = (bigru_vjp.bigru_layer_train_fwd if cell == "gru"
           else bilstm_vjp.bilstm_layer_train_fwd)
    inp, h_ns = x, []
    hid = ly[0][2].shape[1]
    for wih, bih, whh, bhh in ly:
        inp = fwd(inp, wih, bih, whh, bhh, torch.float32)[0]
        h_ns += [inp[-1, :, :hid], inp[0, :, hid:]]
    return inp, torch.stack(h_ns)


def _simt_geometry(cell, plan):
    """The fp32 simt design's geometry at H = 256 (``plan``): U, CN, R, rows
    a thread, threads and shared memory a CTA, the clusters the card holds
    at once (cudaOccupancyMaxActiveClusters) and the waves of 2 ceil(rows /
    R) clusters at 1,024 and 16,384 rows."""
    import math

    from ccsmeth_tpu_torch.ops import bigru

    occ = bigru.simt_occupancy(H, cell, plan)
    return {"U": plan["U"], "CN": plan["CN"], "R": plan["rows"],
            "rows_a_thread": plan["rows_a_thread"], "threads": plan["threads"],
            "smem": plan["smem"], "resident_clusters": occ,
            "waves": {str(rows): math.ceil(2 * math.ceil(rows / plan["rows"]) / occ)
                      for rows in ROWS}}


def _sm_clock_mhz_while(fn, torch, launches):
    """The SM clock (MHz) that nvidia-smi reads while ``launches`` calls of
    fn, queued on the card at once, run."""
    fn()
    torch.cuda.synchronize()
    for _ in range(launches):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    torch.cuda.synchronize()
    return float(out.strip().splitlines()[0])


def _simt_report(torch, cell, plan, ly):
    """``_simt_geometry``; at 1,024 and 16,384 rows the recurrence's ms a
    layer and its step a wave (ms / (waves L)); its step in us on one row
    tile and on one full wave, and the product's FMA rate there, as FMAs a
    clock an SM over 128 (the 128 FMA lanes): the tile's R U NG H FMAs a
    CTA a step over the step's time (gate math and exchange included) at
    the SM clock that nvidia-smi reads during a run of the full wave; and
    the projection's TFLOP/s at C = 11 and 2H beside torch.mm's at 2H (TF32
    off, both directions, no bias) at both row counts; CUDA events,
    medians."""
    from ccsmeth_tpu_torch.models.rnn import n_gates

    G = n_gates(cell) * H
    R = plan["rows"]
    res = dict(_simt_geometry(cell, plan), recurrence_ms={}, step_us_a_wave={},
               projection_tflops={})
    occ = res["resident_clusters"]
    proj, rec, _rows = _phase_fns(plan, ly[0], cell, L)
    proj1 = _phase_fns(plan, ly[1], cell, L)[0]
    for rows in ROWS:
        xg = torch.randn((2, L * rows, G), device="cuda")
        ms = time_ms(lambda: rec(xg, rows), torch)
        res["recurrence_ms"][str(rows)] = ms
        res["step_us_a_wave"][str(rows)] = ms * 1e3 / (res["waves"][str(rows)] * L)
    fmas = R * plan["U"] * n_gates(cell) * H  # a CTA's product a step
    for name, tiles in (("one_tile", 1), ("one_wave", max(1, occ // 2))):
        xg = torch.randn((2, L * tiles * R, G), device="cuda")
        res["step_us_" + name] = time_ms(lambda: rec(xg, tiles * R), torch) * 1e3 / L
        if name == "one_wave":
            res["sm_clock_mhz"] = _sm_clock_mhz_while(lambda: rec(xg, tiles * R), torch, 1500)
    for name in ("one_tile", "one_wave"):
        res["fma_rate_" + name] = (fmas / (res["step_us_" + name] * res["sm_clock_mhz"])
                                   / 128)
    res["tiles_one_wave"] = max(1, occ // 2)
    for rows in ROWS:
        for cin, fn in ((C, proj), (2 * H, proj1)):
            x2 = torch.randn((L * rows, cin), device="cuda")
            xg = fn(x2)
            ms = time_ms(lambda: fn(x2, xg), torch)
            res["projection_tflops"]["C={} rows={}".format(cin, rows)] = (
                2 * x2.shape[0] * cin * 2 * G / ms / 1e9)
        # the yardstick: cuBLAS's f32 product (TF32 off) of the same shape,
        # both directions, without the bias
        w = torch.randn((2, 2 * H, G), device="cuda")
        ms = time_ms(lambda: (torch.mm(x2, w[0]), torch.mm(x2, w[1])), torch)
        flops = 2 * x2.shape[0] * 2 * H * 2 * G
        res["projection_tflops"]["torch_mm_C={} rows={}".format(2 * H, rows)] = flops / ms / 1e9
        del xg, x2, w
    return res


# the fp32 recurrence's candidate geometries at H = 256 (U, R), each
# instantiated in csrc/birnn_simt.cu; the first of a cell is its
# SIMT_GEOMETRY: 9 rows a thread (72 a tile, one wave of 15 clusters up to
# 504 rows, two at 1,024); the GRU's 10 (80), the LSTM's 8 (64; its CTA of
# 80 rows does not fit); the row counts at which they are timed against
# each other (2B, batch 192 .. 512, and 8,192; 504 and 505 the 72-row
# tiles' last row count in one wave and the first in two)
SIMT_SWEEP = {"gru": [(32, 72), (32, 80)],
              "lstm": [(32, 72), (32, 64)]}
SIMT_SWEEP_ROWS = (384, 448, 504, 505, 576, 640, 768, 1024, 16384)
SIMT_SWEEP_ROUNDS = 3


def phase_k1_simt_sweep(torch, smi):
    """K1's fp32 simt design at every candidate geometry (``SIMT_SWEEP``),
    the models' 3 x 256 stack (C = 11): out and h_n against a chain of the
    training forwards (bit-equal) at 1,024, 1,031 and 16,384 rows,
    ``_simt_report`` of each geometry, and K1's time at each row count of
    ``SIMT_SWEEP_ROWS`` in ``SIMT_SWEEP_ROUNDS`` alternating rounds (the
    order reversed every other round), cuDNN's ``nn.GRU`` / ``nn.LSTM``
    beside."""
    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru

    dt = torch.float32
    for cell, geoms in SIMT_SWEEP.items():
        layers_np, ly = _layers(torch, dt, "cuda", cell)
        lib = _cudnn(torch, cell, C, NL, layers_np, dt)
        xs = {rows: torch.from_numpy(np.random.RandomState(SEED + rows).randn(
            L, rows, C).astype(np.float32)).cuda() for rows in (1024, 1031, ROWS[1])}
        refs = {rows: _chain_fwd(torch, ly, x, cell) for rows, x in xs.items()}
        variants = {str(g): dict(bigru.simt_geometry(H, cell, g), design="simt") for g in geoms}
        reports, equal = {}, {}
        for key, plan in variants.items():
            for rows, x in xs.items():
                out, hn = bigru._stack_layers(ly, x, dt, cell, H, plan)
                torch.cuda.synchronize()
                equal["{} {}".format(key, rows)] = bool(torch.equal(out, refs[rows][0])
                                                        and torch.equal(hn, refs[rows][1]))
                del out, hn
            reports[key] = _simt_report(torch, cell, plan, ly)
        del xs, refs
        ms, library = {}, {}
        for rows in SIMT_SWEEP_ROWS:
            x = torch.from_numpy(np.random.RandomState(SEED + rows).randn(
                L, rows, C).astype(np.float32)).cuda()
            got = {key: [] for key in variants}
            with torch.inference_mode():
                for rnd in range(SIMT_SWEEP_ROUNDS):
                    order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
                    for key in order:
                        plan = variants[key]
                        got[key].append(time_ms(
                            lambda: bigru._stack_layers(ly, x, dt, cell, H, plan), torch, 7))
                library[str(rows)] = time_ms(lambda: lib(x), torch)
            ms[str(rows)] = {key: statistics.median(v) for key, v in got.items()}
            del x
        emit({"phase": "k1_simt_sweep", "cell": cell, "geometries": reports, "ms": ms,
              "library_ms": library, "rounds": SIMT_SWEEP_ROUNDS,
              "bit_equal_to_chain": equal, "card": smi})
        assert all(equal.values()), equal


# the row counts of K1's fp32 design sweep (2B: batch 512 .. 8,192), and the
# rows design's candidate geometries (R, ring slots), each instantiated in
# csrc/birnn_rows.cu (ROWS_GEOMETRIES); the first of a cell is its
# ROWS_GEOMETRY
ROWS_SWEEP_ROWS = (1024, 2048, 3072, 3584, 4096, 4224, 5120, 6144, 8192, 16384)
ROWS_SWEEP = {"gru": [(128, 4), (128, 3), (64, 2)],
              "lstm": [(128, 3), (128, 2), (64, 2)]}
ROWS_SWEEP_ROUNDS = 3


def phase_k1_rows_sweep(torch, smi):
    """K1 fp32 (the models' 3 x 256 stack, C = 11) at each row count of
    ``ROWS_SWEEP_ROWS`` in the simt design and in the rows design at each
    geometry of ``ROWS_SWEEP``, in ``ROWS_SWEEP_ROUNDS`` alternating rounds
    (the order reversed every other round); every variant's out and h_n
    equal simt's bit for bit. One line a cell: the medians, cuDNN's
    ``nn.GRU`` / ``nn.LSTM`` and the bound at each row count, the rows
    design's geometry (registers, CTAs an SM) and the crossover, the
    smallest row count from which the rows design at ``ROWS_GEOMETRY`` is
    faster than simt at every count swept, which ``ROWS_CROSSOVER`` holds;
    and at each count swept in ``ROWS_SMALL_WINDOW``, whether the rows
    design at ``ROWS_SMALL_GEOMETRY`` is faster than simt there."""
    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru

    dt = torch.float32
    for cell in MODELS:
        layers_np, ly = _layers(torch, dt, "cuda", cell)
        lib = _cudnn(torch, cell, C, NL, layers_np, dt)
        variants = {"simt": dict(bigru.simt_geometry(H, cell), design="simt")}
        geos = {}
        for geo in ROWS_SWEEP[cell]:
            key = "rows R={} stages={}".format(*geo)
            variants[key] = dict(bigru.rows_geometry(H, cell, geo), design="rows")
            geos[key] = bigru.rows_occupancy(H, cell, variants[key])
        shipped = "rows R={} stages={}".format(*bigru.ROWS_GEOMETRY[cell])
        ms, equal, library, bound = {}, {}, {}, {}
        for rows in ROWS_SWEEP_ROWS:
            x = torch.from_numpy(np.random.RandomState(SEED + rows).randn(
                L, rows, C).astype(np.float32)).cuda()
            with torch.inference_mode():
                ref = bigru._stack_layers(ly, x, dt, cell, H, variants["simt"])
                for key, plan in variants.items():
                    out, hn = bigru._stack_layers(ly, x, dt, cell, H, plan)
                    torch.cuda.synchronize()
                    equal["{} {}".format(key, rows)] = bool(torch.equal(out, ref[0])
                                                            and torch.equal(hn, ref[1]))
                    del out, hn
                del ref
                got = {key: [] for key in variants}
                for rnd in range(ROWS_SWEEP_ROUNDS):
                    order = list(variants) if rnd % 2 == 0 else list(reversed(variants))
                    for key in order:
                        plan = variants[key]
                        got[key].append(time_ms(
                            lambda: bigru._stack_layers(ly, x, dt, cell, H, plan), torch, 7))
                library[str(rows)] = time_ms(lambda: lib(x), torch)
            ms[str(rows)] = {key: statistics.median(v) for key, v in got.items()}
            bound[str(rows)] = _bound(bigru.stack_flops(L, rows, C, H, NL, cell),
                                      _nbytes(x, *[t for lyr in ly for t in lyr])
                                      + 4 * L * rows * 2 * H + 4 * 2 * NL * rows * H,
                                      "float32")[0]
            del x
        faster = [int(r) for r, m in ms.items() if m[shipped] < m["simt"]]
        crossover = next((r for r in ROWS_SWEEP_ROWS
                          if all(q in faster for q in ROWS_SWEEP_ROWS if q >= r)), None)
        small = "rows R={} stages={}".format(*bigru.ROWS_SMALL_GEOMETRY[cell])
        lo, hi = bigru.ROWS_SMALL_WINDOW
        window = {str(r): ms[str(r)][small] < ms[str(r)]["simt"]
                  for r in ROWS_SWEEP_ROWS if lo <= r <= hi}
        emit({"phase": "k1_rows_sweep", "cell": cell, "ms": ms, "library_ms": library,
              "bound_ms": bound, "geometries": geos,
              "shipped": shipped, "bit_equal_to_simt": all(equal.values()),
              "rounds": ROWS_SWEEP_ROUNDS,
              "crossover_measured": crossover, "crossover_in_use": bigru.ROWS_CROSSOVER,
              "small_window": bigru.ROWS_SMALL_WINDOW, "small_faster_than_simt": window,
              "card": smi})
        assert all(equal.values()), equal


# clock64 marks for a copy of csrc/birnn_rows.cu (never in the shipped
# source): each warp of CTA 0 of each direction sums its cycles in six
# parts (K1_ROWS_PROBE_PARTS): the slab waits on `full`, the products, the
# epilogues (gate math, loads and stores), the step's end (the block
# barriers and h's read-back from out), the refills (the box loads of the
# last warp done with a slab) and a pass's start (the xc prefetch)
K1_ROWS_PROBE_PARTS = ("full_wait", "product", "epilogue", "step_end", "refill", "pass_start")
K1_ROWS_PROBE_MARKS = [
    ("  const int tid = threadIdx.x;\n",
     "  const int tid = threadIdx.x;\n  long long pr_t[6] = {0, 0, 0, 0, 0, 0};\n"
     "  long long pr_m = clock64();\n"),
    ("        mbar_wait(smem_u32(full + slot), (g / STAGES) & 1);\n",
     "        { const long long pa = clock64(); pr_t[1] += pa - pr_m;\n"
     "        mbar_wait(smem_u32(full + slot), (g / STAGES) & 1);\n"
     "        pr_m = clock64(); pr_t[0] += pr_m - pa; }\n"),
    ("            load_slab(g + STAGES);\n",
     "            { const long long pi = clock64(); load_slab(g + STAGES); pr_t[4] += clock64() - pi; }\n"),
    ("      // the gate math of the thread's cells, as birnn_simt.cu's\n",
     "      { const long long pq = clock64(); pr_t[1] += pq - pr_m; pr_m = pq; }\n"),
    ("        }\n      }\n    }\n    if (last) break;\n",
     "        }\n      }\n      { const long long pe = clock64(); pr_t[2] += pe - pr_m; pr_m = pe; }\n"
     "    }\n    if (last) break;\n"),
    ("    __syncthreads();  // the buffer holds h(t)\n",
     "    __syncthreads();  // the buffer holds h(t)\n"
     "    { const long long pz = clock64(); pr_t[3] += pz - pr_m; pr_m = pz; }\n"),
    ("      // the product: acc[i][gate][e]",
     "      { const long long pf = clock64(); pr_t[5] += pf - pr_m; pr_m = pf; }\n"
     "      // the product: acc[i][gate][e]"),
    ("template <bool LSTM, int NRG, int STAGES>\n__global__",
     "__device__ long long g_probe[2][16][6];\ntemplate <bool LSTM, int NRG, int STAGES>\n__global__"),
    ("}\n\n// Every float32 bit pattern x",
     "  if (lane == 0 && blockIdx.x == 0)\n"
     "    for (int q = 0; q < 6; ++q) g_probe[blockIdx.y][w][q] = pr_t[q];\n}\n\n"
     "extern \"C\" int rows_probe_read(long long* h) {\n"
     "  return (int)cudaMemcpyFromSymbol(h, g_probe, sizeof(g_probe));\n}\n\n"
     "// Every float32 bit pattern x"),
]


def _probe_build(src_name, marks, tag):
    """A copy of csrc/<src_name> with ``marks`` applied (each old text
    present once), built with the port's nvcc flags into build/chip_smoke/
    as <tag>.so; returns the loaded library."""
    import ctypes

    from ccsmeth_tpu_torch.ops import nvcc

    src = open(os.path.join(nvcc.CSRC, src_name)).read()
    for old, new in marks:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, tag + ".cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    proc = subprocess.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-I", nvcc.CSRC, "-o", so, path],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(so)


def phase_k1_rows_probe(torch, smi):
    """K1's rows design split into its parts (``K1_ROWS_PROBE_MARKS``): one
    layer's recurrence at 16,384 rows (C = 512's projection), both cells, at
    ``ROWS_GEOMETRY``: k cycles a step of each part for each warp of CTA 0
    of direction 0, and the products' FMA rate inside their slab loops (the
    CTA's R H NG H FMAs a step over 128 a clock, against the products'
    cycles a step), beside the recurrence's CUDA-event time and the
    shipped build's; the probed build's out equal to the shipped one's."""
    import ctypes

    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights, n_gates
    from ccsmeth_tpu_torch.ops import bigru

    lib = _probe_build(bigru.ROWS_SRC, K1_ROWS_PROBE_MARKS, "birnn_rows_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.birnn_rows_rec_launch.restype = i
    lib.birnn_rows_rec_launch.argtypes = [i] + [p] * 5 + [i] * 5 + [p, i]
    lib.rows_probe_read.restype = i
    rows, f32 = ROWS[1], torch.float32
    for cell in MODELS:
        G = n_gates(cell) * H
        plan = bigru.k1_plan(H, cell, f32, rows)
        rng = np.random.RandomState(SEED)
        wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 2 * H, H, 1, cell)[0], f32, "cuda")
        x = torch.from_numpy(rng.randn(L * rows, 2 * H).astype(np.float32)).cuda()
        xg = bigru.simt_projection(x, wih, bih, bhh, cell)
        out = torch.empty((L, rows, 2 * H), device="cuda")
        hn = torch.empty((2, rows, H), device="cuda")

        def probed():
            rc = lib.birnn_rows_rec_launch(
                0 if cell == "gru" else 1, xg.data_ptr(), whh.data_ptr(), bhh.data_ptr(),
                out.data_ptr(), hn.data_ptr(), L, rows, H, plan["rows"], plan["stages"],
                torch.cuda.current_stream().cuda_stream, 0)
            assert rc == 0, rc

        ref = bigru.rows_recurrence(xg, whh, bhh, L, rows, plan, cell)[0]
        probed()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        probed_ms = time_ms(probed, torch)
        shipped_ms = time_ms(lambda: bigru.rows_recurrence(xg, whh, bhh, L, rows, plan, cell,
                                                           ref), torch)
        buf = (ctypes.c_longlong * (2 * 16 * 6))()
        assert lib.rows_probe_read(buf) == 0
        per = np.array(buf[:]).reshape(2, 16, 6)[0, :plan["threads"] // 32] / L
        fmas = plan["rows"] * H * G  # a CTA's product a step
        warps = [dict({k: float(v) / 1e3 for k, v in zip(K1_ROWS_PROBE_PARTS, row)},
                      fma_rate_in_products=fmas / 128 / float(row[1]),
                      step_kcycles=float(row.sum()) / 1e3) for row in per]
        emit({"phase": "k1_rows_probe", "cell": cell, "rows": rows, "R": plan["rows"],
              "stages": plan["stages"], "probed_ms": probed_ms, "shipped_ms": shipped_ms,
              "step_kcycles_by_part_and_warp": warps,
              "step_fma_kcycles_at_peak": fmas / 128 / 1e3, "card": smi})
        del x, xg, out, hn, ref


# clock64 marks for a copy of csrc/birnn_simt.cu (never in the shipped
# source) that split a step of birnn_rec_kernel into its parts
# (K1_SIMT_PROBE_PARTS), summed over the L steps by lane 0 of each warp of
# every CTA: the wait on `full` (product warps), the product (with the
# `pre` writes), the first block barrier (for the gate warps the whole
# product: they wait there), the gate math (with the `empty` arrivals, the
# `pre` reads and the out stores), the issue of the next step's xg loads,
# the h block write and its barrier, and thread 0's wait on `empty` with the
# bulk copies' issue (warp 0); each CTA's start and end on %globaltimer,
# from which the phase tells the first wave of clusters from the second
K1_SIMT_PROBE_PARTS = ("full_wait", "product", "barrier_after_product", "gate_math",
                       "xg_loads", "h_write_and_barrier", "empty_wait_and_copies")
K1_SIMT_PROBE_MARKS = [
    ("  const bool prod = tid < K1_PW;  // a product thread (else a gate thread)\n",
     "  const bool prod = tid < K1_PW;  // a product thread (else a gate thread)\n"
     "  long long pr_t[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  unsigned long long pr_g0;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(pr_g0));\n"
     "  long long pr_m = clock64();\n"),
    ("      if (cn > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);\n",
     "      if (cn > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);\n"
     "      { const long long n = clock64(); pr_t[0] += n - pr_m; pr_m = n; }\n"),
    ("          sum[i][gate] = acc[i][gate][0];\n        }\n    }\n",
     "          sum[i][gate] = acc[i][gate][0];\n        }\n"
     "      { const long long n = clock64(); pr_t[1] += n - pr_m; pr_m = n; }\n    }\n"),
    ("    __syncthreads();  // every thread has read h(s) (the peers may send h(s + 1)); `pre` is whole\n",
     "    __syncthreads();  // every thread has read h(s) (the peers may send h(s + 1)); `pre` is whole\n"
     "    { const long long n = clock64(); pr_t[2] += n - pr_m; pr_m = n; }\n"),
    ("    if (last) break;\n    load_x(d == 0 ? s + 1 : L - 2 - s);\n",
     "    { const long long n = clock64(); pr_t[3] += n - pr_m; pr_m = n; }\n"
     "    if (last) break;\n    load_x(d == 0 ? s + 1 : L - 2 - s);\n"
     "    { const long long n = clock64(); pr_t[4] += n - pr_m; pr_m = n; }\n"),
    ("    __syncthreads();  // the block is whole\n",
     "    __syncthreads();  // the block is whole\n"
     "    { const long long n = clock64(); pr_t[5] += n - pr_m; pr_m = n; }\n"),
    ("      asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n    }\n  }\n",
     "      asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n    }\n"
     "    { const long long n = clock64(); pr_t[6] += n - pr_m; pr_m = n; }\n  }\n"),
    ("  cluster_sync_all();  // no CTA leaves while another may still reach its shared memory\n}\n",
     "  cluster_sync_all();  // no CTA leaves while another may still reach its shared memory\n"
     "  if ((tid & 31) == 0 && blockIdx.x < 256)\n"
     "    for (int q = 0; q < 7; ++q) g_probe[blockIdx.y][blockIdx.x][tid >> 5][q] = pr_t[q];\n"
     "  if (tid == 0 && blockIdx.x < 256) {\n"
     "    unsigned long long g1;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g1));\n"
     "    g_time[blockIdx.y][blockIdx.x][0] = (long long)pr_g0;\n"
     "    g_time[blockIdx.y][blockIdx.x][1] = (long long)g1;\n"
     "    g_time[blockIdx.y][blockIdx.x][2] = (long long)__mysmid();\n"
     "  }\n}\n"),
    ("template <bool LSTM, int U, int RT>\n__global__",
     "__device__ long long g_probe[2][256][8][7];\n__device__ long long g_time[2][256][3];\n"
     "__device__ __forceinline__ unsigned __mysmid() {\n"
     "  unsigned r;\n  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(r));\n  return r;\n}\n"
     "template <bool LSTM, int U, int RT>\n__global__"),
    ("}  // extern \"C\"\n",
     "int simt_probe_read(long long* parts, long long* times) {\n"
     "  cudaError_t e = cudaMemcpyFromSymbol(parts, g_probe, sizeof(g_probe));\n"
     "  if (e != cudaSuccess) return (int)e;\n"
     "  return (int)cudaMemcpyFromSymbol(times, g_time, sizeof(g_time));\n}\n\n"
     "}  // extern \"C\"\n"),
]


def _probe_waves(times, n_ctas):
    """The CTAs' waves from their start times (ns, [d][cta]): sorted, the
    starts split at the largest gap; {cta key: 0 or 1}."""
    starts = sorted((int(times[d][c][0]), (d, c)) for d in range(2) for c in range(n_ctas))
    gaps = [starts[i + 1][0] - starts[i][0] for i in range(len(starts) - 1)]
    cut = max(range(len(gaps)), key=gaps.__getitem__) + 1 if gaps else len(starts)
    # one wave only: the largest gap is no gap
    if gaps and gaps[cut - 1] < 10 * (sorted(gaps)[len(gaps) // 2] + 1000):
        cut = len(starts)
    return {key: (0 if i < cut else 1) for i, (_t, key) in enumerate(starts)}


def phase_k1_simt_probe(torch, smi):
    """K1's fp32 simt recurrence (``birnn_rec_kernel`` at ``SIMT_GEOMETRY``)
    split into its parts by ``K1_SIMT_PROBE_MARKS``: one layer's recurrence
    at 1,024 rows (C = 512's projection), both cells; for the first wave of
    clusters and the second, the median over their CTAs of each warp's k
    cycles a step in each part, the product's FMA rate inside its part (the
    CTA's R U NG H FMAs a step over 128 a clock), the step a wave in us
    (the wave's span on %globaltimer over L), beside the recurrence's
    CUDA-event time, the shipped build's, and the SM clock during a run
    (``_sm_clock_mhz_while``); the probed build's out equal to the shipped
    one's."""
    import ctypes

    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights, n_gates
    from ccsmeth_tpu_torch.ops import bigru

    lib = _probe_build(bigru.SIMT_SRC, K1_SIMT_PROBE_MARKS, "birnn_simt_probe")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.birnn_simt_rec_launch.restype = i
    lib.birnn_simt_rec_launch.argtypes = [i, i] + [p] * 5 + [i] * 5 + [p, i]
    lib.simt_probe_read.restype = i
    rows, f32 = ROWS[0], torch.float32
    for cell in MODELS:
        G = n_gates(cell) * H
        plan = dict(bigru.simt_geometry(H, cell, bigru.SIMT_GEOMETRY[cell]), design="simt")
        rng = np.random.RandomState(SEED)
        wih, bih, whh, bhh = layer_weights(init_rnn_params(rng, 2 * H, H, 1, cell)[0], f32, "cuda")
        x = torch.from_numpy(rng.randn(L * rows, 2 * H).astype(np.float32)).cuda()
        xg = bigru.simt_projection(x, wih, bih, bhh, cell)
        out = torch.empty((L, rows, 2 * H), device="cuda")
        hn = torch.empty((2, rows, H), device="cuda")

        def probed():
            rc = lib.birnn_simt_rec_launch(
                0 if cell == "gru" else 1, 0, xg.data_ptr(), whh.data_ptr(), bhh.data_ptr(),
                out.data_ptr(), hn.data_ptr(), L, rows, H, plan["U"], plan["rows"],
                torch.cuda.current_stream().cuda_stream, 0)
            assert rc == 0, rc

        ref = bigru.simt_recurrence(xg, whh, bhh, L, rows, plan, cell)[0]
        probed()
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
        probed_ms = time_ms(probed, torch)
        shipped_ms = time_ms(lambda: bigru.simt_recurrence(xg, whh, bhh, L, rows, plan, cell,
                                                           ref), torch)
        mhz = _sm_clock_mhz_while(probed, torch, 1500)
        probed()  # the parts of one run alone
        torch.cuda.synchronize()
        parts = (ctypes.c_longlong * (2 * 256 * 8 * 7))()
        times = (ctypes.c_longlong * (2 * 256 * 3))()
        assert lib.simt_probe_read(parts, times) == 0
        parts = np.array(parts[:]).reshape(2, 256, 8, 7)
        times = np.array(times[:]).reshape(2, 256, 3)
        n_ctas = plan["CN"] * -(-rows // plan["rows"])
        wave = _probe_waves(times, n_ctas)
        fmas = plan["rows"] * plan["U"] * G  # a CTA's product a step
        waves = []
        for w in sorted(set(wave.values())):
            keys = [k for k, v in wave.items() if v == w]
            per = np.stack([parts[d, c] for d, c in keys]) / L / 1e3  # k cycles a step
            med = np.median(per, axis=0)  # (warp, part)
            span = (max(times[d, c, 1] for d, c in keys)
                    - min(times[d, c, 0] for d, c in keys))
            waves.append({
                "wave": w, "ctas": len(keys), "step_us_from_span": span / 1e3 / L,
                "warps": [dict({k: float(v) for k, v in zip(K1_SIMT_PROBE_PARTS, row)},
                               step_kcycles=float(row.sum())) for row in med],
                "fma_rate_in_product": float(fmas / 128 / 1e3 / np.median(per[:, :4, 1])),
                "sms": len({int(times[d, c, 2]) for d, c in keys})})
        emit({"phase": "k1_simt_probe", "cell": cell, "rows": rows, "U": plan["U"],
              "R": plan["rows"], "CN": plan["CN"], "probed_ms": probed_ms,
              "shipped_ms": shipped_ms, "sm_clock_mhz": mhz,
              "step_fma_kcycles_at_peak": fmas / 128 / 1e3, "waves": waves, "card": smi})
        del x, xg, out, hn, ref


def _tc_geometry(cell, plan, kx=0):
    """The bf16 tc design's recurrence geometry at H = 256 (``plan``): U,
    CN, MR, WN, rows a tile, threads and shared memory a CTA, the clusters
    the card holds at once (cudaOccupancyMaxActiveClusters) and the waves of
    2 ceil(rows / R) clusters at 1,024 and 16,384 rows."""
    import math

    from ccsmeth_tpu_torch.ops import bigru

    occ = bigru.tc_occupancy(H, cell, plan, kx)
    return {"U": plan["U"], "CN": plan["CN"], "MR": plan["MR"], "WN": plan["WN"],
            "R": plan["rows"], "threads": plan["threads"],
            "smem": bigru.tc_smem(H, cell, plan["U"], plan["rows"], kx), "kx": kx,
            "resident_clusters": occ,
            "waves": {str(rows): math.ceil(2 * math.ceil(rows / plan["rows"]) / occ)
                      for rows in ROWS}}


def _tc_report(torch, cell, plan, ly, x):
    """``_tc_geometry`` (unfused, and with layer 0's fused projection) and
    the recurrence's ms a layer at 1,024 and 16,384 rows, its step in us on
    one row tile and on one full wave, the fused layer 0's ms at both row
    counts, and the projection's TFLOP/s at C = 2H (TMA + wgmma) beside
    torch.mm's on the same bf16 product; CUDA events, medians."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import n_gates
    from ccsmeth_tpu_torch.ops import bigru

    G = n_gates(cell) * H
    R = plan["rows"]
    kx = bigru.tc_fused_kx(plan, x.shape[2], cell, H)
    res = dict(_tc_geometry(cell, plan), recurrence_ms={}, fused_layer0_ms={},
               projection_tflops={})
    if kx:
        res["fused"] = _tc_geometry(cell, plan, kx)
    occ = res["resident_clusters"]
    proj1, rec, _rows = _phase_fns(plan, ly[1], cell, L)
    for rows in ROWS:
        xg = torch.randn((2, L * rows, G), device="cuda")
        res["recurrence_ms"][str(rows)] = time_ms(lambda: rec(xg, rows), torch)
        if kx:
            xr = torch.from_numpy(np.random.RandomState(SEED + rows).randn(
                L, rows, x.shape[2]).astype(np.float32)).to("cuda", torch.bfloat16)
            fused = _fused_fn(plan, ly[0], cell, xr)
            res["fused_layer0_ms"][str(rows)] = time_ms(fused, torch)
    for name, tiles in (("one_tile", 1), ("one_wave", max(1, occ // 2))):
        xg = torch.randn((2, L * tiles * R, G), device="cuda")
        res["step_us_" + name] = time_ms(lambda: rec(xg, tiles * R), torch) * 1e3 / L
    res["tiles_one_wave"] = max(1, occ // 2)
    for rows in ROWS:
        x2 = torch.randn((L * rows, 2 * H), device="cuda").to(torch.bfloat16)
        xg = proj1(x2)
        flops = 2 * x2.shape[0] * 2 * H * 2 * G
        ms = time_ms(lambda: proj1(x2, xg), torch)
        # the yardstick: cuBLAS's bf16 product of the same shape, both
        # directions in one, without the bias and with a bf16 output
        w = torch.randn((2 * H, 2 * G), device="cuda").to(torch.bfloat16)
        mm_ms = time_ms(lambda: torch.mm(x2, w), torch)
        res["projection_tflops"][str(rows)] = {"ms": ms, "tflops": flops / ms / 1e9,
                                              "torch_mm_ms": mm_ms,
                                              "torch_mm_tflops": flops / mm_ms / 1e9}
    return res


# the bf16 recurrence's candidate geometries at H = 256 (U, MR, WN), each
# instantiated in csrc/birnn_tc.cu; the first of a cell is its TC_GEOMETRY
TC_SWEEP = {"gru": [(64, 2, 2), (64, 1, 2), (128, 1, 4)],
            "lstm": [(64, 2, 2), (64, 1, 2)]}


def phase_k1_tc_sweep(torch, smi):
    """K1's bf16 tc design at every candidate geometry (``TC_SWEEP``), the
    models' 3 x 256 stack at 1,024 and 16,384 rows: out and h_n against the
    plain version (``TOL``), a bit-equal rerun, ``_tc_report`` and K1's time
    at both row counts."""
    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru

    dt = torch.bfloat16
    for cell, geoms in TC_SWEEP.items():
        _np, ly = _layers(torch, dt, "cuda", cell)
        xs = {rows: torch.from_numpy(np.random.RandomState(SEED + rows).randn(
            L, rows, C).astype(np.float32)).to("cuda", dt) for rows in ROWS}
        refs = {rows: bigru.birnn_stack_plain(ly, x, dt, cell) for rows, x in xs.items()}
        for geometry in geoms:
            plan = dict(bigru.tc_geometry(H, cell, geometry), design="tc")
            errs, equal = {}, {}
            for rows, x in xs.items():
                out, hn = bigru._stack_layers(ly, x, dt, cell, H, plan)
                out2, hn2 = bigru._stack_layers(ly, x, dt, cell, H, plan)
                torch.cuda.synchronize()
                equal[str(rows)] = bool(torch.equal(out, out2) and torch.equal(hn, hn2))
                errs[str(rows)] = max((out.float() - refs[rows][0].float()).abs().max().item(),
                                      (hn - refs[rows][1]).abs().max().item())
                assert errs[str(rows)] <= TOL["bfloat16"] and equal[str(rows)], (
                    cell, geometry, rows, errs, equal)
            rep = _tc_report(torch, cell, plan, ly, xs[ROWS[0]])
            with torch.inference_mode():
                k1_ms = {str(rows): time_ms(
                    lambda: bigru._stack_layers(ly, x, dt, cell, H, plan), torch)
                    for rows, x in xs.items()}
            emit(dict(rep, phase="k1_tc_sweep", cell=cell, max_abs_err=errs,
                      rerun_bit_equal=equal, k1_ms=k1_ms, card=smi))


# The probe of the bf16 recurrence's step: marks put into a copy of
# csrc/birnn_tc.cu (never into the shipped kernel), each adding the clock64
# cycles since the last mark to a per-part sum, for threads 0 and 128 of CTA
# (0, 0). Parts: 0 the wait for the peers' blocks of h, 1 the products
# (with the next step's xg into L2), 2 the barrier and the `empty` arrivals,
# 3 the gate math and the stores, 4 issuing the next step's xg (or bias)
# loads, 5 the new h into shared memory and the barrier, 6 the copies
# (thread 0) and, with a fused projection, x_t's staging.
TC_PROBE_MARKS = [
    ('#include "entry_device.cuh"\n',
     '#include "entry_device.cuh"\n__device__ unsigned long long g_prof[2][8];\n'
     '#define PROF(k) if ((tid == 0 || tid == 128) && blockIdx.x == 0 && blockIdx.y == 0) '
     '{ const unsigned long long now = clock64(); if (s > 0) g_prof[tid >> 7][k] += now - tprev; '
     'tprev = now; }\n'),
    ("  for (int s = 0; s < L; ++s) {\n    const int t = d == 0 ? s : L - 1 - s;\n",
     "  unsigned long long tprev = clock64();\n"
     "  for (int s = 0; s < L; ++s) {\n    const int t = d == 0 ? s : L - 1 - s;\n"),
    ("    if (s > 0) mbar_wait(full_bar, (s - 1) & 1);\n    __syncwarp();\n",
     "    if (s > 0) mbar_wait(full_bar, (s - 1) & 1);\n    __syncwarp();\n    PROF(0)\n"),
    ("    wgmma_wait<0>();\n    fence_regs(acc);\n    fence_regs(xn);\n    if (!last) {",
     "    wgmma_wait<0>();\n    fence_regs(acc);\n    fence_regs(xn);\n    PROF(1)\n    if (!last) {"),
    ("      if (tid < (int)cn && tid != (int)crank) mbar_arrive_remote(empty_bar, tid);\n    }\n",
     "      if (tid < (int)cn && tid != (int)crank) mbar_arrive_remote(empty_bar, tid);\n    }\n"
     "    PROF(2)\n"),
    ("    if (last) break;\n    const int tn = d == 0 ? s + 1 : L - 2 - s;\n    init_acc(tn);",
     "    PROF(3)\n    if (last) break;\n    const int tn = d == 0 ? s + 1 : L - 2 - s;\n"
     "    init_acc(tn);\n    PROF(4)"),
    ("    fence_async_shared();  // visible to the copies and to wgmma\n    __syncthreads();\n",
     "    fence_async_shared();  // visible to the copies and to wgmma\n    __syncthreads();\n"
     "    PROF(5)\n"),
    ("  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
     "  cluster_sync_all();",
     "  if (tid == 0) asm volatile(\"cp.async.bulk.wait_group.read 0;\\n\" ::: \"memory\");\n"
     "  cluster_sync_all();\n  (void)tprev;"),
    ("    if constexpr (FUSED) {\n      stage_x(tn);  // its loads fly while the blocks do\n"
     "      fence_async_shared();\n      __syncthreads();\n    }\n",
     "    if constexpr (FUSED) {\n      stage_x(tn);  // its loads fly while the blocks do\n"
     "      fence_async_shared();\n      __syncthreads();\n    }\n    PROF(6)\n"),
    ("}  // extern \"C\"\n",
     "void tc_probe(unsigned long long* out, int reset) {\n"
     "  unsigned long long z[16] = {0};\n"
     "  if (reset) cudaMemcpyToSymbol(g_prof, z, sizeof(z));\n"
     "  else cudaMemcpyFromSymbol(out, g_prof, sizeof(z));\n}\n}  // extern \"C\"\n"),
]


def phase_k1_tc_probe(torch, smi):
    """The bf16 recurrence's step split into its parts (``TC_PROBE_MARKS``)
    at each candidate geometry of ``TC_SWEEP``, one row tile and 1,024 rows,
    from xg and with layer 0's projection fused: us a step (at the card's
    clock), beside the step's CUDA-event time."""
    import ctypes
    import subprocess as sp

    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import n_gates
    from ccsmeth_tpu_torch.ops import bigru, nvcc

    src = open(os.path.join(nvcc.CSRC, bigru.TC_SRC)).read()
    for old, new in TC_PROBE_MARKS:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    os.makedirs(WORK, exist_ok=True)
    path = os.path.join(WORK, "birnn_tc_probe.cu")
    with open(path, "w") as f:
        f.write(src)
    so = path[:-3] + ".so"
    sp.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-I", nvcc.CSRC, "-o", so, path],
           check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.birnn_tc_rec_launch.restype = i
    lib.birnn_tc_rec_launch.argtypes = [i] + [p] * 8 + [i] * 8 + [p, i]
    lib.tc_probe.argtypes = [p, i]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    shipped, bigru._tc_lib = bigru._tc_lib, lib
    buf = (ctypes.c_ulonglong * 16)()
    dt = torch.bfloat16
    try:
        for cell, geoms in TC_SWEEP.items():
            _np, ly = _layers(torch, dt, "cuda", cell)
            G = n_gates(cell) * H
            for geometry in geoms:
                plan = dict(bigru.tc_geometry(H, cell, geometry), design="tc")
                for rows in (plan["rows"], ROWS[0]):
                    x = torch.from_numpy(np.random.RandomState(SEED + rows).randn(
                        L, rows, C).astype(np.float32)).to("cuda", dt)
                    xg = torch.randn((2, L * rows, G), device="cuda")
                    runs = {"xg": lambda: bigru.tc_recurrence(xg, ly[1][2], ly[1][3], L, rows,
                                                              plan, cell)}
                    fused = _fused_fn(plan, ly[0], cell, x)
                    if fused is not None:
                        runs["fused"] = fused
                    for name, fn in runs.items():
                        fn()
                        torch.cuda.synchronize()
                        lib.tc_probe(None, 1)
                        ms = time_ms(fn, torch)
                        lib.tc_probe(ctypes.cast(buf, p), 0)
                        steps = (REPS + 1) * (L - 1)  # the warm-up and the timed runs
                        parts = [[buf[8 * w + k] / steps / mhz for k in range(7)]
                                 for w in (0, 1)]
                        emit({"phase": "k1_tc_probe", "cell": cell, "geometry": geometry,
                              "rows": rows, "input": name, "step_us": ms * 1e3 / L,
                              "parts_us_thread0": parts[0], "parts_us_thread128": parts[1],
                              "clock_mhz": mhz, "card": smi})
    finally:
        bigru._tc_lib = shipped


def _k2_phases_ms(torch, ly, x, cell, plan):
    """K2's phases on its inputs: the projection and the recurrence, and in
    tc the fused layer where its projection fuses (CUDA-event medians)."""
    Lx, N, _C = x.shape
    proj, rec, _rows = _phase_fns(plan, ly, cell, Lx, layer=True)
    x2 = x.view(Lx * N, -1)
    xg = proj(x2)
    res = {"projection": time_ms(lambda: proj(x2, xg), torch),
           "recurrence": time_ms(lambda: rec(xg, N), torch)}
    fused = _fused_fn(plan, ly, cell, x, layer=True)
    if fused is not None:
        res["fused"] = time_ms(fused, torch)
    return res


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
    """K5's (cell 'gru') or K6's backward ('lstm') CUDA launches a call
    (``bigru_vjp.bwd_cuda_launches``): recurrence, dx, weight gradients, and
    the sum of the row slices (simt: when there is more than one) and of the
    tc bias partials."""
    import torch

    from ccsmeth_tpu_torch.ops import bigru_vjp

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    plan = bigru_vjp.k45_plan(hidden, dt, cell)
    return bigru_vjp.bwd_cuda_launches(plan, seq_len * rows, cin, n_sm)


def _wgrad_split(torch, x, out, dxg, dhg, part, plan, dt):
    """The weight-gradient phase's launches one by one, each a callable:
    the products and the sum of the slices (and of tc's bias partials), as
    ``bigru_vjp.k5_weight_grads`` makes them, on buffers of its sizes."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V

    Lx, N, cin = x.shape
    Hh, G, ng = out.shape[2] // 2, dxg.shape[2], plan["gates"]
    tc, one = plan["design"] == "tc", dhg is dxg
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    S = V.k5_wgrad_slices(Lx * N, cin, Hh, n_sm, ng)
    total = 2 * G * (cin + Hh + 1 + (not one))
    per = 2 * G * (cin + Hh) if tc else total
    grads = torch.empty(total, device="cuda")
    buf = torch.empty(S * per, device="cuda") if S > 1 else grads
    codes = V._codes(plan, dt)
    fns = {"wgrad": lambda: V._launch(
        "k5_wgrad_launch", plan, x, *codes, x.data_ptr(), out.data_ptr(), dxg.data_ptr(),
        dhg.data_ptr(), buf.data_ptr(), Lx, N, cin, Hh, ng, S)}
    if tc:
        fns["sum"] = lambda: V._launch(
            "k5_sum_launch", plan, x, buf.data_ptr(), grads.data_ptr(), per, S,
            part.data_ptr(), grads[per:].data_ptr(), total - per, part.shape[0])
    elif S > 1:
        fns["sum"] = lambda: V._launch("k5_sum_launch", plan, x, buf.data_ptr(),
                                       grads.data_ptr(), total, S, None, None, 0, 0)
    return fns


def _train_phases_ms(torch, x, wih, bih, whh, bhh, dout, dt, cell, clusters):
    """Device time of each phase of the training kernels on one layer's
    inputs: the forward's projection and recurrence, the backward's
    recurrence (which also stores the gate gradients for the products: f32,
    or bf16 with the bias partials in tc), dx and weight gradients (with the
    sums), the weight gradients' launches one by one (``_wgrad_split``); and
    each recurrence on one row tile a direction (one cluster each), its
    serial chain alone, against which the full recurrence's time counts the
    waves of clusters, and on one full wave (half the clusters the card
    holds at once, ``clusters`` = {"fwd": n, "bwd": n} from
    ``bigru_vjp.fwd_rec_occupancy`` / ``bwd_rec_occupancy``, in tiles a
    direction); medians of CUDA-event timings. The backward's
    products' kernel, TFLOP/s beside torch.mm's on the same products in
    the same operand type with both TF32 switches off (a yardstick only),
    tiles and waves. Returns (forward phases, backward
    phases, products), named k4_* / k5_* (cell 'gru') or k6_* ('lstm')."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    Lx, N, cin = x.shape
    Hh = whh.shape[1]
    plan = V.k45_plan(Hh, dt, cell)
    # the forward's tile at these rows (``fwd_rows``), the backward's; the
    # forward's one tile and one wave run at that tile (a plan pinned to it)
    r4, r5 = V.fwd_rows(plan, N), plan["rows_bwd"]
    pin4 = dict(plan, tiles_fwd=(r4,))
    # one full wave of each recurrence: as many row tiles a direction as
    # half the clusters the card holds at once
    rw = r5 * max(1, clusters["bwd"] // 2)
    rw4 = r4 * max(1, clusters["fwd"] // 2)
    xg = V.k4_projection(x, wih, bih, bhh, plan, dt)
    xg4 = torch.randn((2, Lx * r4, xg.shape[2]), device="cuda")
    xgw4 = torch.randn((2, Lx * rw4, xg.shape[2]), device="cuda")
    xg5 = torch.randn((2, Lx * r5, xg.shape[2]), device="cuda")
    dout5 = torch.randn((Lx, r5, dout.shape[2]), device="cuda").to(dt)
    xgw = torch.randn((2, Lx * rw, xg.shape[2]), device="cuda")
    doutw = torch.randn((Lx, rw, dout.shape[2]), device="cuda").to(dt)
    if cell == "gru":
        k = "k5"
        out, gates = V.k4_recurrence(xg, whh, bhh, Lx, N, plan, dt)
        dxg, dhg, part = V.k5_recurrence(dout, out, gates, whh, plan, dt)
        out5, gates5 = V.k4_recurrence(xg5, whh, bhh, Lx, r5, plan, dt)
        outw, gatesw = V.k4_recurrence(xgw, whh, bhh, Lx, rw, plan, dt)
        fwd = {"k4_projection": lambda: V.k4_projection(x, wih, bih, bhh, plan, dt),
               "k4_recurrence_one_tile": lambda: V.k4_recurrence(xg4, whh, bhh, Lx, r4,
                                                                 pin4, dt),
               "k4_recurrence_one_wave": lambda: V.k4_recurrence(xgw4, whh, bhh, Lx, rw4,
                                                                 pin4, dt),
               "k4_recurrence": lambda: V.k4_recurrence(xg, whh, bhh, Lx, N, plan, dt)}
        bwd = {"k5_recurrence_one_tile": lambda: V.k5_recurrence(dout5, out5, gates5, whh,
                                                                 plan, dt),
               "k5_recurrence_one_wave": lambda: V.k5_recurrence(doutw, outw, gatesw, whh,
                                                                 plan, dt),
               "k5_recurrence": lambda: V.k5_recurrence(dout, out, gates, whh, plan, dt)}
    else:
        k = "k6"
        out, c, gates = V6.k6_recurrence(xg, whh, Lx, N, plan, dt)
        dxg, part = V6.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
        dhg = dxg
        _o5, c5, gates5 = V6.k6_recurrence(xg5, whh, Lx, r5, plan, dt)
        _ow, cw, gatesw = V6.k6_recurrence(xgw, whh, Lx, rw, plan, dt)
        fwd = {"k6_projection": lambda: V.k4_projection(x, wih, bih, bhh, plan, dt),
               "k6_recurrence_one_tile": lambda: V6.k6_recurrence(xg4, whh, Lx, r4, pin4,
                                                                  dt),
               "k6_recurrence_one_wave": lambda: V6.k6_recurrence(xgw4, whh, Lx, rw4, pin4,
                                                                  dt),
               "k6_recurrence": lambda: V6.k6_recurrence(xg, whh, Lx, N, plan, dt)}
        bwd = {"k6_bwd_recurrence_one_tile": lambda: V6.k6_bwd_recurrence(
                   dout5, c5, gates5, whh, plan, dt),
               "k6_bwd_recurrence_one_wave": lambda: V6.k6_bwd_recurrence(
                   doutw, cw, gatesw, whh, plan, dt),
               "k6_bwd_recurrence": lambda: V6.k6_bwd_recurrence(dout, c, gates, whh,
                                                                 plan, dt)}
    bwd[k + "_dx"] = lambda: V.k5_dx(dxg, wih, plan, dt)
    bwd[k + "_weight_grads"] = lambda: V.k5_weight_grads(x, out, dxg, dhg, plan, dt, part)
    for name, fn in _wgrad_split(torch, x, out, dxg, dhg, part, plan, dt).items():
        bwd["{}_{}".format(k, name)] = fn
    fwd_ms = {n: time_ms(f, torch) for n, f in fwd.items()}
    bwd_ms = {n: time_ms(f, torch) for n, f in bwd.items()}
    # the products' rates, and torch.mm's on the same operands
    LN, G = Lx * N, dxg.shape[2]
    h_prev = out.reshape(LN, 2 * Hh)
    a_dx = torch.cat([dxg[0], dxg[1]], dim=1).to(dt)
    b_dx = torch.cat([wih[0].t(), wih[1].t()], dim=0).contiguous()
    xs = x.reshape(LN, cin)
    g_ih = [dxg[d].to(dt) for d in (0, 1)]
    g_hh = [dhg[d].to(dt) for d in (0, 1)]
    mm_dx = time_ms(lambda: torch.mm(a_dx, b_dx), torch)
    mm_wgrad = time_ms(lambda: [torch.mm(xs.t(), g_ih[d]) for d in (0, 1)]
                       + [torch.mm(h_prev[:, d * Hh:(d + 1) * Hh].t(), g_hh[d])
                          for d in (0, 1)], torch)
    flops_dx = 2 * LN * cin * 2 * G
    flops_wgrad = 2 * LN * 2 * G * (cin + Hh)
    wgrad_ms = bwd_ms[k + "_wgrad"]
    # each product's tiles in waves of two CTAs an SM (every product
    # kernel's residency): dx's tile by C (16 .. 128 columns; the bf16 simt
    # kernel always 128) and, in f32_tma_kernel, 128 or 112 rows by the
    # waves (``simt_dx_tile``), the weight gradients' 128 x 128 tiles of
    # every slice
    kernel = ("wgemm_kernel" if plan["design"] == "tc" else
              F32_KERNEL if dt == torch.float32 else "gemm_simt_kernel")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    bm, bn = (V.simt_dx_tile(LN, cin, n_sm) if kernel == F32_KERNEL else
              (128, 128 if kernel == "gemm_simt_kernel" else
               next(b for b in (16, 32, 64, 128) if cin <= b or b == 128)))
    S = V.k5_wgrad_slices(LN, cin, Hh, n_sm, plan["gates"])
    dx_tiles = -(-cin // bn) * -(-LN // bm)
    wg_tiles = S * 2 * -(-G // 128) * (-(-cin // 128) + -(-Hh // 128))
    slots = V.WGRAD_CTAS_PER_SM * n_sm
    products = {"kernel": kernel,
                "dx_tflops": flops_dx / bwd_ms[k + "_dx"] / 1e9,
                "dx_torch_mm_tflops": flops_dx / mm_dx / 1e9,
                "dx_tile": [bm, bn], "dx_tiles": dx_tiles, "dx_waves": dx_tiles / slots,
                "wgrad_tflops": flops_wgrad / wgrad_ms / 1e9,
                "wgrad_torch_mm_tflops": flops_wgrad / mm_wgrad / 1e9,
                "wgrad_slices": S, "wgrad_tiles": wg_tiles, "wgrad_waves": wg_tiles / slots,
                "torch_mm_dtype": str(dt).split(".")[-1],
                "tf32": [torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32]}
    return fwd_ms, bwd_ms, products


# The simt backward recurrence's candidate rows a thread at H = 256
# (K56_RT256; R = 8 RT rows a tile: 56, 64 and 72, the tiles whose LSTM CTA
# fits in shared memory): builds of csrc/bigru_train.cu and
# csrc/bilstm_train.cu with -DK56_RT256=n in WORK, timed in alternating rounds
K56_SWEEP_RT = (7, 8, 9)
K56_SWEEP_ROUNDS = 6


def _build_k56(src, defines=(), path=None, tag=""):
    """A build of csrc/<src> (or of the copy at ``path``) with ``defines`` into
    WORK; returns (library, nvcc's -Xptxas -v report)."""
    import subprocess as sp

    from ccsmeth_tpu_torch.ops import nvcc

    os.makedirs(WORK, exist_ok=True)
    path = path or os.path.join(nvcc.CSRC, src)
    so = os.path.join(WORK, src[:-3] + tag + "".join("_" + d.replace("=", "")
                                                      for d in defines) + ".so")
    proc = sp.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + ["-D" + d for d in defines]
                  + ["-I", nvcc.CSRC, "-o", so, path], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return so, proc.stdout + proc.stderr


class _K56Libs:
    """Within the block, K4/K5's and K6's wrappers run the given builds."""

    def __init__(self, gru_lib, lstm_lib):
        self.libs = (gru_lib, lstm_lib)

    def __enter__(self):
        from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

        # the package's own builds load first, reading ``fwd_clusters``
        self.saved = (bigru_vjp._load(), bilstm_vjp._load())
        bigru_vjp._lib, bilstm_vjp._lib = self.libs

    def __exit__(self, *exc):
        from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

        bigru_vjp._lib, bilstm_vjp._lib = self.saved


def _k56_plan(cell):
    """The fp32 plan of the bound build's simt backward at H (the package's
    plan with the build's rows a tile and shared memory, as
    ``bigru_vjp.bwd_rec_occupancy`` reads them) and its resident clusters."""
    import torch

    from ccsmeth_tpu_torch.ops import bigru_vjp

    plan = bigru_vjp.k45_plan(H, torch.float32, cell)
    occ = bigru_vjp.bwd_rec_occupancy(plan, torch.float32)
    return dict(plan, rows_bwd=occ["rows"], smem_bwd=occ["smem"]), occ["clusters"]


def _k56_bwd(cell, plan, dout, x, wih, whh, *rest):
    """K5's or K6's fp32 backward at ``plan``, launch for launch as
    ``bigru_layer_bwd`` / ``bilstm_layer_bwd`` make it: (dx, dw_ih, db_ih,
    dw_hh, db_hh)."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    dt = rest[-1]
    if cell == "gru":
        out, gates = rest[:2]
        dxg, dhg, part = V.k5_recurrence(dout, out, gates, whh, plan, dt)
    else:
        out, c, gates = rest[:3]
        dxg, part = V6.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
        dhg = dxg
    dx = V.k5_dx(dxg, wih, plan, dt)
    grads = V.k5_weight_grads(x, out, dxg, dhg, plan, dt, part)
    return (dx.view(x.shape[0], x.shape[1], -1),) + tuple(grads)


def _k56_inputs(torch, cell, cin, rows=ROWS[0]):
    """One layer's fp32 backward arguments (dout, x, the weights, the plain
    forward's residuals, the dtype) at the train-kernel phase's seeds."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    rng = np.random.RandomState(SEED + cin)
    ld = init_rnn_params(rng, cin, H, 1, cell)[0]
    x = torch.from_numpy(rng.randn(L, rows, cin).astype(np.float32)).cuda()
    dout = torch.from_numpy(rng.randn(L, rows, 2 * H).astype(np.float32)).cuda()
    wih, bih, whh, bhh = layer_weights(ld, torch.float32, "cuda")
    fwd = (bigru_vjp.bigru_layer_train_fwd_plain if cell == "gru"
           else bilstm_vjp.bilstm_layer_train_fwd_plain)
    res = fwd(x, wih, bih, whh, bhh, torch.float32)
    return (dout, x, wih, whh) + tuple(res) + (torch.float32,)


def phase_k56_bwd_simt_sweep(torch, smi):
    """K5's and K6's fp32 backward at each candidate geometry of the simt
    recurrence (``K56_SWEEP_RT``: R = 8 RT rows a tile at H = 256, in two
    row halves), 1,024 rows, C = 11 and 512:
    each build's gradients bit-equal to the other builds' (the bits do not
    depend on the tile) and its rerun's, against the plain version; its
    resident clusters and waves; then ``K56_SWEEP_ROUNDS`` rounds, the
    builds in turn (forward, then reverse order), each timing the whole
    backward at both widths and the recurrence on one tile, one full wave
    and 1,024 rows; cuDNN's backward beside them."""
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    jobs = [(src, rt) for rt in K56_SWEEP_RT for src in (bigru_vjp.SRC, bilstm_vjp.SRC)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build_k56(j[0], ["K56_RT256={}".format(j[1])])[0],
                              jobs))
    libs = {rt: (bigru_vjp.bind(built[2 * i]), bilstm_vjp.bind(built[2 * i + 1]))
            for i, rt in enumerate(K56_SWEEP_RT)}
    for cell in MODELS:
        bwd_plain = (bigru_vjp.bigru_layer_bwd_plain if cell == "gru"
                     else bilstm_vjp.bilstm_layer_bwd_plain)
        inputs = {cin: _k56_inputs(torch, cell, cin) for cin in (C, 2 * H)}
        refs = {cin: bwd_plain(*args) for cin, args in inputs.items()}
        variants, first = [], {}
        for rt in K56_SWEEP_RT:
            with _K56Libs(*libs[rt]):
                plan, clusters = _k56_plan(cell)
                R = plan["rows_bwd"]
                assert R == 8 * rt, (cell, rt, R)
                errs = {}
                for cin, args in inputs.items():
                    got, again = _k56_bwd(cell, plan, *args), _k56_bwd(cell, plan, *args)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for a, b in zip(got, again)), (cell, rt, cin)
                    if cin in first:
                        assert all(torch.equal(a, b) for a, b in zip(got, first[cin])), \
                            (cell, rt, cin, "bits differ from the first build's")
                    first.setdefault(cin, got)
                    # the train-kernel phase's tolerances: dx 1e-5, the
                    # sums over L N rows 1e-5 * max|ref| + 1e-5
                    errs[cin] = {}
                    for nm, a, r in zip(("dx", "dw_ih", "db_ih", "dw_hh", "db_hh"), got,
                                        refs[cin]):
                        errs[cin][nm] = (a - r).abs().max().item()
                        tol = 1e-5 if nm == "dx" else 1e-5 * r.abs().max().item() + 1e-5
                        assert errs[cin][nm] <= tol, (cell, rt, cin, nm, errs[cin][nm], tol)
            fns = _k56_recurrence_fns(torch, cell, plan, clusters)
            for cin, args in inputs.items():
                fns["bwd C={}".format(cin)] = lambda args=args, plan=plan: _k56_bwd(
                    cell, plan, *args)
            variants.append(({"RT": rt, "R": R, "smem": plan["smem_bwd"],
                              "resident_clusters": clusters,
                              "waves_1024": bigru_vjp.rec_waves(R, ROWS[0], clusters),
                              "max_abs_err": errs, "bit_equal": True,
                              "ms_by_round": {k: [] for k in fns}}, fns))
        lib_ms = {cin: [] for cin in inputs}
        cudnn = {}
        for cin, args in inputs.items():
            cudnn[cin] = _cudnn_bwd_fn(torch, cell, cin)
        for r in range(K56_SWEEP_ROUNDS):
            for (res, fns), rt in (zip(variants, K56_SWEEP_RT) if r % 2 == 0 else
                                   zip(variants[::-1], K56_SWEEP_RT[::-1])):
                with _K56Libs(*libs[rt]):
                    for k, fn in fns.items():
                        res["ms_by_round"][k].append(time_ms(fn, torch))
            for cin in inputs:
                lib_ms[cin].append(time_ms(cudnn[cin], torch))
        for res, _fns in variants:
            res["median_ms"] = {k: statistics.median(v) for k, v in res["ms_by_round"].items()}
        emit({"phase": "k56_bwd_simt_sweep", "cell": cell, "rows": ROWS[0],
              "rounds": K56_SWEEP_ROUNDS,
              "shipped_R": bigru_vjp.k45_plan(H, torch.float32, cell)["rows_bwd"],
              "variants": [res for res, _fns in variants],
              "cudnn_bwd_ms": {cin: statistics.median(v) for cin, v in lib_ms.items()},
              "card": smi})


def _k56_recurrence_fns(torch, cell, plan, clusters):
    """The simt backward recurrence of ``plan`` alone (H = 256, fp32, seeded
    residuals), on one row tile, one full wave (half the resident clusters'
    tiles a direction) and 1,024 rows: callables by name."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    R = plan["rows_bwd"]
    G = V.GATES[cell] * H
    fns = {}
    for name, rows in (("rec one tile", R), ("rec one wave", R * max(1, clusters // 2)),
                       ("rec 1024", ROWS[0])):
        g = torch.Generator(device="cuda").manual_seed(SEED + rows)
        dout = torch.randn((L, rows, 2 * H), device="cuda", generator=g)
        gates = torch.rand((2, L, rows, 4 * H), device="cuda", generator=g)
        if cell == "gru":
            out = torch.randn((L, rows, 2 * H), device="cuda", generator=g)
            whh = torch.randn((2, H, G), device="cuda", generator=g) * 0.05
            fns[name] = (lambda dout=dout, out=out, gates=gates, whh=whh:
                         V.k5_recurrence(dout, out, gates, whh, plan, torch.float32))
        else:
            c = torch.randn((2, L, rows, H), device="cuda", generator=g)
            whh = torch.randn((2, H, G), device="cuda", generator=g) * 0.05
            fns[name] = (lambda dout=dout, c=c, gates=gates, whh=whh:
                         V6.k6_bwd_recurrence(dout, c, gates, whh, plan, torch.float32))
    return fns


def _cudnn_bwd_fn(torch, cell, cin):
    """cuDNN's one-layer bidirectional nn.GRU / nn.LSTM backward (fp32, TF32
    off) at the train-kernel phase's weights and shapes: a callable, the
    yardstick of ``phase_train_kernels``."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params

    rng = np.random.RandomState(SEED + cin)
    ld = init_rnn_params(rng, cin, H, 1, cell)[0]
    x_np = rng.randn(L, ROWS[0], cin).astype(np.float32)
    dout = torch.from_numpy(rng.randn(L, ROWS[0], 2 * H).astype(np.float32)).cuda()
    lib = _cudnn(torch, cell, cin, 1, [ld], torch.float32)
    lib.train()
    xg = torch.from_numpy(x_np).cuda().requires_grad_(True)
    y = lib(xg)[0]
    return lambda: torch.autograd.grad(y, [xg] + list(lib.parameters()), dout,
                                       retain_graph=True)


# The probe of the simt backward recurrence's step: marks put into a copy of
# csrc/rnn_train_rec.cuh (never into the shipped header), each adding the
# clock64 cycles since the last mark to a per-part sum, for threads 0 and 128
# of CTA (0, 0), both row halves of a step added. Parts: 0 the wait on a
# half's `full` barrier for the peers' partials (thread 0) and the barrier
# after it, 1 the residuals still in flight (a sum that reads every
# prefetched register of the half), 2 the gate math and its stores, 3 the
# operand's stores, the barrier and the `empty` arrivals, 4 the product
# (with the next gate math's residual loads issued in it), 5 the wait on
# `empty` (thread 0) and the barrier after it, 6 issuing the partials'
# stores (st.async into the peers).
K56_PROBE_PARTS = ["full wait", "residuals", "gate math", "operand", "product",
                   "empty wait", "send"]
K56_PROBE_MARKS = [
    ('#include "rnn_train_gemm.cuh"\n',
     '#include "rnn_train_gemm.cuh"\n__device__ unsigned long long g_k56_prof[2][8];\n'
     '#define K56_PROF(k) if ((tid == 0 || tid == 128) && blockIdx.x == 0 && '
     'blockIdx.y == 0) { const unsigned long long now = clock64(); if (s > 0) '
     'g_k56_prof[tid >> 7][k] += now - tprev; tprev = now; }\n'),
    ("  for (int s = 0; s < L; ++s) {\n    // direction-local time runs backwards: L-1 .. 0\n"
     "    const int t = d == 0 ? L - 1 - s : s;\n#pragma unroll\n"
     "    for (int h = 0; h < NH; ++h) {\n",
     "  unsigned long long tprev = clock64();\n"
     "  for (int s = 0; s < L; ++s) {\n    // direction-local time runs backwards: L-1 .. 0\n"
     "    const int t = d == 0 ? L - 1 - s : s;\n#pragma unroll\n"
     "    for (int h = 0; h < NH; ++h) {\n"),
    ("          if (s + 1 < L) mbar_expect_tx(full_bar[h], (CN - 1) * rh * U * 4);\n"
     "        }\n        __syncthreads();\n      }\n",
     "          if (s + 1 < L) mbar_expect_tx(full_bar[h], (CN - 1) * rh * U * 4);\n"
     "        }\n        __syncthreads();\n      }\n      K56_PROF(0)\n"
     "      { float sink = 0.0f;\n#pragma unroll\n        for (int j = 0; j < QM; ++j)\n"
     "#pragma unroll\n          for (int e = 0; e < NV; ++e) sink += v[j][e].x + v[j][e].w;\n"
     "        asm volatile(\"\" ::\"f\"(sink)); }\n      K56_PROF(1)\n"),
    ("      if (s + 1 == L) {  // dh of the direction's first step is not needed\n",
     "      K56_PROF(2)\n"
     "      if (s + 1 == L) {  // dh of the direction's first step is not needed\n"),
    ("mbar_arrive_remote(empty_bar[h], tid);\n\n      // 3) the half's partial dh",
     "mbar_arrive_remote(empty_bar[h], tid);\n      K56_PROF(3)\n\n"
     "      // 3) the half's partial dh"),
    ("      // 4) every peer has read the half's last partials",
     "      K56_PROF(4)\n      // 4) every peer has read the half's last partials"),
    ("        if (tid == 0) mbar_wait(empty_bar[h], (s - 1) & 1);\n        __syncthreads();\n"
     "      }\n",
     "        if (tid == 0) mbar_wait(empty_bar[h], (s - 1) & 1);\n        __syncthreads();\n"
     "      }\n      K56_PROF(5)\n"),
    ("            st_async_v4(la, full_bar[h], own, val);\n        }\n      }\n    }\n  }\n",
     "            st_async_v4(la, full_bar[h], own, val);\n        }\n      }\n"
     "      K56_PROF(6)\n    }\n  }\n"),
]
K56_PROBE_ENTRY = """
extern "C" void k56_probe(unsigned long long* out, int reset) {
  unsigned long long z[16] = {0};
  if (reset) cudaMemcpyToSymbol(g_k56_prof, z, sizeof(z));
  else cudaMemcpyFromSymbol(out, g_k56_prof, sizeof(z));
}
"""


def phase_k56_bwd_simt_probe(torch, smi):
    """The simt backward recurrence's step split into its parts
    (``K56_PROBE_MARKS``), both cells, fp32, H = 256, on one row tile and on
    1,024 rows: us a step (at the card's clock) for threads 0 and 128 of
    CTA (0, 0), beside the step's CUDA-event time."""
    import ctypes
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp, nvcc

    d = os.path.join(WORK, "k56_probe")
    os.makedirs(d, exist_ok=True)
    hdr = open(os.path.join(nvcc.CSRC, "rnn_train_rec.cuh")).read()
    for old, new in K56_PROBE_MARKS:
        assert hdr.count(old) == 1, old
        hdr = hdr.replace(old, new)
    with open(os.path.join(d, "rnn_train_rec.cuh"), "w") as f:
        f.write(hdr)
    paths = []
    for src in (bigru_vjp.SRC, bilstm_vjp.SRC):
        shutil.copy(os.path.join(nvcc.CSRC, src), os.path.join(d, src))
        with open(os.path.join(d, src), "a") as f:
            f.write(K56_PROBE_ENTRY)
        paths.append(os.path.join(d, src))
    with ThreadPoolExecutor(2) as pool:
        sos = list(pool.map(lambda pth: _build_k56(os.path.basename(pth), path=pth,
                                                   tag="_probe")[0], paths))
    gru, lstm = bigru_vjp.bind(sos[0]), bilstm_vjp.bind(sos[1])
    for lib in (gru, lstm):
        lib.k56_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    buf = (ctypes.c_ulonglong * 16)()
    with _K56Libs(gru, lstm):
        for cell, lib in (("gru", gru), ("lstm", lstm)):
            plan, clusters = _k56_plan(cell)
            fns = _k56_recurrence_fns(torch, cell, plan, clusters)
            for name in ("rec one tile", "rec 1024"):
                fn = fns[name]
                fn()
                torch.cuda.synchronize()
                lib.k56_probe(None, 1)
                ms = time_ms(fn, torch)
                lib.k56_probe(ctypes.cast(buf, ctypes.c_void_p), 0)
                steps = (REPS + 1) * (L - 1)  # the warm-up and the timed runs
                parts = [[buf[8 * w + k] / steps / mhz for k in range(len(K56_PROBE_PARTS))]
                         for w in (0, 1)]
                emit({"phase": "k56_bwd_simt_probe", "cell": cell, "input": name,
                      "rows_a_tile": plan["rows_bwd"], "step_us": ms * 1e3 / L,
                      "parts": K56_PROBE_PARTS,
                      "parts_us_thread0": parts[0], "parts_us_thread128": parts[1],
                      "clock_mhz": mhz, "card": smi})


# The simt forward recurrence's candidate tiles at H = 256: rows a thread
# (K46_FWD_RT256; R = 8 RT rows a tile: 72, 64 and 80, each a CTA that
# fits in shared memory): builds of csrc/bigru_train.cu and
# csrc/bilstm_train.cu with -DK46_FWD_RT256=n in WORK, timed in
# alternating rounds
K46_SWEEP = (9, 8, 10)
K46_SWEEP_ROUNDS = 6


def _k46_plan(cell):
    """The fp32 plan of the bound build's simt forward at H, pinned to the
    build's default tile (the package's plan with the build's rows a tile
    and shared memory, as ``bigru_vjp.fwd_rec_occupancy`` reads them, and
    no other tile), and its resident clusters."""
    import torch

    from ccsmeth_tpu_torch.ops import bigru_vjp

    plan = bigru_vjp.k45_plan(H, torch.float32, cell)
    occ = bigru_vjp.fwd_rec_occupancy(plan, torch.float32)
    return dict(plan, rows_fwd=occ["rows"], tiles_fwd=(occ["rows"],),
                smem_fwd=occ["smem"]), occ["clusters"]


def _k46_fwd(cell, plan, x, wih, bih, whh, bhh):
    """K4's or K6's fp32 forward at ``plan``'s tile, launch for launch as
    ``bigru_layer_train_fwd`` / ``bilstm_layer_train_fwd`` make it: (out,
    gates) or (out, c, gates)."""
    import torch

    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    f32 = torch.float32
    xg = V.k4_projection(x, wih, bih, bhh, plan, f32)
    if cell == "gru":
        return V.k4_recurrence(xg, whh, bhh, x.shape[0], x.shape[1], plan, f32)
    return V6.k6_recurrence(xg, whh, x.shape[0], x.shape[1], plan, f32)


def _k46_inputs(torch, cell, cin, rows=ROWS[0]):
    """One layer's fp32 forward arguments (x and the weights) at the
    train-kernel phase's seeds."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights

    rng = np.random.RandomState(SEED + cin)
    ld = init_rnn_params(rng, cin, H, 1, cell)[0]
    x = torch.from_numpy(rng.randn(L, rows, cin).astype(np.float32)).cuda()
    return (x,) + tuple(layer_weights(ld, torch.float32, "cuda"))


def _k46_recurrence_fns(torch, cell, plan, clusters):
    """The simt forward recurrence of ``plan`` alone (H = 256, fp32, a
    seeded projection and W_hh), on one row tile, one full wave (half the
    resident clusters' tiles a direction) and 1,024 rows: callables by
    name."""
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    R = plan["rows_fwd"]
    G = V.GATES[cell] * H
    fns = {}
    for name, rows in (("rec one tile", R), ("rec one wave", R * max(1, clusters // 2)),
                       ("rec 1024", ROWS[0])):
        g = torch.Generator(device="cuda").manual_seed(SEED + rows)
        xg = torch.randn((2, L * rows, G), device="cuda", generator=g)
        whh = torch.randn((2, H, G), device="cuda", generator=g) * 0.05
        bhh = torch.randn((2, G), device="cuda", generator=g)
        if cell == "gru":
            fns[name] = (lambda xg=xg, whh=whh, bhh=bhh, rows=rows:
                         V.k4_recurrence(xg, whh, bhh, L, rows, plan, torch.float32))
        else:
            fns[name] = (lambda xg=xg, whh=whh, rows=rows:
                         V6.k6_recurrence(xg, whh, L, rows, plan, torch.float32))
    return fns


def _cudnn_fwd_fn(torch, cell, cin):
    """cuDNN's one-layer bidirectional nn.GRU / nn.LSTM forward in train
    mode (fp32, TF32 off) at the train-kernel phase's weights and shapes: a
    callable, the yardstick of ``phase_train_kernels``."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params

    rng = np.random.RandomState(SEED + cin)
    ld = init_rnn_params(rng, cin, H, 1, cell)[0]
    x = torch.from_numpy(rng.randn(L, ROWS[0], cin).astype(np.float32)).cuda()
    lib = _cudnn(torch, cell, cin, 1, [ld], torch.float32)
    lib.train()
    xg = x.requires_grad_(True)
    return lambda: lib(xg)


def phase_k46_fwd_simt_sweep(torch, smi):
    """K4's and K6's fp32 forward at each candidate tile of the simt
    forward recurrence (``K46_SWEEP``: R = 8 RT rows at H = 256), 1,024
    rows, C = 11 and 512: each build's outputs and residuals bit-equal to the other builds' (the bits do not depend on the
    tile) and its rerun's, against the plain version (1e-5); its resident
    clusters and waves; then ``K46_SWEEP_ROUNDS`` rounds, the builds in turn
    (forward, then reverse order), each timing the whole forward at both
    widths and the recurrence on one tile, one full wave and 1,024 rows;
    cuDNN's forward beside them."""
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    jobs = [(src, v) for v in K46_SWEEP for src in (bigru_vjp.SRC, bilstm_vjp.SRC)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda j: _build_k56(j[0], ["K46_FWD_RT256={}".format(j[1])])[0],
                              jobs))
    libs = {v: (bigru_vjp.bind(built[2 * i]), bilstm_vjp.bind(built[2 * i + 1]))
            for i, v in enumerate(K46_SWEEP)}
    for cell in MODELS:
        fwd_plain = (bigru_vjp.bigru_layer_train_fwd_plain if cell == "gru"
                     else bilstm_vjp.bilstm_layer_train_fwd_plain)
        inputs = {cin: _k46_inputs(torch, cell, cin) for cin in (C, 2 * H)}
        refs = {cin: fwd_plain(*args, torch.float32) for cin, args in inputs.items()}
        variants, first = [], {}
        for rt in K46_SWEEP:
            with _K56Libs(*libs[rt]):
                plan, clusters = _k46_plan(cell)
                R = plan["rows_fwd"]
                assert R == 8 * rt, (cell, rt, R)
                errs = {}
                for cin, args in inputs.items():
                    got, again = _k46_fwd(cell, plan, *args), _k46_fwd(cell, plan, *args)
                    torch.cuda.synchronize()
                    assert all(torch.equal(a, b) for a, b in zip(got, again)), (cell, rt, cin)
                    if cin in first:
                        assert all(torch.equal(a, b) for a, b in zip(got, first[cin])), \
                            (cell, rt, cin, "bits differ from the first build's")
                    first.setdefault(cin, got)
                    errs[cin] = max((a - r).abs().max().item() for a, r in zip(got, refs[cin]))
                    assert errs[cin] <= 1e-5, (cell, rt, cin, errs[cin])
            fns = _k46_recurrence_fns(torch, cell, plan, clusters)
            for cin, args in inputs.items():
                fns["fwd C={}".format(cin)] = lambda args=args, plan=plan: _k46_fwd(
                    cell, plan, *args)
            variants.append(({"RT": rt, "R": R, "smem": plan["smem_fwd"],
                              "resident_clusters": clusters,
                              "waves_1024": bigru_vjp.rec_waves(R, ROWS[0], clusters),
                              "max_abs_err": errs, "bit_equal": True,
                              "ms_by_round": {k: [] for k in fns}}, fns))
        cudnn = {cin: _cudnn_fwd_fn(torch, cell, cin) for cin in inputs}
        lib_ms = {cin: [] for cin in inputs}
        for r in range(K46_SWEEP_ROUNDS):
            for (res, fns), v in (zip(variants, K46_SWEEP) if r % 2 == 0 else
                                  zip(variants[::-1], K46_SWEEP[::-1])):
                with _K56Libs(*libs[v]):
                    for k, fn in fns.items():
                        res["ms_by_round"][k].append(time_ms(fn, torch))
            for cin in inputs:
                lib_ms[cin].append(time_ms(cudnn[cin], torch))
        for res, _fns in variants:
            res["median_ms"] = {k: statistics.median(v) for k, v in res["ms_by_round"].items()}
        emit({"phase": "k46_fwd_simt_sweep", "cell": cell, "rows": ROWS[0],
              "rounds": K46_SWEEP_ROUNDS,
              "shipped_R": bigru_vjp.k45_plan(H, torch.float32, cell)["rows_fwd"],
              "variants": [res for res, _fns in variants],
              "cudnn_fwd_ms": {cin: statistics.median(v) for cin, v in lib_ms.items()},
              "card": smi})


# The probe of the simt forward recurrence's step: marks put into a copy of
# csrc/rnn_train_rec.cuh (never into the shipped header), each adding the
# clock64 cycles since the last mark to a per-part sum, for the first
# threads of the two warp groups (threads 0 and 128) of CTA (0, 0). Parts:
# 0 the wait on the group's `full` barrier for the peers' blocks, 1 the
# wait for the group's turn at the product, 2 the product, 3 the group
# barrier after it and the `empty` arrivals, 4 the projection loads still
# in flight (a sum that reads every prefetched register), 5 the gate math
# and its stores, 6 issuing the next projection's loads and writing the new
# h into the CTA's block, 7 the group barrier after it, the wait on `empty`
# and the bulk copies (the first thread).
K46_PROBE_PARTS = ["full wait", "turn wait", "product", "read barrier", "projection loads",
                   "gate math", "next loads and h block", "block barrier, empty wait, copies"]
K46_PROBE_MARKS = [
    ('#include "rnn_train_gemm.cuh"\n',
     '#include "rnn_train_gemm.cuh"\n__device__ unsigned long long g_k46_prof[2][8];\n'
     '#define K46_PROF(k) if ((tid == 0 || tid == 128) && blockIdx.x == 0 && '
     'blockIdx.y == 0) { const unsigned long long now = clock64(); if (s > 0) '
     'g_k46_prof[tid >> 7][k] += now - tprev; tprev = now; }\n'),
    ("  for (int s = 0; s < L; ++s) {\n    const int t = d == 0 ? s : L - 1 - s;\n"
     "    const bool more = s + 1 < L;  // a next step reads the new h\n",
     "  unsigned long long tprev = clock64();\n"
     "  for (int s = 0; s < L; ++s) {\n    const int t = d == 0 ? s : L - 1 - s;\n"
     "    const bool more = s + 1 < L;  // a next step reads the new h\n"),
    ("    if (CN > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);\n",
     "    if (CN > 1 && s > 0) mbar_wait(full_bar, (s - 1) & 1);\n    K46_PROF(0)\n"),
    ("    if (g == 1 || s > 0) named_sync(3 + g, REC_THREADS);\n",
     "    if (g == 1 || s > 0) named_sync(3 + g, REC_THREADS);\n    K46_PROF(1)\n"),
    ("acc[i][gate] = fmaf(hv[i], w[gate], acc[i][gate]);\n    }\n",
     "acc[i][gate] = fmaf(hv[i], w[gate], acc[i][gate]);\n    }\n    K46_PROF(2)\n"),
    ("mbar_arrive_remote(empty_bar, gtid);\n    // 4) the gate math",
     "mbar_arrive_remote(empty_bar, gtid);\n    K46_PROF(3)\n"
     "    { float sink = 0.0f;\n#pragma unroll\n      for (int i = 0; i < RT; ++i)\n"
     "#pragma unroll\n        for (int gate = 0; gate < NG; ++gate) sink += xc[i][gate];\n"
     "      asm volatile(\"\" ::\"f\"(sink)); }\n    K46_PROF(4)\n"
     "    // 4) the gate math"),
    ("    if (!more) break;\n", "    K46_PROF(5)\n    if (!more) break;\n"),
    ("    if constexpr (CN > 1) fence_async_shared();\n",
     "    K46_PROF(6)\n    if constexpr (CN > 1) fence_async_shared();\n"),
    ("      asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n    }\n  }\n",
     "      asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");\n    }\n"
     "    K46_PROF(7)\n  }\n"),
]
K46_PROBE_ENTRY = """
extern "C" void k46_probe(unsigned long long* out, int reset) {
  unsigned long long z[16] = {0};
  if (reset) cudaMemcpyToSymbol(g_k46_prof, z, sizeof(z));
  else cudaMemcpyFromSymbol(out, g_k46_prof, sizeof(z));
}
"""


def phase_k46_fwd_simt_probe(torch, smi):
    """The simt forward recurrence's step split into its parts
    (``K46_PROBE_MARKS``), both cells, fp32, H = 256, on one row tile and on
    1,024 rows: us a step (at the card's clock) for threads 0 and 128 of
    CTA (0, 0), beside the step's CUDA-event time."""
    import ctypes
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp, nvcc

    d = os.path.join(WORK, "k46_probe")
    os.makedirs(d, exist_ok=True)
    hdr = open(os.path.join(nvcc.CSRC, "rnn_train_rec.cuh")).read()
    for old, new in K46_PROBE_MARKS:
        assert hdr.count(old) == 1, old
        hdr = hdr.replace(old, new)
    with open(os.path.join(d, "rnn_train_rec.cuh"), "w") as f:
        f.write(hdr)
    paths = []
    for src in (bigru_vjp.SRC, bilstm_vjp.SRC):
        shutil.copy(os.path.join(nvcc.CSRC, src), os.path.join(d, src))
        with open(os.path.join(d, src), "a") as f:
            f.write(K46_PROBE_ENTRY)
        paths.append(os.path.join(d, src))
    with ThreadPoolExecutor(2) as pool:
        sos = list(pool.map(lambda pth: _build_k56(os.path.basename(pth), path=pth,
                                                   tag="_probe46")[0], paths))
    gru, lstm = bigru_vjp.bind(sos[0]), bilstm_vjp.bind(sos[1])
    for lib in (gru, lstm):
        lib.k46_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    buf = (ctypes.c_ulonglong * 16)()
    with _K56Libs(gru, lstm):
        for cell, lib in (("gru", gru), ("lstm", lstm)):
            plan, clusters = _k46_plan(cell)
            fns = _k46_recurrence_fns(torch, cell, plan, clusters)
            for name in ("rec one tile", "rec 1024"):
                fn = fns[name]
                fn()
                torch.cuda.synchronize()
                lib.k46_probe(None, 1)
                ms = time_ms(fn, torch)
                lib.k46_probe(ctypes.cast(buf, ctypes.c_void_p), 0)
                steps = (REPS + 1) * (L - 1)  # the warm-up and the timed runs
                parts = [[buf[8 * w + k] / steps / mhz for k in range(len(K46_PROBE_PARTS))]
                         for w in (0, 1)]
                emit({"phase": "k46_fwd_simt_probe", "cell": cell, "input": name,
                      "rows_a_tile": plan["rows_fwd"], "step_us": ms * 1e3 / L,
                      "parts": K46_PROBE_PARTS,
                      "parts_us_thread0": parts[0], "parts_us_thread128": parts[1],
                      "clock_mhz": mhz, "card": smi})


# ---- the exact-f32 products (csrc/rnn_train_gemm.cuh's f32_tma_kernel): the
# projection of K1, K2 and the simt forwards, the simt backward's dx and
# weight gradients. Each phase builds its own harness: a copy of the header
# (edited by clock marks, or with -D geometry flags) and F32_ENTRY's C
# entries, one nvcc each, in WORK.

F32_KERNEL = "f32_tma_kernel"
F32_ENTRY = """
#include "rnn_train_gemm.cuh"
extern "C" {
int f32_proj(const void* x, const void* w, const float* bih, const float* bhh, float* xg,
             int M, int C, int G, int nfold, void* s) {
  return rnn_proj<float>(x, w, bih, bhh, xg, M, C, G, nfold, (cudaStream_t)s);
}
int f32_dx(const float* dxg, const void* w, float* dx, int M, int C, int G, void* s) {
  return rnn_dx<float>(dxg, w, dx, M, C, G, (cudaStream_t)s);
}
int f32_wgrad(const void* x, const void* out, const float* dxg, const float* dhg, float* part,
              int L, int N, int C, int H, int G, int S, void* s) {
  return rnn_wgrad<float>(x, out, dxg, dhg, part, L, N, C, H, G, S, (cudaStream_t)s);
}
}
"""
# clock64 marks, lane 0 of each warp of CTA (0, 0, 0): k cycles since the
# last mark into part k (F32_PROF); never in the shipped source
F32_PROBE_PRELUDE = (
    '#include "wgmma_tile.cuh"\n__device__ unsigned long long g_f32_prof[4][8];\n'
    "#define F32_PROF(k) if (f32p_on) { const unsigned long long now = clock64(); "
    "g_f32_prof[threadIdx.x >> 5][k] += now - f32p_t; f32p_t = now; }\n"
    "#define F32_PROF_START unsigned long long f32p_t = clock64(); const bool f32p_on = "
    "(threadIdx.x & 31) == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;\n"
    'extern "C" void f32_probe(unsigned long long* out, int reset) {\n'
    "  unsigned long long z[32] = {0};\n"
    "  if (reset) cudaMemcpyToSymbol(g_f32_prof, z, sizeof(z));\n"
    "  else cudaMemcpyFromSymbol(out, g_f32_prof, sizeof(z));\n}\n")
F32_PROBE_PARTS = ["ring wait", "FMAs", "release and refill", "epilogue"]
F32_PROBE_MARKS = [
    ('#include "wgmma_tile.cuh"\n', F32_PROBE_PRELUDE),
    ("  for (int q = 0; q < NT; ++q) {\n    const int s = q % ST, k0",
     "  F32_PROF_START\n  for (int q = 0; q < NT; ++q) {\n    const int s = q % ST, k0"),
    ("    ft_wait(full + 8 * s, (q / ST) & 1);\n",
     "    ft_wait(full + 8 * s, (q / ST) & 1);\n    F32_PROF(0)\n"),
    ("    if (live) ft_tile<AK, BK, RM, TN, PART ? 0 : KT / 4>(as, bs, tx, ty, acc, nc);\n",
     "    if (live) ft_tile<AK, BK, RM, TN, PART ? 0 : KT / 4>(as, bs, tx, ty, acc, nc);\n"
     "    F32_PROF(1)\n"),
    ("        load(q + ST);\n      }\n    }\n  }\n",
     "        load(q + ST);\n      }\n    }\n    F32_PROF(2)\n  }\n"),
    ("      jb.colsum[so + n0 + tid] = sum;\n    }\n  }\n}\n",
     "      jb.colsum[so + n0 + tid] = sum;\n    }\n  }\n  F32_PROF(3)\n}\n"),
]
# the same parts of the parent's kernels (proj_f32_kernel, gemm_f32_kernel:
# cp.async rings, a CTA barrier a k tile), for ``--only f32_gemm_probe``
# with a git archive of the parent unpacked in build/parent
F32_PARENT_PROBE_PARTS = ["copy wait", "barrier", "copy issue", "FMAs", "epilogue"]
F32_PARENT_PROBE_MARKS = [
    ('#include "wgmma_tile.cuh"\n', F32_PROBE_PRELUDE),
    ("  for (int kt = 0; kt < KT; ++kt) {\n    cp_async_wait<FP_STAGES - 2>();\n"
     "    __syncthreads();  // tile kt is here; every thread is done with tile kt - 1's slot\n"
     "    if (kt + FP_STAGES - 1 < KT) load_stage((kt + FP_STAGES - 1) % FP_STAGES, kt + "
     "FP_STAGES - 1);\n    cp_async_commit();\n",
     "  F32_PROF_START\n  for (int kt = 0; kt < KT; ++kt) {\n    cp_async_wait<FP_STAGES - 2>();\n"
     "    F32_PROF(0)\n    __syncthreads();\n    F32_PROF(1)\n"
     "    if (kt + FP_STAGES - 1 < KT) load_stage((kt + FP_STAGES - 1) % FP_STAGES, kt + "
     "FP_STAGES - 1);\n    cp_async_commit();\n    F32_PROF(2)\n"),
    ("          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);\n"
     "      }\n    }\n  }\n  cp_async_wait<0>();\n",
     "          for (int j = 0; j < 16; ++j) acc[i][j] = fmaf(a[i][kk], b[j], acc[i][j]);\n"
     "      }\n    }\n    F32_PROF(3)\n  }\n  cp_async_wait<0>();\n"),
    ("          if (n + e < G) cp[e] = v[e] + bias[e];\n      }\n    }\n  }\n}\n",
     "          if (n + e < G) cp[e] = v[e] + bias[e];\n      }\n    }\n  }\n  F32_PROF(4)\n}\n"),
    ("  for (int t = 0; t < NT; ++t) {\n    cp_async_wait<GF_STAGES - 2>();\n"
     "    __syncthreads();  // tile t is here; every thread is done with tile t - 1's slot\n"
     "    if (t + GF_STAGES - 1 < NT) load_stage((t + GF_STAGES - 1) % GF_STAGES);\n"
     "    cp_async_commit();\n",
     "  F32_PROF_START\n  for (int t = 0; t < NT; ++t) {\n    cp_async_wait<GF_STAGES - 2>();\n"
     "    F32_PROF(0)\n    __syncthreads();\n    F32_PROF(1)\n"
     "    if (t + GF_STAGES - 1 < NT) load_stage((t + GF_STAGES - 1) % GF_STAGES);\n"
     "    cp_async_commit();\n    F32_PROF(2)\n"),
    ("    if (live) gf_tile<AK, BK, TN, RM>(as, bs, tx, ty, acc);\n  }\n",
     "    if (live) gf_tile<AK, BK, TN, RM>(as, bs, tx, ty, acc);\n    F32_PROF(3)\n  }\n"),
    ("      for (int r = 0; r < 8; ++r) s += cs[r];\n      jb.colsum[so + n0 + tid] = s;\n"
     "    }\n  }\n}\n",
     "      for (int r = 0; r < 8; ++r) s += cs[r];\n      jb.colsum[so + n0 + tid] = s;\n"
     "    }\n  }\n  F32_PROF(4)\n}\n"),
]
PARENT_TREE = os.path.join(REPO, "build", "parent")
# candidate geometries of the sweep, (FT_KT, FT_STAGES, FT_UNROLL, FT_ROWS):
# k a slot, ring slots, the 4-k chunks of the k loop's body, and the rows a
# thread of the projection and dx (0: by the waves); two CTAs an SM in
# each; the first is the shipped one
F32_SWEEP = [(32, 3, 2, 0), (32, 3, 2, 8), (16, 4, 2, 0), (16, 4, 2, 8), (32, 2, 2, 0)]
F32_SWEEP_ROUNDS = 3


def _f32_build(csrc, tag, marks=(), defines=()):
    """The F32_ENTRY harness on ``csrc``'s rnn_train_gemm.cuh, edited by
    ``marks`` and built with ``defines``, in WORK/f32_<tag>: (ctypes library,
    its path, ptxas' lines)."""
    import ctypes

    from ccsmeth_tpu_torch.ops import nvcc

    src = open(os.path.join(csrc, "rnn_train_gemm.cuh")).read()
    for old, new in marks:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    d = os.path.join(WORK, "f32_" + tag)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "rnn_train_gemm.cuh"), "w") as f:
        f.write(src)
    path = os.path.join(d, "f32.cu")
    with open(path, "w") as f:
        f.write(F32_ENTRY)
    so = path[:-3] + ".so"
    proc = subprocess.run([nvcc._nvcc()] + nvcc.NVCC_FLAGS + list(defines)
                          + ["-Xptxas", "-v", "-I", d, "-I", csrc, "-o", so, path],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn, args in (("f32_proj", [p] * 5 + [i] * 4 + [p]), ("f32_dx", [p] * 3 + [i] * 3 + [p]),
                     ("f32_wgrad", [p] * 5 + [i] * 6 + [p])):
        getattr(lib, fn).restype = i
        getattr(lib, fn).argtypes = args
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, so, ptxas


def _f32_builds(jobs):
    """_f32_build over (csrc, tag, marks, defines) jobs, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(jobs)) as ex:
        return list(ex.map(lambda j: _f32_build(*j), jobs))


def _f32_inputs(torch, cell, rows, cin=2 * H, hidden=H, seq_len=L):
    """Seeded operands of the three products at one layer's shape: x (L
    rows, cin), W_ih (2, cin, G) and the biases, the gate gradients (dhg is
    dxg for the LSTM), the layer output, and the outputs."""
    from ccsmeth_tpu_torch.models.rnn import n_gates
    from ccsmeth_tpu_torch.ops import bigru_vjp as V

    g = torch.Generator(device="cuda")
    g.manual_seed(SEED + rows + cin)
    ng = n_gates(cell)
    G, M = ng * hidden, seq_len * rows
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    S = V.k5_wgrad_slices(M, cin, hidden, n_sm, ng)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    t = {"cell": cell, "L": seq_len, "N": rows, "M": M, "C": cin, "H": hidden, "G": G,
         "ng": ng, "S": S, "x": randn(M, cin), "wih": randn(2, cin, G, scale=hidden ** -0.5),
         "bih": randn(2, G), "bhh": randn(2, G), "dxg": randn(2, M, G),
         "out": randn(M, 2 * hidden)}
    t["dhg"] = randn(2, M, G) if ng == 3 else t["dxg"]
    t["xg"] = torch.empty(2, M, G, device="cuda")
    t["dx"] = torch.empty(M, cin, device="cuda")
    t["part"] = torch.empty(S * 2 * G * (cin + hidden + 1 + (ng == 3)), device="cuda")
    return t


def _f32_calls(torch, lib, t):
    """The three products of ``t`` through ``lib``'s entries (F32_ENTRY)."""
    s = torch.cuda.current_stream().cuda_stream
    nfold = (2 if t["ng"] == 3 else 4) * t["H"]

    def ok(rc):
        assert rc == 0, rc

    return {
        "projection": lambda: ok(lib.f32_proj(
            t["x"].data_ptr(), t["wih"].data_ptr(), t["bih"].data_ptr(), t["bhh"].data_ptr(),
            t["xg"].data_ptr(), t["M"], t["C"], t["G"], nfold, s)),
        "dx": lambda: ok(lib.f32_dx(t["dxg"].data_ptr(), t["wih"].data_ptr(), t["dx"].data_ptr(),
                                    t["M"], t["C"], t["G"], s)),
        "wgrad": lambda: ok(lib.f32_wgrad(
            t["x"].data_ptr(), t["out"].data_ptr(), t["dxg"].data_ptr(), t["dhg"].data_ptr(),
            t["part"].data_ptr(), t["L"], t["N"], t["C"], t["H"], t["G"], t["S"], s))}


def _f32_output(t, name):
    return t[{"projection": "xg", "dx": "dx", "wgrad": "part"}[name]].clone()


def _f32_flops(t):
    return {"projection": 2 * t["M"] * t["C"] * 2 * t["G"], "dx": 2 * t["M"] * t["C"] * 2 * t["G"],
            "wgrad": 2 * t["M"] * 2 * t["G"] * (t["C"] + t["H"])}


def _f32_bound_ms(t):
    """Each product's bound on this card's published peaks: its FLOPs at
    67 TFLOP/s or its bytes (each input read once, each output written
    once) at 3.35 TB/s, whichever is longer."""
    M, C, G, H_ = t["M"], t["C"], t["G"], t["H"]
    nbytes = {"projection": 4 * (M * C + 2 * C * G + 4 * G + 2 * M * G),
              "dx": 4 * (2 * M * G + 2 * C * G + M * C),
              "wgrad": 4 * (M * C + 2 * M * H_ + 2 * M * G * (1 + (t["ng"] == 3))
                            + 2 * G * (C + H_ + 2))}
    return {k: _bound(f, nbytes[k], "float32") for k, f in _f32_flops(t).items()}


def _f32_torch_mm(torch, t):
    """torch.mm on each product's operands (TF32 off): the projection's two
    directions, dx as one product over both directions' k, the weight
    gradients' four products (X^T dxg[d], h_prev^T dhg[d])."""
    x, w, G, H_, M, N = t["x"], t["wih"], t["G"], t["H"], t["M"], t["N"]
    a_dx = torch.cat([t["dxg"][0], t["dxg"][1]], dim=1)
    b_dx = torch.cat([w[0].t(), w[1].t()], dim=0).contiguous()
    hp = [torch.cat([torch.zeros(N, H_, device="cuda"), t["out"][:M - N, :H_]]),
          torch.cat([t["out"][N:, H_:], torch.zeros(N, H_, device="cuda")])]
    return {"projection": lambda: (torch.mm(x, w[0]), torch.mm(x, w[1])),
            "dx": lambda: torch.mm(a_dx, b_dx),
            "wgrad": lambda: [torch.mm(x.t(), t["dxg"][d]) for d in (0, 1)]
            + [torch.mm(hp[d].t(), t["dhg"][d]) for d in (0, 1)]}


def _sass_mix(so, kernel):
    """The instruction mix of ``kernel``'s SASS in the library ``so``
    (cuobjdump), over each instantiation: FFMA, LDS, BAR, other, over the
    whole function and over its k loop (from the first FFMA to the last)."""
    from ccsmeth_tpu_torch.ops import nvcc

    tool = os.path.join(os.path.dirname(nvcc._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True, text=True,
                          check=True).stdout
    mixes = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = []
        for ln in part.splitlines():
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
            if m:
                ops.append(m.group(2).split(".")[0])
        ffma = [i for i, op in enumerate(ops) if op == "FFMA"]

        def mix(seq):
            c = {"FFMA": 0, "LDS": 0, "BAR": 0, "other": 0}
            for op in seq:
                c[op if op in c else "other"] += 1
            c["total"] = len(seq)
            c["ffma_share"] = c["FFMA"] / max(1, len(seq))
            return c
        mixes[name[:120]] = {"function": mix(ops),
                             "k_loop": mix(ops[ffma[0]:ffma[-1] + 1] if ffma else [])}
    return mixes


def _torch_mm_kernels(torch, t):
    """The kernels torch.mm runs for each product's operands: name, grid,
    block and device us, from a torch.profiler trace (chrome format)."""
    from torch.profiler import ProfilerActivity, profile

    res = {}
    for name, fn in _f32_torch_mm(torch, t).items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(WORK, "mm_trace_{}.json".format(name))
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        res[name] = [{"kernel": e["name"][:160], "grid": e.get("args", {}).get("grid"),
                      "block": e.get("args", {}).get("block"), "us": e.get("dur")}
                     for e in events if e.get("cat") == "kernel"]
    return res


def _launches_for(fn, torch, seconds=3.0):
    """Calls of fn that keep the card busy ``seconds`` (at least 20)."""
    return max(20, int(seconds * 1e3 / time_ms(fn, torch, 3)))


def phase_f32_gemm_probe(torch, smi, which=("change", "parent")):
    """Where the f32 products' time goes. A build of the shipped
    f32_tma_kernel with clock64 marks (``F32_PROBE_MARKS``, per warp of CTA
    (0, 0, 0): ring wait, FMAs, release and refill, epilogue) and, where
    build/parent holds the parent tree, of its kernels (proj_f32_kernel,
    gemm_f32_kernel: ``F32_PARENT_PROBE_MARKS``: copy wait, barrier, copy
    issue, FMAs, epilogue), each beside an unmarked build, at the main
    path's shapes (1,024 rows, C = 512, both cells; the projection also at
    16,384): k cycles a CTA tile by part and warp, the FMA rate inside the
    FMA part (the SM's two CTAs' FMAs over 128 a clock), the CUDA-event
    time of both builds, the waves of each launch; the SM clock while each
    product and torch.mm run; the SASS mix of each kernel (cuobjdump); the
    kernels torch.mm runs (torch.profiler). Every tree's outputs are bit
    for bit the shipped build's."""
    import ctypes
    import math

    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru_vjp as V, nvcc

    trees = [("change", nvcc.CSRC, F32_PROBE_MARKS, F32_PROBE_PARTS, F32_KERNEL)]
    parent = os.path.join(PARENT_TREE, "ccsmeth_tpu_torch", "ops", "csrc")
    if os.path.isdir(parent):
        # the parent's marks: the cp.async kernels', or this design's
        with open(os.path.join(parent, "rnn_train_gemm.cuh")) as fh:
            old = F32_KERNEL not in fh.read()
        trees.append(("parent", parent) + ((F32_PARENT_PROBE_MARKS, F32_PARENT_PROBE_PARTS,
                                            "_f32_kernel") if old else
                                           (F32_PROBE_MARKS, F32_PROBE_PARTS, F32_KERNEL)))
    trees = [tr for tr in trees if tr[0] in which]
    jobs = []
    for tag, csrc, marks, _parts, _k in trees:
        jobs += [(csrc, tag, (), ()), (csrc, tag + "_probe", marks, ())]
    built = _f32_builds(jobs)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for j, (tag, _c, _m, parts, kname) in enumerate(trees):
        emit({"phase": "f32_gemm_probe", "tree": tag, "ptxas": built[2 * j][2],
              "sass": _sass_mix(built[2 * j][1], kname), "card": smi})
    for cell in MODELS:
        for rows in ROWS:
            t = _f32_inputs(torch, cell, rows)
            names = ("projection",) if rows == ROWS[1] else ("projection", "dx", "wgrad")
            flops = _f32_flops(t)
            mm = _f32_torch_mm(torch, t)
            ref = None
            res = {"phase": "f32_gemm_probe", "cell": cell, "rows": rows, "C": t["C"],
                   "S": t["S"], "card": smi, "trees": {}}
            for j, (tag, _c, _m, parts, kname) in enumerate(trees):
                plain, probed = built[2 * j][0], built[2 * j + 1][0]
                calls, pcalls = _f32_calls(torch, plain, t), _f32_calls(torch, probed, t)
                out = {}
                for name in names:
                    calls[name]()
                    torch.cuda.synchronize()
                    out[name] = _f32_output(t, name)
                    if ref is not None:  # the parent's bits are the shipped build's
                        assert torch.equal(out[name], ref[name]), (tag, name)
                ref = ref or out
                per = {}
                for name in names:
                    fn = ctypes.CDLL(built[2 * j + 1][1]).f32_probe
                    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
                    buf = (ctypes.c_ulonglong * 32)()
                    fn(buf, 1)
                    pcalls[name]()
                    torch.cuda.synchronize()
                    assert torch.equal(_f32_output(t, name), ref[name]), (tag, name, "probed")
                    fn(buf, 0)
                    cyc = np.array(buf[:]).reshape(4, 8)[:, :len(parts)].astype(float)
                    # CTA (0, 0, 0)'s k: the whole C, dx's two segments, slice 0's rows
                    kcta = {"projection": t["C"], "dx": 2 * t["G"],
                            "wgrad": min(t["M"], -(-(-(-t["M"] // t["S"])) // 32) * 32)}[name]
                    # proj_f32_kernel took 128 rows a tile always
                    bm, bn = (V.simt_dx_tile(t["M"], t["C"], n_sm) if name == "dx" else
                              V.simt_proj_tile(t["M"], t["G"], n_sm)
                              if (name, kname) == ("projection", F32_KERNEL) else (128, 128))
                    fmas = 2 * bm * bn * kcta  # the SM's two CTAs' tiles
                    fma_part = parts.index("FMAs")
                    ms = time_ms(calls[name], torch)
                    tiles = {"projection": 2 * math.ceil(t["G"] / 128) * math.ceil(t["M"] / bm),
                             "wgrad": t["S"] * 2 * math.ceil(t["G"] / 128) * (
                                 math.ceil(t["C"] / 128) + math.ceil(t["H"] / 128))}.get(name)
                    per[name] = {
                        "ms": ms, "probed_ms": time_ms(pcalls[name], torch),
                        "tflops": flops[name] / ms / 1e9,
                        "kcycles_by_part_and_warp": [
                            {p: c / 1e3 for p, c in zip(parts, row)} for row in cyc],
                        "share_by_part": {p: float(cyc[:, k].sum() / cyc.sum())
                                          for k, p in enumerate(parts)},
                        "fma_rate_in_fma_part": float(fmas / cyc[:, fma_part].mean() / 128),
                        "waves": tiles / (2 * n_sm) if tiles else None}
                res["trees"][tag] = per
            res["torch_mm"] = {}
            for name in names:
                ms = time_ms(mm[name], torch)
                res["torch_mm"][name] = {"ms": ms, "tflops": flops[name] / ms / 1e9}
            # the SM clock under each product's load and torch.mm's
            lib = built[0][0]
            calls = _f32_calls(torch, lib, t)
            res["sm_clock_mhz"] = {name: _sm_clock_mhz_while(
                calls[name], torch, _launches_for(calls[name], torch)) for name in names}
            res["sm_clock_mhz_torch_mm"] = {name: _sm_clock_mhz_while(
                mm[name], torch, _launches_for(mm[name], torch)) for name in names}
            if rows == ROWS[0] and cell == "gru":
                res["torch_mm_kernels"] = _torch_mm_kernels(torch, t)
            emit(res)
            del t


def phase_f32_gemm_sweep(torch, smi):
    """The f32 products at each geometry of ``F32_SWEEP`` (builds of the
    shipped header with -DFT_KT=k -DFT_STAGES=s -DFT_UNROLL=u -DFT_ROWS=r)
    and, with a parent tree in build/parent, its kernels, in
    ``F32_SWEEP_ROUNDS`` alternating rounds beside torch.mm, at the main
    path's shapes (both cells; the projection at 1,024 and 16,384 rows, dx
    and the weight gradients at 1,024, C = 512; the projection also at
    layer 0's C = 11 and 28): medians, TFLOP/s, the bound and each build's
    registers; every build's bits the first's; the SM clock while each
    build's projection runs at 16,384 rows."""
    from ccsmeth_tpu_torch.ops import nvcc

    jobs = [(nvcc.CSRC, "sweep_{}_{}_{}_{}".format(kt, st, u, rm), (),
             ("-DFT_KT={}".format(kt), "-DFT_STAGES={}".format(st), "-DFT_UNROLL={}".format(u),
              "-DFT_ROWS={}".format(rm))) for kt, st, u, rm in F32_SWEEP]
    tags = ["KT={} stages={} unroll={} rows={}".format(kt, st, u, rm)
            for kt, st, u, rm in F32_SWEEP]
    parent = os.path.join(PARENT_TREE, "ccsmeth_tpu_torch", "ops", "csrc")
    if os.path.isdir(parent):  # the parent's kernels, one more candidate
        jobs.append((parent, "sweep_parent", (), ()))
        tags.append("parent")
    builds = _f32_builds(jobs)
    emit({"phase": "f32_gemm_sweep", "ptxas": {tag: b[2] for tag, b in zip(tags, builds)},
          "card": smi})
    for cell in MODELS:
        for rows, cin in ((ROWS[0], 2 * H), (ROWS[1], 2 * H), (ROWS[0], C), (ROWS[0], C2S2)):
            t = _f32_inputs(torch, cell, rows, cin)
            names = (("projection", "dx", "wgrad") if (rows, cin) == (ROWS[0], 2 * H)
                     else ("projection",))
            flops, bound = _f32_flops(t), _f32_bound_ms(t)
            mm = _f32_torch_mm(torch, t)
            calls = [_f32_calls(torch, b[0], t) for b in builds]
            for name in names:
                ref = None
                for c in calls:
                    c[name]()
                    torch.cuda.synchronize()
                    got = _f32_output(t, name)
                    assert ref is None or torch.equal(got, ref), name
                    ref = got if ref is None else ref
            ms = {name: {tag: [] for tag in tags + ["torch.mm"]} for name in names}
            for r in range(F32_SWEEP_ROUNDS):
                order = list(range(len(builds)))
                order = order if r % 2 == 0 else order[::-1]
                for name in names:
                    for i in order:
                        ms[name][tags[i]].append(time_ms(calls[i][name], torch))
                    ms[name]["torch.mm"].append(time_ms(mm[name], torch))
            res = {"phase": "f32_gemm_sweep", "cell": cell, "rows": rows, "C": t["C"],
                   "card": smi, "bound_ms": {n: bound[n][0] for n in names}, "products": {}}
            for name in names:
                res["products"][name] = {
                    tag: {"ms": statistics.median(v), "runs": v,
                          "tflops": flops[name] / statistics.median(v) / 1e9}
                    for tag, v in ms[name].items()}
            if (rows, cin) == (ROWS[1], 2 * H):
                res["sm_clock_mhz"] = {tag: _sm_clock_mhz_while(
                    c["projection"], torch, _launches_for(c["projection"], torch))
                    for tag, c in zip(tags, calls)}
                res["sm_clock_mhz"]["torch.mm"] = _sm_clock_mhz_while(
                    mm["projection"], torch, _launches_for(mm["projection"], torch))
            emit(res)
            del t, calls


def phase_f32_products(torch, smi):
    """The exact-f32 products through the port's wrappers at the main
    path's shapes (one layer at C = 512, 1,024 rows; the projection also at
    16,384; both cells), each held against its plain PyTorch version on the
    card (float32 matmuls, TF32 off; relative tolerance 1e-5 of the largest
    magnitude: the plain version sums in another order) and timed beside it,
    torch.mm and the bound; the counts of ``bigru_vjp.f32_products`` move
    by one a call."""
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp as V

    res = {"phase": "f32_products", "kernel": F32_KERNEL, "card": smi, "cells": []}
    for cell in MODELS:
        for rows in ROWS:
            t = _f32_inputs(torch, cell, rows)
            plan = V.k45_plan(H, torch.float32, cell)
            x3 = t["x"].view(L, rows, t["C"])
            out3 = t["out"].view(L, rows, 2 * H)
            nfold = (2 if t["ng"] == 3 else 4) * H
            bias = t["bih"] + torch.where(torch.arange(t["G"], device="cuda") < nfold,
                                          t["bhh"], torch.zeros_like(t["bhh"]))
            fns = {"projection": lambda: bigru.simt_projection(t["x"], t["wih"], t["bih"],
                                                               t["bhh"], cell, t["xg"])}
            plain = {"projection": lambda: torch.stack([t["x"] @ t["wih"][d] + bias[d]
                                                        for d in (0, 1)])}
            if rows == ROWS[0]:
                fns["dx"] = lambda: V.k5_dx(t["dxg"], t["wih"], plan, torch.float32)
                fns["wgrad"] = lambda: V.k5_weight_grads(x3, out3, t["dxg"], t["dhg"], plan,
                                                         torch.float32)
                hp = [torch.cat([torch.zeros(rows, H, device="cuda"), t["out"][:-rows, :H]]),
                      torch.cat([t["out"][rows:, H:], torch.zeros(rows, H, device="cuda")])]
                plain["dx"] = lambda: (t["dxg"][0] @ t["wih"][0].t()
                                       + t["dxg"][1] @ t["wih"][1].t())

                def plain_wgrad():
                    dw_ih = torch.stack([t["x"].t() @ t["dxg"][d] for d in (0, 1)])
                    dw_hh = torch.stack([hp[d].t() @ t["dhg"][d] for d in (0, 1)])
                    db_ih = t["dxg"].sum(1)
                    return (dw_ih, db_ih, dw_hh, t["dhg"].sum(1))
                plain["wgrad"] = plain_wgrad
            mm = _f32_torch_mm(torch, t)
            flops, bound = _f32_flops(t), _f32_bound_ms(t)
            for name, fn in fns.items():
                before = V.f32_products[name]
                got = fn()
                torch.cuda.synchronize()
                assert V.f32_products[name] == before + 1, (name, V.f32_products)
                want = plain[name]()
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                err = max(float((a - b).abs().max()) for a, b in zip(got, want))
                scale = max(float(b.abs().max()) for b in want)
                assert all(torch.isfinite(a).all() for a in got), name
                assert err <= 1e-5 * scale, (cell, rows, name, err, scale)
                ms = time_ms(fn, torch)
                mm_ms = time_ms(mm[name], torch)
                lib_ms = (time_ms(lambda: torch.matmul(t["x"], t["wih"]), torch)
                          if name == "projection" else None)
                res["cells"].append({
                    "cell": cell, "rows": rows, "C": t["C"], "product": name, "ms": ms,
                    "plain_ms": time_ms(plain[name], torch), "torch_mm_ms": mm_ms,
                    "bound_ms": bound[name][0], "bound_by": bound[name][1], "library_ms": lib_ms,
                    "tflops": flops[name] / ms / 1e9, "torch_mm_tflops": flops[name] / mm_ms / 1e9,
                    "max_abs_err": err, "max_abs_ref": scale})
            del t
    emit(res)
    return res


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
            gemm0 = dict(bigru_vjp.gemm_calls)
            got = bwd(*args)
            bwd_cuda = V.cuda_launches
            gemm_per_call = {k: bigru_vjp.gemm_calls[k] - gemm0[k] for k in gemm0}
            again = bwd(*args)
            torch.cuda.synchronize()
            # forward: projection, recurrence; backward: 3, + the slice sum
            assert fwd_cuda == 2 and bwd_cuda == _bwd_cuda_launches(
                rows, cin, dt, cell, hidden, seq_len), (cell, fwd_cuda, bwd_cuda)
            # tc: dx, dW_ih and dW_hh on wgmma; simt counts none
            assert gemm_per_call == {"wgmma": 3 * (design == "tc")}, gemm_per_call
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
            # each recurrence's tile, residency and waves, as the library
            # launches it (either design)
            plan = bigru_vjp.k45_plan(hidden, dt, cell)
            occ = {}
            for key, fn in (("fwd", bigru_vjp.fwd_rec_occupancy),
                            ("bwd", bigru_vjp.bwd_rec_occupancy)):
                occ[key] = fn(plan, dt)
                assert (occ[key]["rows"], occ[key]["smem"]) == (
                    plan["rows_" + key], plan["smem_" + key]), (key, occ[key])
                occ[key]["waves"] = bigru_vjp.rec_waves(occ[key]["rows"], rows,
                                                        occ[key]["clusters"])
            # the forward's tile at these rows, and its waves
            occ["fwd"]["rows_here"] = bigru_vjp.fwd_rows(plan, rows)
            occ["fwd"]["waves_here"] = bigru_vjp.rec_waves(occ["fwd"]["rows_here"], rows,
                                                           occ["fwd"]["clusters"])
            phases = _train_phases_ms(torch, x, wih, bih, whh, bhh, dout, dt, cell,
                                      {k: o["clusters"] for k, o in occ.items()})
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
                if name.endswith("_fwd"):
                    c["fwd_recurrence"] = occ["fwd"]
                if name.endswith("_bwd"):
                    c["bwd_recurrence"] = occ["bwd"]
                    c["bit_equal_rerun"] = True
                    c["products"] = phases[2]
                    c["gemm_calls_per_call"] = gemm_per_call
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
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp, transenc

    attrnn.h0_plain_calls = 0
    bigru.launches = bigru.plain_calls = 0
    bigru.layer_launches = bigru.layer_plain_calls = bigru.layer_cuda_launches = 0
    transenc.launches = transenc.plain_calls = 0
    for mod in (bigru, transenc):
        mod.cuda_launches = 0
    for calls in (bigru.design_calls, bigru.layer_design_calls, transenc.design_calls,
                  bigru.tc_projection_calls, bigru_vjp.f32_products):
        for k in calls:
            calls[k] = 0


def _rnn_launches(model_type, prec):
    """(CUDA launches of one K1 call, of one batch's K2 calls, the tc
    projections of one K1 call by kernel) for an RNN model at its full width
    and the precision: the shape rule's design, and in tc the fused layer
    0 (``_per_call``)."""
    import torch

    from ccsmeth_tpu_torch.models import AttRNNConfig
    from ccsmeth_tpu_torch.models.attrnn import rnn_input_size
    from ccsmeth_tpu_torch.ops import bigru

    cfg = AttRNNConfig(model_type=model_type)
    cell = "lstm" if "lstm" in model_type else "gru"
    widths = [rnn_input_size(cfg)] + [2 * H] * (NL - 1)
    plan = bigru.k1_plan(H, cell, torch.bfloat16 if prec == "bf16" else torch.float32)
    proj = {"wgmma": 0, "mma": 0}
    if plan["design"] == "tc":
        for c in widths:
            if not bigru.tc_fused_kx(plan, c, cell, H):
                proj["wgmma" if c % 8 == 0 else "mma"] += 1
    n = _per_call(plan, cell, widths)
    return n, n, proj


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
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp

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
        # K1: simt a projection and a recurrence a layer, tc one launch less
        # where layer 0 fuses its projection; K3 one launch
        per_call, _k2, proj = (_rnn_launches(model_type, prec) if name == "k1"
                               else (1, 0, {"wgmma": 0, "mma": 0}))
        assert cuda[name] == per_call * n and sum(cuda.values()) == cuda[name], cuda
        tc_proj = dict(bigru.tc_projection_calls)
        assert tc_proj == {k: v * n for k, v in proj.items()}, tc_proj
        # fp32 K1 projects each layer with the f32 product kernel
        f32 = dict(bigru_vjp.f32_products)
        assert f32 == {"projection": NL * n if (name, prec) == ("k1", "fp32") else 0,
                       "dx": 0, "wgrad": 0}, f32
        n_tagged = sum(1 for mm, ml in tags[prec].values() if ml is not None)
        assert n_tagged >= 0.9 * len(tags[prec]), (prec, n_tagged)
        # one model replica a visible card, batches padded to a multiple
        assert run["replicas"] == torch.cuda.device_count(), run
        assert run["pad_n"] % run["replicas"] == 0, run
        run.update(phase="e2e", model=model_type, precision=prec, launches=counts,
                   designs=designs, cuda_launches=cuda, tc_projections=tc_proj,
                   f32_products=f32,
                   sites_per_s=run["sites"] / run["seconds"],
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


def _ml_diff(tags_a, tags_b):
    """(sites, share of ML bytes equal, largest ML difference) of two runs'
    tags; the MM strings must be equal."""
    import numpy as np

    n_sites = n_equal = most = 0
    for q, (mm, ml) in tags_a.items():
        mm_b, ml_b = tags_b[q]
        assert mm == mm_b, q
        if ml is None:
            continue
        n_sites += ml.size
        n_equal += int((ml == ml_b).sum())
        most = max(most, int(np.abs(ml - ml_b).max()))
    return n_sites, n_equal / n_sites, most


def phase_e2e_rows(torch, smi, model_type, tags512):
    """call_mods --batch_size 8192 in fp32 (16,384 rows a batch: the rows
    design of K1 and K2) through the CLI, once through K1 and once under
    ``--rnn_backend pallas_layer`` through K2, every kernel's counts set to
    0 just before each run and read just after: the rows design on every
    batch (K1 one call a batch, K2 one a layer and batch, two CUDA launches
    a layer), nothing else and no plain version. The K1 run's ML bytes equal
    the batch-512 fp32 run's (``tags512``) on >= 99.9% of sites and lie
    within 1 of them on all (the rest of the model's products see other
    shapes); K2's equal K1's at the same batch on >= 99.9%."""
    from ccsmeth_tpu_torch.ops import bigru

    runs, tags = {}, {}
    for name, extra in (("k1", []), ("k2", ["--rnn_backend", "pallas_layer"])):
        _zero_counts()
        run, tags[name] = _call_mods(model_type, "fp32", "b{}_{}".format(E2E_ROWS_BATCH, name),
                                     ["--batch_size", str(E2E_ROWS_BATCH)] + extra)
        torch.cuda.synchronize()
        counts, cuda, designs = _all_counts(), _cuda_launches(), _design_counts()[name]
        n = run["batches"] * (1 if name == "k1" else NL)
        assert bigru.k1_plan(H, "gru", torch.float32, 2 * run["pad_n"])["design"] == "rows"
        assert run["batches"] > 0 and counts[name] == n, (name, counts, run)
        assert sum(counts.values()) == n, counts  # no other kernel, no plain run
        assert designs == dict({d: 0 for d in designs}, rows=n), designs
        assert cuda == dict({"k1": 0, "k2": 0, "k3": 0}, **{name: 2 * NL * run["batches"]}), cuda
        base = tags512 if name == "k1" else tags["k1"]
        n_sites, equal, most = _ml_diff(base, tags[name])
        run.update(phase="e2e_rows", model=model_type, precision="fp32",
                   batch_size=E2E_ROWS_BATCH, rnn_backend="pallas_layer" if name == "k2" else "xla",
                   launches=counts, designs=designs, cuda_launches=cuda,
                   sites_per_s=run["sites"] / run["seconds"], sites_compared=n_sites,
                   ml_equal_to=("batch 512 fp32 run" if name == "k1"
                                else "the K1 run at batch {}".format(E2E_ROWS_BATCH)),
                   ml_equal=equal, ml_most_apart=most, card=smi)
        emit(run)
        assert equal >= 0.999, equal
        if name == "k1":
            assert most <= 1, most
        runs[name] = run
    return runs


def phase_e2e_layer(torch, smi, model_type, k1_tags):
    """call_mods --rnn_backend pallas_layer in fp32 and bf16: K2 launches once
    a layer and batch (its design's CUDA launches: simt two in fp32, tc two
    in bf16 and one for layer 0, whose projection fuses), K1 and K3 never, no
    plain version runs. In fp32 K2 runs K1's
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
        per_batch = _rnn_launches(model_type, prec)[1]  # K2's launches for the layers
        assert cuda == {"k1": 0, "k2": per_batch * run["batches"], "k3": 0}, cuda
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
    events name K1's two kernels (the simt design: K4's projection, the
    exact-f32 product kernel ``f32_tma_kernel``, and the recurrence
    ``birnn_rec_kernel``), and with ``--batch_size 8192`` the rows design's
    (``f32_tma_kernel`` and ``birnn_rows_kernel``)."""
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

    # the trace names K1's two kernels of the design that runs: simt at the
    # default batch, rows at batch 8,192 (and not the other recurrence)
    for key, tag, extra, names, absent in (
            ("profile", "profiled", [], (F32_KERNEL, "birnn_rec_kernel"),
             "birnn_rows_kernel"),
            ("profile_rows", "profiled_rows", ["--batch_size", str(E2E_ROWS_BATCH)],
             (F32_KERNEL, "birnn_rows_kernel"), "birnn_rec_kernel")):
        tdir = os.path.join(WORK, "trace_" + tag)
        shutil.rmtree(tdir, ignore_errors=True)
        _zero_counts()
        run, tags = _call_mods(model_type, "fp32", tag, ["--profile_dir", tdir] + extra)
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
        k1 = {name: sum(n for k, n in kernels.items() if name in k) for name in names}
        assert all(n > 0 for n in k1.values()), sorted(kernels)[:20]
        assert not any(absent in k for k in kernels), sorted(kernels)[:20]
        if not extra:
            assert _ml_shares(tags, single_tags)[1] == 1.0  # the trace changes no output
        res[key] = {"trace_bytes": os.path.getsize(traces[0]), "events": len(events),
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
    for k in bigru_vjp.f32_products:
        bigru_vjp.f32_products[k] = 0
    t0 = time.time()
    _train_cli(cli, model_type, tr, va, os.path.join(WORK, model_type + "_fp32"),
               "fp32", epochs, STEP_INTERVAL)
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = dict(LAST_RUN)
    counts = {"fwd": mine.launches_fwd, "bwd": mine.launches_bwd,
              "k1": bigru.launches, "plain_vjp": mine.plain_calls,
              "plain_k1": bigru.plain_calls,
              "other_cell": other.launches_fwd + other.launches_bwd + other.plain_calls,
              "f32_products": dict(bigru_vjp.f32_products)}
    steps = run["steps"]
    n_valid = len(run["valid_losses"])
    assert steps == epochs * (TRAIN_ROWS // 512), steps
    assert counts["fwd"] == counts["bwd"] == 3 * steps, counts
    assert counts["k1"] == n_valid * math.ceil(VALID_ROWS / 512) > 0, counts
    assert counts["plain_vjp"] == counts["plain_k1"] == counts["other_cell"] == 0, \
        counts
    # the f32 product kernel: a projection a layer of each forward and of
    # each validation's K1 call, dx and the weight gradients a layer a step
    assert counts["f32_products"] == {"projection": counts["fwd"] + NL * counts["k1"],
                                      "dx": counts["bwd"],
                                      "wgrad": counts["bwd"]}, counts
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
    # each backward layer's three products (dx, dW_ih, dW_hh) on wgmma;
    # every CUDA launch counted
    cins = (cin0, 2 * H, 2 * H)
    gemm16 = dict(bigru_vjp.gemm_calls)
    assert gemm16 == {"wgmma": 3 * n16[1]}, gemm16
    per_step16 = sum(2 + _bwd_cuda_launches(2 * 512, c, torch.bfloat16, cell) for c in cins)
    assert mine.cuda_launches == per_step16 * run16["steps"], (mine.cuda_launches, per_step16)
    res["bf16_launches"] = {"fwd": n16[0], "bwd": n16[1], "k45_designs": designs16,
                            "k45_cuda_launches": mine.cuda_launches, "gemm_calls": gemm16}
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
    """The training kernels' (K4/K5 and K6) CUDA launches, calls by design
    and tc backward products by kernel, set to 0."""
    from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

    for V in (bigru_vjp, bilstm_vjp):
        V.cuda_launches = 0
        for k in V.design_calls:
            V.design_calls[k] = 0
    for k in bigru_vjp.gemm_calls:
        bigru_vjp.gemm_calls[k] = 0


def phase_profile(torch, smi, cell, steps=5, check_kernels=True):
    """Where a full-width training step's time goes: torch.profiler over
    ``steps`` steps (attbigru2s or attbilstm2s 3x256, batch 512, fp32,
    dropout 0.5, Adam)
    after two warm-up steps; device time per kernel name, the device's busy
    time against the host clock, and the step time; the trace names the
    backward's exact-f32 product kernel (``f32_tma_kernel``) and
    ``gemm_simt_kernel`` for none (``check_kernels``: off in
    ``--ab-step``'s turns, whose parent tree has other kernels). Launches
    here are not the train path's and are read nowhere."""
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
    # the fp32 step's products (K4/K6's projections, K5/K6's dx and weight
    # gradients, a layer each) run f32_tma_kernel, none gemm_simt_kernel (the
    # counts a step are the trace's, which may miss an event of the window)
    products = {name: sum(n for _ms, n, k in rows if name in k)
                for name in (F32_KERNEL, "gemm_simt_kernel")}
    assert not (check_kernels and rows) or (
        products[F32_KERNEL] > 0 and products["gemm_simt_kernel"] == 0), products
    res = {"phase": "profile",
           "what": "train step, {} 3x256, batch 512, fp32".format(MODELS[cell]),
           "steps": steps, "step_ms_host": wall_ms, "device_ms_per_step": device_ms,
           "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms else None,
           "product_kernels_per_step": products,
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


def _freq_modbam():
    """(the freq phase's HP-tagged modbam, its reference), made here when
    the freq phase did not run (--only)."""
    from ccsmeth_tpu_torch import cli

    bam, fasta = _freq_input()
    tagged = os.path.join(WORK, "freq", "mods.hp.bam")
    if not os.path.exists(tagged):
        from ccsmeth_tpu_torch.models.params_io import save_params

        ckpt = os.path.join(WORK, MODELS["gru"] + "_full.ckpt.npz")
        save_params(ckpt, _config_params(MODELS["gru"])[1])
        cli.main(["call_mods", "-i", bam, "-o", os.path.join(WORK, "freq", "mods"), "-m",
                  ckpt, "--mode", "align", "--ref", fasta, "--device", "cuda"])
        _hp_tagged(os.path.join(WORK, "freq", "mods.modbam.bam"), tagged)
    return tagged, fasta


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
    tagged, fasta = _freq_modbam()
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


def _dist_runs(d, tr1, va1, tr, va, tagged, fasta, npz):
    """The dist phase's four runs of one rank, or of one process when
    ``rank`` is None: (name, argv, output to read) with the rank's own
    model dir or output prefix."""
    seed = str(SEED % 10000)

    def runs(rank, batch):
        tag = "one" if rank is None else "rank{}".format(rank)
        own = os.path.join(d, tag)
        return [
            # one step at dropout 0, SGD: Adam's first update is lr g / (|g| +
            # 1e-8), which turns a gradient's last-bit rounding near 0 into
            # a move of up to 2 lr; SGD's is lr g
            ("step", ["trainm", "--train_file", tr1, "--valid_file", va1,
                      "--model_type", MODELS["gru"], "--device", "cuda",
                      "--batch_size", str(batch), "--dropout_rate", "0",
                      "--optim_type", "SGD", "--lr", "0.1", "--max_epoch_num", "1",
                      "--min_epoch_num", "1", "--tseed", seed,
                      "--model_dir", os.path.join(own, "step")]),
            # DIST_EPOCHS epochs at the CLI's defaults (dropout 0.5, Adam 1e-3)
            ("epoch", ["trainm", "--train_file", tr, "--valid_file", va,
                       "--model_type", MODELS["gru"], "--device", "cuda",
                       "--batch_size", str(batch), "--max_epoch_num", str(DIST_EPOCHS),
                       "--min_epoch_num", str(DIST_EPOCHS), "--tseed", seed,
                       "--model_dir", os.path.join(own, "epoch")]),
            ("count", ["call_freqb", "-i", tagged, "--ref", fasta,
                       "-o", os.path.join(own, "freq", "count")]),
            ("aggregate", ["call_freqb", "-i", tagged, "--ref", fasta,
                           "--call_mode", "aggregate", "-m", npz, "--device", "cuda",
                           "-o", os.path.join(own, "freq", "aggregate")])]

    return runs


def _dist_run_one(torch, name, argv):
    """One CLI run with every kernel's counts set to 0 just before it and
    read just after: (its LAST_RUN, wall s, K4/K5 counts, K1's)."""
    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.pipeline import call_freq_bam
    from ccsmeth_tpu_torch.training.train import LAST_RUN

    _zero_train_counts()
    t0 = time.time()
    cli.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    last = LAST_RUN if name in ("step", "epoch") else call_freq_bam.LAST_RUN
    mine, other, inf = _train_counts("gru")
    return {"run": dict(last), "wall_s": wall, "k45": mine, "other_cell": other,
            "inference": inf}


def _dist_rank(rank, d, ports):
    """``--dist-rank K DIR PORT...``: rank K of the dist phase's group, each
    of its runs through the CLI with --dist_coordinator 127.0.0.1:PORT, its
    results written to DIR/rankK.json."""
    import torch

    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    runs = _dist_runs(**spec)(rank, DIST_BATCH)
    out = {}
    for (name, argv), port in zip(runs, ports):
        out[name] = _dist_run_one(torch, name, argv + [
            "--num_processes", str(DIST_RANKS), "--process_id", str(rank),
            "--dist_coordinator", "127.0.0.1:{}".format(port)])
    with open(os.path.join(d, "rank{}.json".format(rank)), "w") as f:
        json.dump(out, f)


def _valid_lines(path):
    """A rank's validation log lines without their wall times."""
    import re

    with open(path) as f:
        return [re.sub(r"; Time: .*", "", ln[ln.index("Epoch ["):])
                for ln in f if "ValidLoss" in ln]


def phase_dist(torch, smi):
    """Two ranks sharing the card (``gloo``, by the backend rule), each a
    process of this script (``--dist-rank``), at full width (attbigru2s 3 x
    256, C 11, L 21), batch 512 a rank, against one process at the global
    batch of 1,024: ``trainm`` one step at dropout 0 (every leaf of the
    checkpoint within DIST_TOL), then DIST_EPOCHS epochs at the CLI's
    defaults on the train phase's separable set (best accuracy >= 0.9, the same
    validation lines on both ranks, K4 and K5 3 times a step on each rank,
    checkpoints on rank 0 only); ``call_freqb --dist_coordinator`` on the
    freq phase's modbam in count mode (rank 0's files byte-equal to one
    process's, rank 1 writes nothing) and in aggregate mode through K1 on
    rank 0 (rows equal to one process's on the card). On one card the two
    ranks share the SMs, so the rates measure the collective path's
    overhead, not scaling. Also the multi-card predict's replicas."""
    import shutil
    import socket

    import numpy as np

    from ccsmeth_tpu_torch.models import (AggrConfig, AttRNNConfig, init_aggr_attrnn,
                                          init_attrnn)
    from ccsmeth_tpu_torch.models.params_io import _flatten, load_params, save_params
    from ccsmeth_tpu_torch.parallel import distributed
    from ccsmeth_tpu_torch.pipeline import call_mods

    t_phase = time.time()
    d = os.path.join(WORK, "dist")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    tr, va, _ = _train_input()
    tr1, va1 = os.path.join(d, "train_1024.tsv"), os.path.join(d, "valid_1024.tsv")
    for src, dst in ((tr, tr1), (va, va1)):  # one global batch each
        with open(src) as f, open(dst, "w") as g:
            for _i, line in zip(range(DIST_RANKS * DIST_BATCH), f):
                g.write(line)
    tagged, fasta = _freq_modbam()
    npz = os.path.join(d, "attbigru_aggr.npz")
    save_params(npz, init_aggr_attrnn(SEED, AggrConfig(model_type="attbigru")))
    spec = dict(d=d, tr1=tr1, va1=va1, tr=tr, va=va, tagged=tagged, fasta=fasta, npz=npz)
    with open(os.path.join(d, "spec.json"), "w") as f:
        json.dump(spec, f)
    runs = _dist_runs(**spec)
    for tag in ("one", "rank0", "rank1"):
        os.makedirs(os.path.join(d, tag, "freq"))

    # one process at the global batch, first, alone on the card
    one = {name: _dist_run_one(torch, name, argv)
           for name, argv in runs(None, DIST_RANKS * DIST_BATCH)}

    ports = []
    for _ in range(4):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        ports.append(s.getsockname()[1])
        s.close()
    procs, logs = [], []
    for rank in range(DIST_RANKS):
        logs.append(os.path.join(d, "rank{}.log".format(rank)))
        with open(logs[-1], "w") as log_f:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank", str(rank), d]
                + [str(p) for p in ports], stdout=log_f, stderr=subprocess.STDOUT))
    t_ranks = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(1.0, DIST_TIMEOUT - (time.time() - t_ranks)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        raise AssertionError("a dist rank outlived {} s".format(DIST_TIMEOUT))
    ranks_wall = time.time() - t_ranks
    for rank, (p, path) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            with open(path) as f:
                raise AssertionError("dist rank {} failed ({}):\n{}".format(
                    rank, p.returncode, f.read()[-4000:]))
    ranks = []
    for rank in range(DIST_RANKS):
        with open(os.path.join(d, "rank{}.json".format(rank))) as f:
            ranks.append(json.load(f))
    backend = distributed.backend_for("cuda", DIST_RANKS, torch.cuda.device_count())
    for r in ranks:
        for name, got in r.items():
            assert got["run"]["world"] == DIST_RANKS, (name, got["run"])
            want = backend if name not in ("count",) else "gloo"  # count: the host
            assert got["run"]["backend"] == want, (name, got["run"]["backend"])

    # one step: every leaf of rank 0's checkpoint against one process's
    a = dict(_flatten(load_params(ranks[0]["step"]["run"]["ckpts"][-1])))
    b = dict(_flatten(load_params(one["step"]["run"]["ckpts"][-1])))
    assert a.keys() == b.keys() and a
    leaf_err = {k: float(np.abs(a[k] - b[k]).max()) for k in sorted(a)}
    step_err = max(leaf_err.values())
    assert step_err <= DIST_TOL, sorted(leaf_err.items(), key=lambda kv: -kv[1])[:5]
    init = dict(_flatten(init_attrnn(SEED % 10000, AttRNNConfig(dropout_rate=0.0))))
    moved = max(float(np.abs(b[k] - init[k]).max()) for k in b)
    loss_err = abs(ranks[0]["step"]["run"]["train_losses"][0]
                   - one["step"]["run"]["train_losses"][0])
    assert loss_err <= DIST_TOL, loss_err

    # one epoch at the defaults
    ep = [r["epoch"] for r in ranks]
    steps = ep[0]["run"]["steps"]
    per_epoch = TRAIN_ROWS // (DIST_RANKS * DIST_BATCH)
    assert steps == DIST_EPOCHS * per_epoch == one["epoch"]["run"]["steps"], steps
    for r in ep:
        assert r["run"]["steps"] == steps
        assert r["k45"]["fwd"] == r["k45"]["bwd"] == 3 * steps, r["k45"]
        assert r["k45"]["plain"] == 0 == r["other_cell"], r
        assert r["k45"]["designs"] == {"tc": 0, "simt": 6 * steps}, r["k45"]
        assert r["inference"]["k1"] > 0 == r["inference"]["k1_plain"], r["inference"]
        assert r["run"]["best_accuracy"] >= DIST_ACC, r["run"]["best_accuracy"]
    assert ep[0]["run"]["valid_losses"] == ep[1]["run"]["valid_losses"]
    lines = [_valid_lines(path) for path in logs]
    assert lines[0] and lines[0] == lines[1], lines
    for name in ("step", "epoch"):  # rank 0 alone writes
        assert ranks[0][name]["run"]["ckpts"] and ranks[1][name]["run"]["ckpts"] == []
        assert os.listdir(os.path.join(d, "rank1", name)) == []
    n_valid = len(ep[0]["run"]["valid_losses"])
    ar = ep[0]["run"]
    assert ar["allreduce_calls"] == 2 * steps + n_valid, ar
    # a step: the weight sum, then the gradients with the loss; a sweep: 7
    # sums a validation batch of the rank
    n_vb = VALID_ROWS // (DIST_RANKS * DIST_BATCH)
    step_bytes = (ar["allreduce_bytes"] - n_valid * n_vb * 7 * 4) // steps
    n_params = sum(v.size for k, v in a.items() if not k.endswith(("mean", "var")))
    assert step_bytes == 4 + 4 * (n_params + 1), (step_bytes, n_params)
    samples = per_epoch * DIST_RANKS * DIST_BATCH  # an epoch's

    # call_freqb: rank 0's files against one process's, rank 1 writes nothing
    freq = {}
    for mode in ("count", "aggregate"):
        got = [r[mode] for r in ranks]
        assert os.listdir(os.path.join(d, "rank1", "freq")) == []
        for tag in ("all", "hp1", "hp2"):
            mine = os.path.join(d, "rank0", "freq", "{}.{}.{}.freq.txt".format(mode, mode, tag))
            ref = os.path.join(d, "one", "freq", "{}.{}.{}.freq.txt".format(mode, mode, tag))
            with open(mine, "rb") as f, open(ref, "rb") as g:
                assert f.read() == g.read(), (mode, tag)
        assert got[0]["run"]["sites"] == one[mode]["run"]["sites"] > 0
        assert got[1]["run"]["sites"] == 0
        assert got[0]["run"]["allreduce_calls"] == got[1]["run"]["allreduce_calls"] >= 3
        if mode == "aggregate":  # rank 0 alone runs the model, through K1
            n = got[0]["run"]["batches"]
            assert got[0]["inference"]["k1"] == n == one[mode]["run"]["batches"] > 0
            assert got[0]["inference"]["k1_plain"] == 0
            assert got[1]["inference"]["k1"] == got[1]["run"]["batches"] == 0
        else:
            assert sum(g["inference"]["k1"] for g in got) == 0
        freq[mode] = {
            "sites": got[0]["run"]["sites"],
            "sites_per_s_2_ranks": got[0]["run"]["sites"] / got[0]["run"]["seconds"],
            "sites_per_s_1_process": one[mode]["run"]["sites"] / one[mode]["run"]["seconds"],
            "seconds_2_ranks": [g["run"]["seconds"] for g in got],
            "seconds_1_process": one[mode]["run"]["seconds"],
            "allreduce_calls": got[0]["run"]["allreduce_calls"],
            "allreduce_bytes": got[0]["run"]["allreduce_bytes"],
            "allreduce_s": got[0]["run"]["allreduce_seconds"],
            "k1_calls_rank0": got[0]["inference"]["k1"]}
    replicas = len(call_mods.predict_devices("cuda"))
    assert replicas == torch.cuda.device_count()
    res = {"phase": "dist", "ranks": DIST_RANKS, "backend": backend,
           "batch_per_rank": DIST_BATCH, "model": MODELS["gru"] + " 3x256",
           "step": {"max_abs_leaf_err": step_err, "gate": DIST_TOL,
                    "max_param_move": moved, "loss_err": loss_err,
                    "leaf_err": leaf_err},
           "epoch": {"steps": steps, "epochs": DIST_EPOCHS,
                     "best_accuracy": [r["run"]["best_accuracy"]
                                                        for r in ep],
                     "best_accuracy_1_process": one["epoch"]["run"]["best_accuracy"],
                     "validations": n_valid,
                     "k4_k5_per_rank": [[r["k45"]["fwd"], r["k45"]["bwd"]] for r in ep],
                     "k1_per_rank": [r["inference"]["k1"] for r in ep],
                     # the last epoch's: the first includes the first calls
                     "samples_per_s_2_ranks": samples / ar["epoch_wall_s"][-1],
                     "samples_per_s_1_process": samples
                     / one["epoch"]["run"]["epoch_wall_s"][-1],
                     "allreduce_calls": ar["allreduce_calls"],
                     "allreduce_bytes": ar["allreduce_bytes"],
                     "allreduce_bytes_per_step": step_bytes,
                     "gradient_values": n_params,
                     "allreduce_ms_per_step": 1e3 * ar["allreduce_seconds"] / steps,
                     "epoch_wall_s_2_ranks": [r["run"]["epoch_wall_s"] for r in ep],
                     "epoch_wall_s_1_process": one["epoch"]["run"]["epoch_wall_s"]},
           "freq": freq, "predict_replicas": replicas,
           "ranks_wall_s": ranks_wall, "wall_s": time.time() - t_phase, "card": smi}
    res["launches"] = {
        "k4": sum(r[n]["k45"]["fwd"] for r in ranks for n in ("step", "epoch")),
        "k5": sum(r[n]["k45"]["bwd"] for r in ranks for n in ("step", "epoch")),
        "k1_validation": sum(r[n]["inference"]["k1"] for r in ranks
                             for n in ("step", "epoch")),
        "k1_aggregate": ranks[0]["aggregate"]["inference"]["k1"]}
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
    ``tree`` at the kernel phase's shapes and inputs (K1 fp32 also at the
    2s2 widths and at ``AB_CROSSOVER_ROWS``), and K4, K5 and K6
    (forward and backward) at the train-kernel phase's (1024 rows, C = 11
    and 512, and 28 in fp32), fp32 and bf16, and K4's to K6's fp32
    forwards and backwards at 512 rows (C = 11, 28, 512) and at the
    aggregate trainer's shape, and the exact-f32 products alone (the
    projection at C = 512, 1,024 and 16,384 rows; dx and the weight
    gradients at 1,024), through the tree's own wrappers; medians of
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
            # K1 fp32 at the 2s2 widths (C = 28 and 52, 1,024 rows) and about
            # the fp32 rules' crossovers (AB_CROSSOVER_ROWS, C = 11)
            for cin, rows in ([(c, ROWS[0]) for c in (C2S2, C2S2_WIDE)]
                              + [(C, r) for r in AB_CROSSOVER_ROWS]):
                x = torch.from_numpy(np.random.RandomState(SEED + rows).randn(
                    L, rows, cin).astype(np.float32)).cuda()
                ly = [layer_weights(ld, torch.float32, "cuda") for ld in
                      init_rnn_params(np.random.RandomState(SEED), cin, H, NL, cell)]
                res["ms"]["k1 {} {} C={} float32".format(cell, rows, cin)] = time_ms(
                    lambda: bigru.birnn_stack(ly, x, torch.float32, cell), torch, AB_REPS)
            # K1 fp32 at call_freqb's aggregate shape (NL 1, H 32, L 11, C 21)
            x = torch.from_numpy(np.random.RandomState(SEED).randn(
                AGGR_L, ROWS[0], AGGR_C).astype(np.float32)).cuda()
            ly = [layer_weights(ld, torch.float32, "cuda") for ld in
                  init_rnn_params(np.random.RandomState(SEED), AGGR_C, AGGR_H, 1, cell)]
            res["ms"]["k1 {} aggr float32".format(cell)] = time_ms(
                lambda: bigru.birnn_stack(ly, x, torch.float32, cell), torch, AB_REPS)
            # K2 at the K2 phase's cells: one layer, 1024 rows, C = 11 and 2H
            # (and the 2s2 family's layer 0, C = 28 and 52, in fp32)
            for cin in (C, C2S2, C2S2_WIDE, 2 * H):
                rng = np.random.RandomState(SEED + cin)
                ld = init_rnn_params(rng, cin, H, 1, cell)[0]
                x_np = rng.randn(L, ROWS[0], cin).astype(np.float32)
                for dname in (("float32", "bfloat16") if cin in (C, 2 * H)
                              else ("float32",)):
                    dt = getattr(torch, dname)
                    lyr = layer_weights(ld, dt, "cuda")
                    x = torch.from_numpy(x_np).to("cuda", dt)
                    res["ms"]["k2 {} C={} {}".format(cell, cin, dname)] = time_ms(
                        lambda: bigru.bigru_layer_tm(lyr, x, dt, cell), torch, AB_REPS)
            # K2 fp32 at batch 8,192's rows, C = 2H
            rng = np.random.RandomState(SEED + 2 * H)
            lyr = layer_weights(init_rnn_params(rng, 2 * H, H, 1, cell)[0], torch.float32, "cuda")
            x = torch.from_numpy(rng.randn(L, ROWS[1], 2 * H).astype(np.float32)).cuda()
            res["ms"]["k2 {} C={} rows={} float32".format(cell, 2 * H, ROWS[1])] = time_ms(
                lambda: bigru.bigru_layer_tm(lyr, x, torch.float32, cell), torch, AB_REPS)
            del x
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
                if (rows, dname) == (ROWS[0], "float32"):  # K3's l2 design, a control
                    res["ms"]["k3_l2 {} {}".format(rows, dname)] = time_ms(
                        lambda: transenc._encoder_l2(st, x, dt, cfg.nhead), torch, AB_REPS)
        # the training kernels at the train-kernel phase's cells: K6 and
        # K4/K5 (the control), forward and backward
        from ccsmeth_tpu_torch.ops import bigru_vjp, bilstm_vjp

        train = {"gru": ("k4", "k5", bigru_vjp.bigru_layer_train_fwd,
                         bigru_vjp.bigru_layer_bwd),
                 "lstm": ("k6f", "k6b", bilstm_vjp.bilstm_layer_train_fwd,
                          bilstm_vjp.bilstm_layer_bwd)}
        rows = ROWS[0]
        for cell, (kf, kb, fwd, bwd) in train.items():
            for cin in (C, C2S2, 2 * H):  # the 2s2 family's layer 0 in fp32
                rng = np.random.RandomState(SEED + cin)
                ld = init_rnn_params(rng, cin, H, 1, cell)[0]
                x_np = rng.randn(L, rows, cin).astype(np.float32)
                dout_np = rng.randn(L, rows, 2 * H).astype(np.float32)
                for dname in ("float32", "bfloat16") if cin != C2S2 else ("float32",):
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
            # the fp32 forwards and backwards at the 1s families' 512 rows
            # (C = 11, 28, 512) and at the aggregate trainer's shape (H 32,
            # C 21, L 11)
            for cin, hidden, seq_len, tag in ((C, H, L, "rows=512 C={}".format(C)),
                                              (C2S2, H, L, "rows=512 C={}".format(C2S2)),
                                              (2 * H, H, L, "rows=512 C={}".format(2 * H)),
                                              (AGGR_C, AGGR_H, AGGR_L, "aggr")):
                rng = np.random.RandomState(SEED + cin)
                ld = init_rnn_params(rng, cin, hidden, 1, cell)[0]
                x = torch.from_numpy(rng.randn(seq_len, 512, cin).astype(np.float32)).cuda()
                dout = torch.from_numpy(rng.randn(seq_len, 512, 2 * hidden).astype(
                    np.float32)).cuda()
                wih, bih, whh, bhh = layer_weights(ld, torch.float32, "cuda")
                res["ms"]["{} {} float32".format(kf, tag)] = time_ms(
                    lambda: fwd(x, wih, bih, whh, bhh, torch.float32), torch, AB_REPS)
                args = (dout, x, wih, whh) + tuple(fwd(x, wih, bih, whh, bhh, torch.float32)) \
                    + (torch.float32,)
                res["ms"]["{} {} float32".format(kb, tag)] = time_ms(
                    lambda: bwd(*args), torch, AB_REPS)
        # the exact-f32 products alone through the tree's wrappers, C = 512:
        # the projection at both row counts, dx and the weight gradients at
        # 1,024 rows
        for cell in MODELS:
            plan = bigru_vjp.k45_plan(H, torch.float32, cell)
            for rows in ROWS:
                rng = np.random.RandomState(SEED + rows)
                wih, bih, _whh, bhh = layer_weights(
                    init_rnn_params(rng, 2 * H, H, 1, cell)[0], torch.float32, "cuda")
                G = wih.shape[2]
                x = torch.from_numpy(rng.randn(L, rows, 2 * H).astype(np.float32)).cuda()
                res["ms"]["proj {} rows={} float32".format(cell, rows)] = time_ms(
                    lambda: bigru.simt_projection(x.view(L * rows, 2 * H), wih, bih, bhh, cell),
                    torch, AB_REPS)
                if rows != ROWS[0]:
                    continue
                dxg = torch.from_numpy(rng.randn(2, L * rows, G).astype(np.float32)).cuda()
                dhg = (torch.from_numpy(rng.randn(2, L * rows, G).astype(np.float32)).cuda()
                       if cell == "gru" else dxg)
                out = torch.from_numpy(rng.randn(L, rows, 2 * H).astype(np.float32)).cuda()
                res["ms"]["dx {} rows={} float32".format(cell, rows)] = time_ms(
                    lambda: bigru_vjp.k5_dx(dxg, wih, plan, torch.float32), torch, AB_REPS)
                res["ms"]["wgrad {} rows={} float32".format(cell, rows)] = time_ms(
                    lambda: bigru_vjp.k5_weight_grads(x, out, dxg, dhg, plan, torch.float32),
                    torch, AB_REPS)
                del dxg, dhg, out
            del x
    emit(res)


def main_ab(parent):
    """Parent, change, change, parent: one process a turn (``_time_tree``);
    the last line holds each shape's two medians per tree, their ratio and
    the parent's own spread (its larger turn over its smaller: a ratio
    within it is noise)."""
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
                        / statistics.mean(parent_ms),
                        "parent_spread": max(parent_ms) / min(parent_ms)}
    emit({"phase": "ab", "order": "parent, change, change, parent",
          "parent": os.path.abspath(parent), "card": smi, "ms": summary})


# --ab-step and --ab-small: rounds of turns, one process a turn, each round
# every tree once, the order reversed every other round
AB_STEP_PAIRS = 10


def _step_tree(tree):
    """One turn of ``--ab-step``: through the package of the checkout at
    ``tree``, the profile phase's full-width fp32 training step of each
    model (host ms and device ms a step) and K6's bf16 backward at the
    train-kernel phase's C = 11 (1024 rows) whole and phase by phase: the
    recurrence, dx, the weight gradients with their sum, and their two
    launches apart (``_wgrad_split``); medians of CUDA-event timings, one
    JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"phase": "ab_step_turn", "tree": os.path.abspath(tree),
           "package": os.path.dirname(os.path.dirname(V.__file__)), "ms": {}}
    for cell in MODELS:
        prof = phase_profile(torch, "", cell, check_kernels=False)
        res["ms"]["{} step host".format(MODELS[cell])] = prof["step_ms_host"]
        res["ms"]["{} step device".format(MODELS[cell])] = prof["device_ms_per_step"]
    dt = torch.bfloat16
    rng = np.random.RandomState(SEED + C)  # the --ab turn's inputs
    ld = init_rnn_params(rng, C, H, 1, "lstm")[0]
    x_np = rng.randn(L, ROWS[0], C).astype(np.float32)
    dout_np = rng.randn(L, ROWS[0], 2 * H).astype(np.float32)
    wih, bih, whh, bhh = layer_weights(ld, dt, "cuda")
    x = torch.from_numpy(x_np).to("cuda", dt)
    dout = torch.from_numpy(dout_np).to("cuda", dt)
    out, c, gates = V6.bilstm_layer_train_fwd(x, wih, bih, whh, bhh, dt)
    plan = V.k45_plan(H, dt, "lstm")
    da, part = V6.k6_bwd_recurrence(dout, c, gates, whh, plan, dt)
    fns = {"bwd": lambda: V6.bilstm_layer_bwd(dout, x, wih, whh, out, c, gates, dt),
           "recurrence": lambda: V6.k6_bwd_recurrence(dout, c, gates, whh, plan, dt),
           "dx": lambda: V.k5_dx(da, wih, plan, dt),
           "weight_grads": lambda: V.k5_weight_grads(x, out, da, da, plan, dt, part)}
    fns.update(_wgrad_split(torch, x, out, da, da, part, plan, dt))
    for name, fn in fns.items():
        res["ms"]["k6b C={} bfloat16 {}".format(C, name)] = time_ms(fn, torch, AB_REPS)
    emit(res)


def _small_tree(tree):
    """One turn of ``--ab-small``: through the package of the checkout at
    ``tree``, K4's and K6's fp32 forward and K5's and K6's fp32 backward as
    a caller runs them at the 1s families' 512 rows (C = 11, 28, 512; H 256,
    L 21) and at the aggregate trainer's shape (H 32, C 21, L 11, 512 rows,
    a cluster of one CTA), and at that shape the forward recurrence alone,
    10 launches back to back a timing (the device's time, not the host's),
    ms a launch; medians of CUDA-event timings, one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru_vjp as V
    from ccsmeth_tpu_torch.ops import bilstm_vjp as V6

    f32 = torch.float32
    res = {"phase": "ab_small_turn", "tree": os.path.abspath(tree),
           "package": os.path.dirname(os.path.dirname(V.__file__)), "ms": {}}
    cells = {"gru": ("k4", "k5", V.bigru_layer_train_fwd, V.bigru_layer_bwd),
             "lstm": ("k6f", "k6b", V6.bilstm_layer_train_fwd, V6.bilstm_layer_bwd)}
    with torch.inference_mode():
        for cell, (kf, kb, fwd, bwd) in cells.items():
            for cin, hidden, seq_len, tag in ((C, H, L, "rows=512 C={}".format(C)),
                                              (C2S2, H, L, "rows=512 C={}".format(C2S2)),
                                              (2 * H, H, L, "rows=512 C={}".format(2 * H)),
                                              (AGGR_C, AGGR_H, AGGR_L, "aggr")):
                rng = np.random.RandomState(SEED + cin)  # the --ab turn's inputs
                ld = init_rnn_params(rng, cin, hidden, 1, cell)[0]
                x = torch.from_numpy(rng.randn(seq_len, 512, cin).astype(np.float32)).cuda()
                dout = torch.from_numpy(rng.randn(seq_len, 512, 2 * hidden).astype(
                    np.float32)).cuda()
                wih, bih, whh, bhh = layer_weights(ld, f32, "cuda")
                res["ms"]["{} {} float32".format(kf, tag)] = time_ms(
                    lambda: fwd(x, wih, bih, whh, bhh, f32), torch, AB_REPS)
                args = (dout, x, wih, whh) + tuple(fwd(x, wih, bih, whh, bhh, f32)) + (f32,)
                res["ms"]["{} {} float32".format(kb, tag)] = time_ms(
                    lambda: bwd(*args), torch, AB_REPS)
            # the recurrence at the last shape's inputs: the aggregate's
            plan = V.k45_plan(hidden, f32, cell)
            xg = V.k4_projection(x, wih, bih, bhh, plan, f32)
            if cell == "gru":
                def rec():
                    return V.k4_recurrence(xg, whh, bhh, seq_len, 512, plan, f32)
            else:
                def rec():
                    return V6.k6_recurrence(xg, whh, seq_len, 512, plan, f32)
            res["ms"]["{} aggr float32 recurrence".format(kf)] = time_ms(
                lambda: [rec() for _ in range(10)], torch, AB_REPS) / 10
    emit(res)


def _ab_rounds(flag, phase, parent, others=()):
    """``AB_STEP_PAIRS`` rounds of turns (``flag`` TREE, one process a turn)
    over the parent, the ``others`` (checkouts named by their directory)
    and this checkout ("change"), in that order in even rounds and reversed
    in odd ones; the last line holds each key's median and quartiles per
    tree and each tree's median over the parent's."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False")
    smi = phase_card(torch)[0]
    trees = ([("parent", parent)] + [(os.path.basename(os.path.normpath(t)), t) for t in others]
             + [("change", REPO)])
    turns = {name: [] for name, _tree in trees}
    for i in range(AB_STEP_PAIRS):
        for name, tree in trees if i % 2 == 0 else trees[::-1]:
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag, tree],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit("turn on {} failed:\n{}".format(tree, proc.stderr[-4000:]))
            line = json.loads(proc.stdout.strip().splitlines()[-1])
            log(json.dumps(line))
            turns[name].append(line["ms"])
    summary = {}
    for key in turns["parent"][0]:
        summary[key] = {}
        for name, ts in turns.items():
            q1, med, q3 = statistics.quantiles([t[key] for t in ts], n=4)
            summary[key][name] = {"q1": q1, "median": med, "q3": q3}
        for name in list(turns)[1:]:
            summary[key][name + "_over_parent"] = (summary[key][name]["median"]
                                                   / summary[key]["parent"]["median"])
    emit({"phase": phase, "rounds": AB_STEP_PAIRS, "parent": os.path.abspath(parent),
          "others": [os.path.abspath(t) for t in others], "card": smi, "ms": summary})


def main_only(names):
    """``--only a,b,...``: the card, the build, then only the named phases of
    the one-card training paths (train_kernels, train_kernels_small,
    train_kernels_2s2, determinism, train1s, train_te, transfer, aggr_train,
    wrappers, profile), the exact-f32 products' phase, probe and sweep
    (f32_products, f32_gemm_probe, f32_gemm_sweep), the simt backward's
    sweep and probe
    (k56_bwd_simt_sweep, k56_bwd_simt_probe), the
    multi-process one (dist), K1's and K2's kernel phases (k1_kernels: K1
    at 1,024 and 16,384 rows, K2 at C = 11, 2H and, fp32, the 2s2 family's
    28 and 52, K1 at the aggregate shape), K1's geometry sweeps and probe
    (k1_simt_sweep, k1_tc_sweep, k1_tc_probe) or K3's kernel phase, its
    bf16 design's sweep and probe (k3_kernels, k3_tc_sweep, k3_tc_probe),
    for a short call after a change to one of them; prints no kernels line
    and no ok line."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    smi = phase_card(torch)[0]
    phase_build()
    phases = {
        "train_kernels": lambda: [phase_train_kernels(torch, smi, cell) for cell in MODELS],
        "k56_bwd_simt_sweep": lambda: phase_k56_bwd_simt_sweep(torch, smi),
        "k56_bwd_simt_probe": lambda: phase_k56_bwd_simt_probe(torch, smi),
        "k46_fwd_simt_sweep": lambda: phase_k46_fwd_simt_sweep(torch, smi),
        "k46_fwd_simt_probe": lambda: phase_k46_fwd_simt_probe(torch, smi),
        "profile": lambda: [phase_profile(torch, smi, cell) for cell in MODELS],
        "train_kernels_2s2": lambda: [
            phase_train_kernels(torch, smi, cell, (C2S2,)) for cell in MODELS] + [
            phase_k2_kernels(torch, smi, "lstm", (C2S2,), ("float32",))],
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
        "k1_kernels": lambda: ([phase_kernels(torch, smi, cell) for cell in MODELS]
                               + [phase_k2_kernels(torch, smi, cell) for cell in MODELS]
                               + [phase_k2_kernels(torch, smi, cell, (2 * H,), ("float32",),
                                                   ROWS[1]) for cell in MODELS]
                               + [phase_k2_kernels(torch, smi, cell, (C2S2, C2S2_WIDE),
                                                   ("float32",)) for cell in MODELS]
                               + [phase_k1_aggr(torch, smi)]),
        "k1_simt_sweep": lambda: phase_k1_simt_sweep(torch, smi),
        "k1_rows_sweep": lambda: phase_k1_rows_sweep(torch, smi),
        "k1_rows_probe": lambda: phase_k1_rows_probe(torch, smi),
        "k1_simt_probe": lambda: phase_k1_simt_probe(torch, smi),
        "k1_tc_sweep": lambda: phase_k1_tc_sweep(torch, smi),
        "k1_tc_probe": lambda: phase_k1_tc_probe(torch, smi),
        "k3_kernels": lambda: phase_k3_kernels(torch, smi),
        "k3_tc_sweep": lambda: phase_k3_tc_sweep(torch, smi),
        "k3_tc_probe": lambda: phase_k3_tc_probe(torch, smi),
        "k3_simt_probe": lambda: phase_k3_simt_probe(torch, smi),
        "k3_simt_sweep": lambda: phase_k3_simt_sweep(torch, smi),
        "dist": lambda: phase_dist(torch, smi),
        "f32_products": lambda: phase_f32_products(torch, smi),
        "f32_gemm_probe": lambda: phase_f32_gemm_probe(torch, smi),
        "f32_gemm_sweep": lambda: phase_f32_gemm_sweep(torch, smi),
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
    if len(sys.argv) == 3 and sys.argv[1] == "--step-tree":
        return _step_tree(sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--ab-step":
        return _ab_rounds("--step-tree", "ab_step", sys.argv[2])
    if len(sys.argv) == 3 and sys.argv[1] == "--small-tree":
        return _small_tree(sys.argv[2])
    if len(sys.argv) >= 3 and sys.argv[1] == "--ab-small":
        return _ab_rounds("--small-tree", "ab_small", sys.argv[2], sys.argv[3:])
    if len(sys.argv) == 5 and sys.argv[1] == "--train-digest":
        return _train_digest(*sys.argv[2:])
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        return main_only(sys.argv[2].split(","))
    if len(sys.argv) == 8 and sys.argv[1] == "--dist-rank":
        return _dist_rank(int(sys.argv[2]), sys.argv[3], [int(p) for p in sys.argv[4:]])
    if len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py [--ab PARENT_TREE | --ab-step PARENT_TREE | "
                 "--ab-small PARENT_TREE [TREE ...] | --only PHASE,...]")
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
    # K2 at batch 8,192's rows, where the rows design runs it
    k2_rows = {cell: phase_k2_kernels(torch, smi, cell, (2 * H,), ("float32",), ROWS[1])[0]
               for cell in MODELS}
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
    f32 = phase_f32_products(torch, smi)
    lap("train_kernels")
    for model_type in list(MODELS.values()) + [TRANSENC]:
        phase_model(torch, model_type)
    m2s2 = {cell: phase_model2s2(torch, smi, cell) for cell in MODELS}
    lap("model")
    e2e = {cell: phase_e2e(torch, smi, MODELS[cell]) for cell in MODELS}
    e2e_k3 = phase_e2e(torch, smi, TRANSENC)
    e2e_rows = {cell: phase_e2e_rows(torch, smi, MODELS[cell], e2e[cell]["tags"]["fp32"])
                for cell in MODELS}
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
    dist = phase_dist(torch, smi)
    lap("dist")
    phase_wrappers()
    for cell in MODELS:
        phase_profile(torch, smi, cell)
    lap("wrappers_profile")
    emit({"phase": "walls", "s": laps, "total_s": time.time() - t_start})
    k1_keys = ("rows", "C", "dtype", "kernel_ms", "plain_ms", "library_ms", "bound_ms",
               "bound_by", "max_abs_err_out", "max_abs_err_hn")

    from ccsmeth_tpu_torch.ops import bigru

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
                "simt_geometry": mc["simt"], "tc_geometry": mc["tc"],
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
            if design == "tc":  # its projections by kernel in the bf16 e2e run
                entry["sources"] = list(TC_SOURCES)
                entry["tc_projections"] = e2e[cell]["runs"]["bf16"]["tc_projections"]
            if design == "simt":  # the train paths validate in fp32
                entry["launches_train_path"] = train_runs[cell]["launches"]["k1"]
                if cell == "gru":  # both ranks' validations
                    entry["launches_dist"] = dist["launches"]["k1_validation"]
                entry["launches_train_path_2s2"] = train2s2[cell]["launches"]["k1"]
                entry["launches_train_path_1s"] = train1s[cell]["k1_launches"]
                entry["projection_source"] = SIMT_PROJECTION
                if cell == "gru":
                    entry["launches_text_path"] = text[MODELS[cell]]["launches"]
                    entry["launches_flags"] = (
                        sum(sh["launches"] for sh in flags["processes"]["shards"])
                        + flags["profile"]["batches"])
            kernels.append(entry)
        # the rows design: fp32 from its crossover up, its main path the
        # batch-8,192 call_mods run
        cells = [c for c in k1_cells[cell] if c["design"] == "rows"]
        mc = next(c for c in cells if c["rows"] == ROWS[1] and not c["forced"])
        kernels.append({
            "name": kname + "_rows", "route": "cuda", "design": "rows",
            "cuda_launches_per_call": mc["cuda_launches_per_call"],
            "source": "ccsmeth_tpu_torch/ops/csrc/birnn_rows.cu",
            "projection_source": SIMT_PROJECTION,
            "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:{}".format(line),
            "launches": e2e_rows[cell]["k1"]["launches"]["k1"],
            "cuda_launches": e2e_rows[cell]["k1"]["cuda_launches"]["k1"],
            "max_abs_err": max(max(c["max_abs_err_out"], c["max_abs_err_hn"]) for c in cells),
            "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
            "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
            "library_ms": mc["library_ms"], "phases_ms": mc["phases_ms"],
            "recurrence_tflops": mc["recurrence_tflops"], "rows_geometry": mc["rows_design"],
            "crossover_rows": bigru.ROWS_CROSSOVER,
            "simt_ms_same_input": next(c["kernel_ms"] for c in k1_cells[cell]
                                       if c["design"] == "simt" and c["rows"] == ROWS[1]),
            "cell": "{} rows={} float32".format(MODELS[cell], ROWS[1]),
            "cells": [{k: c[k] for k in k1_keys + ("forced", "recurrence_tflops")}
                      for c in cells]})
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
            "launches_dist": dist["launches"]["k1_aggregate"] if cell == "gru" else 0,
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
                "fwd_recurrence": mc.get("fwd_recurrence"),
                "bwd_recurrence": mc.get("bwd_recurrence"),
                # the backward's dx and weight-gradient products: their
                # kernel, TFLOP/s beside torch.mm's, tiles and waves
                "products": mc.get("products"),
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
                                      if cell == "gru" else 0),
                "launches_dist": (dist["launches"]["k4" if key == "fwd" else "k5"]
                                  if (cell, design) == ("gru", "simt") else 0)})
            if key == "bwd":
                # the backward products: their rates beside torch.mm's, and in
                # tc the bf16 steps' products by kernel
                kernels[-1]["products"] = mc["products"]
                if design == "tc":
                    kernels[-1]["gemm_calls"] = train_runs[cell]["bf16_launches"]["gemm_calls"]
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
                "simt_geometry": mc["simt"],
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
        mc, run = k2_rows[cell], e2e_rows[cell]["k2"]
        kernels.append({
            "name": kname + "_rows", "route": "cuda", "design": "rows",
            "cuda_launches_per_call": mc["cuda_launches_per_call"],
            "source": "ccsmeth_tpu_torch/ops/csrc/birnn_rows.cu",
            "projection_source": SIMT_PROJECTION,
            "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:{}".format(line),
            "launches": run["launches"]["k2"], "cuda_launches": run["cuda_launches"]["k2"],
            "max_abs_err": mc["max_abs_err"], "ms": mc["kernel_ms"],
            "plain_ms": mc["plain_ms"], "bound_ms": mc["bound_ms"],
            "bound_by": mc["bound_by"], "library_ms": mc["library_ms"],
            "phases_ms": mc["phases_ms"], "rows_geometry": mc["rows_design"],
            "simt_forced": mc["simt_forced"],
            "cell": "{} rows={} C={} float32".format(MODELS[cell], mc["rows"], mc["C"])})
    # the exact-f32 product kernel: the projection of K1's and K2's fp32
    # designs and of the simt forwards, and the simt backward's dx and weight
    # gradients; main cell attbigru2s's layer at C = 512, 1,024 rows
    for prod, names, line in (("projection", ("projection",), "bigru_pallas.py:198"),
                              ("backward", ("dx", "wgrad"), "bigru_pallas_vjp.py:63")):
        cells = [c for c in f32["cells"] if c["product"] in names]
        main_cells = [c for c in cells if (c["cell"], c["rows"]) == ("gru", ROWS[0])]
        launches = (sum(e2e[cell]["runs"]["fp32"]["f32_products"]["projection"]
                        for cell in MODELS) if prod == "projection" else
                    sum(train_runs[cell]["launches"]["f32_products"][n] for cell in MODELS
                        for n in names))
        kernels.append({
            "name": "{}_{}".format(F32_KERNEL, prod), "route": "cuda",
            "source": SIMT_PROJECTION, "replaces": "ccsmeth_tpu/ops/" + line,
            "launches": launches,
            "launches_by": ("call_mods fp32 e2e runs, both RNN cells" if prod == "projection"
                            else "fp32 train runs, both RNN cells"),
            "max_abs_err": max(c["max_abs_err"] for c in cells),
            "ms": sum(c["ms"] for c in main_cells),
            "plain_ms": sum(c["plain_ms"] for c in main_cells),
            "bound_ms": sum(c["bound_ms"] for c in main_cells), "bound_by": "operations",
            # one call: torch.matmul of x with both directions' W_ih (TF32 off);
            # the backward's products take five torch.mm calls (torch_mm_ms)
            "library_ms": main_cells[0]["library_ms"] if prod == "projection" else None,
            "torch_mm_ms": sum(c["torch_mm_ms"] for c in main_cells),
            "cell": "attbigru2s layer C=512 rows={} float32".format(ROWS[0]),
            "cells": cells})
    emit({"kernels": kernels})
    log("chip_smoke: {:.1f} s on {}".format(time.time() - t_start, smi))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
