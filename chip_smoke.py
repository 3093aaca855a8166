#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ccsmeth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; every failed check raises, so the script exits non-zero and
does not print its last line:

  1. the card: nvidia-smi name and power limit, torch's device name; TF32 off;
  2. build: every kernel of the main path is compiled from the checkout;
  3. kernels: kernel K1 (ops/csrc/bigru_stack.cu) at the main path's shapes
     (attbigru2s: NL=3, H=256, L=21, C=11; 2B = 1024 and 16384 rows, fp32 and
     bf16) against its plain PyTorch version on the card, timed with CUDA
     events beside the plain version, cuDNN's nn.GRU and the card's bound;
  4. model: full-width attbigru2s with numpy-seeded weights, probs through K1
     against probs through the plain version;
  5. end to end: the port's CLI ``call_mods --mode align --device cuda`` on a
     simulated aligned BAM, in fp32 and bf16, with K1's launch count read
     around the runs;
  6. one ``kernels`` JSON line, then the ``ok`` line.

It needs a CUDA device and the repository checkout around it; without either it
exits with an error and prints no result. It writes only under build/ of the
checkout.
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

# attbigru2s at full width (ccsmeth_tpu/models/config.py defaults)
NL, H, L, C = 3, 256, 21, 11
ROWS = (1024, 16384)  # 2B for batch 512 (the CLI default) and batch 8192
REPS = 11
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 CUDA
# cores, HBM3 bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
# E2E input: ~62k CpG sites on 330 HiFi-like 2 kb reads
E2E_READS, E2E_READ_LEN, E2E_REF_LEN = 330, 2000, 300_000


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
    from ccsmeth_tpu_torch.ops import bigru

    t0 = time.time()
    so = bigru.build()
    secs = time.time() - t0
    regs = [ln.strip() for ln in bigru.build_log.splitlines()
            if "registers" in ln or "spill" in ln]
    log("build: {} in {:.1f} s".format(os.path.relpath(so, REPO), secs))
    for ln in regs:
        log("  ptxas: " + ln)
    return secs


def _layers(torch, dtype, device):
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights

    rng = np.random.RandomState(SEED)
    layers_np = init_rnn_params(rng, C, H, NL)
    return layers_np, [layer_weights(ld, dtype, device) for ld in layers_np]


def phase_kernels(torch, smi):
    import numpy as np

    from ccsmeth_tpu_torch.ops import bigru

    cells = []
    for rows in ROWS:
        x_np = np.random.RandomState(SEED + rows).randn(L, rows, C).astype(np.float32)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            layers_np, ly = _layers(torch, dt, "cuda")
            x = torch.from_numpy(x_np).to("cuda", dt).contiguous()
            out, hn = bigru.birnn_stack(ly, x, dt)
            torch.cuda.synchronize()
            ref_out, ref_hn = bigru.birnn_stack_plain(ly, x, dt)
            assert out.shape == (L, rows, 2 * H) and hn.shape == (2 * NL, rows, H)
            assert bool(torch.isfinite(out.float()).all())
            assert bool(torch.isfinite(hn).all())
            err_out = (out.float() - ref_out.float()).abs().max().item()
            err_hn = (hn - ref_hn).abs().max().item()
            assert max(err_out, err_hn) <= TOL[dname], (rows, dname, err_out, err_hn)

            # cuDNN's bidirectional GRU with the same weights: the yardstick
            gru = torch.nn.GRU(C, H, NL, bidirectional=True).to("cuda", dt)
            with torch.no_grad():
                for k, ld in enumerate(layers_np):
                    for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                        for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                          ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                            getattr(gru, "{}_l{}{}".format(name, k, suf)).copy_(
                                torch.from_numpy(ld[d][key]))
            gru.flatten_parameters()
            with torch.inference_mode():
                kernel_ms = time_ms(lambda: bigru.birnn_stack(ly, x, dt), torch)
                plain_ms = time_ms(lambda: bigru.birnn_stack_plain(ly, x, dt), torch)
                library_ms = time_ms(lambda: gru(x), torch)
            flops = bigru.stack_flops(L, rows, C, H, NL)
            nbytes = (x.numel() * x.element_size()
                      + sum(t.numel() * t.element_size() for lyr in ly for t in lyr)
                      + out.numel() * out.element_size() + hn.numel() * 4)
            t_ops = flops / PEAK_FLOPS[dname] * 1e3
            t_bytes = nbytes / PEAK_BYTES * 1e3
            cell = {"phase": "kernel", "name": "bigru_stack", "rows": rows,
                    "dtype": dname, "max_abs_err_out": err_out,
                    "max_abs_err_hn": err_hn, "tol": TOL[dname],
                    "kernel_ms": kernel_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": max(t_ops, t_bytes),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "gflop": flops / 1e9,
                    "tflops_achieved": flops / kernel_ms / 1e9, "card": smi}
            emit(cell)
            cells.append(cell)
            del gru, out, hn, ref_out, ref_hn
    return cells


def _model_feats(B, seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    feats = {}
    for s in ("", "2"):
        feats["kmer" + s] = rng.randint(0, 4, (B, L)).astype(np.float32)
        feats["kpass" + s] = rng.randint(3, 25, (B, 1)).repeat(L, 1).astype(np.float32)
        feats["ipd_means" + s] = rng.randn(B, L).astype(np.float32)
        feats["pw_means" + s] = rng.randn(B, L).astype(np.float32)
    return feats


def phase_model(torch):
    from ccsmeth_tpu_torch.models import AttRNNConfig, init_attrnn
    from ccsmeth_tpu_torch.ops import bigru
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model

    cfg = AttRNNConfig()
    model = build_model(init_attrnn(SEED, cfg), cfg, "cuda")
    feats = {k: torch.from_numpy(v).cuda() for k, v in _model_feats(512, SEED).items()}
    res = {}
    for dname, tol in (("float32", 1e-4), ("bfloat16", 2.0 / 256)):
        dt = getattr(torch, dname)
        with torch.inference_mode():
            _l, p_k = model(feats, compute_dtype=dt)
            _l, p_p = model(feats, compute_dtype=dt, rnn_fn=bigru.birnn_stack_plain)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(p_k).all())
        err = (p_k - p_p).abs().max().item()
        assert err < tol, (dname, err)
        res[dname] = err
        emit({"phase": "model", "model": "attbigru2s 3x256", "batch": 512,
              "dtype": dname, "max_abs_err_probs": err, "tol": tol})
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


def phase_e2e(torch, smi):
    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import AttRNNConfig, init_attrnn
    from ccsmeth_tpu_torch.models.params_io import save_params
    from ccsmeth_tpu_torch.ops import bigru
    from ccsmeth_tpu_torch.pipeline import call_mods
    from ccsmeth_tpu_torch.utils.simulate import make_synth_bam, write_fasta

    os.makedirs(WORK, exist_ok=True)
    bam = os.path.join(WORK, "reads.bam")
    fasta = os.path.join(WORK, "ref.fa")
    ckpt = os.path.join(WORK, "attbigru2s_3x256.ckpt.npz")
    t0 = time.time()
    refseq, _ = make_synth_bam(bam, n_reads=E2E_READS, read_len=E2E_READ_LEN,
                               ref_len=E2E_REF_LEN, seed=SEED)
    write_fasta(fasta, {"chrS": refseq})
    save_params(ckpt, init_attrnn(SEED, AttRNNConfig()))
    log("e2e input: {} reads x {} bp, simulated in {:.1f} s".format(
        E2E_READS, E2E_READ_LEN, time.time() - t0))

    tags, runs = {}, {}
    bigru.launches = 0
    bigru.plain_calls = 0
    total_launches = 0
    for prec in ("fp32", "bf16"):
        before = bigru.launches
        prefix = os.path.join(WORK, "mods_" + prec)
        cli.main(["call_mods", "-i", bam, "-o", prefix, "-m", ckpt,
                  "--mode", "align", "--ref", fasta, "--device", "cuda",
                  "--precision", prec])
        torch.cuda.synchronize()
        run = dict(call_mods.LAST_RUN)
        n = bigru.launches - before
        total_launches += n
        assert run["batches"] > 0 and n == run["batches"], (prec, n, run)
        tags[prec] = _read_tags(prefix + ".modbam.bam")
        n_tagged = sum(1 for mm, ml in tags[prec].values() if ml is not None)
        assert n_tagged >= 0.9 * len(tags[prec]), (prec, n_tagged)
        run.update(phase="e2e", precision=prec, k1_launches=n,
                   sites_per_s=run["sites"] / run["seconds"],
                   reads_with_mm_ml=n_tagged, card=smi)
        emit(run)
        runs[prec] = run
    assert bigru.plain_calls == 0  # the CUDA path never ran the plain version
    assert total_launches == bigru.launches
    assert runs["fp32"]["sites"] >= 50_000, runs["fp32"]["sites"]

    n_sites = n_close = 0
    for q, (mm, ml) in tags["fp32"].items():
        mm_b, ml_b = tags["bf16"][q]
        assert mm == mm_b, q
        if ml is None:
            continue
        n_sites += ml.size
        n_close += int((np.abs(ml - ml_b) <= 2).sum())
    frac = n_close / n_sites
    emit({"phase": "e2e", "fp32_vs_bf16_ml_within_2": frac, "sites": n_sites})
    assert frac >= 0.999, frac
    return total_launches, runs


def main():
    if not os.path.isdir(os.path.join(REPO, "ccsmeth_tpu_torch")):
        sys.exit("chip_smoke.py: the ccsmeth_tpu_torch package is not beside "
                 "this script; run it from a checkout of the repository")
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is False; this "
                 "smoke test needs a CUDA device")
    sys.path.insert(0, REPO)
    t_start = time.time()
    smi, name = phase_card(torch)
    phase_build()
    cells = phase_kernels(torch, smi)
    phase_model(torch)
    launches, _runs = phase_e2e(torch, smi)
    main_cell = next(c for c in cells if c["rows"] == ROWS[0] and c["dtype"] == "float32")
    emit({"kernels": [{
        "name": "bigru_stack", "route": "cuda",
        "source": "ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu",
        "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:198",
        "launches": launches,
        "max_abs_err": max(max(c["max_abs_err_out"], c["max_abs_err_hn"])
                           for c in cells),
        "ms": main_cell["kernel_ms"], "plain_ms": main_cell["plain_ms"],
        "bound_ms": main_cell["bound_ms"], "bound_by": main_cell["bound_by"],
        "library_ms": main_cell["library_ms"],
        "cell": "rows={} float32".format(ROWS[0]),
        "cells": [{k: c[k] for k in ("rows", "dtype", "kernel_ms", "plain_ms",
                                     "library_ms", "bound_ms", "bound_by",
                                     "max_abs_err_out", "max_abs_err_hn")}
                  for c in cells]}]})
    log("chip_smoke: {:.1f} s on {}".format(time.time() - t_start, smi))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
