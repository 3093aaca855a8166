#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (ccsmeth_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; every failed check raises, so the script exits non-zero and
does not print its last line:

  1. the card: nvidia-smi name and power limit, torch's device name; TF32 off;
  2. build: every kernel source of the main paths is compiled from the
     checkout, one nvcc per source, all started together;
  3. kernels: kernel K1 (ops/csrc/bigru_stack.cu) at the call_mods path's
     shapes (attbigru2s: NL=3, H=256, L=21, C=11; 2B = 1024 and 16384 rows,
     fp32 and bf16) against its plain PyTorch version on the card, timed with
     CUDA events beside the plain version, cuDNN's nn.GRU and the card's bound;
  4. training kernels: K4 and K5 (ops/csrc/bigru_train.cu) at the train
     path's shapes (one layer, H=256, L=21, 2B = 1024 rows, C = 11 and 512,
     fp32 and bf16) against their plain versions, K5 run twice for bit-equal
     gradients, timed beside the plain versions, cuDNN's one-layer
     bidirectional nn.GRU (forward in training mode, and backward) and the
     bound;
  5. model: full-width attbigru2s with numpy-seeded weights, probs through K1
     against probs through the plain version;
  6. call_mods end to end: the port's CLI ``call_mods --mode align --device
     cuda`` on a simulated aligned BAM, in fp32 and bf16, with K1's launch
     count read around the runs;
  7. train end to end: the port's CLI ``train --device cuda`` at the
     attbigru2s defaults (3x256, batch 512, dropout 0.5, Adam) on a separable
     synthetic features TSV, with K4/K5/K1 launch counts read around the run,
     then a few bf16 steps;
  8. profile: torch.profiler over a few full-width training steps, device
     time per kernel and the device's idle share;
  9. one ``kernels`` JSON line, then the ``ok`` line.

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
# train input: separable synthetic features, 32 steps of batch 512 an epoch
TRAIN_ROWS, VALID_ROWS, TRAIN_EPOCHS, STEP_INTERVAL = 16384, 4096, 3, 8
BF16_TRAIN_ROWS = 2048


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

    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp

    def build(mod):
        t0 = time.time()
        so = mod.build()
        return so, time.time() - t0

    mods = (bigru, bigru_vjp)
    t0 = time.time()
    with ThreadPoolExecutor(len(mods)) as ex:
        built = list(ex.map(build, mods))
    for mod, (so, secs) in zip(mods, built):
        log("build: {} in {:.1f} s".format(os.path.relpath(so, REPO), secs))
        for ln in mod.build_log.splitlines():
            if "registers" in ln or "spill" in ln:
                log("  ptxas: " + ln.strip())
    secs = time.time() - t0
    log("build: all kernels in {:.1f} s".format(secs))
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


def _bound(flops, nbytes, dname):
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_train_kernels(torch, smi):
    """K4 and K5 for one layer at the train path's shapes against their plain
    versions. Tolerances: fp32 out, gates and dx 1e-5; dW and db
    1e-5 * max|ref| + 1e-5, since they sum L * 2B = 21,504 rows in another
    order. bf16 (against the plain version with bf16 operands): out and gates
    1e-2, one bf16 ulp on [0.5, 1) where an f32 sum in another order rounds
    the other way; dx, dW and db 1e-2 * max|ref| + 1e-5, since a dxg/dhg
    operand rounded to bf16 the other way moves one product by 2^-8 of it."""
    import numpy as np

    from ccsmeth_tpu_torch.models.rnn import init_rnn_params, layer_weights
    from ccsmeth_tpu_torch.ops import bigru_vjp as V

    rows = ROWS[0]
    cells = []
    for cin in (C, 2 * H):
        rng = np.random.RandomState(SEED + cin)
        ld = init_rnn_params(rng, cin, H, 1)[0]
        x_np = rng.randn(L, rows, cin).astype(np.float32)
        dout_np = rng.randn(L, rows, 2 * H).astype(np.float32)
        for dname in ("float32", "bfloat16"):
            dt = getattr(torch, dname)
            f32 = dt == torch.float32
            wih, bih, whh, bhh = layer_weights(ld, dt, "cuda")
            x = torch.from_numpy(x_np).to("cuda", dt)
            dout = torch.from_numpy(dout_np).to("cuda", dt)
            out, gates = V.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt)
            ref_out, ref_gates = V.bigru_layer_train_fwd_plain(x, wih, bih, whh, bhh, dt)
            # both backward versions get the same residuals
            args = (dout, x, wih, whh, ref_out, ref_gates, dt)
            got = V.bigru_layer_bwd(*args)
            again = V.bigru_layer_bwd(*args)
            torch.cuda.synchronize()
            ref = V.bigru_layer_bwd_plain(*args)
            names = ("dx", "dw_ih", "db_ih", "dw_hh", "db_hh")
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                "K5 is not bit-equal across two runs"
            errs = {"out": (out.float() - ref_out.float()).abs().max().item(),
                    "gates": (gates.float() - ref_gates.float()).abs().max().item()}
            tols = {"out": 1e-5 if f32 else 1e-2, "gates": 1e-5 if f32 else 1e-2}
            for nm, a, r in zip(names, got, ref):
                assert bool(torch.isfinite(a).all()), nm
                errs[nm] = (a - r).abs().max().item()
                scale = r.abs().max().item()
                tols[nm] = (1e-5 if (f32 and nm == "dx") else
                            (1e-5 if f32 else 1e-2) * scale + 1e-5)
            bad = {k: (errs[k], tols[k]) for k in errs if errs[k] > tols[k]}
            assert not bad, (cin, dname, bad)

            # cuDNN's one-layer bidirectional GRU with the same weights
            gru = torch.nn.GRU(cin, H, 1, bidirectional=True).to("cuda", dt)
            with torch.no_grad():
                for d, suf in (("fwd", ""), ("bwd", "_reverse")):
                    for name, key in (("weight_ih", "w_ih"), ("weight_hh", "w_hh"),
                                      ("bias_ih", "b_ih"), ("bias_hh", "b_hh")):
                        getattr(gru, "{}_l0{}".format(name, suf)).copy_(
                            torch.from_numpy(ld[d][key]))
            gru.flatten_parameters()
            gru.train()
            xg = x.detach().clone().requires_grad_(True)
            lib_fwd_ms = time_ms(lambda: gru(xg), torch)
            y = gru(xg)[0]
            lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                y, [xg] + list(gru.parameters()), dout, retain_graph=True), torch)
            k4_ms = time_ms(lambda: V.bigru_layer_train_fwd(x, wih, bih, whh, bhh, dt),
                            torch)
            k5_ms = time_ms(lambda: V.bigru_layer_bwd(*args), torch)
            p4_ms = time_ms(lambda: V.bigru_layer_train_fwd_plain(x, wih, bih, whh,
                                                                  bhh, dt), torch)
            p5_ms = time_ms(lambda: V.bigru_layer_bwd_plain(*args), torch)
            weights = (wih, bih, whh, bhh)
            b4, by4 = _bound(V.train_fwd_flops(L, rows, cin, H),
                             _nbytes(x, *weights, out, gates), dname)
            b5, by5 = _bound(V.train_bwd_flops(L, rows, cin, H),
                             _nbytes(dout, x, wih, whh, out, gates, *got), dname)
            for kname, ms, pms, lms, bms, bby, keys in (
                    ("bigru_train_fwd", k4_ms, p4_ms, lib_fwd_ms, b4, by4,
                     ("out", "gates")),
                    ("bigru_train_bwd", k5_ms, p5_ms, lib_bwd_ms, b5, by5, names)):
                cell = {"phase": "train_kernel", "name": kname, "rows": rows,
                        "C": cin, "H": H, "L": L, "dtype": dname,
                        "max_abs_err": {k: errs[k] for k in keys},
                        "tol": {k: tols[k] for k in keys},
                        "max_abs_err_max": max(errs[k] for k in keys),
                        "kernel_ms": ms, "plain_ms": pms, "library_ms": lms,
                        "bound_ms": bms, "bound_by": bby, "card": smi}
                if kname == "bigru_train_bwd":
                    cell["bit_equal_rerun"] = True
                emit(cell)
                cells.append(cell)
            del gru, xg, y, got, again, ref, out, gates, ref_out, ref_gates
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
                kmer, "10", ",".join(str(round(x, 6)) for x in ipd), ".",
                ",".join(str(round(x, 6)) for x in pw), ".", ".", ".",
                kmer[::-1], "9", ",".join(str(round(x, 6)) for x in rng.randn(seq_len)),
                ".", ",".join(str(round(x, 6)) for x in rng.randn(seq_len)), ".", ".",
                ".", str(label),
            ]
            f.write("\t".join(row) + "\n")


def _train_cli(cli, tr, va, mdir, prec, epochs, interval):
    cli.main(["train", "--train_file", tr, "--valid_file", va, "--model_dir", mdir,
              "--model_type", "attbigru2s", "--device", "cuda", "--precision", prec,
              "--max_epoch_num", str(epochs), "--min_epoch_num", str(epochs),
              "--step_interval", str(interval), "--tseed", str(SEED % 10000)])


def phase_train(torch, smi):
    """The train path at full width: the CLI at its attbigru2s defaults
    (3x256, batch 512, dropout 0.5, Adam 1e-3, StepLR)."""
    import math

    import numpy as np

    from ccsmeth_tpu_torch import cli
    from ccsmeth_tpu_torch.models import AttRNNConfig
    from ccsmeth_tpu_torch.ops import bigru, bigru_vjp
    from ccsmeth_tpu_torch.pipeline.call_mods import build_model, load_model_params
    from ccsmeth_tpu_torch.training.train import LAST_RUN

    os.makedirs(WORK, exist_ok=True)
    tr, va = os.path.join(WORK, "train.tsv"), os.path.join(WORK, "valid.tsv")
    t0 = time.time()
    _write_feature_tsv(tr, TRAIN_ROWS, SEED)
    _write_feature_tsv(va, VALID_ROWS, SEED + 1)
    log("train input: {} + {} rows, {:.1f} + {:.1f} MB, written in {:.1f} s".format(
        TRAIN_ROWS, VALID_ROWS, os.path.getsize(tr) / 1e6, os.path.getsize(va) / 1e6,
        time.time() - t0))
    log("train cut: {} epochs of {} steps (a real run trains up to 50 epochs on "
        "millions of rows)".format(TRAIN_EPOCHS, TRAIN_ROWS // 512))

    bigru_vjp.launches_fwd = bigru_vjp.launches_bwd = bigru_vjp.plain_calls = 0
    bigru.launches = bigru.plain_calls = 0
    t0 = time.time()
    _train_cli(cli, tr, va, os.path.join(WORK, "models_fp32"), "fp32", TRAIN_EPOCHS,
               STEP_INTERVAL)
    torch.cuda.synchronize()
    wall = time.time() - t0
    run = dict(LAST_RUN)
    counts = {"k4": bigru_vjp.launches_fwd, "k5": bigru_vjp.launches_bwd,
              "k1": bigru.launches, "plain_vjp": bigru_vjp.plain_calls,
              "plain_k1": bigru.plain_calls}
    steps = run["steps"]
    n_valid = len(run["valid_losses"])
    assert steps == TRAIN_EPOCHS * (TRAIN_ROWS // 512), steps
    assert counts["k4"] == counts["k5"] == 3 * steps, counts
    assert counts["k1"] == n_valid * math.ceil(VALID_ROWS / 512) > 0, counts
    assert counts["plain_vjp"] == 0 and counts["plain_k1"] == 0, counts
    assert np.all(np.isfinite(run["train_losses"] + run["valid_losses"])), run
    assert run["best_accuracy"] >= 0.9, run["best_accuracy"]
    # the checkpoint loads into the port's call_mods model
    cfg = AttRNNConfig(dropout_rate=0.0)
    model = build_model(load_model_params(run["ckpts"][-1], cfg), cfg, "cuda")
    feats = {k: torch.from_numpy(v).cuda() for k, v in _model_feats(512, SEED).items()}
    with torch.inference_mode():
        _l, probs = model(feats)
    assert probs.shape == (512, 2) and bool(torch.isfinite(probs).all())

    per_epoch = steps / TRAIN_EPOCHS
    steady = float(np.mean(run["epoch_wall_s"][1:]))
    res = {"phase": "train", "precision": "fp32", "model": "attbigru2s 3x256",
           "batch": 512, "steps": steps, "epochs": TRAIN_EPOCHS,
           "validations": n_valid, "launches": counts,
           "best_accuracy": run["best_accuracy"],
           "train_losses": run["train_losses"], "valid_losses": run["valid_losses"],
           "epoch_wall_s": run["epoch_wall_s"], "wall_s": wall,
           "steps_per_s_steady": per_epoch / steady,
           "samples_per_s_steady": per_epoch * 512 / steady,
           "steps_per_s_first_epoch": per_epoch / run["epoch_wall_s"][0],
           "card": smi}
    emit(res)

    # a few steps in bf16
    tr16 = os.path.join(WORK, "train_bf16.tsv")
    _write_feature_tsv(tr16, BF16_TRAIN_ROWS, SEED + 2)
    before = bigru_vjp.launches_fwd
    _train_cli(cli, tr16, va, os.path.join(WORK, "models_bf16"), "bf16", 1,
               BF16_TRAIN_ROWS // 512)
    torch.cuda.synchronize()
    run16 = dict(LAST_RUN)
    assert bigru_vjp.launches_fwd - before == 3 * run16["steps"] > 0
    assert np.all(np.isfinite(run16["train_losses"] + run16["valid_losses"])), run16
    assert bigru_vjp.plain_calls == 0
    emit({"phase": "train", "precision": "bf16", "steps": run16["steps"],
          "train_losses": run16["train_losses"],
          "valid_losses": run16["valid_losses"],
          "best_accuracy": run16["best_accuracy"], "card": smi})
    return res


def phase_profile(torch, smi, steps=5):
    """Where a full-width training step's time goes: torch.profiler over
    ``steps`` steps (attbigru2s 3x256, batch 512, fp32, dropout 0.5, Adam)
    after two warm-up steps; device time per kernel name, the device's busy
    time against the host clock, and the step time. Launches here are not
    the train path's and are read nowhere."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from ccsmeth_tpu_torch.models import AttRNN, AttRNNConfig
    from ccsmeth_tpu_torch.training import build_optimizer
    from ccsmeth_tpu_torch.training.train import make_train_step

    model = AttRNN(AttRNNConfig()).cuda()
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
    res = {"phase": "profile", "what": "train step, attbigru2s 3x256, batch 512, fp32",
           "steps": steps, "step_ms_host": wall_ms, "device_ms_per_step": device_ms,
           "device_idle_share": (1.0 - device_ms / wall_ms) if device_ms else None,
           "top": [{"kernel": k[:90], "ms_per_step": ms, "calls_per_step": n}
                   for ms, n, k in rows[:12]], "card": smi}
    if not rows:
        log("profile: torch.profiler recorded no device time")
    emit(res)
    return res


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
    tcells = phase_train_kernels(torch, smi)
    phase_model(torch)
    launches, _runs = phase_e2e(torch, smi)
    train_run = phase_train(torch, smi)
    phase_profile(torch, smi)
    main_cell = next(c for c in cells if c["rows"] == ROWS[0] and c["dtype"] == "float32")
    k1 = {"name": "bigru_stack", "route": "cuda",
          "source": "ccsmeth_tpu_torch/ops/csrc/bigru_stack.cu",
          "replaces": "ccsmeth_tpu/ops/bigru_pallas.py:198",
          "launches": launches,
          "launches_train_path": train_run["launches"]["k1"],
          "max_abs_err": max(max(c["max_abs_err_out"], c["max_abs_err_hn"])
                             for c in cells),
          "ms": main_cell["kernel_ms"], "plain_ms": main_cell["plain_ms"],
          "bound_ms": main_cell["bound_ms"], "bound_by": main_cell["bound_by"],
          "library_ms": main_cell["library_ms"],
          "cell": "rows={} float32".format(ROWS[0]),
          "cells": [{k: c[k] for k in ("rows", "dtype", "kernel_ms", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by",
                                       "max_abs_err_out", "max_abs_err_hn")}
                    for c in cells]}
    kernels = [k1]
    for kname, key, line in (("bigru_train_fwd", "k4", 31), ("bigru_train_bwd", "k5", 63)):
        mine = [c for c in tcells if c["name"] == kname]
        # the main cell: layers 1 and 2 of the stack (C = 2H), fp32
        mc = next(c for c in mine if c["C"] == 2 * H and c["dtype"] == "float32")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ccsmeth_tpu_torch/ops/csrc/bigru_train.cu",
            "replaces": "ccsmeth_tpu/ops/bigru_pallas_vjp.py:{}".format(line),
            "launches": train_run["launches"][key],
            "max_abs_err": max(c["max_abs_err_max"] for c in mine),
            "ms": mc["kernel_ms"], "plain_ms": mc["plain_ms"],
            "bound_ms": mc["bound_ms"], "bound_by": mc["bound_by"],
            "library_ms": mc["library_ms"],
            "cell": "rows={} C={} float32".format(mc["rows"], mc["C"]),
            "cells": [{k: c[k] for k in ("rows", "C", "dtype", "kernel_ms", "plain_ms",
                                         "library_ms", "bound_ms", "bound_by",
                                         "max_abs_err_max")} for c in mine]})
    emit({"kernels": kernels})
    log("chip_smoke: {:.1f} s on {}".format(time.time() - t_start, smi))
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
