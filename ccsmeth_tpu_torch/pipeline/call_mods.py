"""call_mods: BAM/SAM -> modbam with MM/ML tags, or a features TSV ->
per_readsite TSV, on one GPU.

Counterpart of ``ccsmeth_tpu/pipeline/call_mods.py`` (``call_mods_bam :378``,
``call_mods_txt :736``). The BAM path is the same threaded pipeline around one
device step:

  reader+extractor thread(s)  ->  bounded queue of padded FeatureBatches
  main thread                 ->  predict step (parallel/predict.py) on the card
  writer thread               ->  MM/ML tagging + BAM encode

The TSV path parses rows in groups of batch_size * max(4, dispatch_fuse),
dispatches their padded batches through the same predict step and writes one
row a site.

On both inputs, as in the JAX package: ``--num_processes N --process_id k``
keeps the reads that ``parallel/distributed.py::owns_read`` gives process k
(by read name; a TSV row's column 4), so the N outputs together are the
single run's; ``--h0_mode randn`` replays the reference's per-forward
``torch.randn`` initial states (``_make_h0_stream``), which the model runs
through the plain BiRNN, since K1 and K2 are zero-h0; ``--profile_dir``
writes a ``torch.profiler`` trace of the dispatch loop
(``utils/observe.py::device_trace``).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
from collections import deque

import numpy as np
import torch

from .._version import __version__
from ..bamio import BamReader, BamWriter, sort_bam
from ..features import (ExtractConfig, FeatureBatch, batch_from_reads,
                        extract_read_features)
from ..models import (AttRNN, AttRNNConfig, TransEnc, TransEncConfig,
                      attrnn_state_dict_from_params, init_attrnn, init_transenc,
                      transenc_state_dict_from_params)
from ..models.attrnn import PORTED, PORTED_2S
from ..models.convert import torch_ckpt_to_params
from ..models.params_io import _flatten, load_params
from ..parallel.distributed import owns_read
from ..parallel.predict import make_predict_fn
from ..utils.codecs import get_motif_seqs
from ..utils.constants import BASE2CODE_DNA, CODE2BASE_DNA
from ..utils.fasta import DNAReference
from ..utils.logging import mylogger
from ..utils.observe import ThroughputMeter, device_trace
from .modbam import add_mm_ml_to_record

LOGGER = mylogger(__name__)

# counts of the last call_mods_bam run (reads, sites, dispatched batches,
# seconds) or call_mods_txt run (sites, batches, seconds), for callers that
# drive it through the CLI
LAST_RUN: dict = {}


@dataclasses.dataclass
class CallModsConfig:
    model_file: str = ""
    model_type: str = "attbigru2s"
    seq_len: int = 21
    is_npass: bool = True
    is_stds: bool = False
    is_sn: bool = False
    is_map: bool = False
    class_num: int = 2
    dropout_rate: float = 0.0
    batch_size: int = 512
    layer_rnn: int = 3
    hid_rnn: int = 256
    layer_trans: int = 6
    nhead: int = 4
    d_model: int = 256
    dim_ff: int = 512
    holes_batch: int = 50
    keep_pulse: bool = False
    no_sort: bool = False
    # output-sort memory budget (MB) of the external merge sort (bamio.sort_bam)
    sort_mem_mb: int = 512
    threads: int = 4
    # extraction options
    mode: str = "denovo"
    ref: str | None = None
    motifs: str = "CG"
    mod_loc: int = 0
    methy_label: int = 1
    norm: str = "zscore"
    no_decode: bool = False
    mapq: int = 1
    identity: float = 0.0
    no_supplementary: bool = False
    skip_unmapped: bool = True
    holeids_e: str | None = None
    holeids_ne: str | None = None
    gzip_out: bool = False
    # RNN models: 'pallas_layer' runs the BiRNN one launch per layer
    # (kernel K2), 'xla' and 'pallas' the whole stack in one (K1), on cpu
    # through their plain versions; transencoder2s runs its encoder through
    # K3 for every value, as ccsmeth_tpu runs its fused encoder kernel
    rnn_backend: str = "xla"
    precision: str = "fp32"  # fp32 | bf16: operand type of the BiRNN / encoder
    # group k batches per dispatch_many call (k launches in a row here)
    dispatch_fuse: int = 8
    # 'int8': int8 IPD/PW means on the host->device copy (zscore/mad only);
    # 'auto': int8 on the bf16 fast path with a standardized norm, else none
    transfer_quant: str = "auto"
    # 'u8': the device returns floor(p1n*256) ML bytes; 'auto': u8 on bf16
    fetch_quant: str = "auto"  # auto | u8 | none
    num_processes: int = 1
    process_id: int = 0
    profile_dir: str | None = None
    h0_mode: str = "zeros"  # zeros | randn
    tseed: int = 1234
    # the one knob ccsmeth_tpu selects through JAX_PLATFORMS
    device: str = "cuda"

    def resolved_transfer_quant(self) -> str:
        if self.transfer_quant == "auto":
            return ("int8" if self.precision == "bf16"
                    and self.norm in ("zscore", "mad") else "none")
        return self.transfer_quant

    def resolved_fetch_mode(self) -> str:
        if self.fetch_quant == "auto":
            return "mlbyte" if self.precision == "bf16" else "probs"
        return "mlbyte" if self.fetch_quant == "u8" else "probs"

    def extract_config(self) -> ExtractConfig:
        return ExtractConfig(
            mode=self.mode, seq_len=self.seq_len, motifs=self.motifs,
            mod_loc=self.mod_loc, methy_label=self.methy_label, norm=self.norm,
            no_decode=self.no_decode, is_sn=self.is_sn, is_map=self.is_map,
            mapq=self.mapq, identity=self.identity,
            no_supplementary=self.no_supplementary, skip_unmapped=self.skip_unmapped,
            holes_batch=self.holes_batch,
        )

    def model_config(self) -> AttRNNConfig | TransEncConfig:
        if self.model_type == "transencoder2s":
            return TransEncConfig(
                seq_len=self.seq_len, num_layers=self.layer_trans,
                num_classes=self.class_num, dropout_rate=0.0, d_model=self.d_model,
                nhead=self.nhead, dim_ff=self.dim_ff, is_npass=self.is_npass,
                is_sn=self.is_sn, is_map=self.is_map, is_stds=self.is_stds,
            )
        if self.model_type in PORTED and self.model_type not in PORTED_2S:
            raise ValueError(
                "--model_type {} is trained by train/trainm only: call_mods "
                "runs {} and transencoder2s, as ccsmeth_tpu's does".format(
                    self.model_type, ", ".join(PORTED_2S)))
        if self.model_type not in PORTED:
            raise NotImplementedError(
                "--model_type {} is not yet ported ({} and transencoder2s only)"
                .format(self.model_type, ", ".join(PORTED_2S)))
        return AttRNNConfig(
            seq_len=self.seq_len, num_layers=self.layer_rnn,
            num_classes=self.class_num, dropout_rate=0.0,
            hidden_size=self.hid_rnn, is_npass=self.is_npass, is_sn=self.is_sn,
            is_map=self.is_map, is_stds=self.is_stds, model_type=self.model_type,
        )


def resolve_device(name: str) -> torch.device:
    """The requested device; cuda without a GPU raises (never runs on the CPU
    instead)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device {} requested but torch.cuda.is_available() "
                           "is False; pass --device cpu to run on the CPU"
                           .format(name))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("--device must be cuda[:i] or cpu, got {}".format(name))
    return dev


def load_model_params(model_file: str, model_cfg) -> dict:
    """Load a native .npz checkpoint or convert a reference torch .ckpt into a
    params pytree, and check it against the config-implied shapes
    (``ccsmeth_tpu/pipeline/call_mods.py:165-221``)."""
    if model_file.endswith(".npz"):
        params = load_params(model_file)
    else:
        params = torch_ckpt_to_params(model_file, model_cfg)
    _check_params_shapes(params, model_cfg, model_file)
    return params


def _check_params_shapes(params, model_cfg, model_file: str) -> None:
    # shape-only probe rng: np.zeros is calloc-backed, so the expected layout
    # costs no random init of the whole model
    class _ShapeProbeRng:
        @staticmethod
        def uniform(_lo, _hi, size=None):
            return np.zeros(() if size is None else size)

        @staticmethod
        def normal(_mu=0.0, _sigma=1.0, size=None):
            return np.zeros(() if size is None else size)

    init = init_transenc if isinstance(model_cfg, TransEncConfig) else init_attrnn
    exp_flat = {k: v.shape for k, v in _flatten(init(_ShapeProbeRng(), model_cfg))}
    got_flat = {k: v.shape for k, v in _flatten(params)}
    problems = []
    for k, shp in exp_flat.items():
        if k not in got_flat:
            problems.append("missing {} (expect {})".format(k, shp))
        elif got_flat[k] != shp:
            problems.append("{}: ckpt {} vs config {}".format(k, got_flat[k], shp))
    problems += ["unexpected {} in ckpt".format(k)
                 for k in got_flat if k not in exp_flat]
    if problems:
        raise ValueError(
            "model checkpoint {} does not match the model flags "
            "(--model_type/--layer_rnn/--hid_rnn/--seq_len...): {}".format(
                model_file, "; ".join(problems[:8])))


def build_model(params: dict, model_cfg, device,
                rnn_backend: str = "xla") -> AttRNN | TransEnc:
    """The model of the config's family with ``params`` loaded, in eval mode
    on ``device``; rnn_backend picks the RNN models' kernel (K1, or K2 for
    'pallas_layer')."""
    if isinstance(model_cfg, TransEncConfig):
        model = TransEnc(model_cfg)
        model.load_state_dict(transenc_state_dict_from_params(params))
    else:
        model = AttRNN(model_cfg, rnn_backend)
        model.load_state_dict(attrnn_state_dict_from_params(params))
    return model.eval().to(device)


def _get_holes(path: str) -> set:
    holes = set()
    with open(path) as rf:
        for line in rf:
            holes.add(line.strip().split("\t")[0])
    return holes


def _check_options(cfg: CallModsConfig) -> None:
    if cfg.rnn_backend not in ("xla", "pallas", "pallas_layer"):
        raise ValueError("--rnn_backend must be xla, pallas or pallas_layer")
    if cfg.precision not in ("fp32", "bf16"):
        raise ValueError("--precision must be fp32 or bf16")


def _make_h0_stream(model_cfg, tseed: int):
    """Replay the reference's per-forward randn initial states
    (``ccsmeth_tpu/pipeline/call_mods.py:247-280``): a generator seeded once
    with ``tseed`` (the stream of the global one after
    ``torch.manual_seed(tseed)``, call_modifications.py:479), then for every
    model forward, in the reference's order (models.py:77-87, 126-131):
    strand-1 h0 [then c0 for the LSTM], strand-2 h0 [then c0]. Each draw
    has the UNPADDED row count (the reference's batch); rows padded to the
    dispatch width get zero states.

    Returns draw(n_valid, pad_n) -> dict of (num_layers*2, pad_n, H) float32
    arrays keyed h0/h0_2[/c0/c0_2], AttRNN's ``h0s``."""
    gen = torch.Generator().manual_seed(tseed)
    nl2 = model_cfg.num_layers * 2
    H = model_cfg.hidden_size
    lstm = model_cfg.rnn_cell == "lstm"

    def draw(n_valid: int, pad_n: int) -> dict:
        def one():
            t = torch.randn(nl2, n_valid, H, generator=gen).numpy().astype(np.float32)
            if pad_n != n_valid:
                t = np.pad(t, ((0, 0), (0, pad_n - n_valid), (0, 0)))
            return t

        out = {"h0": one()}
        if lstm:
            out["c0"] = one()
        out["h0_2"] = one()
        if lstm:
            out["c0_2"] = one()
        return out

    return draw


def _h0_stream_for(cfg: CallModsConfig, model_cfg):
    """Validate + build the randn-h0 replay stream, or None for zero-h0
    (``ccsmeth_tpu/pipeline/call_mods.py:283-299``)."""
    if cfg.h0_mode != "randn":
        return None
    if isinstance(model_cfg, TransEncConfig):
        raise ValueError("--h0_mode randn applies to RNN models only "
                         "(the transformer has no recurrent initial state)")
    if cfg.rnn_backend != "xla":
        raise ValueError("--h0_mode randn requires --rnn_backend xla "
                         "(the fused pallas kernels are zero-h0 only)")
    if cfg.num_processes > 1:
        raise ValueError(
            "--h0_mode randn requires a single process: sharded runs consume "
            "the per-forward torch.randn stream against a different batch "
            "sequence than the reference's, so the replay would reproduce "
            "nothing")
    return _make_h0_stream(model_cfg, cfg.tseed)


def _shard_for(cfg: CallModsConfig):
    """(process_id, num_processes) of a share-nothing run, or None."""
    if cfg.num_processes <= 1:
        return None
    if not 0 <= cfg.process_id < cfg.num_processes:
        raise ValueError("--process_id must be in [0, num_processes)")
    return cfg.process_id, cfg.num_processes


class _FusedDispatcher:
    """Group k sub-batches into one dispatch_many call
    (``ccsmeth_tpu/pipeline/call_mods.py:317-366``). Partial groups are not
    padded: there is no compiled shape to keep, and padding would run extra
    batches."""

    def __init__(self, predict, k: int):
        self.predict = predict
        self.k = max(int(k), 1)
        self._buf: list = []  # [(compact_feats, token)]

    def dispatch(self, cf) -> list:
        """Returns a token [handle | None (buffered), group index | None]."""
        tok: list = [None, None]
        if self.k == 1:
            tok[0] = self.predict.dispatch_async(cf)
            return tok
        self._buf.append((cf, tok))
        if len(self._buf) >= self.k:
            self.flush()
        return tok

    def flush(self):
        if not self._buf:
            return
        handles = self.predict.dispatch_many_async([cf for cf, _t in self._buf])
        for gi, (_cf, tok) in enumerate(self._buf):
            tok[0] = handles
            tok[1] = gi
        self._buf = []

    @staticmethod
    def attached(tok) -> bool:
        return tok[0] is not None

    def collect(self, tok) -> np.ndarray:
        if tok[0] is None:
            self.flush()
        if tok[1] is None:
            return self.predict.collect(tok[0])
        return self.predict.collect(tok[0][tok[1]])


class _Stats:
    def __init__(self):
        self.reads_in = 0
        self.reads_failed = 0
        self.sites = 0
        self.reads_written = 0
        self.reads_tagged = 0


def call_mods_bam(cfg: CallModsConfig, input_path: str, output_prefix: str) -> str:
    """BAM/SAM -> [prefix].modbam.bam. Returns the output path."""
    t_start = time.time()
    out_modbam = output_prefix + ".modbam.bam"
    if cfg.transfer_quant == "int8" and cfg.norm not in ("zscore", "mad"):
        raise ValueError("--transfer_quant int8 requires a standardized "
                         "normalization (--norm zscore or mad)")
    _check_options(cfg)
    device = resolve_device(cfg.device)
    model_cfg = cfg.model_config()
    params = load_model_params(cfg.model_file, model_cfg)
    model = build_model(params, model_cfg, device, cfg.rnn_backend)
    predict = make_predict_fn(
        model, model_cfg, device,
        compute_dtype=torch.bfloat16 if cfg.precision == "bf16" else torch.float32,
        transfer_dtype=cfg.precision,
        kinetics_quant=cfg.resolved_transfer_quant(),
        fetch_mode=cfg.resolved_fetch_mode())
    h0_draw = _h0_stream_for(cfg, model_cfg)
    pad_n = cfg.batch_size

    dnacontigs = None
    if cfg.mode == "align":
        if cfg.ref is None:
            raise ValueError("--ref must be provided when using align mode!")
        dnacontigs = DNAReference(cfg.ref).getcontigs()
    motifs = get_motif_seqs(cfg.motifs)
    holeids_e = _get_holes(cfg.holeids_e) if cfg.holeids_e else None
    holeids_ne = _get_holes(cfg.holeids_ne) if cfg.holeids_ne else None
    ecfg = cfg.extract_config()

    shard = _shard_for(cfg)
    if shard is not None:
        LOGGER.info("read sharding: process %d/%d", *shard)
    reader = BamReader(input_path)
    refnames = [r[0] for r in reader.header.references]
    out_header = reader.header.add_pg("ccsmeth_tpu_torch", "ccsmeth_tpu_torch",
                                      __version__, " ".join(sys.argv) or "call_mods")
    stats = _Stats()

    batch_q: "queue.Queue" = queue.Queue(maxsize=8)
    write_q: "queue.Queue" = queue.Queue(maxsize=16)
    err: list[BaseException] = []

    # multiprocess extraction pool (threads>3): workers run the numpy-only
    # features/mp_extract.py and never touch the card
    pool = None
    n_workers = max(cfg.threads - 2, 0)
    main_mod = sys.modules.get("__main__")
    _main_file = getattr(main_mod, "__file__", None)
    main_importable = bool(getattr(main_mod, "__spec__", None)
                           or (_main_file and os.path.exists(_main_file)))
    if n_workers > 1 and not main_importable:
        # spawn re-imports __main__ in workers; a REPL/heredoc main would hang
        LOGGER.info("extraction pool disabled: __main__ is not importable "
                    "(interactive interpreter?)")
    elif n_workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        from ..features import mp_extract

        pool = ProcessPoolExecutor(
            max_workers=n_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=mp_extract.init_worker,
            initargs=(motifs, ecfg, dnacontigs, holeids_e, holeids_ne, refnames))

    def safe_put(q, item) -> bool:
        """Bounded put that aborts when another stage has died."""
        while not err:
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            from ..features import mp_extract

            holebatch = []
            for rec in reader:
                if shard is not None and not owns_read(rec.qname, *shard):
                    continue
                holebatch.append(rec)
                if len(holebatch) >= cfg.holes_batch:
                    item = (holebatch, pool.submit(mp_extract.extract_holebatch,
                                                   holebatch) if pool else None)
                    if not safe_put(batch_q, item):
                        return
                    holebatch = []
            if holebatch:
                safe_put(batch_q, (holebatch,
                                   pool.submit(mp_extract.extract_holebatch,
                                               holebatch) if pool else None))
        except BaseException as e:  # noqa: BLE001
            err.append(e)
        finally:
            while True:
                try:
                    batch_q.put(None, timeout=0.5)
                    break
                except queue.Full:
                    if err:  # drain one slot so the sentinel always fits
                        try:
                            batch_q.get_nowait()
                        except queue.Empty:
                            pass

    def write():
        try:
            writer = BamWriter(out_modbam, out_header)
            while True:
                item = write_q.get()
                if item is None:
                    break
                for rec, tagged in item:
                    writer.write(rec)
                    stats.reads_written += 1
                    stats.reads_tagged += int(tagged)
            writer.close()
        except BaseException as e:  # noqa: BLE001
            err.append(e)

    t_prod = threading.Thread(target=produce, daemon=True)
    t_write = threading.Thread(target=write, daemon=True)
    t_prod.start()
    t_write.start()

    rm_pulse = not cfg.keep_pulse
    meter = ThroughputMeter("call_mods")
    trace_ctx = device_trace(cfg.profile_dir, device)
    trace_ctx.__enter__()
    # batches are dispatched ahead of result collection: tagging/writing of a
    # previous holebatch overlaps the copies and compute of the next
    pending: deque = deque()
    fuser = _FusedDispatcher(predict, cfg.dispatch_fuse)

    def finalize(item):
        holebatch, idx_map, subs = item
        read_preds: dict[int, list[tuple[int, float]]] = {}
        for tok, sub in subs:
            probs = fuser.collect(tok)[: sub.n_valid]
            if probs.dtype == np.uint8:
                # ML-byte fetch: ml -> a representative prob whose
                # round(.,6)+floor(.*256) round-trips to the SAME byte
                p1n = (probs.astype(np.float64) + 0.5) / 256.0
            else:
                p0 = probs[:, 0].astype(np.float64)
                p1 = probs[:, 1].astype(np.float64)
                p1n = p1 / (p0 + p1)
            for j in range(sub.n_valid):
                ridx = int(idx_map[sub.read_idx[j]])
                read_preds.setdefault(ridx, []).append(
                    (int(sub.locs[j]), round(float(p1n[j]), 6)))
        out_items = []
        for i, rec in enumerate(holebatch):
            tagged = add_mm_ml_to_record(rec, read_preds.get(i, []), rm_pulse)
            out_items.append((rec, tagged))
        safe_put(write_q, out_items)

    while not err:
        try:
            item = batch_q.get(timeout=0.5)
        except queue.Empty:
            continue
        if item is None:
            break
        holebatch, ext_future = item
        stats.reads_in += len(holebatch)
        meter.add("reads", len(holebatch))
        feats_per_read = []
        if ext_future is not None:
            for rec, (rf, errstr) in zip(holebatch, ext_future.result()):
                if errstr is not None:
                    LOGGER.warning("%s in read:%s", errstr, rec.qname)
                if rf is None:
                    stats.reads_failed += 1
                feats_per_read.append(rf)
        else:
            for rec in holebatch:
                refname = refnames[rec.ref_id] if rec.ref_id >= 0 else None
                try:
                    rf = extract_read_features(rec, motifs, ecfg, dnacontigs,
                                               holeids_e, holeids_ne, refname)
                except Exception as e:  # noqa: BLE001  (reference counts per-read failures)
                    LOGGER.warning("%s: %s in read:%s", type(e).__name__, e, rec.qname)
                    rf = None
                if rf is None:
                    stats.reads_failed += 1
                feats_per_read.append(rf)
        kept = [(i, rf) for i, rf in enumerate(feats_per_read) if rf is not None]
        batch = batch_from_reads([rf for _i, rf in kept], cfg.seq_len)
        subs = []
        idx_map = np.empty(0, dtype=np.int64)
        if batch is not None:
            idx_map = np.array([i for i, _rf in kept], dtype=np.int64)
            stats.sites += len(batch)
            meter.add("sites", len(batch))
            for s in range(0, len(batch), pad_n):
                sub = batch.slice(s, min(s + pad_n, len(batch))).pad_to(pad_n)
                cf = sub.compact_feats()
                if h0_draw is not None:
                    cf.update(h0_draw(sub.n_valid, pad_n))
                subs.append((fuser.dispatch(cf), sub))
        pending.append((holebatch, idx_map, subs))
        # finalize only slots whose sub-batches have all been dispatched; the
        # hard cap bounds host memory when holebatches are tiny relative to k
        while (len(pending) > 2
               and all(fuser.attached(t) for t, _s in pending[0][2])):
            finalize(pending.popleft())
        if len(pending) > max(4, 2 * fuser.k):
            fuser.flush()
            while len(pending) > 2:
                finalize(pending.popleft())
    fuser.flush()
    while pending:
        finalize(pending.popleft())

    trace_ctx.__exit__(None, None, None)
    meter.log()
    if err:
        # unblock a producer stuck on a full queue, then surface the error
        while True:
            try:
                batch_q.get_nowait()
            except queue.Empty:
                break
    t_prod.join()
    while True:
        try:
            write_q.put(None, timeout=0.5)
            break
        except queue.Full:
            if err:
                try:
                    write_q.get_nowait()
                except queue.Empty:
                    pass
    t_write.join()
    reader.close()
    predict.close()
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)
    if err:
        raise err[0]

    if not cfg.no_sort:
        LOGGER.info("sorting modbam file..")
        tmp_sorted = os.path.splitext(out_modbam)[0] + ".sorted.bam"
        st = sort_bam(out_modbam, tmp_sorted, mem_budget_mb=cfg.sort_mem_mb)
        if st["runs"]:
            LOGGER.info("external merge sort: %d records in %d spilled runs",
                        st["records"], st["runs"])
        os.replace(tmp_sorted, out_modbam)
        try:
            LOGGER.info("indexing modbam file..")
            from ..bamio.bai import build_index

            build_index(out_modbam)
        except Exception:  # noqa: BLE001 (reference also warns-and-continues)
            LOGGER.warning("failed indexing modbam file..")
    LAST_RUN.clear()
    LAST_RUN.update(reads=stats.reads_in, reads_tagged=stats.reads_tagged,
                    sites=stats.sites, batches=predict.n_batches,
                    seconds=time.time() - t_start)
    LOGGER.info(
        "call_mods finished: %d reads in (%d failed), %d sites, %d written (%d tagged),"
        " %.1fs", stats.reads_in, stats.reads_failed, stats.sites,
        stats.reads_written, stats.reads_tagged, time.time() - t_start)
    return out_modbam


# ---------------------------------------------------------------------------------------
# TSV path (features.tsv -> per_readsite.tsv; parity with
# ccsmeth/_call_modifications_txt.py:121-265,337-357)
# ---------------------------------------------------------------------------------------


def _parse_tsv_batch(rows: list[list[str]], seq_len: int, holeids_e, holeids_ne):
    """Parse TSV rows into a FeatureBatch + sampleinfo, center-truncating kmers to
    seq_len (reference lines 159-196; ``ccsmeth_tpu/pipeline/call_mods.py:
    669-733``)."""
    if not rows:
        return None, []
    oriklen = len(rows[0][5])
    if oriklen == seq_len:
        lc, rc = 0, oriklen
    elif oriklen > seq_len:
        lc = (oriklen - seq_len) // 2
        rc = oriklen - lc
    else:
        return None, []
    sampleinfo = []
    cols = {k: [] for k in (
        "kmer", "kpass", "ipd_means", "pw_means", "sns", "maps",
        "kmer2", "kpass2", "ipd_means2", "pw_means2", "sns2", "maps2",
        "ipd_stds", "pw_stds", "ipd_stds2", "pw_stds2", "labels")}

    def vec(txt, n):
        if txt == ".":
            return np.zeros(n, np.float32)
        return np.asarray([float(x) for x in txt.split(",")][lc:rc], dtype=np.float32)

    for w in rows:
        if holeids_e is not None and w[3] not in holeids_e:
            continue
        if holeids_ne is not None and w[3] in holeids_ne:
            continue
        sampleinfo.append(w[0:5])
        n = seq_len
        cols["kmer"].append(np.asarray([BASE2CODE_DNA[c] for c in w[5][lc:rc]], np.float32))
        cols["kpass"].append(np.full(n, float(int(w[6])), np.float32))
        cols["ipd_means"].append(vec(w[7], n))
        cols["ipd_stds"].append(vec(w[8], n))
        cols["pw_means"].append(vec(w[9], n))
        cols["pw_stds"].append(vec(w[10], n))
        sn = w[11]
        cols["sns"].append(np.zeros(4, np.float32) if sn == "." else
                           np.asarray([float(x) for x in sn.split(",")], np.float32))
        cols["maps"].append(vec(w[12], n))
        cols["kmer2"].append(np.asarray([BASE2CODE_DNA[c] for c in w[13][lc:rc]], np.float32))
        cols["kpass2"].append(np.full(n, float(int(w[14])), np.float32))
        cols["ipd_means2"].append(vec(w[15], n))
        cols["ipd_stds2"].append(vec(w[16], n))
        cols["pw_means2"].append(vec(w[17], n))
        cols["pw_stds2"].append(vec(w[18], n))
        sn2 = w[19]
        cols["sns2"].append(np.zeros(4, np.float32) if sn2 == "." else
                            np.asarray([float(x) for x in sn2.split(",")], np.float32))
        cols["maps2"].append(vec(w[20], n))
        cols["labels"].append(int(w[21]))
    if not sampleinfo:
        return None, []
    N = len(sampleinfo)
    batch = FeatureBatch(
        read_idx=np.zeros(N, np.int32), locs=np.zeros(N, np.int64),
        chrom_pos=np.zeros(N, np.int64),
        **{k: np.stack(v).astype(np.float32) if k != "labels" else np.asarray(v, np.int32)
           for k, v in cols.items()},
        n_valid=N, seq_len=seq_len,
    )
    return batch, sampleinfo


def call_mods_txt(cfg: CallModsConfig, input_path: str, output_prefix: str) -> str:
    """features TSV(.gz) -> [prefix].per_readsite.tsv(.gz).

    Output row parity with _call_modifications_txt.py:253-265: sampleinfo(5 cols),
    "fpass,rpass", prob_0, prob_1, called_label, center 5-mer.
    """
    t_start = time.time()
    out_path = output_prefix + ".per_readsite.tsv"
    _check_options(cfg)
    device = resolve_device(cfg.device)
    model_cfg = cfg.model_config()
    params = load_model_params(cfg.model_file, model_cfg)
    model = build_model(params, model_cfg, device, cfg.rnn_backend)
    # TSV input was extracted elsewhere with an unknown normalization, so
    # 'auto' resolves to no quantization here; explicit --transfer_quant int8
    # is honored (the caller knows their features are standardized)
    tq = "none" if cfg.transfer_quant == "auto" else cfg.transfer_quant
    predict = make_predict_fn(
        model, model_cfg, device,
        compute_dtype=torch.bfloat16 if cfg.precision == "bf16" else torch.float32,
        kinetics_quant=tq)
    fuser = _FusedDispatcher(predict, cfg.dispatch_fuse)
    h0_draw = _h0_stream_for(cfg, model_cfg)
    pad_n = cfg.batch_size
    holeids_e = _get_holes(cfg.holeids_e) if cfg.holeids_e else None
    holeids_ne = _get_holes(cfg.holeids_ne) if cfg.holeids_ne else None
    shard = _shard_for(cfg)

    from ..bamio import create_text_gz, open_text_auto

    opener = ((lambda p, _m="rt": open_text_auto(p))
              if input_path.endswith(".gz") else open)
    if cfg.gzip_out:
        out_path += ".gz"
        wf = create_text_gz(out_path)
    else:
        wf = open(out_path, "w")
    n_sites = 0
    rows: list[list[str]] = []
    with opener(input_path, "rt") as rf, device_trace(cfg.profile_dir, device):
        for line in rf:
            w = line.rstrip("\n").split("\t")
            if len(w) < 22:
                continue
            if shard is not None and not owns_read(w[3], *shard):
                continue
            rows.append(w)
            if len(rows) >= cfg.batch_size * max(4, cfg.dispatch_fuse):
                n_sites += _predict_tsv_rows(rows, cfg, fuser, pad_n, holeids_e,
                                             holeids_ne, wf, h0_draw)
                rows = []
        if rows:
            n_sites += _predict_tsv_rows(rows, cfg, fuser, pad_n, holeids_e,
                                         holeids_ne, wf, h0_draw)
    wf.close()
    predict.close()
    LAST_RUN.clear()
    LAST_RUN.update(sites=n_sites, batches=predict.n_batches,
                    seconds=time.time() - t_start)
    return out_path


def _predict_tsv_rows(rows, cfg, fuser, pad_n, holeids_e, holeids_ne, wf,
                      h0_draw=None) -> int:
    """Predict and write one group of TSV rows; returns the rows written."""
    batch, sampleinfo = _parse_tsv_batch(rows, cfg.seq_len, holeids_e, holeids_ne)
    if batch is None:
        return 0
    # dispatch every sub-batch up front (k-batch groups; copies overlap device
    # compute; h0 draws stay in stream order), then collect in row order
    dispatched = []
    for s in range(0, len(batch), pad_n):
        sub = batch.slice(s, min(s + pad_n, len(batch))).pad_to(pad_n)
        cf = sub.compact_feats()
        if h0_draw is not None:
            cf.update(h0_draw(sub.n_valid, pad_n))
        dispatched.append((s, sub, fuser.dispatch(cf)))
    for s, sub, tok in dispatched:
        probs = fuser.collect(tok)[: sub.n_valid]
        predicted = np.argmax(probs, axis=1)
        for j in range(sub.n_valid):
            i = s + j
            p0 = float(probs[j, 0])
            p1 = float(probs[j, 1])
            prob_0_norm = round(p0 / (p0 + p1), 6)
            prob_1_norm = round(1 - prob_0_norm, 6)
            kmer = "".join(CODE2BASE_DNA[int(c)] for c in sub.kmer[j])
            center = len(kmer) // 2
            ks = max(center - 2, 0)
            ke = min(center + 3, len(kmer))
            wf.write("\t".join(
                sampleinfo[i]
                + ["{},{}".format(int(sub.kpass[j, 0]), int(sub.kpass2[j, 0])),
                   str(prob_0_norm), str(prob_1_norm), str(int(predicted[j])),
                   kmer[ks:ke]]) + "\n")
    return len(batch)
