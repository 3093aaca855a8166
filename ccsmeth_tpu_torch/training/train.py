"""Training loop on one GPU (or the CPU, when asked), or across ranks.

Counterpart of ``ccsmeth_tpu/training/train.py``. The model is ``AttRNN``
(attbigru2s, attbilstm2s, the embedded-kinetics attbigru2s2 and attbilstm2s2, or the
single-strand attbigru1s and attbilstm1s, whose rows are one strand) or
``TransEnc`` (transencoder2s). The BiRNN trains through kernels K4/K5
(``ops/bigru_vjp.py``, GRU) or K6 (``ops/bilstm_vjp.py``, LSTM) on CUDA and
through their plain versions on the CPU; the transformer encoder trains in
PyTorch ops with autograd, as the JAX package trains it through XLA.
Validation runs the inference forward, kernel K1 (K3 for transencoder2s), in
f32 as the JAX package's eval step does. The ``SrcEmbed`` BatchNorms train on
each batch's statistics (pad rows included, as in the JAX package) and keep
their running stats as loaded: those are buffers, which no optimizer
touches, as JAX's optimizers leave leaves with zero gradient.

The train batch crosses to the device in one of three wire formats
(``--train_transfer``, ``train.py:159-282`` of the JAX package): fp32
columns, the same columns in bf16, or ``packed`` quantized byte rows
(kmer 4-bit, npass u16, kinetics int8 round(x*16), the sn channel's raw
bf16 bytes, maps u8) unpacked on the device by ``utils/wirefmt.py``, the
channels the config drops restored as zeros. Validation batches are fp32.

Two runs with the same seeds give the same bits on the card: the BiRNN's
kernels sum in a fixed order with no atomics, and so do the embedding
lookups' backwards (``models/attrnn.py::EmbedRows``).

Loop semantics as the JAX package's (and the reference's train.py): weighted
CE [1, pos_weight] normalized by the weight sum, grad-clip 0.5, validation
every step_interval with accuracy/precision/recall, checkpoint on best
accuracy (tolerance 2e-4) named '{model_type}.b{seq_len}_epoch{N}.ckpt.npz'
(+ betterthanlast), StepLR/ReduceLROnPlateau, early stop after an epoch
without a new best once min_epoch_num is reached. Checkpoints are the JAX
package's ``.ckpt.npz`` params format, so either package loads the other's.

``step_fuse`` keeps its flag and its group schedule: the prefetch thread packs
a group of k batches into one pinned host array and one copy to the device,
and the k steps then run one after another (the same numbers as k single
steps, as in JAX).

Across processes (``--num_processes N --dist_coordinator host:port``, one
rank a card, ``parallel/distributed.py``) the loop keeps the JAX package's
multi-process semantics (``train.py:623-633, 729-770`` there): every rank
trains on ``batch_size`` rows of its shard of the loader (every N-th batch,
tail dropped), so the global batch is ``batch_size * N`` and every rank runs
``len(train) // (batch_size * N)`` steps an epoch. The loss is normalized by
the global weight sum, all-reduced before the backward; the gradients, taken
with ``torch.autograd.grad``, are flattened in the order of
``model.parameters()`` and summed with the step's loss in one all-reduce,
then clipped and applied, as JAX's ``psum`` of loss and grads. There is no
``DistributedDataParallel``: its reducer hooks ``.backward()``, which this
step does not call, and it averages where JAX sums. Rank 0's parameters and
optimizer state are broadcast once at the start. The ``SrcEmbed``
BatchNorms see each rank's local batch, as each device shard does under
JAX's ``shard_map``. Each rank draws its dropout from its own generator,
seeded from (tseed, rank); the draws differ from JAX's ``fold_in`` stream
in any case. Validation sums each batch's [loss numerator, weight sum, n,
correct, tp, fp, fn] over the ranks in one all-reduce a sweep, so every rank
derives the same metrics and takes the same checkpoint and early-stop
decisions; only rank 0 writes files.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import re
import threading
import time

import numpy as np
import torch

from ..models import (AttRNN, AttRNNConfig, TransEnc, TransEncConfig,
                      attrnn_params_from_state_dict, attrnn_state_dict_from_params,
                      init_attrnn, init_transenc, transenc_params_from_state_dict,
                      transenc_state_dict_from_params)
from ..models.attrnn import PORTED
from ..models.convert import gc_dims, torch_ckpt_to_params
from ..models.params_io import load_params, save_params
from ..parallel import distributed
from ..pipeline.call_mods import resolve_device
from ..utils.logging import mylogger
from ..utils.wirefmt import (dequant_i8, pack_kmer4_np, pack_u16_np, quant_i8_np,
                             unpack_kmer4, unpack_u16)
from .data import FeatureDataset, StreamingFeatureDataset
from .optim import LrSchedule, build_optimizer

LOGGER = mylogger(__name__)

STATE_FORMAT = "ccsmeth_tpu_torch.train_state.v1"
VALID_RESIDENT_MB = 1024.0
LAST_RUN: dict = {}  # train()'s result of the last run, for callers of the CLI


@dataclasses.dataclass
class TrainConfig:
    train_file: str = ""
    valid_file: str = ""
    model_dir: str = ""
    model_type: str = "attbigru2s"
    seq_len: int = 21
    is_npass: bool = True
    is_sn: bool = False
    is_map: bool = False
    is_stds: bool = False
    class_num: int = 2
    dropout_rate: float = 0.5
    layer_rnn: int = 3
    hid_rnn: int = 256
    layer_trans: int = 6
    nhead: int = 4
    d_model: int = 256
    dim_ff: int = 512
    optim_type: str = "Adam"
    batch_size: int = 512
    lr_scheduler: str = "StepLR"
    lr: float = 0.001
    lr_decay: float = 0.1
    lr_decay_step: int = 1
    lr_patience: int = 0
    lr_mode_strategy: str = "last"
    max_epoch_num: int = 50
    min_epoch_num: int = 10
    pos_weight: float = 1.0
    step_interval: int = 500
    init_model: str | None = None
    tseed: int = 1234
    # persist optimizer state + epoch next to each params ckpt
    save_opt_state: bool = False
    resume_from: str | None = None  # params .npz; sibling .train_state.npz restores
    #                                 optimizer state + epoch
    # k batches per host->device copy between logging boundaries; the k steps
    # run in turn, with the same numbers as single steps
    step_fuse: int = 8
    dl_offsets: bool = False  # out-of-core streaming loader
    rnn_backend: str = "xla"  # flag parity: every value trains through K4/K5/K6
    precision: str = "fp32"  # fp32 | bf16 (operand type of the products)
    train_transfer: str = "fp32"  # fp32 | bf16 | packed: the train batch's wire
    dist_coordinator: str | None = None  # host:port of rank 0 (trainm across processes)
    num_processes: int = 1
    process_id: int = 0
    device: str = "cuda"

    def model_config(self):
        if self.model_type == "transencoder2s":
            return TransEncConfig(
                seq_len=self.seq_len, num_layers=self.layer_trans,
                num_classes=self.class_num, dropout_rate=self.dropout_rate,
                d_model=self.d_model, nhead=self.nhead, dim_ff=self.dim_ff,
                is_npass=self.is_npass, is_sn=self.is_sn, is_map=self.is_map,
                is_stds=self.is_stds)
        return AttRNNConfig(
            seq_len=self.seq_len, num_layers=self.layer_rnn,
            num_classes=self.class_num, dropout_rate=self.dropout_rate,
            hidden_size=self.hid_rnn, is_npass=self.is_npass, is_sn=self.is_sn,
            is_map=self.is_map, is_stds=self.is_stds, model_type=self.model_type)


def _check_options(cfg: TrainConfig) -> None:
    if (cfg.num_processes > 1) != bool(cfg.dist_coordinator):
        raise ValueError("--num_processes > 1 and --dist_coordinator host:port go "
                         "together (got {} processes, coordinator {})".format(
                             cfg.num_processes, cfg.dist_coordinator))
    if cfg.model_type not in PORTED + ("transencoder2s",):
        raise ValueError("--model_type {} is not a model ({}, transencoder2s)".format(
            cfg.model_type, ", ".join(PORTED)))
    if cfg.train_transfer not in ("fp32", "bf16", "packed"):
        raise ValueError("--train_transfer must be fp32, bf16 or packed")
    if cfg.precision not in ("fp32", "bf16"):
        raise ValueError("--precision must be fp32 or bf16")


def model_io(model_cfg):
    """(module class, state_dict from params, params from state_dict) of the
    config's family: ``AttRNN`` or ``TransEnc``."""
    if isinstance(model_cfg, TransEncConfig):
        return (TransEnc, transenc_state_dict_from_params,
                lambda sd: transenc_params_from_state_dict(sd, model_cfg))
    return AttRNN, attrnn_state_dict_from_params, attrnn_params_from_state_dict


def _init_params(cfg: TrainConfig, model_cfg) -> dict:
    if cfg.init_model:
        LOGGER.info("loading pre-trained model: %s", cfg.init_model)
        if cfg.init_model.endswith(".npz"):
            return load_params(cfg.init_model)
        return torch_ckpt_to_params(cfg.init_model, model_cfg)
    if isinstance(model_cfg, TransEncConfig):
        return init_transenc(cfg.tseed, model_cfg)
    return init_attrnn(cfg.tseed, model_cfg)


def _batch_layout(model_cfg) -> list[tuple[str, int]]:
    """Column layout of a packed (B, n_cols) fp32 training batch: every feature
    channel flattened side by side, then one labels column and one mask column."""
    from .data import _FEATURE_KEYS, _FEATURE_KEYS_SS

    L = model_cfg.seq_len
    keys = (_FEATURE_KEYS if getattr(model_cfg, "two_strand", True)
            else _FEATURE_KEYS_SS)
    return [(k, 4 if k.startswith("sns") else L) for k in keys]


def _pack_cols(fields, feats: dict, labels, mask, wire: str = "fp32") -> np.ndarray:
    """One batch as (B, n_cols) columns: float32, or with ``wire`` 'bf16'
    the same columns rounded to bf16 (to nearest even, as ml_dtypes and the
    JAX package round them), held as their int16 bit patterns."""
    B = np.asarray(labels).shape[0]
    cols = []
    for k, n in fields:
        v = np.asarray(feats[k], np.float32).reshape(B, -1)
        assert v.shape[1] == n, "channel {} has {} cols, layout says {}".format(
            k, v.shape[1], n)
        cols.append(v)
    cols.append(np.asarray(labels, np.float32).reshape(B, 1))
    cols.append(np.asarray(mask, np.float32).reshape(B, 1))
    flat = np.ascontiguousarray(np.concatenate(cols, axis=1))
    if wire == "bf16":
        return torch.from_numpy(flat).to(torch.bfloat16).view(torch.int16).numpy()
    return flat


def _unpack_cols(flat: torch.Tensor, fields):
    """Columns -> (feats, labels, mask); bf16 wire columns (int16 bits)
    widen to f32 on the device."""
    if flat.dtype == torch.int16:
        flat = flat.view(torch.bfloat16)
    flat = flat.float()
    feats, o = {}, 0
    for k, n in fields:
        feats[k] = flat[:, o:o + n]
        o += n
    labels = flat[:, o].long()
    mask = flat[:, o + 1]
    return feats, labels, mask


def _q_fields(model_cfg) -> list[tuple[str, str, int]]:
    """(key, kind, nbytes) wire layout of one quantized training row
    (``train.py:204-219`` of the JAX package). Kinds: kmer4 = two 4-bit base
    codes a byte; u16s = one uint16 scalar broadcast to (B, L) on the
    device; i8q = int8 round(x*16); bf16 = raw bfloat16 bytes; u8frac =
    uint8 round(x*255) for [0,1] fractions (the maps column)."""
    L = model_cfg.seq_len
    per = [("kmer", "kmer4", (L + 1) // 2), ("kpass", "u16s", 2),
           ("ipd_means", "i8q", L), ("pw_means", "i8q", L)]
    if getattr(model_cfg, "is_stds", False):
        per += [("ipd_stds", "i8q", L), ("pw_stds", "i8q", L)]
    if getattr(model_cfg, "is_sn", False):
        per += [("sns", "bf16", 8)]
    if getattr(model_cfg, "is_map", False):
        per += [("maps", "u8frac", L)]
    strands = ("", "2") if getattr(model_cfg, "two_strand", True) else ("",)
    return [(k + s, kind, nb) for s in strands for k, kind, nb in per]


def _pack_rows_q(fields, feats: dict, labels, mask) -> np.ndarray:
    """Host-side pack of one batch into (B, row_bytes) uint8 quantized rows
    (+1 labels byte, +1 mask byte at the end), ``_pack_rows_q`` of the JAX
    package byte for byte."""
    B = np.asarray(labels).shape[0]
    row = sum(nb for _k, _kind, nb in fields) + 2
    buf = np.empty((B, row), np.uint8)
    o = 0
    for k, kind, nb in fields:
        v = np.asarray(feats[k], np.float32)
        if kind == "kmer4":
            buf[:, o:o + nb] = pack_kmer4_np(v)
        elif kind == "u16s":
            buf[:, o:o + nb] = pack_u16_np(v.reshape(B, -1)[:, 0])
        elif kind == "i8q":
            buf[:, o:o + nb] = quant_i8_np(v).view(np.uint8)
        elif kind == "bf16":
            bits = torch.from_numpy(np.ascontiguousarray(v)).to(torch.bfloat16)
            buf[:, o:o + nb] = bits.view(torch.uint8).numpy().reshape(B, -1)
        else:  # u8frac
            buf[:, o:o + nb] = np.clip(np.rint(v * 255.0), 0, 255).astype(np.uint8)
        o += nb
    buf[:, o] = np.asarray(labels).astype(np.uint8)
    buf[:, o + 1] = np.asarray(mask).astype(np.uint8)
    return buf


def _unpack_rows_q(buf: torch.Tensor, fields, model_cfg):
    """On-device unpack of quantized rows back to the full fp32 feats dict
    (disabled channels restored as zeros), labels int64, mask fp32: the JAX
    package's ``_unpack_rows_q`` (``train.py:252-282``) through the port's
    ``utils/wirefmt.py`` unpackers. The sn channel's bytes are reinterpreted
    as bf16, not converted."""
    L = model_cfg.seq_len
    B = buf.shape[0]
    feats, o = {}, 0
    for k, kind, nb in fields:
        raw = buf[:, o:o + nb]
        if kind == "kmer4":
            feats[k] = unpack_kmer4(raw, L).float()
        elif kind == "u16s":
            feats[k] = unpack_u16(raw).float().expand(B, L)
        elif kind == "i8q":
            feats[k] = dequant_i8(raw.view(torch.int8))
        elif kind == "bf16":
            feats[k] = raw.contiguous().view(torch.bfloat16).float()
        else:  # u8frac
            feats[k] = raw.float() * (1.0 / 255.0)
        o += nb
    labels = buf[:, o].long()
    mask = buf[:, o + 1].float()
    for k, n in _batch_layout(model_cfg):  # zeros for wire-dropped channels
        if k not in feats:
            feats[k] = torch.zeros((B, n), dtype=torch.float32, device=buf.device)
    return feats, labels, mask


def _fuse_schedule(total: int, interval: int, k: int):
    """Group sizes for the fused train dispatch: runs of exactly k steps that
    never cross a logging/validation boundary (a multiple of `interval`, or
    `total`); remainder steps run singly. The schedule is deterministic."""
    i = 0
    while i < total:
        seg = min(interval - (i % interval), total - i)
        size = k if (k > 1 and seg >= k) else 1
        yield size
        i += size


def _prefetch(iterator, stage, depth: int = 2):
    """Yield `stage(item)` for each item, with staging (batch pack + the copy
    to the device) running `depth` ahead on a worker thread. Close or exhaust
    the generator to stop the worker; errors re-raise on the consumer."""
    import queue as _queue

    done = object()
    q: _queue.Queue = _queue.Queue(maxsize=depth)
    stop = threading.Event()
    err: list[BaseException] = []

    def work():
        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except _queue.Full:
                    continue
            return False

        try:
            for item in iterator:
                if not put(stage(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            err.append(e)
        finally:
            put(done)

    t = threading.Thread(target=work, daemon=True, name="ccs-train-prefetch")
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                break
            yield item
        if err:
            raise err[0]
    finally:
        stop.set()


def _to_device(flat: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host rows -> device: through pinned memory with a non-blocking copy on
    CUDA (the caching host allocator keeps the pinned buffer until the copy
    is done)."""
    t = torch.from_numpy(flat)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def _ce_terms(logits, labels, mask, class_weights):
    """(sum(w_i * l_i), sum(w_i)) of torch CrossEntropyLoss(weight=[1,
    pos_weight]) over the valid rows, the padding mask folded into w."""
    per = torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None])[:, 0]
    w = class_weights[labels] * mask
    return (per * w).sum(), w.sum()


def weighted_ce(logits, labels, mask, class_weights) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=[1, pos_weight]) over the valid rows:
    sum(w_i * l_i) / sum(w_i), the padding mask folded into w."""
    num, den = _ce_terms(logits, labels, mask, class_weights)
    return num / torch.clamp(den, min=1e-9)


def make_train_step(model, optimizer, pos_weight: float,
                    compute_dtype=torch.float32, train_transfer: str = "fp32"):
    """(feats, labels, mask, generator) -> loss: the forward in training mode
    (dropout from ``generator``), the weighted CE, its gradients through
    autograd (K5 or K6's backward for the BiRNN on CUDA), then clip and the
    optimizer, which updates the model's parameters in place.
    ``optimizer.init`` must have run on ``model.parameters()``.
    ``step.packed(flat, generator)`` takes one batch in the ``train_transfer``
    wire (fp32 or bf16 columns, or ``packed`` byte rows), ``step.pack_batch``
    makes one on the host and ``step.unpack`` turns one back into (feats,
    labels, mask) on its device.
    In a group of ranks (``distributed.world > 1``) the batch is the rank's
    shard of the global batch: the weight sum is all-reduced before the
    backward, and the gradients and the loss are summed over the ranks in
    one all-reduce before the optimizer clips and applies them, so the step
    returns the global batch's loss."""
    params = list(model.parameters())
    dev = params[0].device
    class_weights = torch.tensor([1.0, pos_weight], dtype=torch.float32, device=dev)
    fields = _batch_layout(model.cfg)
    qfields = _q_fields(model.cfg) if train_transfer == "packed" else None

    def step(feats, labels, mask, generator=None):
        logits, _probs = model(feats, compute_dtype, train=True, generator=generator)
        if distributed.world == 1:
            loss = weighted_ce(logits, labels, mask, class_weights)
            grads = torch.autograd.grad(loss, params)
        else:
            num, den = _ce_terms(logits, labels, mask, class_weights)
            den = distributed.all_reduce_sum(den.detach().clone())
            loss = num / torch.clamp(den, min=1e-9)
            flat = torch.cat([g.reshape(-1) for g in torch.autograd.grad(loss, params)]
                             + [loss.detach().reshape(1)])
            distributed.all_reduce_sum(flat)
            grads, o = [], 0
            for p in params:
                grads.append(flat[o:o + p.numel()].view(p.shape))
                o += p.numel()
            loss = flat[o]
        optimizer.step(params, grads)
        return loss.detach()

    def unpack(flat):
        if qfields is not None:
            return _unpack_rows_q(flat, qfields, model.cfg)
        return _unpack_cols(flat, fields)

    step.unpack = unpack
    step.packed = lambda flat, generator=None: step(*unpack(flat), generator)
    if qfields is not None:
        step.pack_batch = lambda feats, labels, mask: _pack_rows_q(
            qfields, feats, labels, mask)
    else:
        step.pack_batch = lambda feats, labels, mask: _pack_cols(
            fields, feats, labels, mask, train_transfer)
    return step


def make_eval_step(model, pos_weight: float):
    """(feats, labels, mask) -> (loss, pred, counts): the inference forward in
    f32 (K1, or K3 for transencoder2s, on CUDA), counts = [n_valid, correct,
    tp, fp, fn] on the device. ``step.pack_batch`` as for the train step;
    ``step.sums(flat)`` gives one packed batch's [sum(w_i * l_i), sum(w_i),
    n_valid, correct, tp, fp, fn], which sum over the ranks."""
    dev = next(model.parameters()).device
    class_weights = torch.tensor([1.0, pos_weight], dtype=torch.float32, device=dev)
    fields = _batch_layout(model.cfg)

    @torch.inference_mode()
    def _eval(feats, labels, mask):
        logits, probs = model(feats)
        num, den = _ce_terms(logits, labels, mask, class_weights)
        pred = torch.argmax(probs, dim=1)
        v = mask > 0
        pos_p = (pred == 1) & v
        pos_l = labels == 1
        counts = torch.stack([
            mask.sum(),
            ((pred == labels) & v).sum().float(),
            (pos_p & pos_l).sum().float(),
            (pos_p & ~pos_l).sum().float(),
            ((pred == 0) & v & pos_l).sum().float(),
        ])
        return num, den, pred, counts

    def step(feats, labels, mask):
        num, den, pred, counts = _eval(feats, labels, mask)
        return num / torch.clamp(den, min=1e-9), pred, counts

    def sums(flat):
        num, den, _pred, counts = _eval(*_unpack_cols(flat, fields))
        return torch.cat([torch.stack([num, den]), counts])

    step.sums = sums
    step.pack_batch = lambda feats, labels, mask: _pack_cols(fields, feats,
                                                             labels, mask)
    return step


def save_train_state(path: str, optimizer, epoch: int, names) -> None:
    """The optimizer's state_dict and the epoch in the port's own npz format
    (not the JAX package's optax-leaf file)."""
    arrays = {"__format": np.asarray(STATE_FORMAT), "__epoch": np.int64(epoch),
              "__names": np.asarray(list(names))}
    for key, val in optimizer.state_dict().items():
        if isinstance(val, list):
            for i, t in enumerate(val):
                arrays["{}/{}".format(key, i)] = t.detach().cpu().numpy()
        else:
            arrays["__" + key] = np.asarray(val)
    np.savez_compressed(path, **arrays)


def load_train_state(path: str, optimizer, names) -> int:
    """Restore a state written by ``save_train_state`` into ``optimizer``;
    returns its epoch. Raises on any other file, the JAX package's own
    train states included."""
    data = np.load(path)
    if "__format" not in data.files or str(data["__format"]) != STATE_FORMAT:
        raise ValueError(
            "{} is not a train state written by ccsmeth_tpu_torch (the JAX "
            "package's optax train states are not read): resume without it, "
            "or warm-start from its .ckpt.npz with --init_model".format(path))
    if list(data["__names"]) != list(names):
        raise ValueError("{} was saved for other parameters".format(path))
    sd: dict = {"optim_type": str(data["__optim_type"]), "lr": float(data["__lr"]),
                "count": int(data["__count"])}
    for key in data.files:
        if "/" in key:
            lst, i = key.split("/")
            sd.setdefault(lst, {})[int(i)] = data[key]
    sd = {k: ([v[i] for i in range(len(v))] if isinstance(v, dict) else v)
          for k, v in sd.items()}
    optimizer.load_state_dict(sd)
    return int(data["__epoch"])


def binary_metrics(labels: np.ndarray, preds: np.ndarray) -> tuple[float, float, float]:
    """accuracy, precision, recall (sklearn-equivalent, positive class 1)."""
    labels = np.asarray(labels)
    preds = np.asarray(preds)
    acc = float(np.mean(labels == preds)) if len(labels) else 0.0
    tp = int(np.sum((preds == 1) & (labels == 1)))
    fp = int(np.sum((preds == 1) & (labels == 0)))
    fn = int(np.sum((preds == 0) & (labels == 1)))
    prec = tp / (tp + fp) if (tp + fp) else 0.0
    rec = tp / (tp + fn) if (tp + fn) else 0.0
    return acc, prec, rec


def train(cfg: TrainConfig) -> dict:
    """Run training; returns {'best_accuracy', 'best_epoch', 'ckpts',
    'epoch_wall_s', 'steps', 'train_losses', 'valid_losses', 'world',
    'backend', 'allreduce_calls', 'allreduce_bytes', 'allreduce_seconds'}. With
    ``num_processes > 1`` this process joins the group at
    ``dist_coordinator`` as rank ``process_id`` on its card and leaves it at
    the end."""
    _check_options(cfg)
    if cfg.num_processes > 1:
        device = distributed.init_multihost(cfg.dist_coordinator, cfg.num_processes,
                                            cfg.process_id, cfg.device)
        LOGGER.info("rank %d/%d on %s, backend %s", cfg.process_id,
                    cfg.num_processes, device, distributed.backend)
        try:
            return _train(cfg, device)
        finally:
            distributed.teardown()
    return _train(cfg, resolve_device(cfg.device))


def _train(cfg: TrainConfig, device: torch.device) -> dict:
    t0 = time.time()
    n_proc = distributed.world
    is_main = distributed.rank == 0
    model_cfg = cfg.model_config()
    model_dir = cfg.model_dir
    if model_dir != "/":
        model_dir = os.path.abspath(model_dir).rstrip("/")
        os.makedirs(model_dir, exist_ok=True)
        # clear stale ckpts of this model_type (train.py:77-80); rank 0 alone
        # writes there
        rx = re.compile(r"" + cfg.model_type + r"\..*b\d+_epoch\d+\.ckpt.*")
        for mfile in os.listdir(model_dir) if is_main else ():
            if rx.match(mfile):
                os.remove(os.path.join(model_dir, mfile))
        model_dir += "/"

    LOGGER.info("reading data..")
    single_strand = not getattr(model_cfg, "two_strand", True)
    if cfg.dl_offsets:
        train_ds = StreamingFeatureDataset(cfg.train_file, cfg.seq_len, single_strand)
        valid_ds = StreamingFeatureDataset(cfg.valid_file, cfg.seq_len, single_strand)
    else:
        train_ds = FeatureDataset.from_tsv(cfg.train_file, cfg.seq_len, single_strand)
        valid_ds = FeatureDataset.from_tsv(cfg.valid_file, cfg.seq_len, single_strand)

    if cfg.resume_from:
        cfg = dataclasses.replace(cfg, init_model=cfg.resume_from)
    module, to_state_dict, to_params = model_io(model_cfg)
    model = module(model_cfg)
    model.load_state_dict(to_state_dict(_init_params(cfg, model_cfg)))
    model.to(device)
    names = [n for n, _ in model.named_parameters()]
    optimizer = build_optimizer(cfg.optim_type, cfg.lr)
    optimizer.init(model.parameters(), gc_dims(names))
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    train_step = make_train_step(model, optimizer, cfg.pos_weight, compute_dtype,
                                 cfg.train_transfer)
    eval_step = make_eval_step(model, cfg.pos_weight)
    start_epoch = 0
    if cfg.resume_from:
        state_path = cfg.resume_from.replace(".ckpt.npz", ".train_state.npz")
        if os.path.exists(state_path):
            start_epoch = load_train_state(state_path, optimizer, names)
            LOGGER.info("resumed optimizer state at epoch %d from %s",
                        start_epoch, state_path)
        else:
            LOGGER.info("no train_state next to %s: warm-start only",
                        cfg.resume_from)
    if n_proc > 1:
        # one start state on every rank: rank 0's parameters, buffers,
        # optimizer state, step count and epoch
        scalars = torch.tensor([optimizer.state["count"], start_epoch],
                               dtype=torch.int64, device=device)
        distributed.broadcast_(list(model.parameters()) + list(model.buffers())
                               + [t for v in optimizer.state.values()
                                  if isinstance(v, list) for t in v] + [scalars])
        optimizer.state["count"], start_epoch = (int(v) for v in scalars.tolist())
    sched = LrSchedule(cfg.lr_scheduler, cfg.lr, cfg.lr_decay, cfg.lr_decay_step,
                       cfg.lr_patience, cfg.lr_mode_strategy)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.tseed if n_proc == 1 else int(
        np.random.SeedSequence([cfg.tseed, distributed.rank]).generate_state(1)[0]))
    nprng = np.random.RandomState(cfg.tseed)
    pad_n = cfg.batch_size
    shard = (distributed.rank, n_proc) if n_proc > 1 else None
    if n_proc > 1:
        # every rank runs the same number of collective steps: the tail
        # that does not fill a global batch is dropped
        total_step = len(train_ds) // (cfg.batch_size * n_proc)
        n_vbatch = len(valid_ds) // (cfg.batch_size * n_proc)
    else:
        total_step = -(-len(train_ds) // cfg.batch_size)
        n_vbatch = None
    LOGGER.info("total_step: %d", total_step)

    def loader(ds, shuffle):
        batches = ds.batches(cfg.batch_size, shuffle, nprng, pad_to=pad_n,
                             shard=shard, drop_remainder=n_proc > 1)
        return batches if n_vbatch is None or shuffle else itertools.islice(
            batches, n_vbatch)

    def pack(b, step_fn):
        feats, labels, n_valid = b
        mask = np.zeros(pad_n, np.float32)
        mask[:n_valid] = 1.0
        return step_fn.pack_batch(feats, labels, mask)

    def gen_groups(batch_gen, sizes):
        it = iter(batch_gen)
        for size in sizes:
            grp = [b for _, b in zip(range(size), it)]
            if not grp:
                return
            yield grp

    def stage_group(grp):
        """k packed batches -> one (k, B, n_cols) copy to the device."""
        return _to_device(np.stack([pack(b, train_step) for b in grp]), device)

    # the valid set is the same at every interval (shuffle=False): its packed
    # batches go to the device once and stay there, unless the caller asked
    # for out-of-core loading or the set exceeds VALID_RESIDENT_MB
    valid_staged: list = []

    def valid_batches():
        if not valid_staged:
            flats = ([] if cfg.dl_offsets else
                     [pack(b, eval_step) for b in loader(valid_ds, False)])
            if flats and sum(f.nbytes for f in flats) / 1e6 <= VALID_RESIDENT_MB:
                valid_staged.append(_to_device(np.stack(flats), device))
            else:
                valid_staged.append(None)
        if valid_staged[0] is not None:
            yield from valid_staged[0]
            return
        staged = _prefetch(loader(valid_ds, False),
                           lambda b: _to_device(pack(b, eval_step), device))
        try:
            yield from staged
        finally:
            staged.close()

    def run_valid():
        """Each batch's [sum(w_i * l_i), sum(w_i), n, correct, tp, fp, fn],
        summed over the ranks in one all-reduce: a batch's loss is that of
        the global batch, the sweep's its mean (in float64)."""
        sums = [eval_step.sums(flat) for flat in valid_batches()]
        if not sums:
            return 0.0, 0.0, 0.0, 0.0
        sums = distributed.all_reduce_sum(torch.stack(sums))
        losses = sums[:, 0] / torch.clamp(sums[:, 1], min=1e-9)
        vloss = float(losses.double().mean())
        n, correct, tp, fp, fn = sums[:, 2:].double().sum(0).tolist()
        acc = correct / n if n else 0.0
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn) if (tp + fn) else 0.0
        return vloss, acc, prec, rec

    def save_ckpt(path, epoch_num=None):
        save_params(path, to_params(model.state_dict()))
        if epoch_num is not None and cfg.save_opt_state:
            save_train_state(path.replace(".ckpt.npz", ".train_state.npz"),
                             optimizer, epoch_num, names)

    curr_best_accuracy = 0.0
    curr_best_loc = 0
    best_epoch_accs: list[float] = []
    ckpts: list[str] = []
    epoch_walls: list[float] = []
    train_losses: list[float] = []
    valid_losses: list[float] = []
    n_steps = 0
    for epoch in range(start_epoch, cfg.max_epoch_num):
        epoch_t0 = time.time()
        curr_best_epoch = 0.0
        accs_per_epoch: list[float] = []
        no_best_model = True
        tlosses: list[torch.Tensor] = []
        start = time.time()
        i = 0  # steps completed this epoch
        staged_train = _prefetch(gen_groups(
            loader(train_ds, True),
            _fuse_schedule(total_step, cfg.step_interval, max(1, cfg.step_fuse))),
            stage_group)
        try:
            for gflat in staged_train:
                for flat in gflat:
                    tlosses.append(train_step.packed(flat, generator))
                i += gflat.shape[0]
                n_steps += gflat.shape[0]
                if i % cfg.step_interval == 0 or i == total_step:
                    tloss_mean = float(torch.stack(tlosses).mean())
                    train_losses.append(tloss_mean)
                    v_meanloss, v_acc, v_prec, v_rec = run_valid()
                    valid_losses.append(v_meanloss)
                    accs_per_epoch.append(v_acc)
                    if v_acc > curr_best_epoch:
                        curr_best_epoch = v_acc
                        if curr_best_epoch > curr_best_accuracy - 0.0002 and is_main:
                            p = (model_dir + cfg.model_type
                                 + ".b{}_epoch{}.ckpt.npz".format(cfg.seq_len, epoch + 1))
                            save_ckpt(p, epoch + 1)
                            ckpts.append(p)
                        if curr_best_epoch > curr_best_accuracy:
                            curr_best_accuracy = curr_best_epoch
                            curr_best_loc = epoch + 1
                            no_best_model = False
                        if (best_epoch_accs and curr_best_epoch > best_epoch_accs[-1]
                                and is_main):
                            save_ckpt(model_dir + cfg.model_type
                                      + ".betterthanlast.b{}_epoch{}.ckpt.npz".format(
                                          cfg.seq_len, epoch + 1))
                    LOGGER.info(
                        "Epoch [%d/%d], Step [%d/%d]; LR: %.4e; TrainLoss: %.4f; "
                        "ValidLoss: %.4f, Acc: %.4f, Prec: %.4f, Reca: %.4f, "
                        "CurrE_best_acc: %.4f, Best_acc: %.4f; Time: %.2fs",
                        epoch + 1, cfg.max_epoch_num, i, total_step, sched.lr,
                        tloss_mean, v_meanloss, v_acc, v_prec, v_rec,
                        curr_best_epoch, curr_best_accuracy, time.time() - start)
                    tlosses = []
                    start = time.time()
        finally:
            staged_train.close()
        epoch_walls.append(time.time() - epoch_t0)
        optimizer.set_learning_rate(sched.epoch_end(accs_per_epoch or [0.0]))
        best_epoch_accs.append(curr_best_epoch)
        if no_best_model and epoch >= cfg.min_epoch_num - 1:
            LOGGER.info("early stop!")
            break
    LOGGER.info("[main]train costs %.1f seconds, best accuracy: %s (epoch %d)",
                time.time() - t0, curr_best_accuracy, curr_best_loc)
    result = {"best_accuracy": curr_best_accuracy, "best_epoch": curr_best_loc,
              "ckpts": ckpts, "epoch_wall_s": epoch_walls, "steps": n_steps,
              "train_losses": train_losses, "valid_losses": valid_losses,
              "world": n_proc, "backend": distributed.backend,
              "allreduce_calls": distributed.allreduce_calls,
              "allreduce_bytes": distributed.allreduce_bytes,
              "allreduce_seconds": distributed.allreduce_seconds}
    LAST_RUN.clear()
    LAST_RUN.update(result)
    return result
