"""Training loop on one GPU (or the CPU, when asked).

Counterpart of ``ccsmeth_tpu/training/train.py`` for one device: no mesh, no
``shard_map`` and no collectives. The model is ``AttRNN`` (attbigru2s,
attbilstm2s, or the embedded-kinetics attbigru2s2 and attbilstm2s2); its
BiRNN trains through kernels K4/K5 (``ops/bigru_vjp.py``, GRU) or K6
(``ops/bilstm_vjp.py``, LSTM) on CUDA and through their plain versions on the
CPU, and validation runs the inference forward, kernel K1, in f32 as the JAX
package's eval step does. The embedded families' ``SrcEmbed`` BatchNorms
train on each batch's statistics (pad rows included, as in the JAX package)
and keep their running stats as loaded: those are buffers, which no
optimizer touches, as JAX's optimizers leave leaves with zero gradient.

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
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
import time

import numpy as np
import torch

from ..models import (AttRNN, AttRNNConfig, attrnn_params_from_state_dict,
                      attrnn_state_dict_from_params, init_attrnn)
from ..models.attrnn import PORTED
from ..models.convert import gc_dims, torch_ckpt_to_params
from ..models.params_io import load_params, save_params
from ..pipeline.call_mods import resolve_device
from ..utils.logging import mylogger
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
    precision: str = "fp32"  # fp32 | bf16 (BiRNN operand type)
    train_transfer: str = "fp32"  # only fp32 is ported
    dist_coordinator: str | None = None  # trainm: not ported
    num_processes: int = 1
    process_id: int = 0
    device: str = "cuda"

    def model_config(self) -> AttRNNConfig:
        return AttRNNConfig(
            seq_len=self.seq_len, num_layers=self.layer_rnn,
            num_classes=self.class_num, dropout_rate=self.dropout_rate,
            hidden_size=self.hid_rnn, is_npass=self.is_npass, is_sn=self.is_sn,
            is_map=self.is_map, is_stds=self.is_stds, model_type=self.model_type)


def _check_unported(cfg: TrainConfig) -> None:
    if cfg.model_type not in PORTED:
        raise NotImplementedError(
            "--model_type {} is not yet ported for training ({} only)".format(
                cfg.model_type, ", ".join(PORTED)))
    if cfg.train_transfer != "fp32":
        raise NotImplementedError(
            "--train_transfer {} is not yet ported (fp32 only)".format(
                cfg.train_transfer))
    if cfg.num_processes > 1 or cfg.dist_coordinator:
        raise NotImplementedError(
            "multi-process training (trainm, --num_processes > 1, "
            "--dist_coordinator) is not yet ported")
    if cfg.precision not in ("fp32", "bf16"):
        raise ValueError("--precision must be fp32 or bf16")


def _init_params(cfg: TrainConfig, model_cfg) -> dict:
    if cfg.init_model:
        LOGGER.info("loading pre-trained model: %s", cfg.init_model)
        if cfg.init_model.endswith(".npz"):
            return load_params(cfg.init_model)
        return torch_ckpt_to_params(cfg.init_model, model_cfg)
    return init_attrnn(cfg.tseed, model_cfg)


def _batch_layout(model_cfg) -> list[tuple[str, int]]:
    """Column layout of a packed (B, n_cols) fp32 training batch: every feature
    channel flattened side by side, then one labels column and one mask column."""
    from .data import _FEATURE_KEYS, _FEATURE_KEYS_SS

    L = model_cfg.seq_len
    keys = (_FEATURE_KEYS if getattr(model_cfg, "two_strand", True)
            else _FEATURE_KEYS_SS)
    return [(k, 4 if k.startswith("sns") else L) for k in keys]


def _pack_cols(fields, feats: dict, labels, mask) -> np.ndarray:
    B = np.asarray(labels).shape[0]
    cols = []
    for k, n in fields:
        v = np.asarray(feats[k], np.float32).reshape(B, -1)
        assert v.shape[1] == n, "channel {} has {} cols, layout says {}".format(
            k, v.shape[1], n)
        cols.append(v)
    cols.append(np.asarray(labels, np.float32).reshape(B, 1))
    cols.append(np.asarray(mask, np.float32).reshape(B, 1))
    return np.ascontiguousarray(np.concatenate(cols, axis=1))


def _unpack_cols(flat: torch.Tensor, fields):
    feats, o = {}, 0
    for k, n in fields:
        feats[k] = flat[:, o:o + n]
        o += n
    labels = flat[:, o].long()
    mask = flat[:, o + 1]
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


def weighted_ce(logits, labels, mask, class_weights) -> torch.Tensor:
    """torch CrossEntropyLoss(weight=[1, pos_weight]) over the valid rows:
    sum(w_i * l_i) / sum(w_i), the padding mask folded into w."""
    per = torch.logsumexp(logits, dim=1) - logits.gather(1, labels[:, None])[:, 0]
    w = class_weights[labels] * mask
    return (per * w).sum() / torch.clamp(w.sum(), min=1e-9)


def make_train_step(model: AttRNN, optimizer, pos_weight: float,
                    compute_dtype=torch.float32):
    """(feats, labels, mask, generator) -> loss: the forward in training mode
    (dropout from ``generator``), the weighted CE, its gradients through
    autograd (K5 or K6's backward for the BiRNN on CUDA), then clip and the optimizer, which
    updates the model's parameters in place. ``optimizer.init`` must have
    run on ``model.parameters()``. ``step.packed(flat, generator)`` takes one
    packed (B, n_cols) batch, ``step.pack_batch`` makes one."""
    params = list(model.parameters())
    dev = params[0].device
    class_weights = torch.tensor([1.0, pos_weight], dtype=torch.float32, device=dev)
    fields = _batch_layout(model.cfg)

    def step(feats, labels, mask, generator=None):
        logits, _probs = model(feats, compute_dtype, train=True, generator=generator)
        loss = weighted_ce(logits, labels, mask, class_weights)
        grads = torch.autograd.grad(loss, params)
        optimizer.step(params, grads)
        return loss.detach()

    step.packed = lambda flat, generator=None: step(*_unpack_cols(flat, fields),
                                                    generator)
    step.pack_batch = lambda feats, labels, mask: _pack_cols(fields, feats,
                                                             labels, mask)
    return step


def make_eval_step(model: AttRNN, pos_weight: float):
    """(feats, labels, mask) -> (loss, pred, counts): the inference forward in
    f32 (K1 on CUDA), counts = [n_valid, correct, tp, fp, fn] on the device.
    ``step.packed`` and ``step.pack_batch`` as for the train step."""
    dev = next(model.parameters()).device
    class_weights = torch.tensor([1.0, pos_weight], dtype=torch.float32, device=dev)
    fields = _batch_layout(model.cfg)

    @torch.inference_mode()
    def step(feats, labels, mask):
        logits, probs = model(feats)
        loss = weighted_ce(logits, labels, mask, class_weights)
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
        return loss, pred, counts

    step.packed = lambda flat: step(*_unpack_cols(flat, fields))
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
    'epoch_wall_s', 'steps', 'train_losses', 'valid_losses'}."""
    t0 = time.time()
    _check_unported(cfg)
    device = resolve_device(cfg.device)
    model_cfg = cfg.model_config()
    model_dir = cfg.model_dir
    if model_dir != "/":
        model_dir = os.path.abspath(model_dir).rstrip("/")
        os.makedirs(model_dir, exist_ok=True)
        # clear stale ckpts of this model_type (train.py:77-80)
        rx = re.compile(r"" + cfg.model_type + r"\..*b\d+_epoch\d+\.ckpt.*")
        for mfile in os.listdir(model_dir):
            if rx.match(mfile):
                os.remove(os.path.join(model_dir, mfile))
        model_dir += "/"

    LOGGER.info("reading data..")
    if cfg.dl_offsets:
        train_ds = StreamingFeatureDataset(cfg.train_file, cfg.seq_len)
        valid_ds = StreamingFeatureDataset(cfg.valid_file, cfg.seq_len)
    else:
        train_ds = FeatureDataset.from_tsv(cfg.train_file, cfg.seq_len)
        valid_ds = FeatureDataset.from_tsv(cfg.valid_file, cfg.seq_len)

    if cfg.resume_from:
        cfg = dataclasses.replace(cfg, init_model=cfg.resume_from)
    model = AttRNN(model_cfg)
    model.load_state_dict(attrnn_state_dict_from_params(_init_params(cfg, model_cfg)))
    model.to(device)
    names = [n for n, _ in model.named_parameters()]
    optimizer = build_optimizer(cfg.optim_type, cfg.lr)
    optimizer.init(model.parameters(), gc_dims(names))
    compute_dtype = torch.bfloat16 if cfg.precision == "bf16" else torch.float32
    train_step = make_train_step(model, optimizer, cfg.pos_weight, compute_dtype)
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
    sched = LrSchedule(cfg.lr_scheduler, cfg.lr, cfg.lr_decay, cfg.lr_decay_step,
                       cfg.lr_patience, cfg.lr_mode_strategy)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.tseed)
    nprng = np.random.RandomState(cfg.tseed)
    pad_n = cfg.batch_size
    total_step = -(-len(train_ds) // cfg.batch_size)
    LOGGER.info("total_step: %d", total_step)

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
                     [pack(b, eval_step) for b in valid_ds.batches(
                         cfg.batch_size, False, nprng, pad_to=pad_n)])
            if flats and sum(f.nbytes for f in flats) / 1e6 <= VALID_RESIDENT_MB:
                valid_staged.append(_to_device(np.stack(flats), device))
            else:
                valid_staged.append(None)
        if valid_staged[0] is not None:
            yield from valid_staged[0]
            return
        staged = _prefetch(valid_ds.batches(cfg.batch_size, False, nprng,
                                            pad_to=pad_n),
                           lambda b: _to_device(pack(b, eval_step), device))
        try:
            yield from staged
        finally:
            staged.close()

    def run_valid():
        losses, counts = [], []
        for flat in valid_batches():
            loss, _pred, c = eval_step.packed(flat)
            losses.append(loss)
            counts.append(c)
        if not losses:
            return 0.0, 0.0, 0.0, 0.0
        # the validation loss is averaged in float64
        vloss = float(torch.stack(losses).double().mean())
        n, correct, tp, fp, fn = torch.stack(counts).double().sum(0).tolist()
        acc = correct / n if n else 0.0
        prec = tp / (tp + fp) if (tp + fp) else 0.0
        rec = tp / (tp + fn) if (tp + fn) else 0.0
        return vloss, acc, prec, rec

    def save_ckpt(path, epoch_num=None):
        save_params(path, attrnn_params_from_state_dict(model.state_dict()))
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
            train_ds.batches(cfg.batch_size, True, nprng, pad_to=pad_n),
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
                        if curr_best_epoch > curr_best_accuracy - 0.0002:
                            p = (model_dir + cfg.model_type
                                 + ".b{}_epoch{}.ckpt.npz".format(cfg.seq_len, epoch + 1))
                            save_ckpt(p, epoch + 1)
                            ckpts.append(p)
                        if curr_best_epoch > curr_best_accuracy:
                            curr_best_accuracy = curr_best_epoch
                            curr_best_loc = epoch + 1
                            no_best_model = False
                        if best_epoch_accs and curr_best_epoch > best_epoch_accs[-1]:
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
              "train_losses": train_losses, "valid_losses": valid_losses}
    LAST_RUN.clear()
    LAST_RUN.update(result)
    return result
