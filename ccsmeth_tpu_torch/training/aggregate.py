"""Training for the call_freqb aggregate regressor (AggrAttRNN) on one GPU
(or the CPU, when asked).

Counterpart of ``ccsmeth_tpu/training/aggregate.py``: MSE against the
BS-seq frequencies of the ``AggreFeaData`` rows (chrom, pos, strand, offsets,
histograms ;-joined, covs, label; ``generate_aggre_train_data.py``'s
format), masked to the batch's valid rows; dropout on the attention context
only; validation RMSE of the output clipped to [0, 1]; a checkpoint on each
new best RMSE (by more than 1e-5) named
'{model_type}.aggre.b{seq_len}_epoch{N}.ckpt.npz' in the JAX package's
``.ckpt.npz`` params format, so either package's ``call_freqb --call_mode
aggregate`` loads it; StepLR on 1 - RMSE; early stop after an epoch without
a new best once min_epoch_num is reached. The model's BiRNN (1 x 32, C =
binsize + 1) trains through kernels K4/K5 (attbigru) or K6 (attbilstm) on
CUDA, and validates through K1; on the CPU through their plain versions.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from ..models import (AggrAttRNN, AggrConfig, aggr_params_from_state_dict,
                      aggr_state_dict_from_params, init_aggr_attrnn)
from ..models.convert import gc_dims, torch_ckpt_to_params
from ..models.params_io import load_params, save_params
from ..pipeline.call_mods import resolve_device
from ..utils.logging import mylogger
from .optim import LrSchedule, build_optimizer

LOGGER = mylogger(__name__)
LAST_RUN: dict = {}  # train_aggregate()'s result of the last run


def load_aggre_tsv(path: str, seq_len: int = 11, binsize: int = 20):
    """Parse AggreFeaData rows -> columnar arrays (offsets, histos, covs, labels)."""
    offsets, histos, covs, labels = [], [], [], []
    with open(path) as rf:
        for line in rf:
            w = line.rstrip("\n").split("\t")
            offsets.append(np.asarray(w[3].split(","), dtype=np.float32))
            histos.append(np.asarray(
                [row.split(",") for row in w[4].split(";")], dtype=np.float32))
            covs.append(np.asarray(w[5].split(","), dtype=np.float32))
            labels.append(float(w[6]))
    return {
        "offsets": np.stack(offsets),
        "histos": np.stack(histos),
        "covs": np.stack(covs),
        "labels": np.asarray(labels, dtype=np.float32),
    }


@dataclasses.dataclass
class AggreTrainConfig:
    train_file: str = ""
    valid_file: str = ""
    model_dir: str = ""
    model_type: str = "attbigru"
    seq_len: int = 11
    layer_rnn: int = 1
    hid_rnn: int = 32
    bin_size: int = 20
    dropout_rate: float = 0.5
    optim_type: str = "Adam"
    batch_size: int = 512
    lr: float = 0.001
    lr_decay: float = 0.1
    lr_decay_step: int = 1
    lr_scheduler: str = "StepLR"
    max_epoch_num: int = 50
    min_epoch_num: int = 5
    step_interval: int = 100
    init_model: str | None = None
    tseed: int = 1234
    device: str = "cuda"

    def model_config(self) -> AggrConfig:
        return AggrConfig(seq_len=self.seq_len, num_layers=self.layer_rnn,
                          dropout_rate=self.dropout_rate, hidden_size=self.hid_rnn,
                          binsize=self.bin_size, model_type=self.model_type)


def _unpack(flat: torch.Tensor, L: int, NB: int):
    """One (B, L + L*NB + 2) fp32 batch -> offsets, histos, labels, mask."""
    offsets = flat[:, :L]
    histos = flat[:, L:L + L * NB].reshape(-1, L, NB)
    return offsets, histos, flat[:, L + L * NB], flat[:, L + L * NB + 1]


def aggr_loss(model: AggrAttRNN, flat: torch.Tensor, generator=None) -> torch.Tensor:
    """The masked MSE of ``train_aggregate``'s ``loss_fn``
    (``aggregate.py:95-99``): the training forward's output against the
    labels over the valid rows."""
    cfg = model.cfg
    offsets, histos, labels, mask = _unpack(flat, cfg.seq_len, cfg.binsize)
    out = model(offsets, histos, train=True, generator=generator)[:, 0]
    se = (out - labels) ** 2 * mask
    return se.sum() / torch.clamp(mask.sum(), min=1.0)


@torch.inference_mode()
def aggr_eval(model: AggrAttRNN, flat: torch.Tensor):
    """(sum of squared errors, valid rows) of the inference forward (K1 on
    CUDA), its output clipped to [0, 1] (``aggregate.py:121-127``)."""
    cfg = model.cfg
    offsets, histos, labels, mask = _unpack(flat, cfg.seq_len, cfg.binsize)
    out = torch.clamp(model(offsets, histos)[:, 0], 0, 1)
    return ((out - labels) ** 2 * mask).sum(), mask.sum()


def train_aggregate(cfg: AggreTrainConfig) -> dict:
    """Run the aggregate trainer; returns {'best_rmse', 'best_epoch',
    'ckpts', 'rmses', 'train_losses', 'epoch_wall_s', 'steps'}."""
    t0 = time.time()
    device = resolve_device(cfg.device)
    model_cfg = cfg.model_config()
    os.makedirs(cfg.model_dir, exist_ok=True)
    train = load_aggre_tsv(cfg.train_file, cfg.seq_len, cfg.bin_size)
    valid = load_aggre_tsv(cfg.valid_file, cfg.seq_len, cfg.bin_size)
    LOGGER.info("train %d rows, valid %d rows", len(train["labels"]),
                len(valid["labels"]))

    if cfg.init_model:
        params = (load_params(cfg.init_model) if cfg.init_model.endswith(".npz")
                  else torch_ckpt_to_params(cfg.init_model, model_cfg))
    else:
        params = init_aggr_attrnn(cfg.tseed, model_cfg)
    model = AggrAttRNN(model_cfg)
    model.load_state_dict(aggr_state_dict_from_params(params))
    model.to(device)
    names = [n for n, _ in model.named_parameters()]
    plist = list(model.parameters())
    optimizer = build_optimizer(cfg.optim_type, cfg.lr)
    optimizer.init(plist, gc_dims(names))
    L, NB = cfg.seq_len, cfg.bin_size
    pad_n = cfg.batch_size

    def batches(data, shuffle, rng):
        n = len(data["labels"])
        idx = np.arange(n)
        if shuffle:
            rng.shuffle(idx)
        for s in range(0, n, cfg.batch_size):
            sel = idx[s:s + cfg.batch_size]
            nv = len(sel)
            flat = np.zeros((pad_n, L + L * NB + 2), np.float32)
            flat[:nv, :L] = data["offsets"][sel]
            flat[:nv, L:L + L * NB] = data["histos"][sel].reshape(nv, -1)
            flat[:nv, L + L * NB] = data["labels"][sel]
            flat[:nv, L + L * NB + 1] = 1.0
            yield torch.from_numpy(flat).to(device)

    sched = LrSchedule(cfg.lr_scheduler, cfg.lr, cfg.lr_decay, cfg.lr_decay_step)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.tseed)
    nprng = np.random.RandomState(cfg.tseed)
    best_rmse = np.inf
    best_epoch = 0
    ckpts: list[str] = []
    rmses: list[float] = []
    train_losses: list[float] = []
    epoch_walls: list[float] = []
    n_steps = 0
    for epoch in range(cfg.max_epoch_num):
        epoch_t0 = time.time()
        no_best = True
        tlosses = []
        for flat in batches(train, True, nprng):
            loss = aggr_loss(model, flat, generator)
            grads = torch.autograd.grad(loss, plist)
            optimizer.step(plist, grads)
            tlosses.append(loss.detach())
            n_steps += 1
        sse = cnt = 0.0
        for flat in batches(valid, False, nprng):
            s, c = aggr_eval(model, flat)
            sse += float(s)
            cnt += float(c)
        rmse = float(np.sqrt(sse / max(cnt, 1.0)))
        tloss = float(torch.stack(tlosses).mean()) if tlosses else 0.0
        rmses.append(rmse)
        train_losses.append(tloss)
        LOGGER.info("Epoch [%d/%d] TrainLoss: %.5f ValidRMSE: %.5f (best %.5f)",
                    epoch + 1, cfg.max_epoch_num, tloss, rmse, best_rmse)
        if rmse < best_rmse - 1e-5:
            best_rmse = rmse
            best_epoch = epoch + 1
            no_best = False
            p = os.path.join(cfg.model_dir, "{}.aggre.b{}_epoch{}.ckpt.npz".format(
                cfg.model_type, cfg.seq_len, epoch + 1))
            save_params(p, aggr_params_from_state_dict(model.state_dict()))
            ckpts.append(p)
        optimizer.set_learning_rate(sched.epoch_end([1.0 - rmse]))
        epoch_walls.append(time.time() - epoch_t0)
        if no_best and epoch >= cfg.min_epoch_num - 1:
            LOGGER.info("early stop!")
            break
    LOGGER.info("[main]train_aggregate costs %.1f s, best RMSE %.5f (epoch %d)",
                time.time() - t0, best_rmse, best_epoch)
    result = {"best_rmse": best_rmse, "best_epoch": best_epoch, "ckpts": ckpts,
              "rmses": rmses, "train_losses": train_losses,
              "epoch_wall_s": epoch_walls, "steps": n_steps}
    LAST_RUN.clear()
    LAST_RUN.update(result)
    return result
