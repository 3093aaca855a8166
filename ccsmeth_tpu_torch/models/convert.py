"""Weights across the two packages and from reference checkpoints.

``attrnn_state_dict_from_params`` turns a ``ccsmeth_tpu`` params pytree
(numpy leaves: ``init_attrnn`` output or ``params_io.load_params`` of a native
``.npz``) into ``AttRNN``'s state_dict, and ``attrnn_params_from_state_dict``
carries it back, so a model trained here is saved with ``params_io`` in the
JAX package's own ``.ckpt.npz`` format. ``torch_ckpt_to_params`` is the
counterpart of ``ccsmeth_tpu/models/convert.py``'s: reference ``.ckpt`` ->
params pytree.

Layout notes (``ccsmeth_tpu/models/convert.py:8-13``): nn.Linear stores
(out, in) while the params pytree is input-major (in, out), so linear weights
transpose; RNN tensors keep torch's layout and gate order and pass through.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .config import AttRNNConfig


def attrnn_state_dict_from_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """params pytree (numpy) -> AttRNN state_dict (float32 CPU tensors)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))

    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    sd["embed.weight"] = t(params["embed"])
    for k, ld in enumerate(params["rnn"]):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            sd["rnn.weight_ih_l{}{}".format(k, suf)] = t(ld[d]["w_ih"])
            sd["rnn.weight_hh_l{}{}".format(k, suf)] = t(ld[d]["w_hh"])
            sd["rnn.bias_ih_l{}{}".format(k, suf)] = t(ld[d]["b_ih"])
            sd["rnn.bias_hh_l{}{}".format(k, suf)] = t(ld[d]["b_hh"])
    for name in ("Wa", "Ua", "va"):
        sd["_att3.{}.weight".format(name)] = t(np.asarray(params["att"][name]).T)
    sd["fc1.weight"] = t(np.asarray(params["fc1"]["w"]).T)
    sd["fc1.bias"] = t(params["fc1"]["b"])
    return sd


def attrnn_params_from_state_dict(sd) -> dict:
    """AttRNN state_dict (tensors on any device, or numpy) -> params pytree
    (numpy float32): the inverse of ``attrnn_state_dict_from_params``."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        np.float32) for k, v in sd.items()}
    num_layers = sum(1 for k in sd if k.startswith("rnn.weight_ih_l")
                     and not k.endswith("_reverse"))
    return {"embed": sd["embed.weight"], "rnn": _rnn_layers(sd, "rnn", num_layers),
            "att": _attention(sd), "fc1": _lin(sd, "fc1")}


# state_dict keys stored (out, in) here and input-major in the params pytree
_TRANSPOSED = ("fc1.weight", "_att3.Wa.weight", "_att3.Ua.weight",
               "_att3.va.weight")


def gc_dims(names) -> list:
    """Per state_dict key, the dims Ranger's gradient centralization averages
    over so that it equals the JAX package's on the params pytree (every dim
    but the first of the pytree leaf): (0,) for the Linear weights, which the
    pytree keeps transposed, None (the default) for the rest."""
    return [(0,) if n in _TRANSPOSED else None for n in names]


def load_torch_state_dict(path: str) -> "OrderedDict[str, np.ndarray]":
    sd = torch.load(path, map_location="cpu", weights_only=True)
    out = OrderedDict()
    for k, v in sd.items():
        if k.startswith("module."):  # DDP-saved (train_multigpu.py:395-412)
            k = k[7:]
        out[k] = v.detach().cpu().numpy()
    return out


def _lin(sd, prefix):
    return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T),
            "b": sd[prefix + ".bias"]}


def _rnn_layers(sd, prefix, num_layers):
    layers = []
    for k in range(num_layers):
        ld = {}
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            ld[d] = {
                "w_ih": sd["{}.weight_ih_l{}{}".format(prefix, k, suf)],
                "w_hh": sd["{}.weight_hh_l{}{}".format(prefix, k, suf)],
                "b_ih": sd["{}.bias_ih_l{}{}".format(prefix, k, suf)],
                "b_hh": sd["{}.bias_hh_l{}{}".format(prefix, k, suf)],
            }
        layers.append(ld)
    return layers


def _attention(sd, prefix="_att3"):
    return {name: np.ascontiguousarray(sd["{}.{}.weight".format(prefix, name)].T)
            for name in ("Wa", "Ua", "va")}


def torch_ckpt_to_params(path: str, cfg: AttRNNConfig) -> dict:
    """Reference .ckpt -> params pytree (scalar-kinetics families)."""
    if not isinstance(cfg, AttRNNConfig) or cfg.embedded_kinetics:
        raise NotImplementedError(
            "only the scalar-kinetics attrnn families are ported")
    sd = load_torch_state_dict(path)
    return {"embed": sd["embed.weight"], "fc1": _lin(sd, "fc1"),
            "rnn": _rnn_layers(sd, "rnn", cfg.num_layers),
            "att": _attention(sd)}
