"""Weights across the two packages and from reference checkpoints.

``attrnn_state_dict_from_params`` turns a ``ccsmeth_tpu`` params pytree of an
attrnn family (two-strand with scalar or embedded kinetics, or
single-strand)
(numpy leaves: ``init_attrnn`` output or ``params_io.load_params`` of a native
``.npz``) into ``AttRNN``'s state_dict, and ``attrnn_params_from_state_dict``
carries it back, so a model trained here is saved with ``params_io`` in the
JAX package's own ``.ckpt.npz`` format. ``transenc_state_dict_from_params``
and ``transenc_params_from_state_dict`` do the same for ``TransEnc``
(transencoder2s), and ``aggr_state_dict_from_params`` and
``aggr_params_from_state_dict`` for ``AggrAttRNN`` (call_freqb's aggregate
model). ``torch_ckpt_to_params`` is the counterpart of
``ccsmeth_tpu/models/convert.py``'s: reference ``.ckpt`` -> params pytree.

Layout notes (``ccsmeth_tpu/models/convert.py:8-13``): nn.Linear stores
(out, in) while the params pytree is input-major (in, out), so linear weights
transpose; RNN tensors keep torch's layout and gate order and pass through;
Conv1d weights (out, in, k) pass through; the attention's in_proj (3d, d)
splits into the input-major wq, wk, wv; BatchNorm's running statistics are
buffers of the state_dict.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .config import AggrConfig, AttRNNConfig, TransEncConfig


def _t(a) -> torch.Tensor:
    """A float32 CPU tensor of an array."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))


_TABLES = ("seq_embed", "ipd_embed", "pw_embed", "npass_embed", "map_embed")
# the SrcEmbed conv stacks of the embedded families and their block_plus
_SRC_EMBEDS = (("ipd_std_embed", 1), ("pw_std_embed", 1), ("sn_embed", 0))


def attrnn_state_dict_from_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """params pytree (numpy) -> AttRNN state_dict (float32 CPU tensors,
    BatchNorm's num_batches_tracked 0): the scalar-kinetics families'
    ``embed`` and ``fc1``, or the embedded families' tables, ``SrcEmbed``
    stacks and ``classifier``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    if "embed" in params:
        sd["embed.weight"] = _t(params["embed"])
    for name in _TABLES:
        if name in params:
            sd[name + ".weight"] = _t(params[name])
    for name, _plus in _SRC_EMBEDS:
        if name in params:
            _src_embed_sd(params[name], name, sd)
    sd.update(_rnn_att_sd(params))
    if "fc1" in params:
        _lin_sd(sd, "fc1", params["fc1"])
    else:
        _classifier_sd(params, sd)
    return sd


def aggr_state_dict_from_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """Aggregate-model params pytree (numpy: ``init_aggr_attrnn`` output or a
    loaded ``.npz``) -> AggrAttRNN state_dict (float32 CPU tensors)."""
    sd = _rnn_att_sd(params)
    _lin_sd(sd, "fc1", params["fc1"])
    return sd


def _rnn_att_sd(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """The rnn and attention entries of AttRNN's and AggrAttRNN's state_dict."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for k, ld in enumerate(params["rnn"]):
        for d, suf in (("fwd", ""), ("bwd", "_reverse")):
            sd["rnn.weight_ih_l{}{}".format(k, suf)] = _t(ld[d]["w_ih"])
            sd["rnn.weight_hh_l{}{}".format(k, suf)] = _t(ld[d]["w_hh"])
            sd["rnn.bias_ih_l{}{}".format(k, suf)] = _t(ld[d]["b_ih"])
            sd["rnn.bias_hh_l{}{}".format(k, suf)] = _t(ld[d]["b_hh"])
    for name in ("Wa", "Ua", "va"):
        sd["_att3.{}.weight".format(name)] = _t(np.asarray(params["att"][name]).T)
    return sd


def _lin_sd(sd, prefix: str, lin: dict) -> None:
    """An input-major {'w', 'b'} -> nn.Linear's ``prefix.weight`` (out, in)
    and ``prefix.bias``."""
    sd[prefix + ".weight"] = _t(np.asarray(lin["w"]).T)
    sd[prefix + ".bias"] = _t(lin["b"])


def _classifier_sd(params: dict, sd) -> None:
    """The two-layer classifier (Linear, ReLU, Dropout, Linear): keys
    ``classifier.0`` and ``classifier.3``."""
    for lin, idx in zip(params["classifier"], (0, 3)):
        _lin_sd(sd, "classifier.{}".format(idx), lin)


def attrnn_params_from_state_dict(sd) -> dict:
    """AttRNN (or reference ModelAttRNN / ModelAttRNN2) state_dict (tensors
    on any device, or numpy) -> params pytree (numpy float32): the inverse
    of ``attrnn_state_dict_from_params``, with ``_attrnn_from_sd``'s mapping
    (``ccsmeth_tpu/models/convert.py:87-107``)."""
    sd = _numpy_sd(sd)
    num_layers = sum(1 for k in sd if k.startswith("rnn.weight_ih_l")
                     and not k.endswith("_reverse"))
    params: dict = {}
    if "embed.weight" in sd:
        params["embed"] = sd["embed.weight"]
    for name in _TABLES:
        if name + ".weight" in sd:
            params[name] = sd[name + ".weight"]
    for name, plus in _SRC_EMBEDS:
        if name + ".conv_embed.0.weight" in sd:
            params[name] = _src_embed(sd, name, plus)
    if "fc1.weight" in sd:
        params["fc1"] = _lin(sd, "fc1")
    else:
        params["classifier"] = [_lin(sd, "classifier.0"), _lin(sd, "classifier.3")]
    params["rnn"] = _rnn_layers(sd, "rnn", num_layers)
    params["att"] = _attention(sd)
    return params


def aggr_params_from_state_dict(sd) -> dict:
    """AggrAttRNN (or reference aggregate-model) state_dict (tensors on any
    device, or numpy) -> params pytree (numpy float32): the inverse of
    ``aggr_state_dict_from_params``, with ``_aggr_from_sd``'s mapping
    (``ccsmeth_tpu/models/convert.py:111-117``)."""
    sd = _numpy_sd(sd)
    num_layers = sum(1 for k in sd if k.startswith("rnn.weight_ih_l")
                     and not k.endswith("_reverse"))
    return {"rnn": _rnn_layers(sd, "rnn", num_layers), "att": _attention(sd),
            "fc1": _lin(sd, "fc1")}


def _numpy_sd(sd) -> dict:
    return {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                          np.float32) for k, v in sd.items()}


# state_dict keys stored (out, in) here and input-major in the params pytree
_TRANSPOSED = ("fc1.weight", "_att3.Wa.weight", "_att3.Ua.weight",
               "_att3.va.weight", "classifier.0.weight", "classifier.3.weight")
# transencoder2s: the encoder layers' Linear weights, transposed as well
_TRANSPOSED_SUFFIXES = (".self_attn.out_proj.weight", ".linear1.weight",
                        ".linear2.weight")


def _centralize_qkv(g: torch.Tensor) -> torch.Tensor:
    """The attention's in_proj (3d, d) is the pytree's input-major wq, wk
    and wv, each centralized over its outputs: the mean over each third's
    rows."""
    q = g.reshape(3, g.shape[0] // 3, g.shape[1])
    return (q - q.mean(dim=1, keepdim=True)).reshape(g.shape)


def gc_dims(names) -> list:
    """Per state_dict key, the dims Ranger's gradient centralization averages
    over so that it equals the JAX package's on the params pytree (every dim
    but the first of the pytree leaf): (0,) for the Linear weights, which the
    pytree keeps transposed, ``_centralize_qkv`` for transencoder2s's in_proj,
    None (the default) for the rest."""
    def spec(n):
        if n in _TRANSPOSED or n.endswith(_TRANSPOSED_SUFFIXES):
            return (0,)
        if n.endswith(".self_attn.in_proj_weight"):
            return _centralize_qkv
        return None

    return [spec(n) for n in names]


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


def _src_embed_sd(p: dict, prefix: str, sd) -> None:
    """SrcEmbed params -> state_dict entries under ``prefix``
    (``conv_embed.{0,1,4,5}``, ``conv_embed_plus.{i}.conv_embed.{0,1}``)."""
    def block(conv_key, bn_key, conv, bn):
        sd[conv_key + ".weight"] = _t(conv)
        for key, name in (("scale", "weight"), ("bias", "bias"),
                          ("mean", "running_mean"), ("var", "running_var")):
            sd["{}.{}".format(bn_key, name)] = _t(bn[key])
        sd[bn_key + ".num_batches_tracked"] = torch.tensor(0)

    ce = prefix + ".conv_embed"
    block(ce + ".0", ce + ".1", p["conv1"], p["bn1"])
    block(ce + ".4", ce + ".5", p["conv2"], p["bn2"])
    # a .npz keeps no key for an empty list: sn_embed's block_plus 0 loads
    # without "plus" (params_io's format; the JAX package's apply_src_embed
    # raises a KeyError on such a load)
    for i, blk in enumerate(p.get("plus", [])):
        bp = "{}.conv_embed_plus.{}.conv_embed".format(prefix, i)
        block(bp + ".0", bp + ".1", blk["conv"], blk["bn"])


def transenc_state_dict_from_params(params: dict) -> "OrderedDict[str, torch.Tensor]":
    """transencoder2s params pytree (numpy) -> TransEnc state_dict (float32
    CPU tensors, BatchNorm's num_batches_tracked 0): the inverse of
    ``ccsmeth_tpu/models/convert.py``'s ``_transenc_from_sd``."""
    sd: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for name in ("seq_embed", "ipd_embed", "pw_embed", "npass_embed", "map_embed"):
        if name in params:
            sd[name + ".weight"] = _t(params[name])
    for name in ("ipd_std_embed", "pw_std_embed", "sn_embed", "trans_input"):
        if name in params:
            _src_embed_sd(params[name], name, sd)
    sd["pos_encoder.pos_embed.weight"] = _t(params["pos_embed"])
    for i, lp in enumerate(params["layers"]):
        p = "transformer_encoder.layers.{}.".format(i)
        sd[p + "self_attn.in_proj_weight"] = _t(np.concatenate(
            [np.asarray(lp[k]).T for k in ("wq", "wk", "wv")]))
        sd[p + "self_attn.in_proj_bias"] = _t(np.concatenate(
            [np.asarray(lp[k]) for k in ("bq", "bk", "bv")]))
        sd[p + "self_attn.out_proj.weight"] = _t(np.asarray(lp["wo"]).T)
        sd[p + "self_attn.out_proj.bias"] = _t(lp["bo"])
        for mod, key in (("linear1", "lin1"), ("linear2", "lin2")):
            sd[p + mod + ".weight"] = _t(np.asarray(lp[key]["w"]).T)
            sd[p + mod + ".bias"] = _t(lp[key]["b"])
        for mod, key in (("norm1", "ln1"), ("norm2", "ln2")):
            sd[p + mod + ".weight"] = _t(lp[key]["scale"])
            sd[p + mod + ".bias"] = _t(lp[key]["bias"])
    _classifier_sd(params, sd)
    return sd


def transenc_params_from_state_dict(sd, cfg: TransEncConfig) -> dict:
    """TransEnc (or reference) state_dict (tensors on any device, or numpy)
    -> params pytree (numpy float32): the inverse of
    ``transenc_state_dict_from_params``, with ``_transenc_from_sd``'s
    mapping."""
    sd = _numpy_sd(sd)
    d = cfg.d_model
    params: dict = {
        "seq_embed": sd["seq_embed.weight"],
        "ipd_embed": sd["ipd_embed.weight"],
        "pw_embed": sd["pw_embed.weight"],
        "trans_input": _src_embed(sd, "trans_input", 1),
        "pos_embed": sd["pos_encoder.pos_embed.weight"],
        "classifier": [_lin(sd, "classifier.0"), _lin(sd, "classifier.3")],
        "layers": [],
    }
    if cfg.is_npass:
        params["npass_embed"] = sd["npass_embed.weight"]
    if cfg.is_stds:
        params["ipd_std_embed"] = _src_embed(sd, "ipd_std_embed", 1)
        params["pw_std_embed"] = _src_embed(sd, "pw_std_embed", 1)
    if cfg.is_sn:
        params["sn_embed"] = _src_embed(sd, "sn_embed", 0)
    if cfg.is_map:
        params["map_embed"] = sd["map_embed.weight"]
    for i in range(cfg.num_layers):
        p = "transformer_encoder.layers.{}".format(i)
        in_w = sd[p + ".self_attn.in_proj_weight"]  # (3d, d)
        in_b = sd[p + ".self_attn.in_proj_bias"]
        params["layers"].append({
            "wq": np.ascontiguousarray(in_w[:d].T), "bq": in_b[:d],
            "wk": np.ascontiguousarray(in_w[d:2 * d].T), "bk": in_b[d:2 * d],
            "wv": np.ascontiguousarray(in_w[2 * d:].T), "bv": in_b[2 * d:],
            "wo": np.ascontiguousarray(sd[p + ".self_attn.out_proj.weight"].T),
            "bo": sd[p + ".self_attn.out_proj.bias"],
            "lin1": _lin(sd, p + ".linear1"),
            "lin2": _lin(sd, p + ".linear2"),
            "ln1": {"scale": sd[p + ".norm1.weight"], "bias": sd[p + ".norm1.bias"]},
            "ln2": {"scale": sd[p + ".norm2.weight"], "bias": sd[p + ".norm2.bias"]},
        })
    return params


def _bn(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"],
            "mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]}


def _src_embed(sd, prefix, block_plus):
    p = {"conv1": sd[prefix + ".conv_embed.0.weight"],
         "bn1": _bn(sd, prefix + ".conv_embed.1"),
         "conv2": sd[prefix + ".conv_embed.4.weight"],
         "bn2": _bn(sd, prefix + ".conv_embed.5"),
         "plus": []}
    for i in range(block_plus):
        bp = "{}.conv_embed_plus.{}.conv_embed".format(prefix, i)
        p["plus"].append({"conv": sd[bp + ".0.weight"], "bn": _bn(sd, bp + ".1")})
    return p


def torch_ckpt_to_params(path: str, cfg) -> dict:
    """Reference .ckpt -> params pytree: the attrnn families (AttRNNConfig;
    ModelAttRNN, ModelAttRNN2 and ModelAttRNNss, whose ``embed``, ``rnn``,
    ``_att3`` and ``fc1`` over 2H read as the two-strand scalar family's),
    transencoder2s (TransEncConfig) and the aggregate model (AggrConfig)."""
    if isinstance(cfg, AggrConfig):
        return aggr_params_from_state_dict(load_torch_state_dict(path))
    if isinstance(cfg, TransEncConfig):
        return transenc_params_from_state_dict(load_torch_state_dict(path), cfg)
    if not isinstance(cfg, AttRNNConfig):
        raise TypeError("cfg must be an AttRNNConfig, TransEncConfig or AggrConfig")
    sd = load_torch_state_dict(path)
    params: dict = {}
    if cfg.embedded_kinetics:
        for name in ("seq_embed", "ipd_embed", "pw_embed"):
            params[name] = sd[name + ".weight"]
        if cfg.is_stds:
            params["ipd_std_embed"] = _src_embed(sd, "ipd_std_embed", 1)
            params["pw_std_embed"] = _src_embed(sd, "pw_std_embed", 1)
        if cfg.is_npass:
            params["npass_embed"] = sd["npass_embed.weight"]
        if cfg.is_sn:
            params["sn_embed"] = _src_embed(sd, "sn_embed", 0)
        if cfg.is_map:
            params["map_embed"] = sd["map_embed.weight"]
        params["classifier"] = [_lin(sd, "classifier.0"), _lin(sd, "classifier.3")]
    else:
        params["embed"] = sd["embed.weight"]
        params["fc1"] = _lin(sd, "fc1")
    params["rnn"] = _rnn_layers(sd, "rnn", cfg.num_layers)
    params["att"] = _attention(sd)
    return params
