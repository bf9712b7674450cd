"""JAX parameters → the port's state dicts, and reference checkpoints.

The port's own copy of the numpy state-dict converters of
``avdn_tpu/compat/torch_export.py`` (``bert_state_dict``,
``darknet_state_dict``, ``et_state_dict``, ``lstm_state_dict``): they turn
the JAX package's parameters, given as nested dicts of numpy arrays, into
the reference-format state dicts that the port's modules load with
``strict=True``. :func:`load_reference_agent` reads the ``.pt`` agent
checkpoint that ``export_reference_agent`` and ``tools/export_torch_ckpt.py``
write, in its family's layout (ET: ``{lang_model, vision_model,
vln_model}`` each with a ``state_dict``; LSTM: ``{lang_model, vln_model}``
with the Darknet nested in ``vln_model``).
:func:`train_state_entries` carries a whole JAX ``TrainState`` across:
parameters, BatchNorm statistics, optax's Adam moments and count, and the
step, as the entries of the port's train checkpoint
(``train/checkpoints.py``; :func:`load_train_state` loads them into a port
train state).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from avdn_tpu_torch.config import check_family


def _tt(w):  # flax kernel (in, out) -> torch Linear weight (out, in)
    return np.asarray(w).T


def _n(w):
    return np.asarray(w)


def _conv(w):  # flax HWIO -> torch OIHW
    return np.transpose(np.asarray(w), (3, 2, 0, 1))


def _p(tree):
    return tree["params"] if "params" in tree else tree


# ---------------------------------------------------------------- BERT ----


def bert_state_dict(bert_vars: Dict[str, Any],
                    num_layers: int = 12) -> Dict[str, np.ndarray]:
    """``BertLanguageEncoder`` params → ``CustomBERTModel`` state_dict
    (inverse of torch_import.bert_params_from_torch)."""
    p = _p(bert_vars)
    sd: Dict[str, np.ndarray] = {}
    emb = "bert.embeddings."
    sd[emb + "word_embeddings.weight"] = _n(p["word_embeddings"]["embedding"])
    sd[emb + "position_embeddings.weight"] = _n(
        p["position_embeddings"]["embedding"]
    )
    sd[emb + "token_type_embeddings.weight"] = _n(
        p["token_type_embeddings"]["embedding"]
    )
    sd[emb + "LayerNorm.weight"] = _n(p["embeddings_norm"]["scale"])
    sd[emb + "LayerNorm.bias"] = _n(p["embeddings_norm"]["bias"])
    for i in range(num_layers):
        li = p[f"layer_{i}"]
        pre = f"bert.encoder.layer.{i}."
        for name in ("query", "key", "value"):
            sd[pre + f"attention.self.{name}.weight"] = _tt(
                li["attention"][name]["kernel"]
            )
            sd[pre + f"attention.self.{name}.bias"] = _n(
                li["attention"][name]["bias"]
            )
        sd[pre + "attention.output.dense.weight"] = _tt(
            li["attention_output"]["kernel"]
        )
        sd[pre + "attention.output.dense.bias"] = _n(
            li["attention_output"]["bias"]
        )
        sd[pre + "attention.output.LayerNorm.weight"] = _n(
            li["attention_norm"]["scale"]
        )
        sd[pre + "attention.output.LayerNorm.bias"] = _n(
            li["attention_norm"]["bias"]
        )
        sd[pre + "intermediate.dense.weight"] = _tt(li["intermediate"]["kernel"])
        sd[pre + "intermediate.dense.bias"] = _n(li["intermediate"]["bias"])
        sd[pre + "output.dense.weight"] = _tt(li["output"]["kernel"])
        sd[pre + "output.dense.bias"] = _n(li["output"]["bias"])
        sd[pre + "output.LayerNorm.weight"] = _n(li["output_norm"]["scale"])
        sd[pre + "output.LayerNorm.bias"] = _n(li["output_norm"]["bias"])
    sd["bert.pooler.dense.weight"] = _tt(p["pooler"]["kernel"])
    sd["bert.pooler.dense.bias"] = _n(p["pooler"]["bias"])
    # head Sequential(Linear, ReLU, Dropout, Linear, ReLU) -> indices 0, 3
    sd["linears.0.weight"] = _tt(p["cls_head"]["dense_0"]["kernel"])
    sd["linears.0.bias"] = _n(p["cls_head"]["dense_0"]["bias"])
    sd["linears.3.weight"] = _tt(p["cls_head"]["dense_1"]["kernel"])
    sd["linears.3.bias"] = _n(p["cls_head"]["dense_1"]["bias"])
    return sd


# ------------------------------------------------------------- Darknet ----


def darknet_state_dict(darknet_vars: Dict[str, Any],
                       block_dicts) -> Dict[str, np.ndarray]:
    """NHWC Darknet variables → reference ``module_list.{i}.*`` state_dict
    (src/models/dark_net.py:17-33 naming)."""
    params = darknet_vars["params"]
    stats = darknet_vars.get("batch_stats", {})
    sd: Dict[str, np.ndarray] = {}
    for i, b in enumerate(block_dicts[1:]):
        if b["type"] != "convolutional":
            continue
        conv = params[f"conv_{i}"]
        sd[f"module_list.{i}.conv_{i}.weight"] = _conv(conv["kernel"])
        if int(b.get("batch_normalize", "0")):
            bn_key = f"module_list.{i}.batch_norm_{i}."
            sd[bn_key + "weight"] = _n(params[f"bn_{i}"]["scale"])
            sd[bn_key + "bias"] = _n(params[f"bn_{i}"]["bias"])
            sd[bn_key + "running_mean"] = _n(stats[f"bn_{i}"]["mean"])
            sd[bn_key + "running_var"] = _n(stats[f"bn_{i}"]["var"])
            sd[bn_key + "num_batches_tracked"] = np.asarray(0, np.int64)
        else:
            sd[f"module_list.{i}.conv_{i}.bias"] = _n(conv["bias"])
    return sd


# ------------------------------------------------------------------ ET ----


def _mlp_head_to_seq(sd, head, prefix, linear_indices):
    for j, li in enumerate(linear_indices):
        sd[f"{prefix}.{li}.weight"] = _tt(head[f"dense_{j}"]["kernel"])
        sd[f"{prefix}.{li}.bias"] = _n(head[f"dense_{j}"]["bias"])


def et_state_dict(et_vars: Dict[str, Any],
                  num_layers: int = 2) -> Dict[str, np.ndarray]:
    """``HAATransformer`` params → reference ET state_dict
    (src/models/ET_haa.py:77-119 naming; dead modules omitted — the
    reference loader's key intersection skips them)."""
    p = _p(et_vars)
    sd: Dict[str, np.ndarray] = {}
    sd["attention_layer_vision.linear_in.weight"] = _tt(
        p["vision_attention"]["linear_in"]["kernel"]
    )
    sd["attention_layer_vision.linear_out.weight"] = _tt(
        p["vision_attention"]["linear_out"]["kernel"]
    )
    sd["fc2.weight"] = _tt(p["frame_proj"]["kernel"])
    sd["fc2.bias"] = _n(p["frame_proj"]["bias"])
    sd["direction_embedding.weight"] = _tt(p["direction_embedding"]["kernel"])
    sd["direction_embedding.bias"] = _n(p["direction_embedding"]["bias"])
    sd["encoder_vl.enc_layernorm.weight"] = _n(p["input_norm"]["scale"])
    sd["encoder_vl.enc_layernorm.bias"] = _n(p["input_norm"]["bias"])
    for i in range(num_layers):
        li = p[f"encoder_layer_{i}"]
        pre = f"encoder_vl.enc_transformer.layers.{i}."
        sd[pre + "self_attn.in_proj_weight"] = _tt(li["in_proj"]["kernel"])
        sd[pre + "self_attn.in_proj_bias"] = _n(li["in_proj"]["bias"])
        sd[pre + "self_attn.out_proj.weight"] = _tt(li["out_proj"]["kernel"])
        sd[pre + "self_attn.out_proj.bias"] = _n(li["out_proj"]["bias"])
        sd[pre + "linear1.weight"] = _tt(li["linear1"]["kernel"])
        sd[pre + "linear1.bias"] = _n(li["linear1"]["bias"])
        sd[pre + "linear2.weight"] = _tt(li["linear2"]["kernel"])
        sd[pre + "linear2.bias"] = _n(li["linear2"]["bias"])
        sd[pre + "norm1.weight"] = _n(li["norm1"]["scale"])
        sd[pre + "norm1.bias"] = _n(li["norm1"]["bias"])
        sd[pre + "norm2.weight"] = _n(li["norm2"]["scale"])
        sd[pre + "norm2.bias"] = _n(li["norm2"]["bias"])
    _mlp_head_to_seq(sd, p["action_head"], "decoder_2_action_full", (0, 3, 6))
    sd["fc.0.weight"] = _tt(p["saliency_proj"]["kernel"])
    sd["fc.0.bias"] = _n(p["saliency_proj"]["bias"])
    return sd


# ---------------------------------------------------------------- LSTM ----


def _lstm_cell_to_torch(sd, cell, prefix):
    sd[prefix + ".weight_ih"] = _tt(cell["ih"]["kernel"])
    sd[prefix + ".bias_ih"] = _n(cell["ih"]["bias"])
    sd[prefix + ".weight_hh"] = _tt(cell["hh"]["kernel"])
    sd[prefix + ".bias_hh"] = _n(cell["hh"]["bias"])


def _attention_to_torch(sd, att, prefix):
    sd[prefix + ".linear_in.weight"] = _tt(att["linear_in"]["kernel"])
    sd[prefix + ".linear_out.weight"] = _tt(att["linear_out"]["kernel"])


def lstm_state_dict(lstm_vars: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """``HAALSTM`` params → reference ViT_LSTM state_dict
    (src/models/vln_model.py:163-210 naming; the Darknet's keys go under the
    ``vision_model.`` prefix of the agent checkpoint, :func:`nest_lstm_agent`).
    The ablation cells' params (``HAALSTMVisionOnly``, ``HAALSTMLangOnly``,
    which have no reference export) convert the same way: each module the
    tree holds under its reference name, and the vision-only cell's
    ``state_query`` Dense under its own."""
    p = _p(lstm_vars)
    sd: Dict[str, np.ndarray] = {}
    for flax_name, name in (("vision_attention", "attention_layer_vision"),
                            ("lang_attention", "attention_layer_lang")):
        if flax_name in p:
            _attention_to_torch(sd, p[flax_name], name)
    for flax_name, name in (("vision_lstm", "vision_lstm"),
                            ("direction_lstm", "direct_lstm")):
        if flax_name in p:
            _lstm_cell_to_torch(sd, p[flax_name], name)
    for name in ("direction_embedding", "state_query"):
        if name in p:
            sd[name + ".weight"] = _tt(p[name]["kernel"])
            sd[name + ".bias"] = _n(p[name]["bias"])
    _mlp_head_to_seq(sd, p["action_head"], "decoder_2_action_full", (0, 3, 6))
    if "saliency_head" in p:
        _mlp_head_to_seq(sd, p["saliency_head"], "fc", (0, 3))
    return sd


# --------------------------------------------------------------- agent ----

#: Buffers a released checkpoint may carry that hold no weight: HF's BERT
#: saves ``position_ids`` (an arange), which the JAX importer ignores too.
#: Every other key is loaded strictly.
IGNORED_BUFFERS = {"lang_model": ("bert.embeddings.position_ids",)}

#: Modules of the reference's ET that its forward never runs, which a
#: released ``best_val_unseen`` carries and the JAX importer skips
#: (``dec_action`` and the vision attention's ``c`` head, ET_haa.py:41-52):
#: keys under these prefixes of ``vln_model`` are dropped in the ET layout.
DEAD_MODULES = {"et": {"vln_model": ("dec_action.", "attention_layer_vision.c.")}}


#: the LSTM agent nests the Darknet's keys under this prefix of
#: ``vln_model`` (src/xview_lstm/agent.py:860-877)
VISION_PREFIX = "vision_model."

#: the entries of an agent checkpoint, by family
AGENT_LAYOUTS = {"et": ("lang_model", "vision_model", "vln_model"),
                 "lstm": ("lang_model", "vln_model")}


def nest_lstm_agent(vision: Dict[str, Any], vln: Dict[str, Any]) -> Dict[str, Any]:
    """The LSTM layout's ``vln_model`` dict: the cell's keys and the
    Darknet's under :data:`VISION_PREFIX` (a state dict, or a per-parameter
    dict of optimizer moments)."""
    return {**vln, **{VISION_PREFIX + k: v for k, v in vision.items()}}


def split_lstm_agent(nested: Dict[str, Any]):
    """Inverse of :func:`nest_lstm_agent`: ``(vision, vln)``."""
    n = len(VISION_PREFIX)
    return ({k[n:]: v for k, v in nested.items() if k.startswith(VISION_PREFIX)},
            {k: v for k, v in nested.items() if not k.startswith(VISION_PREFIX)})


def load_reference_agent(path: str, family: str = "et") -> Dict[str, Dict[str, torch.Tensor]]:
    """Read an agent checkpoint ``.pt`` of ``family``'s layout →
    ``{"lang_model", "vision_model", "vln_model"}`` state dicts (CPU
    tensors), without the :data:`IGNORED_BUFFERS` and the reference's
    :data:`DEAD_MODULES`. The ET layout holds the three entries; the LSTM
    layout holds ``lang_model`` and ``vln_model``, with the Darknet's keys
    under ``vision_model.`` in ``vln_model``. Each entry's ``optimizer``
    (the reference's torch optimizer state, or the port's) is not read."""
    check_family(family)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    missing = [k for k in AGENT_LAYOUTS[family] if k not in blob]
    if family == "lstm" and not missing and not any(
            k.startswith(VISION_PREFIX) for k in blob["vln_model"]["state_dict"]):
        missing = [f"vln_model's {VISION_PREFIX}* keys"]
    if missing:
        raise KeyError(
            f"{path}: not a {family} agent checkpoint, missing {missing} (the ET "
            "layout holds lang_model, vision_model and vln_model; the LSTM layout "
            f"holds lang_model and vln_model, the Darknet under {VISION_PREFIX}*; "
            f"the file holds {sorted(k for k in blob if isinstance(blob[k], dict))})")
    sds = {k: blob[k]["state_dict"] for k in AGENT_LAYOUTS[family]}
    if family == "lstm":
        sds["vision_model"], sds["vln_model"] = split_lstm_agent(sds["vln_model"])
    return {k: weights_only(sd, k, family) for k, sd in sds.items()}


def weights_only(sd: Dict[str, Any], entry: str, family: str) -> Dict[str, Any]:
    """``sd`` (the state dict of checkpoint entry ``entry``) without the
    :data:`IGNORED_BUFFERS` and the :data:`DEAD_MODULES` of ``family``."""
    dead = DEAD_MODULES.get(family, {}).get(entry, ())
    return {name: v for name, v in sd.items()
            if name not in IGNORED_BUFFERS.get(entry, ()) and not name.startswith(dead)}


def load_agent_weights(models, state_dicts: Dict[str, Dict[str, Any]]) -> None:
    """Load ``{lang_model, vision_model, vln_model}`` state dicts (numpy
    arrays or tensors) strictly into ``(bert, darknet, vln)``."""
    for model, key in zip(models, ("lang_model", "vision_model", "vln_model")):
        model.load_state_dict({k: torch.as_tensor(np.array(v))
                               for k, v in state_dicts[key].items()}, strict=True)


# ---------------------------------------------------------- train state ----


def _adam_state(opt_state):
    """The Adam state (``count``, ``mu``, ``nu``) inside an optax chain's
    state tuple (found by its fields: no optax import)."""
    stack = [opt_state]
    while stack:
        st = stack.pop()
        if all(hasattr(st, f) for f in ("count", "mu", "nu")):
            return st
        if isinstance(st, (tuple, list)):
            stack.extend(st)
    raise ValueError("no Adam state (count, mu, nu) in the optimizer state")


def train_state_entries(state, block_dicts, bert_layers: int = 12,
                        et_layers: int = 2, family: str = "et") -> Dict[str, Any]:
    """A JAX ``TrainState`` (numpy leaves) of ``family`` → ``{"step",
    "lang_model", "vision_model", "vln_model"}``, each entry
    ``{"state_dict", "optimizer": {"count", "mu", "nu"}}`` in the port's
    names. The moments of a weight are laid out as the weight (a Dense
    kernel transposed, a conv kernel to OIHW)."""
    vln_sd = ((lambda t: et_state_dict({"params": t}, et_layers)) if family == "et"
              else (lambda t: lstm_state_dict({"params": t})))
    stats = state.batch_stats
    groups = {
        "lang_model": (lambda t: bert_state_dict({"params": t}, bert_layers),
                       state.bert_params, state.opt_bert),
        "vision_model": (lambda t: darknet_state_dict(
            {"params": t, "batch_stats": stats}, block_dicts),
                         state.darknet_params, state.opt_darknet),
        "vln_model": (vln_sd, state.vln_params, state.opt_vln),
    }
    out: Dict[str, Any] = {"step": int(np.asarray(state.step))}
    buffers = ("running_mean", "running_var", "num_batches_tracked")
    for key, (convert, params, opt_state) in groups.items():
        adam = _adam_state(opt_state)
        moments = [{k: v for k, v in convert(m).items() if not k.endswith(buffers)}
                   for m in (adam.mu, adam.nu)]
        out[key] = {"state_dict": convert(params), "optimizer": {
            "count": int(np.asarray(adam.count)), "mu": moments[0], "nu": moments[1]}}
    return out


def load_train_state(train_state, entries: Dict[str, Any]) -> None:
    """Load :func:`train_state_entries` into a port ``TrainState`` in place:
    the modules strictly, the optimizers' moments and counts by parameter
    name, and the step."""
    for key, model, opt in zip(("lang_model", "vision_model", "vln_model"),
                               train_state.models(), train_state.optimizers()):
        e = entries[key]
        model.load_state_dict({k: torch.as_tensor(np.array(v))
                               for k, v in e["state_dict"].items()}, strict=True)
        o = e["optimizer"]
        opt.load_state_dict({"count": o["count"],
                             **{m: {k: torch.as_tensor(np.array(v)) for k, v in o[m].items()}
                                for m in ("mu", "nu")}})
    train_state.step = entries["step"]
