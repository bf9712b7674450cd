"""Checkpoints of the train state, and the pretrained-tower imports (torch
counterpart of ``avdn_tpu/train/checkpoints.py``).

The reference snapshots a dict of three submodel entries per checkpoint
file, ``{lang_model, vision_model, vln_model}`` each ``{epoch, state_dict,
optimizer}``, and selects the best by val_unseen SPL
(src/xview_et/agent.py:899-945, src/xview_et/main.py:200-204); the LSTM
family's has two, ``{lang_model, vln_model}``, the Darknet nested in the
VLN model under ``vision_model.`` (src/xview_lstm/agent.py:860-877). The
port writes its family's layout as one ``.pt``: the ``state_dict``s in the
reference's key layout (the BatchNorm running statistics inside the vision
model's), so ``compat/from_jax.py:load_reference_agent`` and ``valid()``
read a training checkpoint unchanged; ``optimizer`` holds the port's Adam state (``count``
and the moments by parameter name); a top-level ``step`` holds the train
step. ``asynchronous=True`` copies the state to the host and writes on a
background thread, the counterpart of orbax's async save;
``wait_for_saves`` blocks until every write is on disk.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List

import torch

from avdn_tpu_torch.compat.from_jax import nest_lstm_agent, split_lstm_agent, weights_only

#: the checkpoint's submodel entries, in the train state's order
ENTRIES = ("lang_model", "vision_model", "vln_model")

_pending: List[threading.Thread] = []


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _snapshot(state) -> Dict:
    """The checkpoint blob of ``state`` in its family's layout: ET three
    entries; LSTM ``lang_model`` and ``vln_model``, the Darknet's weights,
    statistics and Adam moments under ``vision_model.`` in ``vln_model``
    (its count is the VLN optimizer's: both step every step)."""
    blob = {"step": state.step}
    for key, model, opt in zip(ENTRIES, state.models(), state.optimizers()):
        blob[key] = {"epoch": state.step + 1, "state_dict": model.state_dict(),
                     "optimizer": opt.state_dict()}
    if state.family == "lstm":
        vision, vln = blob.pop("vision_model"), blob["vln_model"]
        vln["state_dict"] = nest_lstm_agent(vision["state_dict"], vln["state_dict"])
        for m in ("mu", "nu"):
            vln["optimizer"][m] = nest_lstm_agent(vision["optimizer"][m],
                                                  vln["optimizer"][m])
    return _to_host(blob)


def _entries(blob: Dict, family: str) -> Dict:
    """The three ``{state_dict, optimizer}`` entries of a checkpoint blob of
    ``family``'s layout, in the train state's order (:data:`ENTRIES`)."""
    if family != "lstm":
        return {key: blob[key] for key in ENTRIES}
    vln = blob["vln_model"]
    vision_sd, vln_sd = split_lstm_agent(vln["state_dict"])
    opt = vln.get("optimizer")
    vision_opt = vln_opt = opt
    if isinstance(opt, dict) and "mu" in opt:
        split = {m: split_lstm_agent(opt[m]) for m in ("mu", "nu")}
        vision_opt, vln_opt = ({"count": opt["count"], **{m: split[m][i] for m in split}}
                               for i in (0, 1))
    return {"lang_model": blob["lang_model"],
            "vision_model": {"state_dict": vision_sd, "optimizer": vision_opt},
            "vln_model": dict(vln, state_dict=vln_sd, optimizer=vln_opt)}


def _write(blob: Dict, path: str) -> None:
    tmp = path + f".tmp{os.getpid()}"
    torch.save(blob, tmp)
    os.replace(tmp, path)  # a reader never sees a half-written file


def save_checkpoint(ckpt_dir: str, name: str, state, asynchronous: bool = False) -> str:
    """Save the train state as ``<ckpt_dir>/<name>.pt``; returns the path.
    With ``asynchronous`` the host copy is taken now and the file written
    on a background thread (``wait_for_saves`` before reading it)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, name + ".pt"))
    blob = _snapshot(state)
    if asynchronous:
        thread = threading.Thread(target=_write, args=(blob, path), daemon=True)
        thread.start()
        _pending.append(thread)
    else:
        _write(blob, path)
    return path


def wait_for_saves() -> None:
    """Block until every asynchronous write has finished."""
    while _pending:
        _pending.pop().join()


def load_checkpoint(path: str, state, optimizer: bool = True) -> int:
    """Load a checkpoint of ``state.family``'s layout into ``state`` in
    place: the three modules strictly (BatchNorm statistics included; HF's
    ``position_ids`` and the reference's dead ET modules are skipped, as
    ``compat/from_jax.py:load_reference_agent`` skips them) and, with
    ``optimizer``, the three optimizers' states. Returns and sets the
    checkpoint's step (for a reference checkpoint without one, its
    ``epoch`` − 1, as the reference's loader returns it)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    entries = _entries(blob, state.family)
    for key, model in zip(ENTRIES, state.models()):
        model.load_state_dict(weights_only(entries[key]["state_dict"], key, state.family),
                              strict=True)
    if optimizer:
        for key, opt in zip(ENTRIES, state.optimizers()):
            if not isinstance(entries[key].get("optimizer"), dict) or \
                    "mu" not in entries[key]["optimizer"]:
                raise KeyError(f"{path}: {key} holds no optimizer state of the "
                               "port's (--resume_optimizer needs one)")
            opt.load_state_dict(entries[key]["optimizer"])
    state.step = int(blob.get("step", int(blob["vln_model"].get("epoch", 1)) - 1))
    return state.step


@torch.no_grad()
def import_bert_pretrain(path: str, bert_model) -> None:
    """Load a raw HuggingFace BERT checkpoint (``pytorch_model.bin``:
    ``bert.``-prefixed keys with ``cls.*`` heads, or a bare ``BertModel``
    state dict) into the language tower's body, as the reference
    initialises it (``AutoModel.from_pretrained('bert-base-uncased')``,
    src/models/vln_model.py:131). The 768→64→49 head keeps its random
    init, as in the reference and the JAX importer. Raises on a missing
    key."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob)
    if not any(k.startswith("bert.") for k in sd):
        sd = {"bert." + k: v for k, v in sd.items()}
    body = {k: v for k, v in bert_model.state_dict().items()
            if not k.startswith("linears.")}
    missing = sorted(k for k in body if k not in sd)
    if missing:
        raise KeyError(f"{path}: not a BERT checkpoint of this width (missing "
                       f"{missing[:4]}{'...' if len(missing) > 4 else ''})")
    for k, v in body.items():
        v.copy_(torch.as_tensor(sd[k]))


@torch.no_grad()
def import_darknet_pretrain(path: str, darknet_model) -> None:
    """Load the released YOLO pretrain (``{'model': state_dict}`` or a bare
    state dict) into the vision tower: every conv and BatchNorm tensor of
    the tower's cfg, by the reference's names (src/xview_et/agent.py:136-141
    keeps the keys the model has). ``num_batches_tracked`` is optional.
    Raises on a missing key."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob["model"] if "model" in blob else blob
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    own = darknet_model.state_dict()
    missing = sorted(k for k in own if k not in sd and not k.endswith("num_batches_tracked"))
    if missing:
        raise KeyError(f"{path}: not a Darknet checkpoint of this cfg (missing "
                       f"{missing[:4]}{'...' if len(missing) > 4 else ''})")
    for k, v in own.items():
        if k in sd:
            v.copy_(torch.as_tensor(sd[k]))
