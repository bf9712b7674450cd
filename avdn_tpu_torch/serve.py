"""Batch-inference API (torch counterpart of ``avdn_tpu/serve.py``).

Load weights once (random from ``--seed``, or a reference-format ``.pt``
agent checkpoint in ``--family``'s layout), then map ANDH-format annotation
items to predicted trajectories with a student-forced rollout
(``compute_losses=False`` — no ground truth required). Batches pad to a fixed serving batch size.

    args = parse_args(["--resume_file", "agent.pt", "--root_dir", dataset])
    nav = Navigator(args)
    preds = nav.navigate(items)              # {instr_id: {path_corners, actions, progress}}

It runs on the card unless ``device="cpu"`` is passed; without a card it
raises. Serving uses the eval config with the JAX package's defaults: the
two-pass render (its crop sized from the annotations under ``--root_dir``
with ``--render_crop 0``, 512 px without them), bf16 towers on the card
(fp32 on the CPU) and the BN-folded tower; ``--render_twopass False --bf16
False`` restore the reference numerics. The constructor sets
``torch.backends.cudnn.allow_tf32`` and
``torch.backends.cuda.matmul.allow_tf32`` to False.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from avdn_tpu_torch.compat.from_jax import load_agent_weights, load_reference_agent
from avdn_tpu_torch.config import Args
from avdn_tpu_torch.data.batcher import make_train_batch
from avdn_tpu_torch.data.maps import DeviceMapBank
from avdn_tpu_torch.data.prefetch import Prefetcher
from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
from avdn_tpu_torch.device import resolve_device, use_fp32_numerics
from avdn_tpu_torch.metrics.nav import assemble_trajectories
from avdn_tpu_torch.train.loop import (
    batcher_config,
    build_models,
    check_supported,
    eval_bf16,
    eval_config_from_args,
    init_state,
    resolve_inference_checkpoint,
    resolve_render_crop,
)
from avdn_tpu_torch.train.step import make_eval_rollout


class Navigator:
    """Closed-loop navigation for serving.

    ``serve_batch`` fixes the batch size: shorter item lists are padded
    (padding items are dropped from the returned predictions), longer lists
    are chunked. ``map_loader`` (item → RGB uint8 map) replaces the GeoTIFF
    decode of the map bank. The built models (``bert``, ``darknet``,
    ``vln``), the eval config (``cfg``) and the bank are attributes, so the
    validation rollouts can be built over the same weights.
    """

    def __init__(self, args: Args, serve_batch: Optional[int] = None,
                 device=None, map_loader=None):
        self.device = resolve_device(device)
        check_supported(args, self.device)
        use_fp32_numerics()
        self.args = args = resolve_render_crop(args)
        self.serve_batch = serve_batch or args.batch_size
        self.cfg = eval_config_from_args(args)
        self.bert, self.darknet, self.vln = build_models(
            args, self.device, bf16=eval_bf16(args, self.device))
        init_state((self.bert, self.darknet, self.vln),
                   torch.Generator().manual_seed(args.seed))
        resolve_inference_checkpoint(args)
        if args.resume_file:
            load_agent_weights((self.bert, self.darknet, self.vln),
                               load_reference_agent(args.resume_file, args.family))
        self.tokenizer = WordPieceTokenizer.load(args.bert_vocab_file)
        self.bcfg = batcher_config(args)
        self.bank = DeviceMapBank(
            args.val_dataset_dir, (args.map_bank_px, args.map_bank_px),
            n_slots=args.map_bank_slots, device=self.device, loader=map_loader)
        self._rollout = make_eval_rollout(self.cfg, self.bert, self.darknet,
                                          self.vln, teacher=False,
                                          compute_losses=False)
        self._gen = torch.Generator(self.device).manual_seed(args.seed)

    @staticmethod
    def _normalize_item(item: dict) -> dict:
        """Accept raw ANDH items; fill the GT-only fields serving doesn't
        need (losses are off) so the batcher's static shapes hold."""
        it = dict(item)
        it.setdefault("route_index", "0_1")
        it["angle"] = round(float(it["angle"])) % 360
        it["instructions"] = str(it["instructions"]).lower()
        pd = it.get("pre_dialogs", "")
        it["pre_dialogs"] = (" ".join(pd) if isinstance(pd, list) else str(pd)).lower()
        start = np.asarray(it["gt_path_corners"][0] if it.get("gt_path_corners")
                           else it["start_corners"], np.float64)
        it["gt_path_corners"] = [np.asarray(c, np.float64)
                                 for c in (it.get("gt_path_corners") or [start])]
        it.setdefault("attention_list", [])
        return it

    # -- pipeline stages: navigate() composes these -------------------------

    def prepare(self, chunk: List[dict]):
        """Host batch assembly (map decode into the bank, tokenisation,
        batch build, upload) for ONE ≤ ``serve_batch`` chunk of normalized
        items. Safe while a previous ``launch`` is still running on the card
        (the bank copies on write)."""
        chunk = list(chunk)
        while len(chunk) < self.serve_batch:  # pad; dropped via meta["valid"]
            chunk = chunk + [dict(chunk[0], _pad=True)]
        bank, slot_of = self.bank.prepare(chunk)
        batch, meta = make_train_batch(chunk, self.tokenizer, slot_of, self.bcfg,
                                       device=self.device)
        return bank, batch, meta

    def launch(self, prepared):
        """Enqueue the rollout for a ``prepare``d chunk; on the card this
        returns once the work is queued."""
        bank, batch, meta = prepared
        return self._rollout(bank, batch, self._gen), meta

    def drain(self, pending) -> Dict[str, dict]:
        """Wait for a ``launch``ed rollout and assemble its predictions."""
        out, meta = pending
        return assemble_trajectories(out.cpu(), meta)

    def navigate(self, items: List[dict]) -> Dict[str, dict]:
        """Predicted trajectories for ANDH items, keyed by instr_id. Each
        record: ``path_corners`` [(corners (4, 2) gps-offset, heading°), …],
        ``actions`` [[waypoint_ratio (2,), altitude], …], ``progress``."""
        items = [self._normalize_item(it) for it in items]
        B = self.serve_batch
        chunks = [items[lo: lo + B] for lo in range(0, len(items), B)]
        if len(chunks) > 1:  # overlap host assembly with the device rollout
            prepared = Prefetcher(chunks, self.prepare, depth=2)
        else:
            prepared = (self.prepare(c) for c in chunks)
        preds: Dict[str, dict] = {}
        pending = None  # launched rollout — drain one behind
        for prep in prepared:
            if pending is not None:
                preds.update(self.drain(pending))
            pending = self.launch(prep)
        if pending is not None:
            preds.update(self.drain(pending))
        return preds
