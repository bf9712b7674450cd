"""The system under test: the port, ``avdn_tpu_torch``, imported from the
checkout that holds the benchmark (never from anywhere else)."""

from __future__ import annotations

import os
import sys
import types

from harness.cell import ROOT


def modules() -> types.SimpleNamespace:
    """The port's entry points the benchmark drives."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import avdn_tpu_torch

    where = os.path.dirname(os.path.abspath(avdn_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise SystemExit(f"avdn_tpu_torch imported from {where}, not from the checkout {ROOT}")
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.data.annotations import ANDHDataset
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.prefetch import Prefetcher
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.device import use_fp32_numerics
    from avdn_tpu_torch.ops import saliency
    from avdn_tpu_torch.parallel.runtime import ParallelRuntime
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.serve_http import make_server
    from avdn_tpu_torch.train.loop import (
        batcher_config,
        build_models,
        eval_bf16,
        eval_config_from_args,
        run_validation,
        train_bf16,
        train_config_from_args,
    )
    from avdn_tpu_torch.train.step import (
        create_train_state,
        make_eval_rollout,
        make_train_step,
    )
    from avdn_tpu_torch.utils.logging import MetricWriter

    return types.SimpleNamespace(**{k: v for k, v in locals().items()
                                    if not k.startswith("_") and k not in ("where",)})
