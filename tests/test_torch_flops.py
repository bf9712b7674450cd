"""The port's analytic model-FLOP counts (``avdn_tpu_torch/utils/flops.py``,
the MFU numerator) on the CPU.

* Every count equals the JAX package's (``avdn_tpu/utils/flops.py``) exactly,
  for the default and the tiny configs of both families, per forward, per
  eval rollout (step and one-pass trunk) and per train step.
* Each per-forward count equals ``torch.utils.flop_counter.FlopCounterMode``'s
  count of the port's own module (contractions only: ``mm``, ``addmm``,
  ``bmm``, ``convolution``) on a loop-free forward: the tiny Darknet with its
  shortcut block, the tiny BERT, the tiny ET trunk, and one
  HAA-LSTM step at its published width (the count's language attention
  takes the joint LSTM state, 192 + 576, as wide as ``hidden_size``: true at
  768 only).

Wall: ~2 s on one worker.
"""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from avdn_tpu.models.bert import BertConfig as JaxBertConfig
from avdn_tpu.models.darknet import DarknetConfig as JaxDarknetConfig
from avdn_tpu.models.et import ETConfig as JaxETConfig
from avdn_tpu.models.lstm import LSTMConfig as JaxLSTMConfig
from avdn_tpu.utils import flops as JF

from avdn_tpu_torch.models.bert import BertConfig, BertLanguageEncoder
from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig, output_channels
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.models.lstm import HAALSTM, LSTMConfig
from avdn_tpu_torch.utils import flops as F

# (bert, darknet, vln) constructors shared by both packages, and feat_ch
CONFIGS = {
    "et_default": (lambda m: m[0](), lambda m: m[1].default(), lambda m: m[2](), 512),
    "et_tiny": (lambda m: m[0].tiny(), lambda m: m[1].tiny(),
                lambda m: m[2](demb=128, encoder_heads=4, encoder_layers=1), 64),
    "lstm_default": (lambda m: m[0](), lambda m: m[1].default(), lambda m: m[3](), 512),
    "lstm_tiny": (lambda m: m[0].tiny(), lambda m: m[1].tiny(),
                  lambda m: m[3](hidden_size=128), 64),
}
PORT = (BertConfig, DarknetConfig, ETConfig, LSTMConfig)
JAX = (JaxBertConfig, JaxDarknetConfig, JaxETConfig, JaxLSTMConfig)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_counts_equal_jax(name):
    make_bert, make_dk, make_vln, C = CONFIGS[name]
    port = tuple(make(PORT) for make in (make_bert, make_dk, make_vln))
    jax = tuple(make(JAX) for make in (make_bert, make_dk, make_vln))
    B, T, L, D = 4, 10, 100, 320
    assert F.darknet_forward_flops(port[1], B) == JF.darknet_forward_flops(jax[1], B)
    assert F.bert_forward_flops(port[0], B, L) == JF.bert_forward_flops(jax[0], B, L)
    if name.startswith("et"):
        assert F.et_trunk_flops(port[2], B, L, T, C) == JF.et_trunk_flops(jax[2], B, L, T, C)
    else:
        assert F.lstm_step_flops(port[2], B, L, C) == JF.lstm_step_flops(jax[2], B, L, C)
    for kw in (dict(), dict(one_pass_trunk=True), dict(single_bert_pass=True)):
        assert F.eval_rollout_flops(*port, B, T, L, dialog_len=D, feat_ch=C, **kw) == \
            JF.eval_rollout_flops(*jax, B, T, L, dialog_len=D, feat_ch=C, **kw)
    for kw in (dict(), dict(double_rollout=False), dict(single_bert_pass=True)):
        got = F.train_step_flops(*port, B, T, L, dialog_len=D, feat_ch=C, **kw)
        assert got == JF.train_step_flops(*jax, B, T, L, dialog_len=D, feat_ch=C, **kw)
        assert got > 0


def _counted(fn):
    with torch.no_grad(), FlopCounterMode(display=False) as mode:
        fn()
    return mode.get_total_flops()


def test_darknet_matches_flop_counter():
    cfg = DarknetConfig.tiny()
    assert any(b["type"] == "shortcut" for b in cfg.block_dicts())
    model = Darknet(cfg).eval()
    x = torch.zeros(2, 224, 224, 3)
    assert _counted(lambda: model(x)) == F.darknet_forward_flops(cfg, batch=2)


def test_bert_matches_flop_counter():
    cfg = BertConfig.tiny()
    model = BertLanguageEncoder(cfg).eval()
    ids = torch.zeros(2, 24, dtype=torch.long)
    assert _counted(lambda: model(ids, torch.ones_like(ids))) == \
        F.bert_forward_flops(cfg, 2, 24)


def test_et_trunk_matches_flop_counter():
    cfg = ETConfig(demb=64, encoder_heads=4, encoder_layers=1)
    model = HAATransformer(cfg).eval()
    B, L, T, C = 2, 12, 3, 64
    args = (torch.zeros(B, L, cfg.demb), torch.zeros(B, 49), torch.zeros(B, T, C, 49),
            torch.zeros(B, T, 2), torch.full((B,), T, dtype=torch.long))
    assert _counted(lambda: model(*args)) == F.et_trunk_flops(cfg, B, L, T, C)


def test_lstm_step_matches_flop_counter():
    cfg = LSTMConfig()
    model = HAALSTM(cfg).eval()
    B, L, C = 2, 12, 512
    state = (torch.zeros(B, cfg.dir_hidden), torch.zeros(B, cfg.dir_hidden),
             torch.zeros(B, cfg.vis_hidden), torch.zeros(B, cfg.vis_hidden))
    counted = _counted(lambda: model(torch.zeros(B, 1), torch.zeros(B, C, 49),
                                     torch.zeros(B, 49), torch.zeros(B, L, cfg.hidden_size),
                                     state))
    assert counted == F.lstm_step_flops(cfg, B, L, C)
    assert output_channels(DarknetConfig.default())[-1] == C
