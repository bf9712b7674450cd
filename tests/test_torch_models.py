"""The port's models against the JAX package's, on the CPU, in fp32.

Weights are the JAX package's initialisations carried across by
``avdn_tpu_torch.compat.from_jax`` (whose state dicts must equal those of
``avdn_tpu.compat.torch_export`` key by key), loaded with ``strict=True``.
Forward passes agree within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.compat import torch_export
from avdn_tpu.models import layers as jlayers
from avdn_tpu.models.bert import BertConfig as JBertConfig
from avdn_tpu.models.bert import BertLanguageEncoder as JBert
from avdn_tpu.models.darknet import Darknet as JDarknet
from avdn_tpu.models.darknet import DarknetConfig as JDarknetConfig
from avdn_tpu.models.darknet import fold_darknet_params as jfold
from avdn_tpu.models.et import ETConfig as JETConfig
from avdn_tpu.models.et import HAATransformer as JET
from avdn_tpu_torch.compat import from_jax
from avdn_tpu_torch.models import layers
from avdn_tpu_torch.models.bert import BertConfig, BertLanguageEncoder
from avdn_tpu_torch.models.darknet import Darknet, DarknetConfig, fold_darknet_params
from avdn_tpu_torch.models.et import ETConfig, HAATransformer
from avdn_tpu_torch.rollout.engine import RGB_MEAN, RGB_STD
from test_e2e_loop import TINY_DARKNET_CFG

ATOL = 1e-4


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4,
                               atol=atol)


def load(model, sd):
    model.load_state_dict({k: torch.as_tensor(np.array(v)) for k, v in sd.items()},
                          strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def bert():
    jm = JBert(JBertConfig.tiny())
    ids = np.random.default_rng(0).integers(0, 1024, (3, 12)).astype(np.int32)
    mask = np.ones((3, 12), np.int32)
    mask[1, 7:] = 0
    mask[2, 3:] = 0
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids), jnp.asarray(mask))
    return jm, v, ids, mask


def dk_vars(cfg, seed):
    jm = JDarknet(cfg)
    v = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 224, 224, 3)), train=False))(
        jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    for s in stats.values():
        s["mean"] = rng.normal(0, 0.2, s["mean"].shape).astype(np.float32)
        s["var"] = rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)
    return jm, {"params": v["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def et():
    jm = JET(JETConfig(demb=64, encoder_heads=4, encoder_layers=1))
    rng = np.random.default_rng(1)
    B, L, T, C = 4, 10, 5, 16
    inputs = (rng.normal(0, 1, (B, L, 64)).astype(np.float32),
              rng.normal(0, 1, (B, 49)).astype(np.float32),
              rng.normal(0, 1, (B, T, C, 49)).astype(np.float32),
              rng.normal(0, 1, (B, T, 2)).astype(np.float32),
              np.array([1, 3, 5, 2], np.int32))
    v = jax.jit(jm.init)(jax.random.PRNGKey(2), *(jnp.asarray(x) for x in inputs))
    return jm, v, inputs


def test_state_dicts_equal_torch_export(bert, et):
    jbert, bv, _, _ = bert
    jet, ev, _ = et
    cfg = JDarknetConfig.tiny()
    _, dv = dk_vars(cfg, 3)
    pairs = [
        (from_jax.bert_state_dict(bv, 2), torch_export.bert_state_dict(bv, 2)),
        (from_jax.darknet_state_dict(dv, cfg.block_dicts()),
         torch_export.darknet_state_dict(dv, cfg.block_dicts())),
        (from_jax.et_state_dict(ev, 1), torch_export.et_state_dict(ev, 1)),
    ]
    for got, want in pairs:
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_bert_forward(bert):
    jm, v, ids, mask = bert
    want = jm.apply(v, jnp.asarray(ids), jnp.asarray(mask))
    model = load(BertLanguageEncoder(BertConfig.tiny()),
                 from_jax.bert_state_dict(v, BertConfig.tiny().num_layers))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    for g, w in zip(got, want):
        close(g, w)


@pytest.mark.parametrize("cfg_name", ["tiny", "e2e_tiny"])
@pytest.mark.parametrize("folded", [False, True])
def test_darknet_forward(cfg_name, folded):
    text = (TINY_DARKNET_CFG if cfg_name == "e2e_tiny" else None)
    jcfg = (JDarknetConfig.from_text(text) if text else JDarknetConfig.tiny())
    cfg = DarknetConfig.from_text(text) if text else DarknetConfig.tiny()
    jm, v = dk_vars(jcfg, 4)
    x = np.random.default_rng(5).uniform(0, 255, (2, 224, 224, 3)).astype(np.float32)
    model = load(Darknet(cfg), from_jax.darknet_state_dict(v, jcfg.block_dicts()))
    if folded:
        jparams = jfold(jcfg, v["params"], v["batch_stats"], input_std=np.asarray(RGB_STD))
        want = JDarknet(jcfg, folded=True).apply({"params": jparams},
                                                 jnp.asarray(x - np.asarray(RGB_MEAN)))
        model = load(Darknet(cfg, folded=True),
                     fold_darknet_params(cfg, model.state_dict(), input_std=RGB_STD))
        xin = x - np.asarray(RGB_MEAN, np.float32)
    else:
        want = jm.apply(v, jnp.asarray(x), train=False)
        xin = x
    with torch.no_grad():
        got = model(torch.from_numpy(xin))
    assert got.shape == want.shape
    close(got, want, atol=ATOL * float(np.abs(np.asarray(want)).max()))


def test_haa_transformer_forward_ragged(et):
    jm, v, inputs = et
    want = jm.apply(v, *(jnp.asarray(x) for x in inputs))
    model = load(HAATransformer(ETConfig(demb=64, encoder_heads=4, encoder_layers=1)),
                 from_jax.et_state_dict(v, 1))
    with torch.no_grad():
        got = model(*(torch.from_numpy(x) for x in inputs[:4]),
                    torch.from_numpy(inputs[4]).long())
    close(got[0], want[0])
    close(layers.saliency_upsample(got[1]), want[1])


def test_layer_helpers():
    close(layers.sinusoidal_pos_encoding(50, 32),
          jlayers.sinusoidal_pos_encoding(50, 32), atol=1e-5)
    np.testing.assert_array_equal(layers.haa_attention_mask(7, 3).numpy(),
                                  np.asarray(jlayers.haa_attention_mask(7, 3)))
    x8 = np.random.default_rng(6).normal(0, 1, (2, 8, 8)).astype(np.float32)
    close(layers.saliency_upsample(torch.from_numpy(x8)),
          jlayers.saliency_upsample(jnp.asarray(x8)), atol=1e-5)


# ------------------------------------------------------------ train mode --


@pytest.mark.parametrize("p", [0.1, 0.2, 0.5])
def test_dropout_statistics(p):
    """flax's dropout: each value kept with probability 1 − p (the keep rate
    within 3σ of it over 2¹⁸ values), kept values scaled by 1/(1 − p), the
    rest 0; the same masks from the same generator seed; the identity in
    eval mode and without a generator outside train mode."""
    drop = layers.Dropout(p).train()
    x = torch.rand((512, 512)) + 0.5
    y = drop(x, torch.Generator().manual_seed(7))
    kept = y != 0
    n = kept.numel()
    keep = 1.0 - p
    assert abs(float(kept.float().mean()) - keep) <= 3 * np.sqrt(keep * (1 - keep) / n)
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
    torch.testing.assert_close(drop(x, torch.Generator().manual_seed(7)), y,
                               rtol=0, atol=0)
    assert not torch.equal(drop(x, torch.Generator().manual_seed(8)), y)
    with pytest.raises(ValueError, match="Generator"):
        drop(x)
    assert drop.eval()(x) is x


def test_models_place_dropout_at_flax_sites():
    """The dropout sites of the flax modules, with their rates: BERT's
    embeddings, attention probabilities, two residual branches per layer
    and its head; the trunk's input, four sites per encoder layer, the
    action head's two and the saliency projection's. No parameter name
    changes."""
    bcfg = BertConfig.tiny()
    bert_rates = sorted(m.p for m in BertLanguageEncoder(bcfg).modules()
                        if isinstance(m, layers.Dropout))
    assert bert_rates == sorted([0.1] * (1 + 3 * bcfg.num_layers) + [0.2])
    ecfg = ETConfig(demb=64, encoder_heads=4, encoder_layers=2, dropout_emb=0.05)
    et_rates = sorted(m.p for m in HAATransformer(ecfg).modules()
                      if isinstance(m, layers.Dropout))
    assert et_rates == sorted([0.05] + [0.1] * 4 * 2 + [0.2] * 3)


def test_train_mode_forwards_draw_from_the_generator(et):
    """In train mode the trunk's outputs depend on the generator (dropout
    on) and equal eval mode's with every rate at 0."""
    jm, v, inputs = et
    model = load(HAATransformer(ETConfig(demb=64, encoder_heads=4, encoder_layers=1)),
                 from_jax.et_state_dict(v, 1))
    args = [torch.from_numpy(x) for x in inputs[:4]] + [torch.from_numpy(inputs[4]).long()]
    with torch.no_grad():
        ref = model(*args)
        model.train()
        a = model(*args, generator=torch.Generator().manual_seed(0))
        b = model(*args, generator=torch.Generator().manual_seed(1))
        assert not torch.equal(a[0], b[0])
        for m in model.modules():
            if isinstance(m, layers.Dropout):
                m.p = 0.0
        for g, w in zip(model(*args, generator=torch.Generator()), ref):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_darknet_batchnorm_train_mode_matches_flax():
    """Train-mode BatchNorm against flax's ``train=True,
    mutable=["batch_stats"]`` on the same weights and randomised running
    statistics: outputs within 1e-4 (of the output's scale), the new running
    statistics within 1e-5 relative (μ = 0.9 on the batch's biased variance,
    not ``torch.nn.BatchNorm2d``'s update, which would be off by the
    unbiased factor and the momentum); two calls in a row chain them. The
    variance is E[x²] − E[x]² over 37,632 values per channel of convolutions
    that themselves differ in summation order: the two sides agree to
    3.8e-6 relative here, not to 1e-6."""
    jcfg = JDarknetConfig.from_text(TINY_DARKNET_CFG)
    cfg = DarknetConfig.from_text(TINY_DARKNET_CFG)
    jm, v = dk_vars(jcfg, 6)
    rng = np.random.default_rng(7)
    xs = [((rng.uniform(0, 255, (3, 224, 224, 3)) - np.asarray(RGB_MEAN))
           / np.asarray(RGB_STD)).astype(np.float32) for _ in range(2)]
    model = load(Darknet(cfg), from_jax.darknet_state_dict(v, jcfg.block_dicts())).train()
    apply = jax.jit(lambda variables, x: jm.apply(variables, x, train=True,
                                                  mutable=["batch_stats"]))
    stats = v["batch_stats"]
    for x in xs:
        want, upd = apply({"params": v["params"], "batch_stats": stats}, jnp.asarray(x))
        stats = upd["batch_stats"]
        got = model(torch.from_numpy(x))
        close(got, want, atol=ATOL * float(np.abs(np.asarray(want)).max()))
    sd = model.state_dict()
    for name, s in stats.items():
        i = int(name.split("_")[1])
        pre = f"module_list.{i}.batch_norm_{i}."
        for key, jkey in (("running_mean", "mean"), ("running_var", "var")):
            np.testing.assert_allclose(sd[pre + key].numpy(), np.asarray(s[jkey]),
                                       rtol=1e-5, atol=1e-6, err_msg=pre + key)
