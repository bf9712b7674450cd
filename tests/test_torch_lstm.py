"""The port's HAA-LSTM cells against the JAX package's, on the CPU.

The heading enters the JAX cells in degrees and the port's in radians
(``DEG_TO_RAD`` times the degrees, as XLA folds the JAX cells'
conversion). Weights are the JAX package's initialisations carried across by
``avdn_tpu_torch.compat.from_jax.lstm_state_dict`` (equal, key by key, to
``avdn_tpu.compat.torch_export.lstm_state_dict`` for ``HAALSTM``; for the
ablation cells, which have no reference export, the same function carries
their trees), loaded with ``strict=True``. Each cell runs 3 chained steps
from the zero state, each side carrying its own state, on the same seeded
numpy inputs: ``TorchLSTMCell``, ``HAALSTM`` at ``demb`` 64 (the language
attention queried by the 768-wide joint state) and at full width (768 /
192 / 576, features (B, 1024, 49)), and both ablation cells.

Tolerances: float32 within 1e-4; bfloat16 towers within 1e-2 of the
largest magnitude of each output (action, the upsampled saliency head, each
state tensor), with the carried state float32 on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avdn_tpu.compat import torch_export
from avdn_tpu.models import lstm as jlstm
from avdn_tpu_torch.compat.from_jax import lstm_state_dict
from avdn_tpu_torch.models import lstm
from avdn_tpu_torch.ops.saliency import saliency_upsample

B, L = 3, 7
STEPS = 3

# case: (the cell's class name in both packages, config kwargs, feature channels)
CELLS = {
    "haalstm_demb64": ("HAALSTM", dict(hidden_size=64), 64),
    "haalstm_full_width": ("HAALSTM", dict(), 1024),
    "vision_only": ("HAALSTMVisionOnly", dict(hidden_size=64, dir_hidden=16, vis_hidden=48),
                    64),
    "lang_only": ("HAALSTMLangOnly", dict(hidden_size=64), None),
}


def _inputs(cfg, channels, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        deg=[rng.uniform(-180, 360, (B, 1)).astype(np.float32) for _ in range(STEPS)],
        feat=[rng.normal(size=(B, channels or 1, 49)).astype(np.float32)
              for _ in range(STEPS)],
        cls=rng.normal(size=(B, 49)).astype(np.float32),
        lang=rng.normal(size=(B, L, cfg.hidden_size)).astype(np.float32))


def _call_args(name, x, t):
    """The cell's positional inputs at step ``t`` (before the state)."""
    if name == "HAALSTM":
        return (x["deg"][t], x["feat"][t], x["cls"], x["lang"])
    if name == "HAALSTMVisionOnly":
        return (x["deg"][t], x["feat"][t])
    return (x["deg"][t], x["lang"])


def _run_both(case, bf16):
    name, kw, channels = CELLS[case]
    jcfg, pcfg = jlstm.LSTMConfig(**kw), lstm.LSTMConfig(**kw)
    jdt, pdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    jm = getattr(jlstm, name)(jcfg, dtype=jdt)
    x = _inputs(jcfg, channels)
    if name == "HAALSTMLangOnly":
        jstate = (jnp.zeros((B, jcfg.hidden_size)),) * 2
        pstate = tuple(torch.zeros((B, pcfg.hidden_size)) for _ in range(2))
    else:
        jstate = jlstm.init_lstm_state(B, jcfg)
        pstate = lstm.init_lstm_state(B, pcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(1), *_call_args(name, x, 0), jstate)
    pm = getattr(lstm, name)(pcfg, dtype=pdt).eval()
    pm.load_state_dict({k: torch.as_tensor(np.array(v))
                        for k, v in lstm_state_dict(params).items()}, strict=True)
    apply = jax.jit(jm.apply)
    steps = []
    for t in range(STEPS):
        jout = apply(params, *_call_args(name, x, t), jstate)
        heading, *rest = (torch.from_numpy(a) for a in _call_args(name, x, t))
        with torch.no_grad():
            pout = pm(heading * lstm.DEG_TO_RAD, *rest, pstate)
        jstate, pstate = jout[0], pout[0]
        steps.append((jax.device_get(jout), pout))
    return params, steps


def _check(got, want, bf16, what):
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    if bf16:
        err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= 1e-2, (what, err)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=what)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CELLS))
def test_cell_matches_jax(case, bf16):
    _, steps = _run_both(case, bf16)
    for t, ((jstate, jaction, *jsal), (pstate, paction, *psal)) in enumerate(steps):
        assert len(pstate) == len(jstate)
        for i, (p, j) in enumerate(zip(pstate, jstate)):
            # the carried state stays float32 on both sides
            assert p.dtype == torch.float32 and np.asarray(j).dtype == np.float32
            _check(p, j, bf16, f"step {t} state {i}")
        _check(paction, jaction, bf16, f"step {t} action")
        if jsal:
            assert psal[0].shape == (B, 8, 8)
            _check(saliency_upsample(psal[0]), jsal[0], bf16, f"step {t} saliency")


def test_torch_lstm_cell_matches_jax():
    """``TorchLSTMCell`` alone, 49 → 576, 3 chained steps: float32 within
    1e-4, bfloat16 within 1e-2 of the state's largest magnitude."""
    rng = np.random.default_rng(3)
    xs = [rng.normal(size=(B, 49)).astype(np.float32) for _ in range(STEPS)]
    for bf16 in (False, True):
        jm = jlstm.TorchLSTMCell(576, dtype=jnp.bfloat16 if bf16 else jnp.float32)
        state0 = (jnp.zeros((B, 576)), jnp.zeros((B, 576)))
        params = jax.jit(jm.init)(jax.random.PRNGKey(2), xs[0], state0)
        pm = lstm.TorchLSTMCell(49, 576, torch.bfloat16 if bf16 else torch.float32)
        p = params["params"]
        with torch.no_grad():
            for gate in ("ih", "hh"):
                getattr(pm, f"weight_{gate}").copy_(
                    torch.from_numpy(np.array(p[gate]["kernel"]).T.copy()))
                getattr(pm, f"bias_{gate}").copy_(torch.from_numpy(np.array(p[gate]["bias"])))
        jstate, pstate = state0, tuple(torch.zeros((B, 576)) for _ in range(2))
        for t, x in enumerate(xs):
            jstate = jax.jit(jm.apply)(params, x, jstate)
            with torch.no_grad():
                pstate = pm(torch.from_numpy(x), pstate)
            for i, (a, b) in enumerate(zip(pstate, jstate)):
                assert a.dtype == torch.float32
                _check(a, b, bf16, f"bf16={bf16} step {t} state {i}")


def test_state_dict_matches_reference_export():
    """``lstm_state_dict`` equals the JAX package's reference export key by
    key and value by value (the names ``vision_lstm``, ``direct_lstm``,
    ``attention_layer_*``, ``decoder_2_action_full.{0,3,6}``, ``fc.{0,3}``),
    and the port's ``HAALSTM`` has exactly those parameters."""
    cfg = jlstm.LSTMConfig(hidden_size=64)
    x = _inputs(cfg, 64)
    params = jax.jit(jlstm.HAALSTM(cfg).init)(
        jax.random.PRNGKey(0), *_call_args("HAALSTM", x, 0), jlstm.init_lstm_state(B, cfg))
    got, want = lstm_state_dict(params), torch_export.lstm_state_dict(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    names = {n for n, _ in lstm.HAALSTM(lstm.LSTMConfig(hidden_size=64)).named_parameters()}
    assert names == set(want)
    assert "direct_lstm.weight_hh" in names
    assert got["attention_layer_lang.linear_in.weight"].shape == (64, 768)
    assert got["attention_layer_lang.linear_out.weight"].shape == (64, 832)


def test_heading_round_trip_matches_xla():
    """The angle the rollouts hand the cells equals, bit for bit, the one
    XLA computes from the JAX closures' ``atan2(·)/π·180`` degrees and the
    cell's ``/180·π`` in one program (the constants fold to 1), over the
    circle and for the zeroed ``--no_direction`` features, where the cell
    sees (sin, cos) = (0, 1)."""
    pi = 3.14159
    deg = np.arange(-180, 540, 0.37, dtype=np.float32)
    rad = deg / np.float32(180.0) * np.float32(pi)
    feat = np.stack([np.sin(rad), np.cos(rad)], -1).astype(np.float32)
    feat = np.concatenate([feat, np.zeros((1, 2), np.float32)])
    jax_angle = jax.jit(lambda f: (jnp.arctan2(f[:, 0:1], f[:, 1:2]) / pi * 180.0)
                        / 180.0 * pi)(feat)
    got = lstm.heading_radians(torch.from_numpy(feat))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_angle))
    zero = lstm._direction_features(got[-1:])
    assert zero.tolist() == [[0.0, 1.0]]
