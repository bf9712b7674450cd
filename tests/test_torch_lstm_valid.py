"""The port's ``valid()`` of an HAA-LSTM checkpoint against the JAX
package's, on the CPU at the fixture's tiny widths (BERT 2×64, the tiny
Darknet, ``HAALSTM`` at ``demb`` 64, B = 2, T = 2) and the reference numerics
(``--render_twopass False --bf16 False``).

The checkpoint is the JAX package's random init exported by
``export_reference_agent(family="lstm")`` (the reference's LSTM layout:
``lang_model`` and ``vln_model``, the Darknet under ``vision_model.``); JAX's
``valid()`` of it is made once per session (``tests/torch_shared.py:
jax_lstm_valid``). The port's ``cli.train_lstm --inference True`` reads the
same file. Success outcomes are equal episode by episode in each nav eval,
the metric keys are equal, and every value is within rtol = atol = 1e-3
(``tests/test_render_mode_goldens.py``'s ``PIN_TOL["exact"]``), SR and
oracle SR exactly equal.
"""

import pytest

import avdn_tpu_torch.train.loop as port_loop
from test_e2e_loop import make_args
from torch_shared import jax_lstm_valid, metrics_of, port_argv, recording_successes

PIN_TOL = 1e-3  # tests/test_render_mode_goldens.py PIN_TOL["exact"]


def test_valid_matches_jax(tmp_path_factory, tmp_path):
    from avdn_tpu_torch.cli.train_lstm import main

    jax_run = jax_lstm_valid(tmp_path_factory)
    args = make_args(jax_run["root"], str(tmp_path / "out"), jax_run["cfg_path"],
                     family="lstm", inference=True, seed=0, render_twopass=False,
                     resume_file=jax_run["pt"])
    successes = []
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path)
        recording_successes(mp, port_loop, successes)
        main(port_argv(args) + ["--bf16", "False"], device="cpu")
    assert len(successes) == len(jax_run["successes"]) == 2
    for got, want in zip(successes, jax_run["successes"]):
        assert got == want
    assert any(any(s.values()) for s in successes)  # some episode succeeds
    got, want = metrics_of(args.log_dir), jax_run["metrics"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if k.startswith(("sr", "oracle_sr")):
            assert got[k] == v, k
        assert abs(got[k] - v) <= PIN_TOL + PIN_TOL * abs(v), (k, got[k], v)
