"""The port's train driver on the CPU at tiny width, on the fixture dataset
(shared with the other files, ``tests/torch_shared.py``): B = 8, T = 2,
demb 64, the exact render in training and validation.

* ``python -m avdn_tpu_torch.cli.train_et`` trains 2 intervals (iters 2,
  log_every 1: one step each over the 8 train items), writes
  ``latest_dict_{iter}.pt`` (``--ckpt_keep 1`` prunes the older one),
  ``best_val_unseen.pt``, ``train.txt`` and ``metrics.jsonl`` with the
  interval's loss, grad norms, throughput and validation metrics.
* ``--resume_file latest`` continues from the saved step; a
  ``--resume_optimizer`` run restores the moments (without it they start
  at 0); ``valid()`` loads a training checkpoint unchanged.
* SIGTERM through ``PreemptionGuard`` saves ``latest_dict_{step}`` and
  returns after that step.
* ``--grad_accum 2`` equals two micro-batch backward passes (each loss over
  the full B, the BatchNorm statistics chained), and ``--grad_accum 3``
  with B = 2 raises.
"""

import copy
import dataclasses
import json
import os
import shutil
import signal

import numpy as np
import pytest
import torch

from test_e2e_loop import make_args
from torch_shared import fixture_dataset, port_argv


def _argv(root, cfg_path, out, **over):
    args = make_args(root, out, cfg_path, render_twopass=False, **dict(
        dict(batch_size=8), **over))
    return port_argv(args) + ["--iters", str(args.iters), "--log_every",
                              str(args.log_every), "--lr", "1e-3"]


def _train(argv, *extra):
    from avdn_tpu_torch.cli.train_et import main

    return main(list(argv) + list(extra), device="cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root, cfg_path = fixture_dataset(tmp_path_factory)
    out = str(tmp_path_factory.mktemp("port_train") / "out")
    argv = _argv(root, cfg_path, out, iters=2)
    state, history = _train(argv, "--ckpt_keep", "1")
    return dict(root=root, cfg_path=cfg_path, out=out, argv=argv, state=state,
                history=history)


def _records(out):
    with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_writes_checkpoints_and_records(trained):
    out = trained["out"]
    assert trained["state"].step == 2
    assert len(trained["history"]) == 2
    for m in trained["history"]:
        assert set(m) == {"loss", "grad_norm_vln", "grad_norm_bert"}
        assert all(np.isfinite(v) and v > 0 for v in m.values()), m
    ckpts = sorted(os.listdir(os.path.join(out, "ckpts")))
    assert ckpts == ["best_val_unseen.pt", "latest_dict_2.pt"]  # 1 pruned
    recs = _records(out)
    assert [r["step"] for r in recs if "loss/IL_loss" in r] == [1, 2]
    for r in recs:
        if "loss/IL_loss" in r:
            assert {"throughput/train_eps", "grad_norm/vln", "grad_norm/bert"} <= set(r)
    assert {"spl/val_unseen", "sr/val_seen", "nss/val_unseen_ha"} <= {
        k for r in recs for k in r}
    with open(os.path.join(out, "logs", "train.txt")) as f:
        text = f.read()
    assert "IL_loss" in text and "phase timers" in text and "BEST: Iter" in text
    blob = torch.load(os.path.join(out, "ckpts", "latest_dict_2.pt"), weights_only=False)
    assert blob["step"] == 2
    assert blob["vln_model"]["optimizer"]["count"] == 2


def _copy_run(trained, tmp_path):
    out = str(tmp_path / "out")
    shutil.copytree(trained["out"], out)
    return out, [out if a == trained["out"] else a for a in trained["argv"]]


def test_resume_latest_continues_from_saved_step(trained, tmp_path):
    out, argv = _copy_run(trained, tmp_path)
    argv[argv.index("--iters") + 1] = "1"
    state, history = _train(argv, "--resume_file", "latest")
    assert state.step == 3 and len(history) == 1
    assert "latest_dict_3.pt" in os.listdir(os.path.join(out, "ckpts"))
    assert [r["step"] for r in _records(out) if "loss/IL_loss" in r] == [1, 2, 3]
    with open(os.path.join(out, "logs", "train.txt")) as f:
        assert "latest_dict_2.pt, iteration 2" in f.read()


@pytest.mark.parametrize("resume_optimizer", [True, False])
def test_resume_optimizer_restores_moments(trained, tmp_path, resume_optimizer):
    out, argv = _copy_run(trained, tmp_path)
    path = os.path.join(out, "ckpts", "latest_dict_2.pt")
    argv[argv.index("--iters") + 1] = "0"
    state, history = _train(argv, "--resume_file", path, "--resume_optimizer",
                            str(resume_optimizer))
    assert history == [] and state.step == 2
    blob = torch.load(path, weights_only=False)
    want = trained["state"]
    for key, opt in zip(("lang_model", "vision_model", "vln_model"),
                        state.optimizers()):
        assert opt.count == (2 if resume_optimizer else 0)
        for name, mu in zip(opt.names, opt.mu):
            saved = blob[key]["optimizer"]["mu"][name]
            if resume_optimizer:
                torch.testing.assert_close(mu, saved, rtol=0, atol=0)
            else:
                assert not mu.any()
        torch.testing.assert_close(dict(state.models()[0].named_parameters())[
            "bert.pooler.dense.weight"], dict(want.models()[0].named_parameters())[
            "bert.pooler.dense.weight"], rtol=0, atol=0)


def test_valid_loads_a_training_checkpoint(trained, tmp_path):
    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.train.loop import valid

    best = os.path.join(trained["out"], "ckpts", "best_val_unseen.pt")
    argv = _argv(trained["root"], trained["cfg_path"], str(tmp_path / "out"),
                 resume_file=best)
    results, _ = valid(parse_args(argv), device="cpu")
    assert set(results) == {"val_seen", "val_unseen", "val_seen_human_att",
                            "val_unseen_human_att"}
    with open(tmp_path / "out" / "logs" / "valid.txt") as f:
        assert "sr:" in f.read()


def test_sigterm_saves_latest_and_exits_cleanly(trained, tmp_path, monkeypatch):
    import avdn_tpu_torch.train.loop as loop

    real = loop.make_train_step

    def make_signalling_step(*a, **kw):
        step = real(*a, **kw)

        def signalled(*sa, **skw):
            out = step(*sa, **skw)
            os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
            return out

        return signalled

    monkeypatch.setattr(loop, "make_train_step", make_signalling_step)
    before = signal.getsignal(signal.SIGTERM)
    out = str(tmp_path / "out")
    state, history = _train(_argv(trained["root"], trained["cfg_path"], out, iters=2))
    assert state.step == 1 and len(history) == 1
    assert os.listdir(os.path.join(out, "ckpts")) == ["latest_dict_1.pt"]
    with open(os.path.join(out, "logs", "train.txt")) as f:
        assert "preemption signal" in f.read()
    assert signal.getsignal(signal.SIGTERM) == before  # handler restored


def _tiny_setup(trained, batch_size):
    from avdn_tpu_torch.config import Args, postprocess_args
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train.loop import (batcher_config, build_models, init_state,
                                           train_config_from_args)

    jargs = make_args(trained["root"], trained["out"] + "_accum", trained["cfg_path"],
                      render_twopass=False, batch_size=batch_size)
    args = postprocess_args(Args(**dataclasses.asdict(jargs)))
    models = build_models(args, torch.device("cpu"))
    init_state(models, torch.Generator().manual_seed(0))
    with open(os.path.join(args.train_anno_dir, "train_data.json")) as f:
        items = [Navigator._normalize_item(it) for it in json.load(f)[:batch_size]]
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                         n_slots=args.map_bank_slots, device="cpu")
    arr, slots = bank.prepare(items)
    batch, _ = make_train_batch(items, WordPieceTokenizer.load(None), slots,
                                batcher_config(args))
    return args, train_config_from_args(args), models, arr, batch


def test_grad_accum_equals_two_micro_batch_passes(trained):
    from avdn_tpu_torch.train.optim import global_norm
    from avdn_tpu_torch.train.step import (_micro_batch, create_train_state,
                                           make_loss_fn, make_train_step)

    args, cfg, models, arr, batch = _tiny_setup(trained, 2)
    manual = copy.deepcopy(models)
    cfg2 = dataclasses.replace(cfg, grad_accum=2)
    state = create_train_state(cfg2, *models)
    metrics = make_train_step(cfg2, *models)(state, arr, batch,
                                              torch.Generator().manual_seed(3))
    # by hand: each micro loss over the full B, one backward each, summed
    mstate = create_train_state(cfg, *manual)
    loss_fn = make_loss_fn(cfg, *manual)
    gen = torch.Generator().manual_seed(3)
    for m in manual:
        m.train()
    loss = 0.0
    for k in range(2):
        micro = loss_fn(_micro_batch(batch, k, 2), arr, gen, 2)
        micro.backward()
        loss = loss + micro.detach()
    for opt in mstate.optimizers():
        opt.step([torch.zeros_like(p) if p.grad is None else p.grad for p in opt.params])
    torch.testing.assert_close(metrics["loss"], loss)
    assert float(metrics["grad_norm_vln"]) > 0
    for a, b in zip(models, manual):
        for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
            torch.testing.assert_close(x, y, msg=name)
    assert global_norm([p for p in models[1].parameters()]) > 0


def test_grad_accum_must_divide_the_batch(trained):
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    _, cfg, models, arr, batch = _tiny_setup(trained, 2)
    cfg3 = dataclasses.replace(cfg, grad_accum=3)
    with pytest.raises(ValueError, match="grad_accum 3 must evenly divide batch_size 2"):
        make_train_step(cfg3, *models)(create_train_state(cfg3, *models), arr, batch,
                                       torch.Generator())


def test_pretrain_imports_match_jax(trained, tmp_path):
    """``--bert_weight_file`` (a raw HF BERT file: bare ``BertModel`` keys
    with ``position_ids``, or ``bert.``-prefixed with ``cls.*`` heads) and
    ``--darknet_weight_file`` (the YOLO ``{'model': state_dict}``) load the
    same tensors as the JAX importers; the 49-d head keeps its random
    init."""
    from avdn_tpu.train import checkpoints as jax_ckpt
    from avdn_tpu_torch.compat import from_jax
    from avdn_tpu_torch.train.loop import build_models, init_state

    args, _, models, _, _ = _tiny_setup(trained, 2)
    bert, darknet = models[0], models[1]
    src = [copy.deepcopy(m) for m in build_models(args, torch.device("cpu"))[:2]]
    init_state(src + [build_models(args, torch.device("cpu"))[2]],
               torch.Generator().manual_seed(11))
    body = {k[len("bert."):]: v for k, v in src[0].state_dict().items()
            if k.startswith("bert.")}
    bare = dict(body, **{"embeddings.position_ids": torch.arange(args.max_instr_len)[None]})
    prefixed = {"bert." + k: v for k, v in body.items()}
    prefixed["cls.predictions.bias"] = torch.zeros(3)
    dk_file = str(tmp_path / "best.pt")
    torch.save({"model": src[1].state_dict()}, dk_file)
    for i, layout in enumerate((bare, prefixed)):
        bert_file = str(tmp_path / f"bert{i}.bin")
        torch.save(layout, bert_file)
        args.bert_weight_file, args.darknet_weight_file = bert_file, dk_file
        head = {k: v.clone() for k, v in bert.state_dict().items() if k.startswith("linears.")}
        init_state(models, torch.Generator().manual_seed(0), args)
        got = bert.state_dict()
        for k, v in src[0].state_dict().items():
            want = head[k] if k.startswith("linears.") else v
            torch.testing.assert_close(got[k], want, rtol=0, atol=0, msg=k)
        jax_bert = from_jax.bert_state_dict(
            jax_ckpt.import_bert_pretrain(bert_file, num_layers=args.bert_layers),
            args.bert_layers)
        for k, v in jax_bert.items():
            if not k.startswith("linears."):
                np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    from avdn_tpu.models.darknet import DarknetConfig as JDarknetConfig

    with open(args.darknet_model_file) as f:
        blocks = JDarknetConfig.from_text(f.read()).block_dicts()
    jax_dk = from_jax.darknet_state_dict(jax_ckpt.import_darknet_pretrain(dk_file, blocks),
                                         blocks)
    got = darknet.state_dict()
    for k, v in jax_dk.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
