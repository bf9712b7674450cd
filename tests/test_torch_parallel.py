"""The port's multi-process runs (``avdn_tpu_torch/parallel/``) on the CPU:
two processes joined over gloo, each spawned with a subprocess timeout and
joined with a 60 s ``init_process_group`` timeout, so a hung rendezvous
fails its own test.

* **Collectives.** ``all_gather_metrics``, ``reduce_mean_metrics``,
  ``merge_prediction_dicts``, ``any_flag``, ``sync_bank_growth`` (both banks
  grow to the larger) and ``assert_replicas_identical``, which raises on
  both ranks when one rank's parameters are perturbed.
* **Shards.** ``ANDHDataset``'s per-process shards (items, order, owned
  ids, batches) equal the JAX package's for the same seed, count and index.
* **The step.** Two ranks, each given its half of 4 fixture items (B = 2),
  against one process given all 4, at tiny width (T = 3, the exact render,
  ``--feedback student``), the one process computing BatchNorm with the
  data-parallel formula (E[x²] − E[x]² of the batch sums) so the comparison
  sees the collectives alone. Bars: the loss within 1e-6 relative; every
  averaged gradient leaf within 1e-4 of the leaf's largest magnitude (BERT's
  attention key biases, zero in exact arithmetic, of their group's largest
  gradient); the BatchNorm running statistics within 1e-5 of theirs; after
  two AdamW steps the parameters within 1e-4 of each leaf's largest
  magnitude (save the elements whose first gradient is below 1e-6 of their
  group's largest, the key biases: Adam steps them by the sign of rounding
  noise); both ranks bit-identical. Cases: dropout 0; the same under
  ``--remat`` (the ``dots`` policy, whose recompute repeats the BatchNorm
  collectives); dropout on (each rank's masks are its rows of one draw over
  the global batch, ``parallel.batch.batch_rand``, so the masks equal the
  one process's); and a control with the BatchNorm collective removed (each
  rank normalising with its own statistics), which must fail a bar.
  Readings (2 threads a process; loss / gradients / statistics /
  parameters): dropout 0 and remat 8.4e-8 / 9.1e-6 / 5.1e-7 / 1.4e-5,
  dropout on 2.0e-7 / 6.5e-6 / 3.1e-7 / 3.0e-5, the control 1.9e-3 / 0.44 /
  0.12 / 1.87. The gradient bar is 1e-4 (as ``test_torch_train_step.py``
  holds the port's step against JAX's): the tiny Darknet's conv weights
  behind train-mode BatchNorm move 9.1e-6 under the split alone, and 2.5e-6
  between 1 and 4 threads of one process, so 1e-5 had no room.
* **The driver.** ``cli.train_et.main`` in 2 processes
  (``AVDN_NUM_PROCESSES``): 4 steps and one validation; checkpoints from
  rank 0 only, both ranks' metric records within 1e-9. Then a SIGTERM to
  rank 1 after its second step: both ranks stop at that step, rank 0 saves
  ``latest_dict_2.pt``, both exit 0.

Run a worker by hand: ``python tests/test_torch_parallel.py <case> <rank>
<port> <work dir>``.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N_ITEMS = 4
T_STEPS = 3
WORKER_TIMEOUT_S = 300
GROUP_TIMEOUT_S = 60


# ------------------------------------------------------------- the workers --
# They import the port only (no JAX), and run with 2 intra-op threads each.


def _join(rank, port):
    from avdn_tpu_torch.parallel.collectives import init_distributed

    return init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo",
                            timeout_s=GROUP_TIMEOUT_S)


def _worker_collectives(rank, port, work):
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.parallel.collectives import (all_gather_metrics,
                                                     merge_prediction_dicts,
                                                     reduce_mean_metrics)
    from avdn_tpu_torch.parallel.runtime import setup_runtime

    assert _join(rank, port) == rank
    rt = setup_runtime(None)
    out = dict(rank=rt.process_index, count=rt.process_count, main=rt.is_main,
               multi=rt.multiprocess)
    out["metrics"] = all_gather_metrics({"loss": float(rank), "n": 1.0})
    out["mean"] = reduce_mean_metrics({"loss": float(rank), "sr": 10.0 * rank})
    out["merged"] = merge_prediction_dicts({f"m__{rank}": rank, "m__shared": rank})
    out["flags"] = [rt.any_flag(rank == 1), rt.any_flag(False)]
    bank = DeviceMapBank(work, (64 + 64 * rank, 256 - 64 * rank), n_slots=2,
                         device="cpu")
    rt.sync_bank_growth(bank)
    out["bank"] = [list(bank.bank_hw), list(bank.array.shape)]
    model = torch.nn.Linear(3, 2)
    with torch.no_grad():
        model.weight.copy_(torch.arange(6.0).reshape(2, 3))
        model.bias.zero_()
    rt.assert_replicas_identical([model])
    if rank == 1:
        with torch.no_grad():
            model.weight[0, 0] += 1e-3
    try:
        rt.assert_replicas_identical([model], "weights")
        out["perturbed"] = "no error"
    except RuntimeError as e:
        out["perturbed"] = str(e)
    return out


def _worker_step(rank, port, work):
    from avdn_tpu_torch.parallel import batch as pbatch

    _join(rank, port)
    out = {}
    real = pbatch.batch_sum
    for case in CASES:
        if case == "control":
            pbatch.batch_sum = lambda x: x  # BatchNorm on local statistics
        try:
            out[case] = two_steps(work, rank, remat=case == "remat",
                                  dropout=case == "dropout")
        finally:
            pbatch.batch_sum = real
    if rank == 0:  # one process at the global batch, at the ranks' thread count
        for case in ("plain", "remat", "dropout"):
            out[f"one_process_{case}"] = two_steps(
                work, None, remat=case == "remat", dropout=case == "dropout")
    torch.save(out, os.path.join(work, f"step_rank{rank}.pt"))
    return {"cases": sorted(out)}


def _worker_driver(rank, port, work):
    import signal

    import avdn_tpu_torch.train.checkpoints as ckpt
    import avdn_tpu_torch.train.loop as loop
    from avdn_tpu_torch.cli.train_et import main

    _join(rank, port)  # with the test's timeout: cli's maybe_init_distributed finds it joined
    with open(os.path.join(work, "argv.json")) as f:
        argv = json.load(f)
    saves = []
    real_save = ckpt.save_checkpoint

    def save(ckpt_dir, name, *a, **kw):
        saves.append(name)
        return real_save(ckpt_dir, name, *a, **kw)

    ckpt.save_checkpoint = save
    if os.environ.get("SIGTERM_RANK") == str(rank):
        real_step = loop.make_train_step

        def make_signalling_step(*a, **kw):
            step = real_step(*a, **kw)
            done = []

            def signalled(*sa, **skw):
                res = step(*sa, **skw)
                done.append(1)
                if len(done) == 2:
                    os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
                return res

            return signalled

        loop.make_train_step = make_signalling_step
    state, history = main(argv, device="cpu")
    return {"step": state.step, "steps_run": len(history), "saves": saves,
            "losses": [m["loss"] for m in history]}


def two_steps(work, rank, remat, dropout=False, world=2):
    """Two train steps from the seed's weights, dropout 0 unless ``dropout``:
    this rank's half of the first ``N_ITEMS`` fixture items (all of them
    with ``rank`` None, one process, whose BatchNorm then computes the data-
    parallel step's formula, E[x²] − E[x]² of the batch sums, so that the
    comparison sees the collectives and not the formula). Returns the loss
    and the gradients the optimizers were given in the first step, the
    BatchNorm running statistics after it, and the parameters after the
    second."""
    import dataclasses

    from avdn_tpu_torch.config import parse_args
    from avdn_tpu_torch.parallel import batch as pbatch
    from avdn_tpu_torch.data.batcher import make_train_batch
    from avdn_tpu_torch.data.maps import DeviceMapBank
    from avdn_tpu_torch.data.tokenizer import WordPieceTokenizer
    from avdn_tpu_torch.models.layers import Dropout
    from avdn_tpu_torch.serve import Navigator
    from avdn_tpu_torch.train import optim
    from avdn_tpu_torch.train.loop import (batcher_config, build_models, init_state,
                                           train_config_from_args)
    from avdn_tpu_torch.train.step import create_train_state, make_train_step

    with open(os.path.join(work, "argv.json")) as f:
        args = parse_args(json.load(f))
    cfg = dataclasses.replace(train_config_from_args(args), max_action_len=T_STEPS,
                              remat=remat, remat_policy="dots")
    models = build_models(args, torch.device("cpu"))
    init_state(models, torch.Generator().manual_seed(0))
    for m in models:
        for mod in m.modules():
            if isinstance(mod, Dropout) and not dropout:
                mod.p = 0.0
    with open(os.path.join(args.train_anno_dir, "train_data.json")) as f:
        items = [Navigator._normalize_item(it) for it in json.load(f)[:N_ITEMS]]
    if rank is not None:
        half = N_ITEMS // world
        items = items[rank * half:(rank + 1) * half]
    bank = DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                         n_slots=args.map_bank_slots, device="cpu")
    arr, slots = bank.prepare(items)
    batch, _ = make_train_batch(items, WordPieceTokenizer.load(None), slots,
                                batcher_config(args))
    state = create_train_state(cfg, *models)
    group = None if rank is None else torch.distributed.group.WORLD
    step = make_train_step(cfg, *models, group=group)
    seen = []
    real = optim.Adam.step

    def record(opt, grads, *a, **kw):
        seen.append([g.clone() for g in grads])
        return real(opt, grads, *a, **kw)

    optim.Adam.step = record
    real_active = pbatch.active
    if rank is None:
        pbatch.active = lambda: True  # the global-batch formula, over one process
    try:
        gen = torch.Generator().manual_seed(5)
        m1 = step(state, arr, batch, gen)
        stats = {n: b.clone() for n, b in models[1].named_buffers()}
        m2 = step(state, arr, batch, gen)
    finally:
        optim.Adam.step = real
        pbatch.active = real_active
    grads = {f"{i}.{n}": g for i, (opt, gs) in enumerate(zip(state.optimizers(), seen[:3]))
             for n, g in zip(opt.names, gs)}
    params = {f"{i}.{n}": p.detach().clone() for i, m in enumerate(models)
              for n, p in m.named_parameters()}
    return dict(loss=[float(m1["loss"]), float(m2["loss"])], grads=grads, stats=stats,
                params=params)


#: the ranks' runs: dropout 0 without and with ``--remat``, dropout on (the
#: ranks' masks are their rows of one process's draw), and the control
#: (BatchNorm on each rank's own statistics)
CASES = ("plain", "remat", "dropout", "control")

_WORKERS = {"collectives": _worker_collectives, "step": _worker_step,
            "driver": _worker_driver}


if __name__ == "__main__":
    case, rank, port, work = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    result = _WORKERS[case](rank, port, work)
    with open(os.path.join(work, f"{case}_rank{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"rank {rank} OK", flush=True)
    sys.exit(0)


# --------------------------------------------------------------- the tests --


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(case, work, env_per_rank=None, timeout=WORKER_TIMEOUT_S):
    """Run ``case`` in 2 processes; returns their outputs, after asserting
    both exited 0. Each process is killed at ``timeout`` seconds."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="2")
    procs = []
    for rank in range(2):
        e = dict(env, **(env_per_rank(rank, port) if env_per_rank else {}))
        cmd = [sys.executable, os.path.abspath(__file__), case, str(rank), str(port), work]
        procs.append(subprocess.Popen(cmd, cwd=REPO, env=e, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{o[-4000:]}"
        assert f"rank {rank} OK" in o
    results = []
    for rank in range(2):
        with open(os.path.join(work, f"{case}_rank{rank}.json")) as f:
            results.append(json.load(f))
    return results, outs


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    from test_e2e_loop import make_args
    from torch_shared import fixture_dataset, port_argv

    root, cfg_path = fixture_dataset(tmp_path_factory)

    def argv(out, **over):
        args = make_args(root, out, cfg_path, render_twopass=False, **over)
        return port_argv(args) + ["--bf16", "False", "--iters", str(args.iters),
                                  "--log_every", str(args.log_every), "--lr", "1e-3"]

    return root, argv


def test_collectives(tmp_path):
    (r0, r1), _ = _spawn("collectives", str(tmp_path))
    for rank, r in enumerate((r0, r1)):
        assert (r["rank"], r["count"], r["main"], r["multi"]) == (rank, 2, rank == 0, True)
        assert r["metrics"] == [{"loss": 0.0, "n": 1.0}, {"loss": 1.0, "n": 1.0}]
        assert r["mean"] == {"loss": 0.5, "sr": 5.0}
        # the union, later processes overwriting a shared key
        assert r["merged"] == {"m__0": 0, "m__1": 1, "m__shared": 1}
        assert r["flags"] == [True, False]
        assert r["bank"] == [[128, 256], [2, 128, 256, 3]]
        assert "differs between process 0 and process 1" in r["perturbed"]


@pytest.mark.parametrize("count", [2, 3])
@pytest.mark.parametrize("split", ["train", "val_seen"])
def test_shards_equal_the_jax_package(fixture, split, count):
    from avdn_tpu.data.annotations import ANDHDataset as JaxDataset
    from avdn_tpu_torch.data.annotations import ANDHDataset

    root, _ = fixture
    anno = os.path.join(root, "AVDN", "annotations")

    def ids(items):
        return [it["map_name"] + "__" + it["route_index"] for it in items]

    covered = set()
    for index in range(count):
        mine = ANDHDataset(anno, [split], 3, seed=7 + index, shard=(index, count))
        theirs = JaxDataset(anno, [split], 3, seed=7 + index, shard=(index, count))
        assert ids(mine.data) == ids(theirs.data)
        assert mine.owned_instr_ids == theirs.owned_instr_ids
        assert mine.size() == theirs.size() == -(-theirs.total_size // count)
        for _ in range(2):  # two epochs: the wrap-around refill reshuffles
            assert [ids(b) for b in mine] == [ids(b) for b in theirs]
        covered |= mine.owned_instr_ids
    assert len(covered) == theirs.total_size


def _rel_to_max(a, b, scale=None):
    scale = max(float(b.abs().max()) if scale is None else scale, 1e-30)
    return float((a - b).abs().max()) / scale


#: the bars, by kind (see :func:`_readings`)
BARS = {"loss": 1e-6, "grads": 1e-4, "stats": 1e-5, "params": 1e-4}

#: gradients that are zero in exact arithmetic (a key bias shifts every
#: logit of a softmax row alike): held to their group's largest gradient
_ZERO_GRADS = "attention.self.key.bias"


def _readings(got, want):
    """How far ``got`` is from ``want``, by kind: the first step's loss
    relative; the largest difference of each gradient leaf and BatchNorm
    running statistic relative to that leaf's largest magnitude; the same
    of the parameters after two steps. Each as ``(reading, leaf)`` of the
    worst leaf."""
    out = {"loss": (abs(got["loss"][0] - want["loss"][0]) / abs(want["loss"][0]), "loss")}
    group_max = {}
    for k, g in want["grads"].items():
        group = k.split(".")[0]
        group_max[group] = max(group_max.get(group, 0.0), float(g.abs().max()))
    for kind in ("grads", "stats", "params"):
        assert got[kind].keys() == want[kind].keys()
        worst = (0.0, "")
        for k, w in want[kind].items():
            if not w.is_floating_point():
                assert torch.equal(got[kind][k], w), k
                continue
            a, scale = got[kind][k], None
            if kind == "params":
                # Adam steps an element whose gradient is rounding noise (a
                # key bias's) by the noise's sign: compare the others
                keep = want["grads"][k].abs() > 1e-6 * group_max[k.split(".")[0]]
                scale, a, w = float(w.abs().max()), a[keep], w[keep]
            elif _ZERO_GRADS in k:
                scale = group_max[k.split(".")[0]]
            if w.numel():
                worst = max(worst, (_rel_to_max(a, w, scale), k))
        out[kind] = worst
    return out


def test_two_ranks_equal_one_process_at_the_global_batch(fixture, tmp_path):
    root, argv = fixture
    work = str(tmp_path)
    with open(os.path.join(work, "argv.json"), "w") as f:
        json.dump(argv(os.path.join(work, "out"), batch_size=N_ITEMS // 2,
                       max_action_len=T_STEPS), f)
    _spawn("step", work)
    ranks = [torch.load(os.path.join(work, f"step_rank{r}.pt"), weights_only=False)
             for r in range(2)]
    readings = {}
    for case in CASES:
        a, b = ranks[0][case], ranks[1][case]
        if case != "control":  # the replicas stay bit-identical
            assert a["loss"] == b["loss"]
            for kind in ("params", "stats"):
                for k, x in a[kind].items():
                    assert torch.equal(x, b[kind][k]), (case, k)
        want = ranks[0][f"one_process_{'plain' if case == 'control' else case}"]
        readings[case] = _readings(a, want)
    print("readings (worst leaf):", json.dumps(readings, indent=1))
    over = {case: {kind: r[0] / BARS[kind] for kind, r in rs.items()}
            for case, rs in readings.items()}
    print("as multiples of the bars:", over)
    for case in ("plain", "remat", "dropout"):
        assert max(over[case].values()) <= 1.0, (case, readings[case])
    # it sees a missing BN collective
    assert max(over["control"].values()) > 1.0, readings["control"]


def test_two_process_train_driver_and_sigterm_consensus(fixture, tmp_path):
    root, argv = fixture

    def env(rank, port):
        return {"AVDN_NUM_PROCESSES": "2", "AVDN_COORDINATOR": f"127.0.0.1:{port}",
                "AVDN_PROCESS_ID": str(rank)}

    # 8 train items, 4 per rank, B = 2: one interval of 4 steps (2 epochs)
    work = str(tmp_path / "run")
    os.makedirs(work)
    out = os.path.join(work, "out")
    with open(os.path.join(work, "argv.json"), "w") as f:
        json.dump(argv(out, batch_size=2, iters=4, log_every=2), f)
    (r0, r1), _ = _spawn("driver", work, env)
    assert r0["step"] == r1["step"] == 4 and r0["steps_run"] == r1["steps_run"] == 4
    assert r0["saves"] == ["latest_dict_4", "best_val_unseen"] and r1["saves"] == []
    assert r0["losses"] == r1["losses"]  # the loss is the global batch's
    assert sorted(os.listdir(os.path.join(out, "ckpts"))) == [
        "best_val_unseen.pt", "latest_dict_4.pt"]
    from torch_shared import metrics_of

    m0 = metrics_of(os.path.join(out, "logs"))
    m1 = metrics_of(os.path.join(out, "logs", "proc1"))
    assert m0.keys() == m1.keys() and "spl/val_unseen" in m0 and "loss/IL_loss" in m0
    for k in m0:
        assert abs(m0[k] - m1[k]) < 1e-9, (k, m0[k], m1[k])
    with open(os.path.join(out, "logs", "train.txt")) as f:
        assert "data parallel: 2 processes over gloo, process 0" in f.read()

    # SIGTERM to rank 1 after its second step: both stop there
    work = str(tmp_path / "sigterm")
    os.makedirs(work)
    out = os.path.join(work, "out")
    with open(os.path.join(work, "argv.json"), "w") as f:
        json.dump(argv(out, batch_size=2, iters=4, log_every=2), f)
    (r0, r1), outs = _spawn("driver", work, lambda rank, port: dict(
        env(rank, port), SIGTERM_RANK="1"))
    assert r0["step"] == r1["step"] == 2 and r0["steps_run"] == r1["steps_run"] == 2
    assert r0["saves"] == ["latest_dict_2"] and r1["saves"] == []
    assert os.listdir(os.path.join(out, "ckpts")) == ["latest_dict_2.pt"]
    for log in ("", "proc1"):
        with open(os.path.join(out, "logs", log, "train.txt")) as f:
            assert "preemption signal" in f.read()
