"""Traffic kind ``train``: the port's train step, fed as its train driver
feeds it, for ``--seconds``.

Set-up builds one train state (the models with the seed's weights, the
three optimizers) and drives it through its first ``check_steps`` steps on
the driver's own feed (``ANDHDataset`` over the seeded items, the map bank,
``make_train_batch`` on a prefetch thread, the generator seeded from
``--seed``): those steps warm up every shape, and their losses, the first
gradient (from the optimizers' first moments after step 1) and the change
of the parameters are kept for the check. The same state then trains on in
the window. ``train_eps`` is the episodes of the window's steps over the
window: it closes at the end of the step during which ``--seconds`` ran
out, a step counting once its loss reached the host.

During the checked steps each call of the port's optimizers is also checked
against the reference's AdamW run from the same state (:class:`AdamCheck`).
After the window the reference runs the same first steps from the same
weights, items and generator seed and the two are compared
(``harness/compare.py``).
"""

from __future__ import annotations

import copy
import functools
import gc
import itertools
import sys
import time

import torch

from harness import compare, data, kernels, program, refmodels
from harness.weights import init_weights


def _norms(tensors):
    return [float(torch.linalg.vector_norm(t)) for t in tensors]


def _leaf_gaps(got, want, scale):
    """Per leaf, the norm of ``got − want`` over the norm of ``scale``'s
    leaf or of its median leaf, whichever is larger."""
    diff = torch.stack([torch.linalg.vector_norm(a - b) for a, b in zip(got, want)]).tolist()
    size = torch.stack([torch.linalg.vector_norm(t) for t in scale]).tolist()
    floor = sorted(size)[len(size) // 2] if size else 0.0
    return [d / max(n, floor, 1e-30) for d, n in zip(diff, size)]


class AdamCheck:
    """Each call of a train state's optimizers checked against the
    reference's AdamW (``reference/train/optim.py`` with the reference's own
    hyperparameters: ``templates``, optimizers over no parameters) run from
    the same state: the parameters, both moments and the count before the
    call, and the gradients handed to it. The reference recomputes the clip,
    the moments, the bias corrections, the weight decay and the update. Per
    call the worst leaf of the parameters' update (over the reference's
    update), of each moment and of the count is kept in ``gaps``: the whole
    AdamW update at every count, which the first step's numbers alone cannot
    see (at count 1 the update is about lr · sign(g), whatever b2 is)."""

    def __init__(self, opts, templates):
        self.opts, self.gaps = list(opts), []
        for opt, template in zip(self.opts, templates):
            opt.step = functools.partial(self._step, opt, opt.step, template)

    def remove(self) -> None:
        for opt in self.opts:
            del opt.step

    @torch.no_grad()
    def _step(self, opt, step, template, grads, norm=None):
        ref = copy.copy(template)
        before = [p.detach().clone() for p in opt.params]
        ref.params = [p.clone() for p in before]
        ref.mu, ref.nu = [t.clone() for t in opt.mu], [t.clone() for t in opt.nu]
        ref.count = opt.count
        given = [g.detach().clone() for g in grads]
        step(grads, norm)
        ref.step(given)
        if opt.count != ref.count:
            self.gaps.append(float("inf"))
            return
        update = [a - b for a, b in zip(ref.params, before)]
        got = [p.detach() - b for p, b in zip(opt.params, before)]
        gaps = (_leaf_gaps(got, update, update) + _leaf_gaps(opt.mu, ref.mu, ref.mu)
                + _leaf_gaps(opt.nu, ref.nu, ref.nu))
        self.gaps.append(max(gaps, default=0.0))


def reference_optimizers(flags: dict, family: str):
    """The reference's three optimizers over no parameters: its learning
    rate, betas, eps, weight decay and clip for each of the port's."""
    from reference.train.step import create_train_state

    cfg = refmodels.train_config(flags, family)
    return create_train_state(cfg, *(torch.nn.Module() for _ in range(3))).optimizers()


def _first_steps(state, next_batch, step, generator, n_steps, templates):
    """Drive ``state`` through its first ``n_steps`` steps: each step's
    loss; per leaf (in the optimizers' order) the norm of the first gradient
    as the optimizer got it (its first moment after step 1, over 1 − b1) and
    of the parameters' change after step 1 and after the last step; and the
    worst reading of :class:`AdamCheck` over every optimizer call."""
    opts = state.optimizers()
    params = [p for opt in opts for p in opt.params]
    p0 = [p.detach().clone() for p in params]
    out = {"losses": []}
    check = AdamCheck(opts, templates)
    try:
        for k in range(n_steps):
            bank, batch = next_batch()
            out["losses"].append(float(step(state, bank, batch, generator)["loss"]))
            if k == 0:
                out["grad_norms"] = [n / (1 - opt.b1) for opt in opts for n in _norms(opt.mu)]
                out["step1_norms"] = _norms([p.detach() - q for p, q in zip(params, p0)])
    finally:
        check.remove()
    out["delta_norms"] = _norms([p.detach() - q for p, q in zip(params, p0)])
    out["adam_gaps"] = check.gaps
    return out


def run(ctx) -> dict:
    P = program.modules()
    cell, seed, device = ctx.cell, ctx.seed, ctx.device
    tr = cell.traffic
    run_dir = ctx.run_dir
    items = data.make_items(seed, tr["n_items"], tr["n_maps"], tr["map_px"])
    maps = data.make_maps(seed, tr["n_maps"], tr["map_px"], device)
    data.write_annotations(run_dir, {"train": items})
    args = P.parse_args(ctx.argv, family=cell.config["family"])
    P.use_fp32_numerics()
    models = P.build_models(args, device, bf16=P.train_bf16(args))
    init_weights(models, seed, device)
    cfg = P.train_config_from_args(args)
    state = P.create_train_state(cfg, *models)
    train_step = ctx.wrap_step(P.make_train_step(cfg, *models))
    tokenizer = P.WordPieceTokenizer.load(None)
    bcfg = P.batcher_config(args)
    bank = P.DeviceMapBank(args.train_dataset_dir, (args.map_bank_px,) * 2,
                           n_slots=args.map_bank_slots, device=device,
                           loader=lambda it: maps[it["map_name"]])
    env = P.ANDHDataset(args.train_anno_dir, ["train"], args.batch_size, seed=seed)

    def prepare(batch_items):
        bank_arr, slot_of = bank.prepare(batch_items)
        batch, _ = P.make_train_batch(batch_items, tokenizer, slot_of, bcfg, device=device)
        return bank_arr, batch

    feed = iter(P.Prefetcher(itertools.chain.from_iterable(iter(lambda: env, None)),
                             prepare, depth=2))
    generator = torch.Generator(device).manual_seed(data.sub_seed(seed, 4))
    B = args.batch_size

    # -- set-up: the checked first steps, which also build and warm up --
    got = _first_steps(state, lambda: next(feed), train_step, generator, tr["check_steps"],
                       reference_optimizers(ctx.flags, cell.config["family"]))
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    # -- the window --
    def steps(seconds=None, n=None):
        done, waited = 0, 0.0
        t0 = time.perf_counter()
        while True:
            tw = time.perf_counter()
            bank_arr, batch = next(feed)
            waited += time.perf_counter() - tw
            float(train_step(state, bank_arr, batch, generator)["loss"])
            done += 1
            el = time.perf_counter() - t0
            if (seconds is not None and el >= seconds) or (n is not None and done >= n):
                return done, waited, el

    n_steps, waited, window_s = steps(seconds=ctx.seconds)
    rec = ctx.record
    rec.update(units=n_steps, window_s=window_s, episodes=n_steps * B,
               unit_name="step", batch_wait_s=waited,
               flops_per_unit=refmodels.step_flops(ctx.flags, cell.config["family"], "train"),
               peak_flops=kernels.FP32_FLOPS if not P.train_bf16(args) else None)
    if ctx.trace:
        launches = []

        def traced_steps():
            launches.clear()
            with kernels.recording(P.saliency, launches):
                done, _, _ = steps(n=tr["trace_units"])
            return done

        rec["trace"] = ctx.traced(traced_steps, lambda: steps(n=1)[0],
                                  lambda: kernels.counts(launches))
        rec["launches"] = launches
    rec["memory_peak_bytes"] = ctx.memory_peak()
    metrics = {"train_eps": n_steps * B / window_s, "setup_s": setup_s}

    # -- free the port, then the reference's first steps --
    del state, models, train_step, feed, bank
    gc.collect()
    ctx.free()
    want = reference_steps(ctx, args, maps, seed)
    rec["check"] = (got, want)
    print(f"[train] {compare.train_detail(got, want)}", file=sys.stderr)
    return dict(metrics=metrics, compared=compare.train(got, want),
                attempted=tr["check_steps"] + n_steps)


def reference_steps(ctx, args, maps, seed):
    """The reference's first steps from the seed's weights on the same
    items, batches and generator seed: its losses, first-gradient and
    parameter-change norms per leaf, in the port's leaf order."""
    from reference.device import use_fp32_numerics
    from reference.train.step import create_train_state, make_train_step

    cell, device, tr = ctx.cell, ctx.device, ctx.cell.traffic
    flags = ctx.flags
    family = cell.config["family"]
    use_fp32_numerics()
    models = refmodels.build_models(flags, family, device, bf16=False)
    init_weights(models, seed, device)
    cfg = refmodels.train_config(flags, family)
    state = create_train_state(cfg, *models)
    step = make_train_step(cfg, *models)
    bank = refmodels.Bank(maps, flags["map_bank_px"], device)
    gen = torch.Generator(device).manual_seed(data.sub_seed(seed, 4))
    feed = refmodels.batches(args.train_anno_dir, "train", args.batch_size, seed, flags,
                             device, bank.slot_of)
    return _first_steps(state, lambda: (bank.array, next(feed)[1]), step, gen,
                        tr["check_steps"], reference_optimizers(flags, family))
