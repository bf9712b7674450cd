"""Faults planted under a run's timed path, for the tests and the
calibration that show each comparison fails on them: each wraps what
``Context.wrap_step`` hands it."""

from __future__ import annotations

import dataclasses

import torch


def half_batch(fn):
    """The train step on the first half of each batch (the loss's mean over
    those items alone)."""
    from avdn_tpu_torch.train.step import _micro_batch

    def step(state, bank, batch, gen):
        return fn(state, bank, _micro_batch(batch, 0, 2), gen)
    return step


def frozen_state(fn):
    """A train step that leaves the parameters and optimizer state as they
    were."""
    import torch

    def step(state, bank, batch, gen):
        params = [p.detach().clone() for m in state.models() for p in m.parameters()]
        opt = [(o.count, [t.clone() for t in o.mu], [t.clone() for t in o.nu])
               for o in state.optimizers()]
        out = fn(state, bank, batch, gen)
        with torch.no_grad():
            for p, q in zip((p for m in state.models() for p in m.parameters()), params):
                p.copy_(q)
        for o, (count, mu, nu) in zip(state.optimizers(), opt):
            o.count, o.mu, o.nu = count, mu, nu
        return out
    return step


def wrong_b2(fn):
    """A train step whose optimizers decay the second moment at 0.99 in
    place of 0.999."""
    def step(state, bank, batch, gen):
        for opt in state.optimizers():
            opt.b2 = 0.99
        return fn(state, bank, batch, gen)
    return step


def altered_outputs(out):
    """An eval rollout whose first item's first waypoint is moved."""
    wp = out.actions_wp.clone()
    wp[0, 0] += 0.05
    return dataclasses.replace(out, actions_wp=wp)


def altered_rollout(fn):
    """The serving rollout with :func:`altered_outputs`."""
    def call(*a, **kw):
        return altered_outputs(fn(*a, **kw))
    return call


TRAIN = {"half": half_batch, "frozen": frozen_state, "wrong_b2": wrong_b2}
