"""Eval-only single-pass teacher trunk (torch counterpart of
``teacher_onepass`` in ``avdn_tpu/models/et_fast.py``).

The trunk's attention mask is causal over the frame and direction blocks
(src/models/model_util.py:213-241): the token at step position j attends
language plus steps ≤ j. With the per-item key padding (``step >=
lengths[b]`` masked, src/models/enc_vl.py:49-55), the attention support of
position j in a full-history pass equals its support in the step-t call for
every t ≥ j:

* item alive at step t (``lengths_t[b] = t+1``): causality already restricts
  keys to ``s ≤ j ≤ t < lengths``, so neither call's padding binds;
* item ended at step e < t (``lengths_t[b] = e+1`` frozen): both calls mask
  ``s ≥ e+1`` identically.

By induction over layers every token at position j is the same in all calls
with t ≥ j, so ONE pass with the final lengths gives every step's readout
token: the per-step outputs are gathers at the batch-max positions
``max_b lengths_t[b] − 1`` (src/models/ET_haa.py:157-158). In eval mode
(no dropout) this equals the T step-masked re-encodes of the teacher rollout
at a T-th of the trunk work.
"""

from __future__ import annotations


def teacher_onepass(model, lang, lang_cls, frames, dirs, lengths_steps):
    """All T per-step (action, saliency) outputs of ``model`` (an eval-mode
    ``HAATransformer``) from one trunk pass.

    ``frames`` (B, T, C, 49) and ``dirs`` (B, T, 2) are the full unmasked
    history; ``lengths_steps`` (T, B) the cumulative alive counts per step.
    Returns ``action (T, B, 4)`` and ``saliency (T, B, hw, hw)``."""
    B, T = frames.shape[0], frames.shape[1]
    L = lang.shape[1]
    seq = model.encode(lang, lang_cls, frames, dirs, lengths_steps[-1])
    m = lengths_steps.max(dim=1).values - 1                  # (T,)
    vis_tok = seq.index_select(1, L + m)                      # (B, T, D)
    dir_tok = seq.index_select(1, L + T + m)
    # step-major, so the readout's rows are (t, b) in order
    action, saliency = model.readout(vis_tok.transpose(0, 1).reshape(T * B, -1),
                                     dir_tok.transpose(0, 1).reshape(T * B, -1))
    return action.reshape(T, B, -1), saliency.reshape(T, B, *saliency.shape[1:])
