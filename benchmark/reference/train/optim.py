# Frozen copy of avdn_tpu_torch/train/optim.py at commit d6443de, its imports pointed
# at the reference package.
"""The train step's optimizers: optax's Adam / AdamW and global-norm clip.

The JAX package builds each of its three optimizers (language tower, vision
tower, VLN model) as ``optax.chain([clip_by_global_norm(40)], adamw(...))``
or ``adam(...)`` (``avdn_tpu/train/step.py:_make_optimizer``). This module
applies the same update in the same order of operations, so one step
agrees with optax to float32 rounding:

* clip: ``g ← (g / ‖g‖) · max_norm`` only where ``‖g‖ ≥ max_norm``, with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ``‖g‖ + 1e-6``);
* ``μ ← (1 − b1)·g + b1·μ``, ``ν ← (1 − b2)·g² + b2·ν``, ``count += 1``;
* ``u = μ̂ / (√ν̂ + eps)`` with ``μ̂ = μ / (1 − b1^count)`` and likewise ν̂;
* AdamW adds ``weight_decay · p`` to ``u`` (optax's decoupled decay, which
  ``torch.optim.AdamW`` applies as ``p·(1 − lr·wd)`` before the step);
* ``p ← p + (−lr)·u``.

The updates run as ``torch._foreach_*`` ops (a few multi-tensor kernels per
step on the card) with no host synchronisation: the clip decision stays a
tensor.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: √(Σ over tensors of Σ x²), a 0-d tensor."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """``optax.clip_by_global_norm``: the grads unchanged where their global
    norm is below ``max_norm``, else ``(g / norm) · max_norm``."""
    norm = global_norm(grads) if norm is None else norm
    keep = norm < max_norm
    return [torch.where(keep, g, (g / norm) * max_norm) for g in grads]


class Adam:
    """optax's ``adamw`` (``weight_decay`` > 0) or ``adam`` chained after an
    optional ``clip_by_global_norm(clip)``, over named parameters.

    ``step(grads)`` updates the parameters in place from a list of
    gradients in the parameters' order; ``state_dict`` /
    ``load_state_dict`` carry ``count`` and the moments by parameter name.
    """

    def __init__(self, named_params, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 clip: Optional[float] = None):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.weight_decay = weight_decay
        self.clip = clip
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def _bias_correction(self, decay: float) -> float:
        # 1 − decay**count in float32, as optax computes it
        return float(1.0 - torch.tensor(decay, dtype=torch.float32) ** self.count)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             norm: Optional[torch.Tensor] = None) -> None:
        """One update from ``grads`` (``norm``: their global norm, if the
        caller has it already)."""
        grads = [g.detach() for g in grads]
        if self.clip is not None:
            grads = clip_by_global_norm(grads, self.clip, norm)
        b1, b2 = self.b1, self.b2
        mu = torch._foreach_mul(grads, 1.0 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(self.mu, b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(self.nu, b2))
        self.mu, self.nu = mu, nu
        self.count += 1
        mu_hat = torch._foreach_div(mu, self._bias_correction(b1))
        nu_hat = torch._foreach_div(nu, self._bias_correction(b2))
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(update, torch._foreach_mul(self.params,
                                                           self.weight_decay))
        torch._foreach_add_(self.params, torch._foreach_mul(update, -self.lr))

    def state_dict(self) -> Dict:
        return {"count": self.count,
                "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, state: Dict) -> None:
        """Restore ``count`` and the moments (strict on the names)."""
        for key in ("mu", "nu"):
            if set(state[key]) != set(self.names):
                raise KeyError(f"optimizer {key}: names differ from the "
                               f"parameters' ({sorted(set(state[key]) ^ set(self.names))})")
        self.count = int(state["count"])
        self.mu = [state["mu"][n].to(p) for n, p in zip(self.names, self.params)]
        self.nu = [state["nu"][n].to(p) for n, p in zip(self.names, self.params)]
