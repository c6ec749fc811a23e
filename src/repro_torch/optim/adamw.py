"""AdamW, written out as the reference writes it (not ``torch.optim``).

The partner of ``repro/optim/adamw.py``, with its update rule:

  * float32 moments whatever the parameter dtype (bfloat16 parameters,
    float32 m and v);
  * global-norm clipping by ``min(1, clip / (norm + 1e-9))``, the norm
    reported before the clip;
  * bias correction from the step count, the schedule a function of it;
  * weight decay added to the Adam step before the learning rate, the
    step computed in float32, cast to the parameter dtype and added as
    ``p + u`` — so the rounding is the reference's, which
    ``torch.optim.AdamW`` (decay applied to the parameter first, updates
    in place) does not reproduce.

States mirror the parameter tree (``optim.tree``), so the moments of the
port's per-layer list are per-layer lists too.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple

import torch

from .tree import tree_leaves, tree_map, tree_unflatten


class OptState(NamedTuple):
    """The optimizer's state: first and second moments (float32 trees of
    the parameters' structure) and the int32 step count."""

    m: Any
    v: Any
    count: torch.Tensor


class TrainState(NamedTuple):
    """Parameters, optimizer state and the int32 step, in the reference's
    field order (its checkpoints flatten them in this order)."""

    params: Any
    opt_state: OptState
    step: torch.Tensor


@dataclass(frozen=True)
class AdamW:
    """Decoupled-weight-decay Adam with the reference's defaults."""

    lr: float | Callable[[torch.Tensor], torch.Tensor] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float | None = 1.0

    def init(self, params: Any) -> OptState:
        """Zero moments in float32 and a zero count, on the parameters'
        device."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        device = tree_leaves(params)[0].device
        return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                        count=torch.zeros((), dtype=torch.int32,
                                          device=device))

    def _lr(self, count: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(count)
        return torch.tensor(self.lr, dtype=torch.float32,
                            device=count.device)

    def update(self, grads: Any, state: OptState, params: Any
               ) -> tuple[Any, OptState, dict[str, torch.Tensor]]:
        """Returns (updates, new_state, stats).  ``updates`` are deltas
        to be added to params (in param dtype); ``stats`` holds the
        pre-clip ``grad_norm`` and the ``lr``.

        Each leaf's float32 gradient, moments and step are computed leaf
        by leaf (the reference's arithmetic, op for op), so the
        temporaries of one leaf are live at a time."""
        gnorm = global_norm(grads)
        scale = None
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        count = state.count + 1
        b1, b2 = self.b1, self.b2
        c = count.float()
        mhat_scale = 1.0 / (1 - torch.pow(b1, c))
        vhat_scale = 1.0 / (1 - torch.pow(b2, c))
        lr = self._lr(count)

        def leaf(g, m_, v_, p):
            g = g.float()
            if scale is not None:
                g = g * scale
            m_ = b1 * m_ + (1 - b1) * g
            v_ = b2 * v_ + (1 - b2) * g * g
            step = (m_ * mhat_scale) / (torch.sqrt(v_ * vhat_scale)
                                        + self.eps)
            step = step + self.weight_decay * p.float()
            return m_, v_, (-lr * step).to(p.dtype)

        out = [leaf(*xs) for xs in zip(tree_leaves(grads),
                                       tree_leaves(state.m),
                                       tree_leaves(state.v),
                                       tree_leaves(params))]
        m, v, updates = (tree_unflatten(params, [o[i] for o in out])
                         for i in range(3))
        return updates, OptState(m, v, count), {"grad_norm": gnorm, "lr": lr}


def apply_updates(params: Any, updates: Any) -> Any:
    """``p + u`` leaf by leaf, in the parameters' dtype."""
    return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree: Any) -> torch.Tensor:
    """The L2 norm of every leaf together, in float32."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


__all__ = ["AdamW", "OptState", "TrainState", "apply_updates",
           "global_norm"]
