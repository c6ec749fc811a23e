"""Hand a parameter tree of the JAX package over to the port.

``params_from_reference(tree, cfg, device)`` is the model counterpart of
the streaming coordinator's ``carries_from_reference``: it takes the tree
``repro.models.init_params`` builds, as numpy arrays (``jax.device_get``),
with every layer leaf stacked on a leading ``(L, ...)`` axis, and returns
the port's parameters — the same keys, ``layers`` unstacked into a list
of per-layer dicts — on ``device``.  bfloat16 arrays (numpy's
``ml_dtypes`` type) are reinterpreted bit for bit, so no value changes.

``train_state_from_reference(tree, cfg, device)`` does the same for the
reference's ``TrainState(params, OptState(m, v, count), step)``: the
moments unstack like the parameters, count and step become int32
scalars.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..engine.plan import resolve_device
from ..optim import OptState, TrainState
from .config import ModelConfig
from .transformer import check_ported


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_reference(tree: dict[str, Any], cfg: ModelConfig,
                          device="cuda") -> dict[str, Any]:
    """The port's parameters from a reference tree of numpy arrays."""
    check_ported(cfg)
    dev = resolve_device(device)
    out = {k: _map(v, lambda a: _tensor(a, dev))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = [_map(tree["layers"], lambda a, i=i: _tensor(a[i], dev))
                     for i in range(cfg.n_layers)]
    return out


def train_state_from_reference(tree, cfg: ModelConfig, device="cuda"):
    """The port's ``optim.TrainState`` from the reference's, as numpy
    arrays (``jax.device_get`` of a ``repro.optim.TrainState``, or any
    ``(params, (m, v, count), step)`` of the same trees)."""
    params, (m, v, count), step = tree
    dev = resolve_device(device)
    return TrainState(
        params=params_from_reference(params, cfg, dev),
        opt_state=OptState(m=params_from_reference(m, cfg, dev),
                           v=params_from_reference(v, cfg, dev),
                           count=_tensor(count, dev)),
        step=_tensor(step, dev))


__all__ = ["params_from_reference", "train_state_from_reference"]
