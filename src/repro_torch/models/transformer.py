"""Model assembly: init / forward / loss / prefill / decode.

The partner of ``repro/models/transformer.py`` for the attention
family (``layer_kind == "attn"``: the dense gemma2-9b, qwen3-32b,
stablelm-12b and yi-34b, and the mixture-of-experts qwen2-moe-a2.7b and
mixtral-8x7b, whose FFN is ``models/moe.py``'s), the Mamba-1 family
(``layer_kind == "mamba1"``: falcon-mamba-7b) and the hybrid zamba2-1.2b
(``layer_kind == "mamba2"`` with ``shared_attn_every``: one attention
block, one set of weights, run after every ``shared_attn_every``-th
Mamba-2 layer, ``_layer_walk``).  An embedding-input configuration
(``input_mode == "embeddings"``: internvl2-2b, whose vision frontend is a
stub) takes (B, S, d) inputs in place of token ids in ``forward`` and
``prefill_forward``, and in ``decode_step`` whenever the step's input is
(B, 1, d) (``_embed_inputs``).

Parameters are nested dicts of tensors with the reference's keys, except
that ``params["layers"]`` is a Python list of per-layer dicts where the
reference stacks a leading L axis for ``lax.scan``: the scan becomes a
loop over that list (``models.convert.params_from_reference`` unstacks a
reference tree).  The serving cache keeps the reference's layout — k and
v are (L, B, Hkv, max_len, hd) tensors, or for mamba1 ``cache["mamba"] =
{"conv": (L, B, K-1, di), "ssm": (L, B, di, N) float32}`` and for mamba2
{"conv": (L, B, K-1, di+2n), "ssm": (L, B, nh, n, p) float32}, plus the
shared block's ``sa_k`` / ``sa_v`` (n_calls, B, Hkv, max_len, hd), one
cache a call of the shared block; and lengths (B,) int32 — and decode
writes each step's k and v, or each layer's new conv and SSM state, into
it in place (JAX's functional update becomes an in-place write on one
device).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from ..engine.plan import not_ported, resolve_device
from .attention import attn_decode, attn_forward, attn_init, window_schedule
from .config import ModelConfig
from .layers import (Params, embed, embed_init, glu_mlp, glu_mlp_init,
                     layernorm, rmsnorm, unembed)
from .mamba import (mamba1_decode, mamba1_forward, mamba1_init,
                    mamba1_init_cache, mamba2_decode, mamba2_forward,
                    mamba2_init, mamba2_init_cache)
from .moe import moe_forward, moe_init


def check_ported(cfg: ModelConfig, *, train_on=None) -> None:
    """Raise ``NotImplementedError`` for a family the port does not run —
    or, given ``train_on`` (the device a training step runs on), does
    not train there: the Mamba families train on the CPU (the plain scan
    and the SSD's tensor operations are differentiable) but not on the
    card (``scan_fwd`` has no gradient; Mamba-2 training there waits for
    the same item).  The shared attention block runs between Mamba
    layers only, as in the reference's prefill and decode."""
    if cfg.layer_kind not in ("attn", "mamba1", "mamba2"):
        raise ValueError(cfg.layer_kind)
    if cfg.shared_attn_every > 0 and cfg.layer_kind == "attn":
        raise ValueError(f"{cfg.name}: a shared attention block runs "
                         f"between Mamba layers, not attention layers")
    if cfg.layer_kind != "attn" and train_on is not None and \
            torch.device(train_on).type == "cuda":
        raise not_ported(f"{cfg.name}: {cfg.layer_kind} training on the "
                         f"card (the scan kernel has no gradient)",
                         "Queue A #13f")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _norm_init(cfg: ModelConfig, device) -> Params:
    dt = cfg.param_dtype_
    if cfg.norm == "layernorm":
        return {"w": torch.ones((cfg.d_model,), dtype=dt, device=device),
                "b": torch.zeros((cfg.d_model,), dtype=dt, device=device)}
    base = torch.zeros if cfg.norm_offset else torch.ones
    return {"w": base((cfg.d_model,), dtype=dt, device=device)}


def _apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm(p["w"], p["b"], x, cfg.norm_eps)
    return rmsnorm(p["w"], x, cfg.norm_eps, cfg.norm_offset)


def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Params:
    if cfg.layer_kind != "attn":
        init = mamba1_init if cfg.layer_kind == "mamba1" else mamba2_init
        return {"norm1": _norm_init(cfg, gen.device), "mixer": init(gen, cfg)}
    p: Params = {"norm1": _norm_init(cfg, gen.device),
                 "attn": attn_init(gen, cfg),
                 "norm2": _norm_init(cfg, gen.device),
                 "ffn": moe_init(gen, cfg) if cfg.is_moe else
                 glu_mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.param_dtype_)}
    if cfg.post_block_norm:
        p["post_norm1"] = _norm_init(cfg, gen.device)
        p["post_norm2"] = _norm_init(cfg, gen.device)
    return p


def init_params(seed: int, cfg: ModelConfig, *, device="cuda") -> Params:
    """Random parameters for ``cfg`` on ``device`` (default the card; on
    a host without CUDA, ask for ``device="cpu"``), drawn from a
    ``torch.Generator`` on that device seeded with ``seed``."""
    check_ported(cfg)
    gen = torch.Generator(device=resolve_device(device)).manual_seed(seed)
    p: Params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype_),
        "final_norm": _norm_init(cfg, gen.device),
        "layers": [_layer_init(gen, cfg) for _ in range(cfg.n_layers)],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model,
                                  cfg.param_dtype_).T.contiguous()
    if _shared_attn_positions(cfg):
        sa_cfg = _shared_cfg(cfg)
        p["shared_attn"] = {
            "norm1": _norm_init(cfg, gen.device),
            "attn": attn_init(gen, sa_cfg),
            "norm2": _norm_init(cfg, gen.device),
            "ffn": glu_mlp_init(gen, cfg.d_model, cfg.d_ff,
                                cfg.param_dtype_)}
    return p


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ffn_half(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """The block's second half: (x + FFN(norm(x)), the layer's aux loss —
    0.0 for a dense FFN)."""
    h = _apply_norm(lp["norm2"], x, cfg)
    aux = 0.0
    if cfg.is_moe:
        f, aux = moe_forward(lp["ffn"], h, cfg)
    else:
        f = glu_mlp(lp["ffn"], h, cfg.activation, cfg.compute_dtype_)
    if cfg.post_block_norm:
        f = _apply_norm(lp["post_norm2"], f, cfg)
    return x + f, aux


def _attn_block(lp: Params, x: torch.Tensor, cfg: ModelConfig, *,
                window: int):
    """Pre-norm attention and FFN with gemma2's sandwich norms: (x, the
    layer's aux loss, (k, v))."""
    h = _apply_norm(lp["norm1"], x, cfg)
    a, kv = attn_forward(lp["attn"], h, cfg, window=window, return_kv=True)
    if cfg.post_block_norm:
        a = _apply_norm(lp["post_norm1"], a, cfg)
    x, aux = _ffn_half(lp, x + a, cfg)
    return x, aux, kv


def _mamba_block(lp: Params, x: torch.Tensor, cfg: ModelConfig):
    """Pre-norm Mamba-1 or Mamba-2 mixer with a residual, and the mixer's
    state after the sequence."""
    h = _apply_norm(lp["norm1"], x, cfg)
    if cfg.layer_kind == "mamba1":
        y, state = mamba1_forward(lp["mixer"], h, cfg)
    else:
        y, state = mamba2_forward(lp["mixer"], h, cfg, return_state=True)
    return x + y, state


def _shared_attn_positions(cfg: ModelConfig) -> list[int]:
    """zamba2: the layers after which the shared attention block runs."""
    if cfg.shared_attn_every <= 0:
        return []
    return list(range(cfg.shared_attn_every - 1, cfg.n_layers,
                      cfg.shared_attn_every))


def _layer_walk(cfg: ModelConfig) -> list[tuple[int, int | None]]:
    """Each layer's index and the call of the shared attention block that
    follows it — its index into ``sa_k`` / ``sa_v`` — or None.  One walk
    for ``forward``, ``prefill_forward`` and ``decode_step``: the
    reference writes it three times, as segments between the calls (its
    tests ``hi - 1 in sa_pos`` and ``si < len(sa_pos)`` agree)."""
    calls = {layer: si for si, layer in
             enumerate(_shared_attn_positions(cfg))}
    return [(i, calls.get(i)) for i in range(cfg.n_layers)]


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared block's configuration: a dense attention layer of the
    model's widths."""
    return cfg.replace(layer_kind="attn", n_experts=0)


def _embed_inputs(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
                  *, decode: bool = False):
    """The first layer's input in the compute dtype.  An embeddings
    configuration's (B, S, d) inputs are cast, with no embed scale; in a
    decode step only a (B, 1, d) input is taken as embeddings, and (B, 1)
    ids go through ``params["embed"]`` as for a token model (the
    reference's two rules)."""
    if cfg.input_mode == "embeddings" and (not decode or inputs.dim() == 3):
        return inputs.to(cfg.compute_dtype_)
    scale = cfg.d_model ** 0.5 if cfg.embed_scale else None
    return embed(params["embed"], inputs, scale, cfg.compute_dtype_)


def _logits(params: Params, x: torch.Tensor, cfg: ModelConfig):
    x = _apply_norm(params["final_norm"], x, cfg)
    table = params["embed"] if cfg.tie_embeddings else params["lm_head"]
    return unembed(table, x, tied=cfg.tie_embeddings,
                   softcap=cfg.final_softcap)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------

def _train_layer(lp: Params, x: torch.Tensor, cfg: ModelConfig,
                 window: int):
    """One layer of the full-sequence forward: (x, the layer's aux
    loss)."""
    if cfg.layer_kind != "attn":
        return _mamba_block(lp, x, cfg)[0], 0.0
    x, aux, _ = _attn_block(lp, x, cfg, window=window)
    return x, aux


def forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig):
    """inputs: (B, S) token ids, or (B, S, d) embeddings for an
    embeddings configuration.  Returns (logits (B, S, vocab) float32,
    aux loss) — the MoE layers' router losses summed over layers, as the
    reference's scan carries them; 0 for the dense and Mamba-1 families.

    Under autograd with ``cfg.remat``, each layer runs inside
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` of its
    layer function): its activations are recomputed in the backward, so
    on the card each attention layer launches the forward kernel twice a
    step.  zamba2's shared block runs outside the checkpoints, as in the
    reference."""
    check_ported(cfg)
    x = _embed_inputs(params, inputs, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    windows = window_schedule(cfg) if cfg.layer_kind == "attn" \
        else [0] * cfg.n_layers
    remat = cfg.remat and torch.is_grad_enabled()
    for (i, si), w in zip(_layer_walk(cfg), windows):
        lp = params["layers"][i]
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                _train_layer, lp, x, cfg, w, use_reentrant=False)
        else:
            x, a = _train_layer(lp, x, cfg, w)
        aux = aux + a
        if si is not None:
            x = _attn_block(params["shared_attn"], x, _shared_cfg(cfg),
                            window=0)[0]
    return _logits(params, x, cfg), aux


def loss_fn(params: Params, batch: dict[str, torch.Tensor],
            cfg: ModelConfig):
    """batch: {"inputs": (B, S) ids or (B, S, d) embeddings, "labels":
    (B, S)}; labels < 0 are ignored.  Returns (loss, metrics)."""
    logits, aux = forward(params, batch["inputs"], cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
    ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux, "tokens": mask.sum()}


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device="cuda") -> dict[str, Any]:
    """Serving state: zeroed k and v caches (L, B, Hkv, max_len, hd) in
    the compute dtype — or for the Mamba families the zeroed per-layer
    states ``cache["mamba"]`` = {conv (L, B, K-1, di), ssm (L, B, di, N)}
    (mamba1) or {conv (L, B, K-1, di+2n), ssm (L, B, nh, n, p)} (mamba2),
    ssm in float32, which do not grow with ``max_len``, and for zamba2's
    shared block ``sa_k`` / ``sa_v`` (n_calls, B, Hkv, max_len, hd) — and
    lengths (B,) int32, on ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    cache: dict[str, Any] = {"lengths": torch.zeros((batch,),
                                                    dtype=torch.int32,
                                                    device=dev)}
    if cfg.layer_kind == "attn":
        names, n = ("k", "v"), cfg.n_layers
    else:
        init = mamba1_init_cache if cfg.layer_kind == "mamba1" \
            else mamba2_init_cache
        cache["mamba"] = {name: torch.zeros((cfg.n_layers,) + t.shape,
                                            dtype=t.dtype, device=dev)
                          for name, t in init(cfg, batch,
                                              device=dev).items()}
        names, n = ("sa_k", "sa_v"), len(_shared_attn_positions(cfg))
    if n:
        shape = (n, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        for name in names:
            cache[name] = torch.zeros(shape, dtype=cfg.compute_dtype_,
                                      device=dev)
    return cache


def decode_step(params: Params, cache: dict[str, Any], token: torch.Tensor,
                cfg: ModelConfig):
    """One serving step: token (B, 1) ids — or, for an embeddings
    configuration, (B, 1, d) embeddings — → (logits (B, vocab) float32,
    cache).  The returned cache holds the same
    k and v tensors, written in place at each row's length (for the Mamba
    families the same conv and ssm tensors, each layer's new state written
    in place, and zamba2's ``sa_k`` / ``sa_v``, each call of the shared
    block writing its own at each row's length), and lengths + 1."""
    check_ported(cfg)
    x = _embed_inputs(params, token, cfg, decode=True)
    lengths = cache["lengths"]
    if cfg.layer_kind != "attn":
        decode = mamba1_decode if cfg.layer_kind == "mamba1" \
            else mamba2_decode
        states = cache["mamba"]
        for i, si in _layer_walk(cfg):
            lp = params["layers"][i]
            h = _apply_norm(lp["norm1"], x, cfg)
            y, new = decode(lp["mixer"], h, {
                name: t[i] for name, t in states.items()}, cfg)
            for name, t in new.items():
                states[name][i] = t
            x = x + y
            if si is not None:
                x = _shared_decode(params["shared_attn"], x, cache, si,
                                   cfg)
    else:
        for i, (lp, w) in enumerate(zip(params["layers"],
                                        window_schedule(cfg))):
            h = _apply_norm(lp["norm1"], x, cfg)
            a, _, _ = attn_decode(lp["attn"], h, cfg, window=w,
                                  k_cache=cache["k"][i],
                                  v_cache=cache["v"][i], lengths=lengths)
            if cfg.post_block_norm:
                a = _apply_norm(lp["post_norm1"], a, cfg)
            x, _ = _ffn_half(lp, x + a, cfg)
    logits = _logits(params, x[:, 0], cfg)
    return logits, dict(cache, lengths=lengths + 1)


def _shared_decode(sp: Params, x: torch.Tensor, cache: dict[str, Any],
                   si: int, cfg: ModelConfig) -> torch.Tensor:
    """Call ``si`` of the shared block on one token: the shared weights,
    call ``si``'s own k and v caches (written in place at each row's
    length)."""
    sa_cfg = _shared_cfg(cfg)
    h = _apply_norm(sp["norm1"], x, sa_cfg)
    a, _, _ = attn_decode(sp["attn"], h, sa_cfg, window=0,
                          k_cache=cache["sa_k"][si],
                          v_cache=cache["sa_v"][si],
                          lengths=cache["lengths"])
    return _ffn_half(sp, x + a, sa_cfg)[0]


def prefill_forward(params: Params, inputs: torch.Tensor, cfg: ModelConfig,
                    max_len: int):
    """One forward pass over the prompt that also fills the serving cache.

    inputs: (B, S) tokens, or (B, S, d) embeddings for an embeddings
    configuration.  Returns (last_logits
    (B, vocab), cache) with caches of ``max_len`` positions, the prompt's
    k and v in the first S (for the Mamba families each layer's conv and
    SSM state after the prompt, and each shared-block call's k and v in
    the first S of its ``sa_k`` / ``sa_v``)."""
    check_ported(cfg)
    b, s = inputs.shape[0], inputs.shape[1]
    x = _embed_inputs(params, inputs, cfg)
    cache = init_cache(cfg, b, max_len, device=x.device)
    if cfg.layer_kind != "attn":
        for i, si in _layer_walk(cfg):
            x, state = _mamba_block(params["layers"][i], x, cfg)
            for name, t in state.items():
                cache["mamba"][name][i] = t
            if si is not None:
                x, _, (k, v) = _attn_block(params["shared_attn"], x,
                                           _shared_cfg(cfg), window=0)
                cache["sa_k"][si, :, :, :s] = k
                cache["sa_v"][si, :, :, :s] = v
    else:
        for i, (lp, w) in enumerate(zip(params["layers"],
                                        window_schedule(cfg))):
            x, _, (k, v) = _attn_block(lp, x, cfg, window=w)
            cache["k"][i, :, :, :s] = k
            cache["v"][i, :, :, :s] = v
    cache["lengths"].fill_(s)
    return _logits(params, x[:, -1], cfg), cache


def prefill(params: Params, cache: dict[str, Any], tokens: torch.Tensor,
            cfg: ModelConfig):
    """Fill the cache by running ``decode_step`` over the prompt, one
    token at a time.  tokens: (B, S).  Returns (last_logits, cache)."""
    logits = None
    for t in range(tokens.shape[1]):
        logits, cache = decode_step(params, cache, tokens[:, t:t + 1], cfg)
    return logits, cache


__all__ = ["check_ported", "decode_step", "forward", "init_cache",
           "init_params", "loss_fn", "prefill", "prefill_forward"]
