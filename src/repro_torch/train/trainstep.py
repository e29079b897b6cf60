"""The causal-LM loss and the train step; port of
``repro/train/trainstep.py``.

Training runs the dense (unquantized) model: configs trained here carry
``quant.mode == "none"``, and the GPTQ int4 plan is made from the
trained weights afterwards.  So the step reaches none of the port's
CUDA kernels: the MLPs are plain products, attention takes the einsum
path.

The step is eager autograd: ``loss.backward()`` where the reference
takes ``jax.value_and_grad``, then ``optimizer.apply_updates`` in place.
The params are the state's own leaf tensors (``requires_grad``), and
their ``.grad`` is set to None once the update has read it, so one
gradient tree is alive at a time, only between the backward and the
update.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.policy import DEFAULT_POLICY
from repro_torch.device import DeviceLike
from repro_torch.models.registry import Model
from repro_torch.train import optimizer as opt
from repro_torch.train.checkpoint import flatten_keys, map_tensors


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_index: int = -1) -> torch.Tensor:
    """Mean token cross-entropy.  logits: (B, S, V), labels: (B, S); a
    label equal to ``ignore_index`` counts for nothing."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        labels.clamp(min=0).long()[..., None])[..., 0]
    nll = logz - gold
    mask = (labels != ignore_index).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(model: Model, params, batch: dict) -> torch.Tensor:
    """Next-token loss of ``batch`` (``"tokens"``, ``"labels"``, and the
    audio and vision families' ``"frames"`` / ``"patches"``); the last
    position is left out, as the reference leaves it out."""
    logits = model.forward(params, batch, DEFAULT_POLICY)
    return cross_entropy(logits[:, :-1], batch["labels"][:, :-1])


def make_train_step(model: Model, ocfg: opt.AdamWConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``state = {"params", "opt"}`` (``init_train_state``), updated in
    place.  ``metrics``: ``loss`` (before the update), ``grad_norm`` (of
    the unclipped gradients), ``lr`` and ``step`` (after it), as 0-dim
    tensors on the params' device."""

    def train_step(state: dict, batch: dict):
        params = state["params"]
        loss = loss_fn(model, params, batch)
        loss.backward()
        grads = map_tensors(params, lambda _, p: p.grad)
        _, _, gn = opt.apply_updates(ocfg, params, grads, state["opt"])
        del grads
        for p in flatten_keys(params).values():
            p.grad = None
        step = state["opt"]["step"]
        metrics = {"loss": loss.detach(), "grad_norm": gn,
                   "lr": opt.cosine_lr(ocfg, step), "step": step}
        return state, metrics

    return train_step


def trainable(params: Any) -> Any:
    """``params`` with every floating leaf a leaf tensor that requires a
    gradient (in place)."""
    for p in flatten_keys(params).values():
        if p.is_floating_point():
            p.requires_grad_(True)
    return params


def init_train_state(model: Model, seed: int = 0, *,
                     device: DeviceLike = None) -> dict:
    """The dense model's params from ``seed`` (``Model.init``; the card
    unless ``device`` says otherwise) and a zero optimizer state."""
    if model.cfg.quant.mode != "none":
        raise ValueError(f"training runs the dense model: "
                         f"quant.mode is {model.cfg.quant.mode!r}, expected "
                         f"'none' (cfg.with_quant(mode='none'))")
    params = trainable(model.init(seed, device=device))
    return {"params": params, "opt": opt.init_state(params)}


def train_state_specs(model: Model, params, tp: int) -> dict:
    """TP specs of the train state: the params' and the optimizer's."""
    pspecs = model.param_specs(params, tp)
    return {"params": pspecs, "opt": opt.state_specs(pspecs)}
