"""Train-step factory for the LM (counterpart of the training half of
`repro.launch.steps`).

``make_train_step(cfg, lr) -> (opt, train_step)`` as in the reference
(``steps.py:61-66, 166-200``), with one difference of form: where the JAX
step is a pure function of a params pytree (which the reference's launcher
jits with the params and optimizer state donated), ``train_step(model,
opt_state, batch)`` takes the `LM` module and writes the updated
parameters into it, and the new Adam moments into ``opt_state``'s
tensors, in place and a leaf at a time (`optim.clip_adamw_in_place`: the
values of the chain's update and `optim.apply_updates`), so no second copy
of the weights or the moments is alive.  It returns ``(model, opt_state,
metrics)``; the optimizer state is the reference's ``chain`` tuple over the
parameter tree of `LM.tree`.  It trains every family the port runs: the
batch is `model.forward_train`'s (a vlm batch's ``vision_embeds`` split
into microbatches like the tokens), and the metrics are
`forward_train`'s (an MoE model's ``router_aux`` and ``router_z``
averaged over microbatches like the rest).
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_map


MAX_GRAD_NORM, WEIGHT_DECAY = 1.0, 0.1


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4):
    """Global-norm clipping at 1.0, then AdamW with weight decay 0.1."""
    del cfg
    return optim.chain(
        optim.clip_by_global_norm(MAX_GRAD_NORM),
        optim.adamw(lr, weight_decay=WEIGHT_DECAY),
    )


def _grad(p):
    # a parameter the loss does not reach has a zero gradient, as in JAX
    return torch.zeros_like(p) if p.grad is None else p.grad


def _grads(model, batch):
    """(metrics, gradient tree) of `forward_train` on ``batch``."""
    loss, metrics = M.forward_train(model, batch)
    loss.backward()
    grads = model.tree(_grad)
    for p in model.parameters():
        p.grad = None
    return {k: v.detach() for k, v in metrics.items()}, grads


def make_train_step(cfg: ModelConfig, lr: float = 3e-4):
    """The optimizer and one step of training; see the module docstring.

    With ``cfg.grad_accum = k > 1`` the batch is split into k microbatches
    along its leading dim; their gradients are summed in float32, each
    divided by k, and the metrics are averaged.
    """
    opt = make_optimizer(cfg, lr)
    k = max(cfg.grad_accum, 1)

    def train_step(model, opt_state, batch):
        if k == 1:
            metrics, grads = _grads(model, batch)
        else:
            micro = {name: x.reshape((k, x.shape[0] // k) + x.shape[1:])
                     for name, x in batch.items()}
            grads, per_micro = None, []
            for i in range(k):
                m, g = _grads(model, {name: x[i] for name, x in micro.items()})
                g = tree_map(lambda x: x.float() / k, g)
                grads = g if grads is None else tree_map(torch.add, grads, g)
                per_micro.append(m)
            metrics = {name: torch.stack([m[name] for m in per_micro]).mean()
                       for name in per_micro[0]}
        opt_state = optim.clip_adamw_in_place(model.tree(), grads, opt_state, MAX_GRAD_NORM,
                                              lr, weight_decay=WEIGHT_DECAY)
        return model, opt_state, metrics

    return opt, train_step
