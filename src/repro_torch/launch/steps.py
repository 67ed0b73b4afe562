"""Train-step factory for the LM (counterpart of the training half of
`repro.launch.steps`).

``make_train_step(cfg, lr) -> (opt, train_step)`` as in the reference
(``steps.py:61-66, 166-200``), with one difference of form: where the JAX
step is a pure function of a params pytree, ``train_step(model, opt_state,
batch)`` takes the `LM` module and writes the updated parameters into it
in place (``p + u`` in the param dtype, as `optim.apply_updates` does),
so no second copy of the weights is alive.  It returns ``(model,
opt_state, metrics)``; the optimizer state is the reference's ``chain``
tuple over the parameter tree of `LM.tree`.
"""
from __future__ import annotations

import torch

from repro_torch import optim
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map


def make_optimizer(cfg: ModelConfig, lr: float = 3e-4):
    """Global-norm clipping at 1.0, then AdamW with weight decay 0.1."""
    del cfg
    return optim.chain(
        optim.clip_by_global_norm(1.0),
        optim.adamw(lr, weight_decay=0.1),
    )


def _grads(model, batch):
    """(metrics, gradient tree) of `forward_train` on ``batch``."""
    loss, metrics = M.forward_train(model, batch)
    loss.backward()
    grads = model.tree(lambda p: p.grad)
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
        params = model.tree()
        updates, opt_state = opt.update(grads, opt_state, params)
        del grads
        with torch.no_grad():
            for p, u in zip(tree_leaves(params), tree_leaves(updates)):
                p.add_(u.to(p.dtype))
        return model, opt_state, metrics

    return opt, train_step
