"""Faults planted in the program underneath a run, for the controls and the tests.

Each is a context manager that patches one of the program's functions for
as long as it is open, so that the rest of a run (the driver, the window,
the reference and the comparison) goes on as it would and must come out
not correct.  No benchmark run opens one.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def patched(module, name: str, make):
    """``module.name`` replaced by ``make(original)`` while the context is open."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


# ------------------------------------------------------------ LM training


def lm_train_unchanged():
    """The optimizer step returns its state and leaves every parameter as it was."""
    from repro_torch import optim

    return patched(optim, "clip_adamw_in_place",
                   lambda orig: lambda params, grads, state, *a, **k: state)


def lm_train_half_batch():
    """Each step's gradients from the first half of the batch's rows, the mean over them."""
    from repro_torch.launch import steps

    return patched(steps, "_grads", lambda orig: lambda model, batch: orig(
        model, {k: v[: v.shape[0] // 2] for k, v in batch.items()}))


# ---------------------------------------------------------------- prefill


def prefill_token():
    """Each served first token is the next id after the greedy one."""
    from repro_torch.models import model as M

    def make(orig):
        def prefill(model, tokens, *a, **k):
            logits, cache = orig(model, tokens, *a, **k)
            return logits.roll(1, dims=-1), cache
        return prefill

    return patched(M, "prefill", make)


def prefill_unchanged():
    """The conv and SSM states come back as the empty cache had them."""
    from repro_torch.models import model as M

    def make(orig):
        def prefill(model, tokens, *a, **k):
            logits, cache = orig(model, tokens, *a, **k)
            return logits, dict(cache, conv=cache["conv"].zero_(), ssm=cache["ssm"].zero_())
        return prefill

    return patched(M, "prefill", make)


def prefill_half_batch():
    """Only the first half of a batch's prompts is prefilled; request i gets the answers of
    prompt i // 2."""
    import torch

    from repro_torch.models import model as M

    def make(orig):
        def prefill(model, tokens, *a, **k):
            B = tokens.shape[0]
            logits, cache = orig(model, tokens[: (B + 1) // 2], *a, **k)
            rows = torch.arange(B, device=tokens.device) // 2
            both = lambda x, dim: x.index_select(dim, rows)  # noqa: E731
            return both(logits, 0), dict(cache, conv=both(cache["conv"], 1),
                                         ssm=both(cache["ssm"], 1), pos=both(cache["pos"], 0))
        return prefill

    return patched(M, "prefill", make)


# ------------------------------------------------------------------ PPO


def ppo_unchanged():
    """Every optimizer step returns the parameters and state it was given."""
    from repro_torch.systems import onpolicy

    return patched(onpolicy, "_apply", lambda orig: lambda opt, grads, opt_state, params, n:
                   (params, opt_state))


def ppo_half_batch():
    """Each minibatch's loss over the first half of its rows, the mean over them."""
    from repro_torch.systems import onpolicy

    return patched(onpolicy, "_pick", lambda orig: lambda x, idx, axis, lane=None: orig(
        x, idx[..., : idx.shape[-1] // 2], axis, lane))


def ppo_token():
    """Each sampled action is replaced, where it is drawn, by the next one."""
    from repro_torch.systems import onpolicy

    return patched(onpolicy, "_sample", lambda orig: lambda logits, generator: (
        orig(logits, generator) + 1) % logits.shape[-1])


FAULTS = {
    "lm_train": {"unchanged": lm_train_unchanged, "half_batch": lm_train_half_batch},
    "lm_prefill": {"token": prefill_token, "unchanged": prefill_unchanged,
                   "half_batch": prefill_half_batch},
    "anakin": {"unchanged": ppo_unchanged, "half_batch": ppo_half_batch, "token": ppo_token},
}
