"""The port's flash-attention op on the CPU against the JAX package.

On the CPU the op takes its plain version (`attention_ref`); the CUDA
kernel is held against that version on the card (tests/test_torch_cuda.py
and chip_smoke.py).  Here, on tests/test_kernels.py's sweep (GQA, ragged
S, sliding window, head_dim 80, bfloat16), the op's forward matches the
JAX op in Pallas interpret mode and the JAX oracle at 2e-5 in float32 and
2e-2 in bfloat16 (docs/KERNELS.md's pins); its gradients, the vjp of the
plain version taken a block of query rows at a time, match `jax.vjp` of
the JAX op at 1e-4; and a non-causal call on a ragged S matches the JAX
oracle.  The check that holds the kernel against the plain version on the
card (`ref.kernel_errors`) passes the bf16 kernel's own roundings and
fails a kv tile left out or a causal limit one off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import ROW_TOL, kernel_errors  # noqa: E402

SWEEP = [  # tests/test_kernels.py:19-27
    (2, 4, 2, 256, 64, 0, "float32"),
    (1, 4, 4, 128, 32, 0, "float32"),
    (2, 8, 2, 200, 64, 0, "float32"),   # ragged S
    (1, 4, 1, 256, 64, 96, "float32"),  # sliding window
    (1, 2, 2, 128, 128, 0, "bfloat16"),
    (1, 6, 3, 160, 80, 64, "float32"),  # head_dim 80
]
GRAD_TOL = 1e-4


def _inputs(B, Hq, Hkv, S, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.normal(size=(B, H, S, hd)), dtype) for H in (Hq, Hkv, Hkv)]


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window,dtype", SWEEP)
def test_forward_matches_the_jax_op_and_oracle(B, Hq, Hkv, S, hd, window, dtype):
    q, k, v = _inputs(B, Hq, Hkv, S, hd, dtype)
    tq, tk, tv = params_from_jax([q, k, v])
    before = flash_attention.launches
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    assert flash_attention.launches == before  # the CPU path launches no kernel
    assert out.dtype == tq.dtype and out.shape == tq.shape
    want = jax_flash(q, k, v, causal=True, window=window, block_q=64, block_kv=64,
                     interpret=True)
    _close(out, want, _tol(dtype))
    _close(out, jax_ref(q, k, v, causal=True, window=window), _tol(dtype))


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,window,block", [
    (2, 8, 2, 200, 64, 0, 64),    # ragged S: the last row block is short
    (1, 4, 1, 256, 64, 96, 48),   # window: blocks start inside the key range
    (1, 6, 3, 160, 80, 64, 512),  # one block
])
def test_gradients_match_jax_vjp(B, Hq, Hkv, S, hd, window, block):
    q, k, v = _inputs(B, Hq, Hkv, S, hd, "float32", seed=1)
    g = jnp.asarray(np.random.default_rng(2).normal(size=q.shape), jnp.float32)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=True, window=window, interpret=True), q, k, v
    )
    want = vjp(g)
    leaves = [t.requires_grad_(True) for t in params_from_jax([q, k, v])]
    out = flash_attention(*leaves, causal=True, window=window, bwd_block=block)
    got = torch.autograd.grad(out, leaves, params_from_jax(g))
    for x, y in zip(got, want):
        _close(x, y, GRAD_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 50])
def test_non_causal_ragged_matches_the_oracle(dtype, window):
    """The JAX op pads S and leans on the causal mask; the port masks S itself."""
    q, k, v = _inputs(1, 4, 2, 200, 64, dtype, seed=3)
    out = flash_attention(*params_from_jax([q, k, v]), causal=False, window=window)
    _close(out, jax_ref(q, k, v, causal=False, window=window), _tol(dtype))
    if dtype == "float32":  # and the backward's key ranges without the causal cut
        g = jnp.asarray(np.random.default_rng(4).normal(size=q.shape), jnp.float32)
        _, vjp = jax.vjp(lambda q, k, v: jax_ref(q, k, v, causal=False, window=window),
                         q, k, v)
        leaves = [t.requires_grad_(True) for t in params_from_jax([q, k, v])]
        got = torch.autograd.grad(
            flash_attention(*leaves, causal=False, window=window, bwd_block=64),
            leaves, params_from_jax(g),
        )
        for x, y in zip(got, vjp(g)):
            _close(x, y, GRAD_TOL)


def test_bfloat16_gradients_keep_the_input_dtype():
    q, k, v = (t.requires_grad_(True)
               for t in params_from_jax(_inputs(1, 4, 2, 64, 32, "bfloat16")))
    out = flash_attention(q, k, v, bwd_block=16)
    grads = torch.autograd.grad(out.float().sum(), (q, k, v))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 3
    want = torch.autograd.grad(attention_ref(q, k, v).float().sum(), (q, k, v))
    for x, y in zip(grads, want):
        torch.testing.assert_close(x, y, atol=2e-2, rtol=2e-2)


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(1, 4, 8, 32)
    kv = torch.zeros(1, 2, 8, 32)
    with pytest.raises(TypeError):
        flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError):
        flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), kv, kv)
    with pytest.raises(ValueError):
        flash_attention(torch.zeros(1, 3, 8, 32), kv, kv)  # 3 heads over 2 kv heads
    with pytest.raises(ValueError):
        flash_attention(q, torch.zeros(1, 2, 9, 32), torch.zeros(1, 2, 9, 32))
    with pytest.raises(NotImplementedError):  # no kernel and no plain path there
        flash_attention(q.to("meta"), kv.to("meta"), kv.to("meta"))


def _bf16_kernel_arithmetic(q, k, v, keys):
    """The bf16 kernel's roundings in plain PyTorch: each softmax weight rounded
    to bf16 in P·V and in the normaliser, the output rounded to bf16.
    keys: (S, S) bool, the keys each query row reads."""
    n_rep = q.shape[1] // k.shape[1]
    kf, vf = (t.float().repeat_interleave(n_rep, dim=1) for t in (k, v))
    s = q.float() @ kf.transpose(-1, -2) / q.shape[-1] ** 0.5
    s = s.masked_fill(~keys, float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    return ((p @ vf) / p.sum(-1, keepdim=True)).to(torch.bfloat16)


@pytest.mark.parametrize("fault,agrees", [
    (None, True),
    ("kv tile before the diagonal left out", False),
    ("causal limit one past the diagonal", False),
])
def test_kernel_check_passes_bf16_rounding_and_fails_faults(fault, agrees):
    S, tile = 1024, 64
    q, k, v = params_from_jax(_inputs(1, 4, 2, S, 128, "bfloat16", seed=5))
    pos = torch.arange(S)
    keys = pos[None, :] <= pos[:, None]
    if fault == "kv tile before the diagonal left out":
        # in the rows past 512 only, where each row reads 8 tiles or more
        keys &= (pos[None, :] // tile != pos[:, None] // tile - 1) | (pos[:, None] < 512)
    elif fault == "causal limit one past the diagonal":
        keys = pos[None, :] <= pos[:, None] + 1
    elem, row, _ = kernel_errors(_bf16_kernel_arithmetic(q, k, v, keys), q, k, v)
    assert (elem <= 1 and row <= ROW_TOL) == agrees, (elem, row)
