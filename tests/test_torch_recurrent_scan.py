"""The port's recurrent-scan op against the JAX package, on the CPU.

The port's `linear_recurrent_scan` (plain path on CPU tensors) is held
against `repro`'s Pallas kernel run in interpret mode and against its
sequential oracle, forward at 1e-5 and gradients da/db/dh0 at 1e-4 (the
tolerances of docs/KERNELS.md), over the shapes and reset patterns of
tests/test_recurrent_scan.py.  The CUDA kernel itself is compared with its
plain version by tests/test_torch_cuda.py (on a GPU) and by chip_smoke.py.
`chunked_scan_ref`, the kernel's chunked algebra in PyTorch, is held
against the JAX oracle (forward) and `scan_ref` (both directions) across
ragged T and resets on a chunk's first and last step.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.recurrent_scan.ops import linear_recurrent_scan as jax_scan  # noqa: E402
from repro.kernels.recurrent_scan.ref import linear_recurrence_ref as jax_ref  # noqa: E402
from repro_torch.kernels.recurrent_scan import (  # noqa: E402
    chunked_scan_ref,
    linear_recurrence_ref,
    linear_recurrent_scan,
    scan_ref,
)
from repro_torch.kernels.recurrent_scan.ops import KERNEL_CHUNK  # noqa: E402

FWD_TOL = 1e-5
GRAD_TOL = 1e-4
SHAPES = [
    (7, (3,), 5),      # odd T, odd D
    (33, (2, 4), 16),  # two batch dims, odd T
    (128, (4,), 32),   # T a chunk multiple
    (1, (2,), 8),      # single step
]
PATTERNS = ["none", "all", "mid_window", "random"]


def _inputs(T, batch, D, pattern, seed=0):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(T, *batch, D))))).astype(np.float32)
    b = (rng.normal(size=(T, *batch, D)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(*batch, D)).astype(np.float32)
    reset = {
        "none": None,
        "all": np.ones((T, *batch), bool),
        "mid_window": np.zeros((T, *batch), bool),
        "random": rng.random(size=(T, *batch)) < 0.3,
    }[pattern]
    if pattern == "mid_window":
        reset[T // 2] = True
    return a, b, h0, reset


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("T,batch,D", SHAPES)
def test_forward_matches_jax(T, batch, D, pattern):
    a, b, h0, reset = _inputs(T, batch, D, pattern)
    out = linear_recurrent_scan(_t(a), _t(b), _t(h0), _t(reset)).numpy()
    ref = np.asarray(jax_ref(_j(a), _j(b), _j(h0), _j(reset)))
    np.testing.assert_allclose(out, ref, atol=FWD_TOL, rtol=FWD_TOL)
    if pattern == "random":  # the Pallas kernel, interpreted
        pallas = jax_scan(_j(a), _j(b), _j(h0), _j(reset), interpret=True)
        np.testing.assert_allclose(out, np.asarray(pallas), atol=FWD_TOL, rtol=FWD_TOL)


@pytest.mark.parametrize("pattern", PATTERNS)
@pytest.mark.parametrize("T,batch,D", [(17, (3,), 8), (33, (2, 4), 16)])
def test_gradients_match_jax(T, batch, D, pattern):
    a, b, h0, reset = _inputs(T, batch, D, pattern, seed=2)
    g = np.random.default_rng(3).normal(size=a.shape).astype(np.float32)

    def loss_jax(a, b, h0):
        return jnp.sum(jax_ref(a, b, h0, _j(reset)) * g)

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(_j(a), _j(b), _j(h0))
    at, bt, ht = (_t(x).requires_grad_(True) for x in (a, b, h0))
    (linear_recurrent_scan(at, bt, ht, _t(reset)) * _t(g)).sum().backward()
    for name, x, y in zip(("da", "db", "dh0"), (at, bt, ht), want):
        np.testing.assert_allclose(
            x.grad.numpy(), np.asarray(y), atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=name
        )


def test_port_oracle_matches_jax_oracle():
    a, b, h0, reset = _inputs(33, (2, 4), 16, "random", seed=4)
    out = linear_recurrence_ref(_t(a), _t(b), _t(h0), _t(reset)).numpy()
    ref = np.asarray(jax_ref(_j(a), _j(b), _j(h0), _j(reset)))
    np.testing.assert_allclose(out, ref, atol=FWD_TOL, rtol=FWD_TOL)


def test_reverse_scan_is_the_flipped_shifted_forward():
    """The adjoint direction equals ops.py:112-119's flipped forward scan."""
    a, b, _, reset = _inputs(9, (3,), 4, "random", seed=5)
    a2, b2 = _t(a).reshape(9, 12), _t(b).reshape(9, 12)
    r2 = _t(reset)
    out = scan_ref(a2, b2, r2, None, reverse=True)
    a_eff = a2 * (1 - r2.float().repeat_interleave(4, dim=1))
    a_shift = torch.cat([a_eff[1:], torch.zeros_like(a_eff[:1])])
    want = scan_ref(a_shift.flip(0), b2.flip(0), None, torch.zeros(12)).flip(0)
    torch.testing.assert_close(out, want, atol=FWD_TOL, rtol=FWD_TOL)


def test_rejects_bad_operands():
    a, b, h0, reset = (_t(x) for x in _inputs(4, (2,), 3, "random"))
    with pytest.raises(TypeError):
        linear_recurrent_scan(a.double(), b.double(), h0.double(), reset)
    with pytest.raises(ValueError):
        linear_recurrent_scan(a.transpose(1, 2), b.transpose(1, 2), h0.T.contiguous(), reset)
    with pytest.raises(ValueError):
        linear_recurrent_scan(a, b, h0[:1], reset)
    with pytest.raises(TypeError):
        linear_recurrent_scan(a, b, h0, reset.float())



@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("pattern", PATTERNS + ["chunk_first", "chunk_last"])
@pytest.mark.parametrize("T", [1, 15, 16, 17, 129])
def test_chunked_scan_matches_the_sequential_scan(T, pattern, reverse):
    """The kernel's algebra, at 1e-5: its products are taken in another order.

    D = 35 is B = 5 batch lanes of H = 7 features; T runs around the
    kernel's 16-step chunk, and the resets fall on the first or the last
    step of every chunk (where the adjoint's shifted decay crosses chunks).
    """
    base = "none" if pattern.startswith("chunk") else pattern
    a, b, h0, reset = _inputs(T, (5,), 7, base, seed=6)
    if pattern.startswith("chunk"):
        step = 0 if pattern == "chunk_first" else KERNEL_CHUNK - 1
        reset = np.broadcast_to((np.arange(T) % KERNEL_CHUNK == step)[:, None], (T, 5)).copy()
    a2, b2, r2 = _t(a).reshape(T, 35), _t(b).reshape(T, 35), _t(reset)
    h = None if reverse else _t(h0).reshape(35)
    got = chunked_scan_ref(a2, b2, r2, h, KERNEL_CHUNK, reverse=reverse)
    torch.testing.assert_close(got, scan_ref(a2, b2, r2, h, reverse=reverse),
                               atol=FWD_TOL, rtol=FWD_TOL)
    if not reverse:
        want = np.asarray(jax_ref(_j(a), _j(b), _j(h0), _j(reset))).reshape(T, 35)
        np.testing.assert_allclose(got.numpy(), want, atol=FWD_TOL, rtol=FWD_TOL)
