"""The scans' backward on the CPU, against the JAX package.

Split from tests/test_torch_lm_training_ssm.py (the mamba1 and hybrid
families' training), whose tolerances it shares:

* the op ``selective_scan``'s autograd and the plain ``selective_scan_bwd``
  against ``jax.vjp(selective_scan_ref)`` with cotangents for both outputs
  (a nonzero one for ``h_final``), float32 at 1e-5 and bfloat16 x/B/C at
  2e-2 (gradients in bf16, as ``jax.vjp`` gives them);
* ``selective_scan_chunked`` against the JAX package's (outputs and vjp)
  at a ragged S;
* ``ssd_chunked``'s gradient finite, and equal to the step-by-step
  recurrence's in float64, where the reference's unmasked decay overflows
  (1e-3: the SSD runs in float32, and dt of up to ~100 scales the terms).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan,
    selective_scan_bwd,
    selective_scan_ref,
)
from repro_torch.models import ssm as TS  # noqa: E402
from test_torch_lm_training import TOL, close  # noqa: E402

BF16_TOL = 2e-2


def _scan_inputs(b, S, di, N, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    return [
        rng.normal(size=(b, S, di)).astype(f),
        (np.abs(rng.normal(size=(b, S, di))) * 0.1).astype(f),
        -(np.abs(rng.normal(size=(di, N))) + 0.5).astype(f),
        rng.normal(size=(b, S, N)).astype(f),
        rng.normal(size=(b, S, N)).astype(f),
        rng.normal(size=(di,)).astype(f),
    ], [rng.normal(size=(b, S, di)).astype(f), rng.normal(size=(b, di, N)).astype(f)]


def _cast(arrays, dtype):
    """x, B, C (and dy) in the model dtype; delta, A, D (and dh_final) float32."""
    low = {0, 3, 4}
    return [a.astype(dtype) if i in low else a for i, a in enumerate(arrays)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,di,N", [(2, 37, 48, 16), (1, 20, 32, 4)])
def test_selective_scan_autograd_matches_jax_vjp(b, S, di, N, dtype):
    inputs, (dy, dh) = _scan_inputs(b, S, di, N)
    jdtype = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jin = [jnp.asarray(a) for a in _cast(inputs, jdtype)]
    (jy, jh), vjp = jax.vjp(jax_ref, *jin)
    want = vjp((jnp.asarray(dy).astype(jdtype), jnp.asarray(dh)))

    tdtype = getattr(torch, dtype)
    tin = [torch.from_numpy(a) for a in inputs]
    tin = [t.to(tdtype) if i in (0, 3, 4) else t for i, t in enumerate(tin)]
    tdy, tdh = torch.from_numpy(dy).to(tdtype), torch.from_numpy(dh)
    tol = TOL if dtype == "float32" else BF16_TOL
    plain = selective_scan_bwd(*tin, tdy, tdh)
    leaves = [t.clone().requires_grad_() for t in tin]
    y, h = selective_scan(*leaves)
    close(y, jy, tol)
    close(h, jh, TOL)
    torch.autograd.backward((y, h), (tdy, tdh))
    for i, (got, grad, ref) in enumerate(zip(plain, (t.grad for t in leaves), want)):
        assert got.dtype == grad.dtype == leaves[i].dtype == tin[i].dtype
        close(got, ref, tol)
        close(grad, ref, tol)


@pytest.mark.parametrize("chunk", [8, 16])
def test_selective_scan_chunked_matches_jax(chunk):
    inputs, (dy, dh) = _scan_inputs(2, 37, 24, 8, seed=3)  # 37: a ragged last chunk
    jfn = jax.jit(JS.selective_scan_chunked, static_argnums=6)
    (jy, jh), vjp = jax.vjp(lambda *a: jfn(*a, chunk), *map(jnp.asarray, inputs))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    y, h = TS.selective_scan_chunked(*leaves, chunk)
    close(y, jy)
    close(h, jh)
    torch.autograd.backward((y, h), (torch.from_numpy(dy), torch.from_numpy(dh)))
    for t, ref in zip(leaves, want):
        close(t.grad, ref)
    # and the same function as the op's plain version
    y_ref, h_ref = selective_scan_ref(*(t.detach() for t in leaves))
    close(y, y_ref.numpy())
    close(h, h_ref.numpy())


def test_ssd_chunked_gradient_is_finite_where_the_reference_decay_overflows():
    """Large dt (as tests/test_torch_hybrid_serving.py's overflow case): the
    gradient of the port's SSD is finite and equals the step-by-step
    recurrence's."""
    rng = np.random.default_rng(1)
    b, S, h, p, n = 2, 48, 3, 4, 5
    x = rng.normal(size=(b, S, h, p)).astype(np.float32)
    dt = (40.0 * np.log1p(np.exp(rng.normal(size=(b, S, h))))).astype(np.float32)
    A = -np.exp(rng.uniform(-1.0, 0.5, size=(h,))).astype(np.float32)
    B, C = (rng.normal(size=(b, S, n)).astype(np.float32) for _ in range(2))
    D = rng.normal(size=(h,)).astype(np.float32)
    dy = rng.normal(size=(b, S, h, p)).astype(np.float32)

    def grads(fn):
        leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, dt, A, B, C, D)]
        y = fn(*leaves)
        y.backward(torch.from_numpy(dy).double())
        return [t.grad for t in leaves]

    def steps(x, dt, A, B, C, D):
        state, ys = torch.zeros(b, h, n, p, dtype=x.dtype), []
        for s in range(S):
            state = (torch.exp(dt[:, s, :, None, None] * A[:, None, None]) * state
                     + torch.einsum("bn,bhp->bhnp", B[:, s], x[:, s] * dt[:, s, :, None]))
            ys.append(torch.einsum("bn,bhnp->bhp", C[:, s], state) + D[:, None] * x[:, s])
        return torch.stack(ys, 1)

    got = grads(lambda *a: TS.ssd_chunked(*(t.float() for t in a), 16)[0].double())
    want = grads(steps)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3, rtol=1e-3)
