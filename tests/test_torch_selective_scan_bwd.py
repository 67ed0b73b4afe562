"""The backward selective-scan kernel's algebra, on the CPU.

``selective_scan_bwd_blocked`` writes out step by step what
``csrc/selective_scan_bwd.cu`` computes: the state stored every ``CHUNK``
steps, each chunk rebuilt with a_t kept, g carried back through it, and
dB/dC summed over d in the kernel's fixed order over blocks of
``lanes(N)`` lanes.  It is held against ``jax.vjp(selective_scan_ref)``
with cotangents for both outputs (a nonzero one for ``h_final``) at S
around a chunk, di not a multiple of a block's lanes and every N the kernel
takes, float32 at 1e-5 (the same sums in another order).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan_bwd_blocked  # noqa: E402

TOL = 1e-5
# csrc/selective_scan_bwd.cu's kChunk (steps between stored states) and lanes_for(N)
# (kThreads = 128 threads a block, kStates = 4 states a thread)
CHUNK = 16


def lanes(N):
    return 128 * 4 // N


def _scan_inputs(b, S, di, N, seed):
    """Operands drawn like prefill's (delta > 0, A < 0), and the two cotangents."""
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


@jax.jit
def _jax_vjp(primals, cotangents):
    return jax.vjp(jax_ref, *primals)[1](cotangents)


def _embedded_jax_vjp(inputs, dy, dh, S_to=37, di_to=200, N_to=16):
    """``jax.vjp(selective_scan_ref)`` with the problem embedded in (b, S_to, di_to,
    N_to) by zero steps after S, zero lanes and zero states, which leave its
    outputs and gradients as they are: every case reuses one compiled scan."""
    x, delta, A, B, C, D = inputs
    b, S, di = x.shape
    N = A.shape[1]
    lane, step = ((0, 0), (0, S_to - S), (0, di_to - di)), ((0, 0), (0, S_to - S), (0, N_to - N))
    big = [np.pad(x, lane), np.pad(delta, lane), np.pad(A, ((0, di_to - di), (0, N_to - N))),
           np.pad(B, step), np.pad(C, step), np.pad(D, (0, di_to - di))]
    grads = _jax_vjp(tuple(map(jnp.asarray, big)),
                     (jnp.asarray(np.pad(dy, lane)),
                      jnp.asarray(np.pad(dh, ((0, 0), (0, di_to - di), (0, N_to - N))))))
    cut = [np.s_[:, :S, :di], np.s_[:, :S, :di], np.s_[:di, :N], np.s_[:, :S, :N],
           np.s_[:, :S, :N], np.s_[:di]]
    return [np.asarray(g)[c] for g, c in zip(grads, cut)]


@pytest.mark.parametrize("N", [4, 8, 16])
@pytest.mark.parametrize("di", [200, 130])
@pytest.mark.parametrize("S", [1, CHUNK - 1, CHUNK + 1, 37])
def test_selective_scan_bwd_blocked_matches_jax_vjp(S, di, N):
    inputs, (dy, dh) = _scan_inputs(2, S, di, N, seed=S + di + N)
    want = _embedded_jax_vjp(inputs, dy, dh)
    got = selective_scan_bwd_blocked(*map(torch.from_numpy, inputs), torch.from_numpy(dy),
                                     torch.from_numpy(dh), CHUNK, lanes(N))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)
