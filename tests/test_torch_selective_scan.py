"""The port's selective-scan op against the JAX package, on the CPU.

The port's `selective_scan` (its plain version, on CPU tensors) is held
against `repro`'s oracle `selective_scan_ref` and its Pallas kernel run in
interpret mode, over the sweep shapes of tests/test_kernels.py plus a
ragged S and a d_inner that is not a multiple of 128: float32 y and h_final
at 1e-5, and bfloat16 x/B/C (what prefill passes) with y at 2e-2, bf16's
rounding.  The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (on a GPU) and by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.selective_scan.ops import selective_scan as jax_scan  # noqa: E402
from repro.kernels.selective_scan.ref import selective_scan_ref as jax_ref  # noqa: E402
from repro_torch.kernels.selective_scan import selective_scan, selective_scan_ref  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 2e-2
# (b, S, di, N, block_d, chunk): test_kernels.py's sweep, then ragged S with
# a d_inner of 200 (not a multiple of 128)
SHAPES = [
    (2, 64, 128, 16, 128, 32),
    (1, 100, 256, 16, 128, 64),
    (2, 32, 64, 8, 64, 32),
    (1, 48, 128, 4, 64, 16),
    (3, 37, 200, 16, 200, 16),
]


def _inputs(b, S, di, N, seed=1):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.normal(size=(b, S, di)).astype(f),
        delta=(np.abs(rng.normal(size=(b, S, di))) * 0.1).astype(f),
        A=-(np.abs(rng.normal(size=(di, N))) + 0.5).astype(f),
        B=rng.normal(size=(b, S, N)).astype(f),
        C=rng.normal(size=(b, S, N)).astype(f),
        D=rng.normal(size=(di,)).astype(f),
    )


def _port(inp, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("x", "B", "C"):
        t[k] = t[k].to(dtype)
    return t


def _jax(inp, dtype=jnp.float32):
    j = {k: jnp.asarray(v) for k, v in inp.items()}
    for k in ("x", "B", "C"):
        j[k] = j[k].astype(dtype)
    return j


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("b,S,di,N,block_d,chunk", SHAPES)
def test_float32_matches_jax_oracle_and_pallas(b, S, di, N, block_d, chunk):
    inp = _inputs(b, S, di, N)
    y, h = selective_scan(**_port(inp))
    assert y.dtype == torch.float32 and h.shape == (b, di, N)
    y_ref, h_ref = jax_ref(**_jax(inp))
    _close(y, y_ref, F32_TOL)
    _close(h, h_ref, F32_TOL)
    y_k, h_k = jax_scan(**_jax(inp), block_d=block_d, chunk=chunk, interpret=True)
    _close(y, y_k, F32_TOL)
    _close(h, h_k, F32_TOL)


@pytest.mark.parametrize("b,S,di,N", [(2, 64, 128, 16), (3, 37, 200, 16)])
def test_bfloat16_inputs_match_jax(b, S, di, N):
    inp = _inputs(b, S, di, N, seed=2)
    y, h = selective_scan(**_port(inp, torch.bfloat16))
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_ref, h_ref = jax_ref(**_jax(inp, jnp.bfloat16))
    _close(y, y_ref, BF16_TOL)
    _close(h, h_ref, F32_TOL)  # the state never leaves float32


def test_cpu_takes_the_plain_version_and_launches_nothing():
    t = _port(_inputs(2, 9, 16, 4))
    before = selective_scan.launches
    y, h = selective_scan(**t)
    y_ref, h_ref = selective_scan_ref(**t)
    assert selective_scan.launches == before
    assert torch.equal(y, y_ref) and torch.equal(h, h_ref)


def test_rejects_what_it_does_not_take():
    t = _port(_inputs(2, 5, 8, 4))
    bad = [
        (TypeError, dict(x=t["x"].double())),
        (TypeError, dict(B=t["B"].to(torch.bfloat16))),  # B not in x's dtype
        (TypeError, dict(delta=t["delta"].to(torch.bfloat16))),
        (ValueError, dict(x=t["x"].transpose(0, 1).contiguous().transpose(0, 1))),
        (ValueError, dict(D=t["D"][:4])),
        (ValueError, dict(A=t["A"][:, :2])),
        (ValueError, dict(C=t["C"].to("meta"))),  # operands on two devices
    ]
    for exc, change in bad:
        with pytest.raises(exc):
            selective_scan(**{**t, **change})
    with pytest.raises(NotImplementedError):  # no kernel and no plain path there
        selective_scan(**{k: v.to("meta") for k, v in t.items()})
