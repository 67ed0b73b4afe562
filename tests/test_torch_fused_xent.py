"""The port's fused softmax cross-entropy on the CPU against the JAX package.

On the CPU the op takes its plain version (`softmax_xent_ref`); the CUDA
kernel is held against that version on the card (tests/test_torch_cuda.py
and chip_smoke.py).  Here the op matches the JAX op in Pallas interpret
mode on tests/test_kernels.py's sweep (ragged T, V = 77) at 1e-4; the
training loss built on it, `layers.chunked_softmax_xent` (one fused call
forward, the plain loss's vjp per chunk backward), matches the JAX loss
and `jax.grad` of it with respect to x and W at 1e-5 in float32; and in
bfloat16, where both packages round each logit to bfloat16 before the
float32 softmax, the loss matches the JAX loss at 2e-2.  The check that
holds the kernel against the plain version on the card
(`ref.kernel_errors`) passes one flipped logit rounding and fails a vocab
tile left out of the logsumexp.  The bf16 kernel's operand helpers are
pinned here too: `tma_operands` pads d and W's rows to multiples of 8
with zeros (copying nothing when they are already) and the plain loss over
the padded operands' first V columns is the unpadded one; `vocab_splits`
covers every vocab tile with runs of whole tiles, none empty.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_xent.ops import fused_softmax_xent as jax_fused  # noqa: E402
from repro.kernels.fused_xent.ref import softmax_xent_ref as jax_ref  # noqa: E402
from repro.models.layers import chunked_softmax_xent as jax_chunked  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.fused_xent import fused_softmax_xent, softmax_xent_ref  # noqa: E402
from repro_torch.kernels.fused_xent.ops import VOCAB_TILE, tma_operands, vocab_splits  # noqa: E402
from repro_torch.kernels.fused_xent.ref import kernel_errors  # noqa: E402
from repro_torch.models.layers import chunked_softmax_xent  # noqa: E402

OP_TOL = 1e-4
LOSS_TOL = 1e-5
BF16_TOL = 2e-2


def _close(got, want, tol):
    np.testing.assert_allclose(
        got.detach().float().numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("T,d,V,bt,bv", [  # tests/test_kernels.py:93-98
    (64, 128, 1000, 32, 256),
    (100, 64, 512, 32, 128),   # ragged T
    (128, 32, 2048, 128, 512),
    (32, 16, 77, 32, 64),      # V = 77: the JAX op shrinks its tile to 7
])
def test_op_matches_the_jax_op(T, d, V, bt, bv):
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=(T, d)), jnp.float32)
    w = jnp.asarray(rng.normal(size=(d, V)) * 0.05, jnp.float32)
    labels = jnp.asarray(rng.integers(0, V, (T,)), jnp.int32)
    before = fused_softmax_xent.launches
    got = fused_softmax_xent(*params_from_jax([x, w, labels]))
    assert fused_softmax_xent.launches == before  # the CPU path launches no kernel
    assert got.dtype == torch.float32 and got.shape == (T,)
    _close(got, jax_fused(x, w, labels, block_t=bt, block_v=bv, interpret=True), OP_TOL)
    _close(got, jax_ref(x, w, labels), OP_TOL)


def _loss_inputs(B, S, d, V, dtype, seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.normal(size=(B, S, d)), dtype)
    w = jnp.asarray(rng.normal(size=(d, V)) * 0.05, dtype)
    labels = jnp.asarray(rng.integers(0, V, (B, S)), jnp.int32)
    return x, w, labels


@pytest.mark.parametrize("S,chunk,masked", [(32, 8, False), (30, 8, False), (30, 7, True)])
def test_loss_and_gradients_match_jax(S, chunk, masked):
    x, w, labels = _loss_inputs(2, S, 16, 128, jnp.float32, seed=3)
    mask = None
    if masked:
        mask = jnp.asarray(np.random.default_rng(4).random((2, S)) < 0.7, jnp.float32)
    loss_j, (gx_j, gw_j) = jax.value_and_grad(
        lambda x, w: jax_chunked(x, w, labels, chunk, mask), argnums=(0, 1))(x, w)
    tx, tw = (t.requires_grad_(True) for t in params_from_jax([x, w]))
    tmask = None if mask is None else params_from_jax(mask)
    loss = chunked_softmax_xent(tx, tw, params_from_jax(labels), chunk, tmask)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    _close(loss, loss_j, LOSS_TOL)
    _close(gx, gx_j, LOSS_TOL)
    _close(gw, gw_j, LOSS_TOL)
    # and the fused op's mean is the loss (tests/test_kernels.py:111)
    if not masked:
        per_tok = fused_softmax_xent(tx.detach().reshape(-1, 16), tw.detach(),
                                     params_from_jax(labels).reshape(-1))
        _close(per_tok.mean(), loss_j, LOSS_TOL)


def test_bfloat16_rounds_the_logits_as_the_training_loss_does():
    x, w, labels = _loss_inputs(2, 24, 32, 300, jnp.bfloat16, seed=5)
    tx, tw, tl = params_from_jax([x, w, labels])
    _close(chunked_softmax_xent(tx, tw, tl, 8), jax_chunked(x, w, labels, 8), BF16_TOL)
    # the op rounds each logit to bf16: it differs from the upcasting oracle
    per_tok = fused_softmax_xent(tx.reshape(-1, 32), tw, tl.reshape(-1))
    rounded = torch.log_softmax((tx.reshape(-1, 32) @ tw).float(), -1)
    torch.testing.assert_close(
        per_tok, -rounded.gather(-1, tl.reshape(-1, 1).long())[:, 0], atol=1e-5, rtol=1e-5)
    assert torch.equal(per_tok, softmax_xent_ref(tx.reshape(-1, 32), tw, tl.reshape(-1)))
    tx.requires_grad_(True)
    tw.requires_grad_(True)
    gx, gw = torch.autograd.grad(chunked_softmax_xent(tx, tw, tl, 8), (tx, tw))
    assert gx.dtype == gw.dtype == torch.bfloat16


def test_rejects_what_the_kernel_does_not_take():
    x, w, lab = torch.zeros(4, 8), torch.zeros(8, 10), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError):
        fused_softmax_xent(x.double(), w.double(), lab)
    with pytest.raises(TypeError):
        fused_softmax_xent(x, w.bfloat16(), lab)
    with pytest.raises(TypeError):
        fused_softmax_xent(x, w, lab.float())
    with pytest.raises(ValueError):
        fused_softmax_xent(x, w.t().contiguous().t(), lab)
    with pytest.raises(ValueError):
        fused_softmax_xent(x, torch.zeros(9, 10), lab)
    with pytest.raises(NotImplementedError):  # no kernel and no plain path there
        fused_softmax_xent(x.to("meta"), w.to("meta"), lab.to("meta"))


@pytest.mark.parametrize("fault,agrees", [
    (None, True),
    ("gold logit's rounding flipped for one token", True),
    ("vocab tile left out of the logsumexp", False),
])
def test_kernel_check_passes_bf16_rounding_and_fails_faults(fault, agrees):
    T, d, V, tile = 256, 64, 92544, 128
    g = torch.Generator().manual_seed(6)
    x = torch.randn(T, d, generator=g).bfloat16()
    w = (torch.randn(d, V, generator=g) * d**-0.5).bfloat16()
    labels = torch.randint(0, V, (T,), generator=g)
    logits = (x @ w).float()
    gold = logits.gather(-1, labels[:, None])[:, 0]
    if fault == "vocab tile left out of the logsumexp":
        cut = logits.clone()
        cut[:, 5 * tile:6 * tile] = float("-inf")
        got = torch.logsumexp(cut, -1) - gold
    else:
        got = torch.logsumexp(logits, -1) - gold
    if fault == "gold logit's rounding flipped for one token":
        i = int(gold.abs().argmax())
        got[i] -= float(gold[i].bfloat16().float().abs().log2().floor().exp2()) / 128
    elem, total, _ = kernel_errors(got, x, w, labels)
    assert (elem <= 1 and total <= 1) == agrees, (elem, total)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,d,V", [(32, 16, 77), (130, 96, 70), (129, 13, 255), (40, 64, 257)])
def test_tma_operands_pad_with_zeros_and_keep_the_loss(T, d, V, dtype):
    g = torch.Generator().manual_seed(T + d + V)
    x = torch.randn(T, d, generator=g).to(dtype)
    w = (torch.randn(d, V, generator=g) * d**-0.5).to(dtype)
    labels = torch.randint(0, V, (T,), generator=g)
    xp, wp = tma_operands(x, w)
    d8, v8 = -(-d // 8) * 8, -(-V // 8) * 8
    assert xp.shape == (T, d8) and wp.shape == (d8, v8)
    assert xp.data_ptr() % 16 == 0 and wp.data_ptr() % 16 == 0
    assert torch.equal(xp[:, :d], x) and torch.equal(wp[:d, :V], w)
    assert not xp[:, d:].any() and not wp[d:].any() and not wp[:, V:].any()
    # the kernel reads only columns < V: the loss over them is the unpadded one
    got = softmax_xent_ref(xp, wp[:, :V], labels)
    elem, total, _ = kernel_errors(got, x, w, labels)
    assert elem <= 1 and total <= 1, (elem, total)
    if dtype == torch.float32:
        torch.testing.assert_close(got, softmax_xent_ref(x, w, labels), atol=1e-5, rtol=1e-5)


def test_tma_operands_copy_nothing_at_the_training_widths():
    x, w = torch.zeros(24, 2048, dtype=torch.bfloat16), torch.zeros(2048, 92544 // 16,
                                                                    dtype=torch.bfloat16)
    xp, wp = tma_operands(x, w)
    assert xp.data_ptr() == x.data_ptr() and wp.data_ptr() == w.data_ptr()
    # an unaligned start is copied, though the widths need no padding
    xs = torch.zeros(24 * 2048 + 1, dtype=torch.bfloat16)[1:].view(24, 2048)
    xq, _ = tma_operands(xs, w)
    assert xq.data_ptr() % 16 == 0 and xq.data_ptr() != xs.data_ptr()


@pytest.mark.parametrize("T,V,sms", [(16384, 92544, 132), (129, 257, 132), (32, 77, 132),
                                     (100, 512, 132), (300, 5000, 132), (16384, 92544, 114)])
def test_vocab_splits_cover_every_tile_once(T, V, sms):
    splits, per = vocab_splits(T, V, sms)
    n_vt = -(-V // VOCAB_TILE)
    assert 1 <= splits <= n_vt and (splits - 1) * per < n_vt <= splits * per
    if (T, V, sms) == (16384, 92544, 132):  # the training shape: 9 splits of 41 tiles
        assert (splits, per) == (9, 41)
