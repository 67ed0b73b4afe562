"""Tests of the port that need a CUDA GPU; they skip without one.

This file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The recurrent-scan kernel is held against its plain versions (forward and
adjoint at 1e-5, gradients at 1e-4, as in docs/KERNELS.md), its chunked
algebra's twin `chunked_scan_ref` among them, at T around its 16-step
chunks with resets on a chunk's first and last step, and a short
rec-IPPO run on the GPU must go through the kernel.  The selective-scan
kernel is held against its plain version (float32 at 1e-4; bfloat16 x/B/C
with y at 2e-2, bf16's rounding, and the float32 state at 1e-4), also at
S = 1 and around its 16-step stage, ragged di and N = 4 and 8, and a
smoke-sized Falcon-Mamba prefill on the GPU must launch it once a layer.
The flash-attention and fused-xent kernels are held against their plain
versions by each one's `ref.kernel_errors` (flash: 2e-5 in float32; in
bfloat16 2**-6 of the attention of |v| an element and 1e-2 of a query
row's norm; xent: 1e-4 in float32; in bfloat16, where both round the
logits to bfloat16, 2e-2 a token and 1e-4 a token on average),
at the wgmma designs' tile edges too (S = 127, 129, 200 around 128-row
query tiles, a window that starts inside a kv tile; T = 129, V = 255 and
257 around 256-wide vocab tiles, d and V that are not multiples of 8),
and a smoke-sized InternLM2 train step on the GPU must launch the flash
kernel twice a layer (remat runs each layer's forward again) and the
xent kernel and its combine once.  The flash kernel is held at the
attention serving path's shapes too (Granite's 32/8 heads at prompts of
16, 37 and 64 tokens, OLMoE's 16/16 at 50, and the launchers' prefills
at 4 x 2048 and Minitron's 1 x 512); a smoke-sized Granite,
Minitron and OLMoE prefill on the GPU launches it once a layer and decode
never, with the logits, the KV cache and three decode steps equal to the
CPU's at 1e-4, and the engine on the card equals sequential
generation; so do the hybrid, vlm and audio ones (Zamba2's smoke config
launching it once a shared-block invocation, its engine too), and the
kernel is held at their prefill shapes (Zamba2's head_dim 80 with its
window at least S and inside S, MusicGen's 32/32 at 64, LLaVA's 32/8 at
4 x 4096 and a ragged 2,917).  A seed-lane (3 lanes) rec-MAPPO and
IPPO update on the card must match the same update on the CPU at 1e-4,
rec-MAPPO's with no more scan launches than one lane needs.  Every
replay system's training iteration (act, write the table, update, a hard
target sync among them) runs under `torch.cuda.set_sync_debug_mode`
("error"): it never waits on the card; so do rec-MADQN's (the sequence
table, both cores, per-agent stacks on speaker_listener), DIAL's and
RIAL's (the rollout, the message carry) and a replay system's on each of
the four envs that draw at reset or inside ``step`` (switch_game's next
prisoner, robot_warehouse's re-requests).  A linear-core rec-MADQN update
and a fused no-channel DIAL update launch the recurrent-scan kernel as
often as their unrolls say.  The async actor/learner runner's ticks of
ippo and vdn (2 actors, a stale snapshot, the queue's pushes and pops, the
learner's updates) never wait on the card either.  The serving engine's
tick (ippo, rec_ippo with the linear core, vdn; admissions included)
waits on the card once, for its one packed copy of the decisions, and the
runners' telemetry tap never waits on it (its copies land behind the
queued work and are delivered later).  The selective scan's backward
kernel is held against autograd of the plain version (float32 gradients at
1e-4, bfloat16 at 2e-2) at ragged S and di and N = 4, 8 and 16, autograd of
the op on the card goes through it, and one train step of each new
training family's smoke config (OLMoE, Falcon-Mamba, Zamba2, LLaVA-NeXT,
MusicGen) on the card equals the same step on the CPU at 1e-4, with the
scan's forward twice and its backward once a mamba1 layer.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.recurrent_scan import (  # noqa: E402
    chunked_scan_ref,
    linear_recurrence_ref,
    linear_recurrent_scan,
    scan_ref,
)
from repro_torch.kernels.recurrent_scan.ops import KERNEL_CHUNK, _scan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import ref as flash_ref  # noqa: E402
from repro_torch.kernels.fused_xent import fused_softmax_xent  # noqa: E402
from repro_torch.kernels.fused_xent import ref as xent_ref  # noqa: E402
from repro_torch.kernels.selective_scan import (  # noqa: E402
    selective_scan,
    selective_scan_bwd,
    selective_scan_ref,
    selective_scan_ref_vjp,
)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(T, B, H, device, seed=0, pattern="random"):
    g = torch.Generator().manual_seed(seed)
    a = torch.sigmoid(torch.randn(T, B, H, generator=g))
    b = torch.randn(T, B, H, generator=g) * 0.1
    h0 = torch.randn(B, H, generator=g)
    reset = torch.rand(T, B, generator=g) < 0.3
    if pattern != "random":  # a reset on the first or the last step of every kernel chunk
        step = 0 if pattern == "chunk_first" else KERNEL_CHUNK - 1
        reset = (torch.arange(T) % KERNEL_CHUNK == step)[:, None].expand(T, B).contiguous()
    return (x.to(device) for x in (a, b, h0, reset))


@pytest.mark.cuda
@pytest.mark.parametrize("T,B,H,pattern", [
    (128, 64, 64, "random"), (33, 5, 7, "random"), (1, 3, 4, "random"),
    # the chunked design's edges: T around its 16-step chunks and 128-step windows
    (15, 5, 7, "chunk_first"), (17, 5, 7, "chunk_last"), (129, 5, 7, "chunk_first"),
    (129, 5, 7, "chunk_last"),
])
def test_kernel_matches_plain_versions(cuda, T, B, H, pattern):
    a, b, h0, reset = _inputs(T, B, H, cuda, pattern=pattern)
    before = linear_recurrent_scan.launches
    out = linear_recurrent_scan(a, b, h0, reset)
    rev = _scan(a, b, reset, None, reverse=True)
    torch.cuda.synchronize()
    assert linear_recurrent_scan.launches == before + 2
    torch.testing.assert_close(
        out, linear_recurrence_ref(a, b, h0, reset), atol=FWD_TOL, rtol=FWD_TOL
    )
    flat = (a.reshape(T, -1), b.reshape(T, -1), reset)
    want = scan_ref(*flat, None, reverse=True)
    torch.testing.assert_close(rev, want.reshape(T, B, H), atol=FWD_TOL, rtol=FWD_TOL)
    for got, h, direction in ((out, h0.reshape(-1), False), (rev, None, True)):
        chunked = chunked_scan_ref(*flat, h, KERNEL_CHUNK, reverse=direction)
        torch.testing.assert_close(got, chunked.reshape(T, B, H), atol=FWD_TOL, rtol=FWD_TOL)

    g = torch.randn(T, B, H, device=cuda)
    xs = [x.clone().requires_grad_(True) for x in (a, b, h0)]
    ys = [x.clone().requires_grad_(True) for x in (a, b, h0)]
    got = torch.autograd.grad((linear_recurrent_scan(*xs, reset) * g).sum(), xs)
    ref = torch.autograd.grad((linear_recurrence_ref(*ys, reset) * g).sum(), ys)
    for x, y in zip(got, ref):
        torch.testing.assert_close(x, y, atol=GRAD_TOL, rtol=GRAD_TOL)


@pytest.mark.cuda
def test_cuda_tensors_never_take_the_plain_path(cuda):
    a, b, h0, reset = _inputs(4, 2, 3, cuda)
    with pytest.raises(ValueError):  # a CUDA input is checked, not routed to the CPU
        linear_recurrent_scan(a, b, h0.cpu(), reset)


@pytest.mark.cuda
def test_short_rec_ippo_run_goes_through_the_kernel(cuda):
    from repro_torch.core import train_anakin
    from repro_torch.envs import MatrixGame
    from repro_torch.systems import PPOConfig, make_rec_ippo

    cfg = PPOConfig(hidden_sizes=(16, 16), rollout_len=8, epochs=1,
                    num_minibatches=2, recurrent_core="linear")
    system = make_rec_ippo(MatrixGame(), cfg)
    linear_recurrent_scan.launches = 0
    st, m = train_anakin(system, 0, 8, 4, device=cuda)
    # 2 bootstrap unrolls + 1 epoch x 2 minibatches x 2 agents x 2 nets x (fwd + bwd)
    assert linear_recurrent_scan.launches == 2 + 16
    assert int(st.train.steps) == 1 and bool(torch.isfinite(m["loss"]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["rec_mappo", "ippo"])
def test_seed_lane_update_on_the_card_matches_the_cpu(cuda, name, monkeypatch):
    from repro_torch.core.buffer import RolloutState
    from repro_torch.core.system import _step_phase, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems import onpolicy
    from repro_torch.systems.registry import make_pair
    from repro_torch.tree import tree_leaves, tree_map

    cfg = dict(hidden_sizes=(16, 16), rollout_len=8, epochs=1, num_minibatches=2)
    if name == "rec_mappo":
        cfg["recurrent_core"] = "linear"
    _, system = make_pair(name, "spread", env_kwargs={"horizon": 5}, **cfg)
    S, N = 3, 4
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, S, "cpu"), N, tenv)
    with torch.no_grad():
        for _ in range(cfg["rollout_len"]):
            st, _ = _step_phase(system, tenv, st)
    g = torch.Generator().manual_seed(1)
    perms = [torch.stack([torch.randperm(n, generator=g) for _ in range(S)]) for n in (N, 8 * N)]
    results = []
    for device in ("cpu", cuda):
        # the same shuffles on both devices: (S, N) env perms, (S, 8 N) row perms
        env_perm, row_perm = (p.to(device) for p in perms)
        monkeypatch.setattr(onpolicy, "_env_permutation", lambda n, gen: env_perm)
        monkeypatch.setattr(onpolicy, "_row_permutation", lambda n, gen: row_perm)
        move = lambda x: x.to(device)
        buffer = RolloutState(tree_map(move, st.buffer.storage), st.buffer.t)
        linear_recurrent_scan.launches = 0
        train, _, m = system.update(tree_map(move, st.train), buffer,
                                    seed_generators(0, S, device))
        results.append((train, m["loss"], linear_recurrent_scan.launches))
    (cpu, cpu_loss, _), (gpu, gpu_loss, launches) = results
    assert gpu_loss.shape == (S,)
    torch.testing.assert_close(gpu_loss.cpu(), cpu_loss, atol=1e-4, rtol=1e-4)
    for x, y in zip(tree_leaves(gpu.params), tree_leaves(cpu.params), strict=True):
        torch.testing.assert_close(x.cpu(), y, atol=1e-4, rtol=1e-4)
    if name == "rec_mappo":
        # 3 bootstrap unrolls, then per minibatch 3 agents x 2 nets x (fwd + bwd):
        # the seed lanes fold into the kernel's D axis and add no launch
        assert launches == 3 + 2 * 12


@pytest.mark.cuda
@pytest.mark.parametrize("name,env", [
    ("madqn", "matrix_game"), ("madqn-fp", "matrix_game"), ("vdn", "spread"),
    ("qmix", "lbf"), ("maddpg", "spread"), ("mad4pg", "spread"),
])
def test_replay_iterations_never_wait_on_the_card(cuda, name, env):
    from repro_torch.core.system import _one_iteration, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems.registry import make_pair

    kw = dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64, min_replay=16)
    if name not in ("maddpg", "mad4pg"):
        kw["target_update_period"] = 2  # a hard target sync among the updates
    # horizon 3: the episodes end and restart among the checked iterations
    _, system = make_pair(name, env, env_kwargs={"horizon": 3}, **kw)
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, 2, cuda), 4, tenv)
    for _ in range(4):  # the 4th iteration's rows open the gate; its update warms up
        st, _, _ = _one_iteration(system, tenv, st)
    assert st.train.steps == 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            st, _, _ = _one_iteration(system, tenv, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.train.steps == 5 and st.buffer.size == 8 * 4


@pytest.mark.cuda
@pytest.mark.parametrize("name,env,overrides", [
    ("rec_madqn", "spread", {"recurrent_core": "linear"}),
    ("rec_madqn", "speaker_listener", {}),
    ("dial", "switch_game", {}),
    ("rial", "switch_game", {}),
    ("dial", "switch_game", {"use_comm": False, "recurrent_core": "linear"}),
    ("madqn", "switch_game", {}), ("madqn", "speaker_listener", {}),
    ("vdn", "smax_lite", {}), ("qmix", "robot_warehouse", {}),
])
def test_matrix_iterations_never_wait_on_the_card(cuda, name, env, overrides):
    from repro_torch.core.system import _one_iteration, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems.registry import REGISTRY, make_pair

    config = REGISTRY[name].config_cls.__name__
    kw = {
        "RecMadqnConfig": dict(hidden_sizes=(16,), seq_len=2, burn_in=1, batch_size=4,
                               buffer_capacity=32, min_windows=4, target_update_period=2),
        "DialConfig": dict(hidden_dim=16, rollout_len=2, target_update_period=2),
        "OffPolicyConfig": dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64,
                                min_replay=16, target_update_period=2),
    }[config]
    # short episodes: they end and restart among the checked iterations
    env_kwargs = {} if env == "switch_game" else {"horizon": 3}
    _, system = make_pair(name, env, env_kwargs=env_kwargs, **dict(kw, **overrides))
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, 2, cuda), 4, tenv)
    for _ in range(4):  # the dataset is ready by the 4th iteration; its update warms up
        st, _, _ = _one_iteration(system, tenv, st)
    before = st.train.steps if isinstance(st.train.steps, int) else None
    assert before is not None and before >= 1
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(4):
            st, _, _ = _one_iteration(system, tenv, st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.train.steps > before


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides", [
    ("ippo", dict(hidden_sizes=(16, 16), rollout_len=4, epochs=1, num_minibatches=2)),
    ("vdn", dict(hidden_sizes=(16, 16), batch_size=8, buffer_capacity=64, min_replay=16,
                 target_update_period=2)),
])
def test_async_ticks_never_wait_on_the_card(cuda, name, overrides):
    from repro_torch.distributed.impala import make_async
    from repro_torch.systems.registry import make_pair

    # horizon 3: the episodes end and restart among the checked ticks
    _, system = make_pair(name, "spread", env_kwargs={"horizon": 3}, **overrides)
    program = make_async(system, 64, 4, 2, param_sync_every=2, device=cuda)
    st = program.init_state(0)
    for _ in range(3):  # the dataset fills and the first updates warm up
        st, _ = program.tick(st)
    before = st.updates
    assert before > 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st, metrics = program.tick(st)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert st.updates > before and st.dropped == 0 and metrics["staleness"] >= 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,env,expected", [
    # the agents' shared stack: online burn-in, suffix forward and backward,
    # target burn-in and suffix
    ("rec_madqn", "spread", 5),
    # the fused re-run of every agent: online forward and backward, the target's forward
    ("dial", "switch_game", 3),
])
def test_linear_core_updates_launch_the_scan_kernel(cuda, name, env, expected):
    from repro_torch.core.system import _step_phase, _training_env, init_system_state
    from repro_torch.core.system import seed_generators
    from repro_torch.systems.registry import make_pair

    kw = dict(recurrent_core="linear")
    kw.update(dict(hidden_sizes=(16,), seq_len=3, burn_in=2, batch_size=4, min_windows=2)
              if name == "rec_madqn" else dict(hidden_dim=16, use_comm=False))
    _, system = make_pair(name, env, **kw)
    tenv = _training_env(system.env)
    st = init_system_state(system, seed_generators(0, 2, cuda), 4, tenv)
    with torch.no_grad():
        while not system.can_sample(st.buffer):
            st, _ = _step_phase(system, tenv, st)
    before = linear_recurrent_scan.launches
    train, _, m = system.update(st.train, st.buffer, st.key)
    torch.cuda.synchronize()
    # the seed lanes fold into the kernel's D axis and add no launch
    assert linear_recurrent_scan.launches - before == expected
    assert m["loss"].shape == (2,) and bool(torch.isfinite(m["loss"]).all())


def _scan_inputs(b, S, di, N, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    t = dict(
        x=torch.randn(b, S, di, generator=g),
        delta=torch.randn(b, S, di, generator=g).abs() * 0.1,
        A=-(torch.randn(di, N, generator=g).abs() + 0.5),
        B=torch.randn(b, S, N, generator=g),
        C=torch.randn(b, S, N, generator=g),
        D=torch.randn(di, generator=g),
    )
    for k in ("x", "B", "C"):
        t[k] = t[k].to(dtype)
    return {k: v.to(device) for k, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,di,N", [(1, 64, 8192, 16), (3, 37, 200, 16), (2, 33, 130, 8),
                                      (1, 5, 64, 4),
                                      # the staged design's edges: S = 1 and S around its
                                      # 16-step stage, di not a multiple of a block's lanes,
                                      # N = 4 and 8 with an odd b * S
                                      (1, 1, 200, 16), (3, 15, 130, 16), (3, 17, 200, 16),
                                      (3, 17, 130, 8), (1, 15, 200, 8), (3, 15, 200, 4),
                                      (1, 17, 130, 4)])
def test_selective_scan_kernel_matches_plain_version(cuda, b, S, di, N, dtype):
    t = _scan_inputs(b, S, di, N, getattr(torch, dtype), cuda)
    before = selective_scan.launches
    y, h = selective_scan(**t)
    torch.cuda.synchronize()
    assert selective_scan.launches == before + 1
    y_ref, h_ref = selective_scan_ref(**t)
    y_tol = 1e-4 if dtype == "float32" else 2e-2
    assert y.dtype == t["x"].dtype and h.dtype == torch.float32
    torch.testing.assert_close(y.float(), y_ref.float(), atol=y_tol, rtol=y_tol)
    torch.testing.assert_close(h, h_ref, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_selective_scan_raises_on_what_the_kernel_does_not_take(cuda):
    t = _scan_inputs(1, 4, 32, 6, torch.float32, cuda)
    with pytest.raises(ValueError, match="N in"):  # no instance for N = 6
        selective_scan(**t)
    dy, dh = torch.zeros(1, 4, 32, device=cuda), torch.zeros(1, 32, 6, device=cuda)
    with pytest.raises(ValueError, match="N in"):  # nor a backward
        selective_scan_bwd(*t.values(), dy, dh)
    t = _scan_inputs(1, 4, 32, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="dh_final"):  # a cotangent is checked, not moved
        selective_scan_bwd(*t.values(), dy, torch.zeros(1, 32, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,S,di,N", [(2, 37, 200, 16), (1, 64, 1024, 16), (2, 33, 130, 8),
                                      (3, 17, 64, 4), (1, 1, 40, 16)])
def test_selective_scan_bwd_kernel_matches_plain_version(cuda, b, S, di, N, dtype):
    t = _scan_inputs(b, S, di, N, getattr(torch, dtype), cuda, seed=S)
    g = torch.Generator().manual_seed(di)
    dy = torch.randn(b, S, di, generator=g).to(device=cuda, dtype=t["x"].dtype)
    dh = torch.randn(b, di, N, generator=g).to(cuda)
    before = selective_scan_bwd.launches
    got = selective_scan_bwd(*t.values(), dy, dh)
    torch.cuda.synchronize()
    assert selective_scan_bwd.launches == before + 1
    want = selective_scan_ref_vjp(*t.values(), dy, dh)
    tol = 1e-4 if dtype == "float32" else 2e-2
    for x, y, inp in zip(got, want, t.values()):
        assert x.dtype == y.dtype == inp.dtype
        torch.testing.assert_close(x.float(), y.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_selective_scan_autograd_goes_through_the_backward_kernel(cuda):
    t = _scan_inputs(2, 40, 96, 16, torch.bfloat16, cuda)
    leaves = {k: v.clone().requires_grad_() for k, v in t.items()}
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    y, h = selective_scan(**leaves)
    (y.float().square().sum() + h.sum()).backward()
    assert (selective_scan.launches - fwd, selective_scan_bwd.launches - bwd) == (1, 1)
    assert all(v.grad.dtype == v.dtype for v in leaves.values())
    with torch.no_grad():  # and no backward without a graph
        selective_scan(**leaves)
    assert selective_scan_bwd.launches - bwd == 1


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "falcon-mamba-7b", "zamba2-2.7b",
                                  "llava-next-mistral-7b", "musicgen-large"])
def test_smoke_family_train_step_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import SyntheticTokenDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    gpu = M.LM(tree_map(lambda x: x.to(cuda, copy=True), cpu.tree()), cfg)
    ds = SyntheticTokenDataset(cfg.vocab, 24, 2, seed=1)
    host = train.make_batch(cfg, ds, np.random.default_rng(1), "cpu")
    fwd, bwd = selective_scan.launches, selective_scan_bwd.launches
    after = []
    for model in (gpu, cpu):
        opt, step = make_train_step(cfg)
        batch = {k: v.to(next(model.parameters()).device) for k, v in host.items()}
        model, _, metrics = step(model, opt.init(model.tree()), batch)
        assert bool(torch.isfinite(metrics["loss"]))
        after.append([p.cpu() for p in tree_leaves(model.tree())])
    mamba1 = cfg.num_layers if arch == "falcon-mamba-7b" else 0
    assert selective_scan.launches - fwd == 2 * mamba1  # remat: each layer's forward twice
    assert selective_scan_bwd.launches - bwd == mamba1
    for x, y in zip(*after):
        torch.testing.assert_close(x, y, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_smoke_prefill_launches_the_scan_once_a_layer(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M

    cfg = get_smoke_config("falcon-mamba-7b")
    model = M.init_model(torch.Generator(cuda).manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 19), device=cuda)
    selective_scan.launches = 0
    logits, cache = M.prefill(model, tokens)
    assert selective_scan.launches == cfg.num_layers
    logits2, _ = M.decode_step(model, cache, logits.argmax(-1))
    assert selective_scan.launches == cfg.num_layers  # decode runs no kernel
    assert bool(torch.isfinite(logits2).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal,window", [
    (2, 8, 2, 200, 64, True, 0),     # ragged S, GQA
    (1, 4, 1, 256, 64, True, 96),    # sliding window
    (1, 6, 3, 160, 80, True, 64),    # head_dim 80
    (1, 4, 4, 77, 32, False, 0),     # non-causal, ragged: keys >= S masked
    (1, 2, 1, 300, 128, False, 40),  # non-causal window
    # the wgmma design's edges: 128-row query tiles, 128-key tiles
    (1, 4, 2, 127, 128, True, 0),
    (1, 4, 2, 127, 128, False, 0),
    (1, 4, 2, 129, 128, True, 0),
    (1, 4, 2, 129, 64, False, 0),
    (1, 4, 2, 200, 128, False, 0),
    (1, 2, 1, 300, 128, True, 70),   # a window that starts inside a kv tile
    (1, 2, 2, 384, 64, True, 200),
    # the serving path's shapes: Granite's 32/8 heads (n_rep 4) at the engine's short
    # prompts, under one 128-row query tile, and OLMoE's 16/16
    (1, 32, 8, 16, 128, True, 0),
    (1, 32, 8, 37, 128, True, 0),
    (1, 32, 8, 64, 128, True, 0),
    (1, 16, 16, 50, 128, True, 0),
    # and the launchers' prefills: Granite's and OLMoE's at 4 x 2048, Minitron's at 1 x 512
    (4, 32, 8, 2048, 128, True, 0),
    (4, 16, 16, 2048, 128, True, 0),
    (1, 32, 8, 512, 128, True, 0),
    # the hybrid, vlm and audio prefills: Zamba2's shared block (32/32 heads, head_dim 80,
    # window 4096: at least S, and a window of 1024 inside S) at an engine prompt and the
    # launcher's 4 x 2048; MusicGen's 32/32 at hd 64; LLaVA's 32/8 at a ragged S (2,880
    # vision + 37 text positions) and the launcher's 4 x 4096
    (1, 32, 32, 37, 80, True, 4096),
    (4, 32, 32, 2048, 80, True, 4096),
    (1, 32, 32, 2048, 80, True, 1024),
    (4, 32, 32, 2048, 64, True, 0),
    (1, 32, 8, 2917, 128, True, 0),
    (4, 32, 8, 4096, 128, True, 0),
])
def test_flash_attention_kernel_matches_plain_version(cuda, B, Hq, Hkv, S, hd, causal, window,
                                                      dtype):
    g = torch.Generator().manual_seed(S)
    q, k, v = (torch.randn(B, H, S, hd, generator=g).to(cuda, getattr(torch, dtype))
               for H in (Hq, Hkv, Hkv))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert out.dtype == q.dtype
    elem, row, _ = flash_ref.kernel_errors(out, q, k, v, causal=causal, window=window)
    assert elem <= 1 and row <= flash_ref.ROW_TOL, (elem, row)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "minitron-8b", "olmoe-1b-7b"])
def test_smoke_attention_serving_launches_flash_once_a_layer(cuda, arch):
    """Prefill launches the flash kernel once a layer, decode none; card = CPU at 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    gpu = M.LM(tree_map(lambda t: t.to(cuda, copy=True), cpu.tree()), cfg)
    tokens = torch.randint(0, cfg.vocab, (2, 70), generator=torch.Generator().manual_seed(1))
    flash_attention.launches = 0
    lg, cg = M.prefill(gpu, tokens.to(cuda), max_len=74)
    assert flash_attention.launches == cfg.num_layers
    lc, cc = M.prefill(cpu, tokens, max_len=74)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        torch.testing.assert_close(cg["kv"][name].cpu(), cc["kv"][name], atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for _ in range(3):
        lg, cg = M.decode_step(gpu, cg, tok.to(cuda))
        lc, cc = M.decode_step(cpu, cc, tok)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    assert flash_attention.launches == cfg.num_layers  # decode runs no kernel


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "llava-next-mistral-7b", "musicgen-large"])
def test_smoke_family_serving_launches_flash_once_an_attention_layer(cuda, arch):
    """The hybrid, vlm and audio prefills launch the flash kernel once an attention layer
    (the hybrid's shared-block invocations), decode none; card = CPU at 1e-4, every cache
    leaf; the hybrid's prompt of 70 passes its window of 32 (a ring) over 5 SSD chunks."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.tree import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    cpu = M.init_model(torch.Generator().manual_seed(0), cfg)
    gpu = M.LM(tree_map(lambda t: t.to(cuda, copy=True), cpu.tree()), cfg)
    inputs = serve.make_inputs(cfg, 2, 70, 1, "cpu")
    tokens, vision = inputs["tokens"], inputs.get("vision_embeds")
    flash_attention.launches = 0
    lg, cg = M.prefill(gpu, tokens.to(cuda), max_len=74,
                       vision_embeds=None if vision is None else vision.to(cuda))
    layers = cfg.num_attn_invocations if cfg.arch_type == "hybrid" else cfg.num_layers
    assert flash_attention.launches == layers
    lc, cc = M.prefill(cpu, tokens, max_len=74, vision_embeds=vision)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
    for x, y in zip(tree_leaves(cg), tree_leaves(cc)):
        torch.testing.assert_close(x.cpu(), y, atol=1e-4, rtol=1e-4)
    tok = lc.argmax(-1)
    for _ in range(3):
        lg, cg = M.decode_step(gpu, cg, tok.to(cuda))
        lc, cc = M.decode_step(cpu, cc, tok)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=1e-4)
        tok = lc.argmax(-1)
    assert flash_attention.launches == layers  # decode runs no kernel


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "olmoe-1b-7b", "zamba2-2.7b"])
def test_engine_on_the_card_equals_sequential_generation(cuda, arch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    from repro_torch.serving import Request, ServingEngine

    cfg = get_smoke_config(arch)
    model = M.init_model(torch.Generator(cuda).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in (12, 9, 15)]
    engine = ServingEngine(model, max_slots=2, prompt_capacity=16, max_new_tokens=6,
                           device=cuda)
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=i, prompt=p, max_new_tokens=6))
    flash_attention.launches = 0
    got = {r.uid: r.output for r in engine.run_until_drained()}
    layers = cfg.num_attn_invocations if cfg.arch_type == "hybrid" else cfg.num_layers
    assert flash_attention.launches == 3 * layers  # one prefill an admission
    for i, p in enumerate(prompts):
        one = torch.as_tensor(p[None], dtype=torch.long, device=cuda)
        assert got[i] == serve.generate(model, one, 6).tokens[0].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,d,V", [(64, 128, 1000), (100, 64, 512), (32, 16, 77), (130, 96, 70),
                                   # the wgmma design's edges: 128-token blocks, 256-wide
                                   # vocab tiles, d and V padded to multiples of 8
                                   (129, 64, 255), (129, 128, 257), (64, 40, 1001)])
def test_fused_xent_kernel_matches_plain_version(cuda, T, d, V, dtype):
    g = torch.Generator().manual_seed(T)
    x = torch.randn(T, d, generator=g).to(cuda, getattr(torch, dtype))
    w = (torch.randn(d, V, generator=g) * 0.05).to(cuda, getattr(torch, dtype))
    labels = torch.randint(0, V, (T,), generator=g).to(cuda)
    before = fused_softmax_xent.launches, fused_softmax_xent.combine_launches
    loss = fused_softmax_xent(x, w, labels)
    torch.cuda.synchronize()
    # bf16 runs the product-and-fold kernel over vocab splits, then their combine
    combines = int(dtype == "bfloat16")
    assert (fused_softmax_xent.launches, fused_softmax_xent.combine_launches) == (
        before[0] + 1, before[1] + combines)
    elem, total, _ = xent_ref.kernel_errors(loss, x, w, labels)
    assert elem <= 1 and total <= 1, (elem, total)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_xent_empty_batch_launches_nothing(cuda, dtype):
    x = torch.zeros(0, 16, device=cuda, dtype=getattr(torch, dtype))
    w = torch.zeros(16, 77, device=cuda, dtype=getattr(torch, dtype))
    before = fused_softmax_xent.launches, fused_softmax_xent.combine_launches
    loss = fused_softmax_xent(x, w, torch.zeros(0, dtype=torch.int64, device=cuda))
    assert loss.shape == (0,) and loss.dtype == torch.float32
    assert (fused_softmax_xent.launches, fused_softmax_xent.combine_launches) == before


@pytest.mark.cuda
def test_new_kernels_raise_on_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 48, device=cuda)
    with pytest.raises(ValueError, match="head_dim in"):  # no instance for hd = 48
        flash_attention(q, q, q)
    with pytest.raises(ValueError):  # a CUDA input is checked, not routed to the CPU
        flash_attention(q, q.cpu(), q)
    x, w = torch.zeros(4, 8, device=cuda), torch.zeros(8, 10, device=cuda)
    with pytest.raises(ValueError):
        fused_softmax_xent(x, w, torch.zeros(4, dtype=torch.int32))


@pytest.mark.cuda
def test_smoke_train_step_goes_through_both_kernels(cuda):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M

    cfg = get_smoke_config("internlm2-1.8b")
    model = M.init_model(torch.Generator(cuda).manual_seed(0), cfg)
    opt, step = make_train_step(cfg)
    state = opt.init(model.tree())
    toks = torch.randint(0, cfg.vocab, (2, 33), device=cuda)
    flash_attention.launches = fused_softmax_xent.launches = 0
    fused_softmax_xent.combine_launches = 0
    model, state, metrics = step(model, state, {"tokens": toks[:, :-1], "labels": toks[:, 1:]})
    assert flash_attention.launches == 2 * cfg.num_layers
    assert fused_softmax_xent.launches == 1
    assert fused_softmax_xent.combine_launches == int(cfg.dtype == "bfloat16")
    assert bool(torch.isfinite(metrics["loss"]))


def _sync_warnings(fn):
    """``fn()`` under ``set_sync_debug_mode("warn")``: where it waited on the card (file:line)."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,overrides", [
    ("ippo", {}), ("rec_ippo", {"recurrent_core": "linear"}), ("vdn", {}),
])
def test_engine_tick_copies_to_the_host_once(cuda, name, overrides):
    from repro_torch.serve import DecisionEngine, ServeRequest
    from repro_torch.systems.registry import make_pair, smoke_overrides

    _, system = make_pair(name, "matrix_game", **smoke_overrides(name), **overrides)
    train = system.init_train(torch.Generator(cuda).manual_seed(0))
    engine = DecisionEngine(system, train, max_slots=4, device=cuda)
    for i in range(12):
        engine.submit(ServeRequest(uid=i, seed=i))
    # episodes of 10 steps: slots retire at ticks 10 and 20 and the queue
    # refills them at 11 and 21; the first 12 ticks take the first-use costs
    for _ in range(12):
        engine.tick()
    ticks = 12
    waits = _sync_warnings(lambda: [engine.tick() for _ in range(ticks)])
    assert len(waits) == ticks, waits  # one packed copy a tick, admissions included
    assert len(engine.finished) == 8


@pytest.mark.cuda
def test_tap_never_waits_on_the_card(cuda):
    from repro_torch.core.system import _one_iteration, _Tap, _training_env, init_system_state
    from repro_torch.systems.registry import make_pair

    _, system = make_pair("ippo", "matrix_game", hidden_sizes=(16, 16), rollout_len=4,
                          epochs=1, num_minibatches=2)
    tenv = _training_env(system.env)
    st = init_system_state(system, torch.Generator(cuda).manual_seed(0), 4, tenv)
    rows = []
    tap = _Tap(4, lambda *r: rows.append(r))

    def iterations(its):
        nonlocal st
        for it in its:
            st, metrics, _ = _one_iteration(system, tenv, st)
            tap(it, st.train.steps, metrics)

    iterations([0, 1, 2, 3])  # warm: first-use costs, an update, one emission
    tap.drain()
    torch.cuda.set_sync_debug_mode("error")
    try:
        iterations([4, 5, 6, 7, 8])  # a logging iteration (7) among them: no wait either
    finally:
        torch.cuda.set_sync_debug_mode("default")
    tap.drain()  # the run's end delivers what is still in flight
    assert [r[0] for r in rows] == [3, 7] and int(rows[-1][1]) == 2
