"""The LM training launcher for every family, and its checkpoints, on the CPU.

* ``launch.train.make_batch`` draws what the reference's launcher draws
  from one numpy generator (``repro/launch/train.py:55-70``): the dataset's
  sample, then a vlm batch's vision embeddings (float32 and bfloat16), or
  an audio batch's (B, S+1, K) codebook tokens shifted into tokens and
  labels;
* ``python -m repro_torch.launch.train --arch <arch> --smoke --steps 3
  --device cpu --ckpt-dir <dir> --ckpt-every 1`` runs for every arch of
  ``ARCH_IDS``, writes a checkpoint a step, and the last one, restored by
  ``repro.checkpoint.restore_checkpoint`` into ``repro.models.model.
  init_model``'s tree, equals the port's parameters exactly; the port's
  ``restore_checkpoint`` reads it back as well, and reads the same
  parameters from a checkpoint that ``repro.checkpoint`` wrote.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_smoke_config as jax_get_smoke_config  # noqa: E402
from repro.data.tokens import SyntheticTokenDataset as JaxDataset  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.convert import lm_params_to_jax, params_to_jax  # noqa: E402
from repro_torch.data import SyntheticTokenDataset  # noqa: E402
from repro_torch.launch import train  # noqa: E402


def _reference_batch(cfg, batch, seq, seed, steps):
    """The reference launcher's batches for ``steps`` steps, its lines as written."""
    ds = JaxDataset(cfg.vocab, seq, batch, seed=seed)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        host = ds.sample(rng)
        b = {"tokens": jnp.asarray(host["tokens"]), "labels": jnp.asarray(host["labels"])}
        if cfg.arch_type == "vlm":
            V = cfg.vision_tokens
            b["vision_embeds"] = jnp.asarray(
                rng.normal(size=(batch, V, cfg.d_model)), cfg.activation_dtype)
        if cfg.arch_type == "audio":
            K = cfg.num_codebooks
            toks = rng.integers(0, cfg.vocab, (batch, seq + 1, K)).astype(np.int32)
            b = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
        out.append(b)
    return out


@pytest.mark.parametrize("arch,dtype", [("llava-next-mistral-7b", "float32"),
                                        ("llava-next-mistral-7b", "bfloat16"),
                                        ("musicgen-large", "float32"),
                                        ("internlm2-1.8b", "float32")])
def test_batches_are_the_reference_launchers_draws(arch, dtype):
    jcfg = dataclasses.replace(jax_get_smoke_config(arch), dtype=dtype)
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    want = _reference_batch(jcfg, 3, 20, 7, 2)
    ds = SyntheticTokenDataset(tcfg.vocab, 20, 3, seed=7)
    rng = np.random.default_rng(7)
    for w in want:
        got = train.make_batch(tcfg, ds, rng, "cpu")
        assert sorted(got) == sorted(w)
        for name, x in params_to_jax(got).items():
            assert x.dtype == np.asarray(w[name]).dtype, name
            np.testing.assert_array_equal(x, np.asarray(w[name]))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launcher_checkpoints_restore_in_both_packages(arch, tmp_path, capsys):
    run = train.main(["--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq", "16",
                      "--device", "cpu", "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
                      "--log-every", "1"])
    assert len(run.losses) == 3 and np.isfinite(run.losses).all()
    assert run.checkpoints == [str(tmp_path / f"ckpt_{s:08d}.npz") for s in (1, 2, 3)]
    assert capsys.readouterr().out.count("checkpoint -> ") == 3

    jcfg = jax_get_smoke_config(arch)
    target = jax.eval_shape(lambda key: JM.init_model(key, jcfg), jax.random.key(1))
    restored = jax_restore(str(tmp_path), 3, target)
    want = lm_params_to_jax(run.model)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(want)
    for x, y in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(want)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x), y)

    port_tree = train.jax_layout(run.model)
    back = restore_checkpoint(str(tmp_path), 3, port_tree)
    for x, y in zip(jax.tree_util.tree_leaves(params_to_jax(back)),
                    jax.tree_util.tree_leaves(params_to_jax(port_tree))):
        np.testing.assert_array_equal(x, y)

    # the other way round: the JAX package's checkpoint of the same params
    jax_save(str(tmp_path / "jax"), 1, restored)
    got = restore_checkpoint(str(tmp_path / "jax"), 1, port_tree)
    for x, y in zip(jax.tree_util.tree_leaves(params_to_jax(got)),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(x, y)
