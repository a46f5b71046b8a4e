"""The examples against the JAX scripts (``examples/gpt/fp8_training.py``
and ``examples/dcgan/main_amp.py``, run as ``tests/test_examples.py``
runs them, and ``examples/long_context/train_long_context.py`` at
``--cpu 4``): the same initial weights
and data (drawn here with the JAX scripts' keys and handed to the port's
CLI with ``--init``), 3 steps at the JAX tests' small sizes, every
printed loss compared.

Tolerances: the fp8 GPT's losses within ``FP8_PARITY_TOL["loss"]`` (1e-3
relative, ``chip_smoke.py``: the e4m3 / e5m2 recipe rounds the two
packages' bf16 GEMM inputs to the same grid but their accumulations
differ); the DCGAN's within 3e-2 relative, the amp parity tolerance of
the bf16 ResNet steps (``tests/test_torch_resnet_train.py``, O2), here
O1's bf16 casts of every convolution and GEMM; the long-context GPT's
(fp32) within 1e-4, the JAX script printing its losses to 4 decimals.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
FP8_LOSS_TOL = 1e-3
AMP_LOSS_TOL = 3e-2


def _run_jax_script(parts, argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, str(REPO / "examples" / Path(*parts))] + argv,
        capture_output=True, text=True, env=env, timeout=600, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = np.asarray(v, np.float32)
    return out


FP8_ARGS = ["--steps", "3", "--layers", "2", "--hidden", "64", "--heads",
            "4", "--vocab", "128", "--seq", "64"]


def test_fp8_training_matches_jax_script(tmp_path, capsys):
    from apex_tpu.transformer.testing import GPTConfig, init_gpt_params
    from apex_tpu_torch.examples.gpt import fp8_training

    cfg = GPTConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128, max_position_embeddings=64,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    compute_dtype=jnp.bfloat16, fp8=True)
    params = jax.tree_util.tree_map(
        lambda p: p.astype(jnp.bfloat16),
        init_gpt_params(cfg, jax.random.PRNGKey(0)))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 64), 0, 128)
    path = tmp_path / "init.npz"
    np.savez(path, tokens=np.asarray(tokens),
             **_flat(jax.tree_util.tree_map(
                 lambda p: p.astype(jnp.float32), params), "params"))
    want = _run_jax_script(("gpt", "fp8_training.py"),
                           ["--cpu", "1"] + FP8_ARGS)
    got = fp8_training.main(["--cpu", "1", "--init", str(path)] + FP8_ARGS)
    out = capsys.readouterr().out
    wl = [float(m) for m in re.findall(r"step +\d+  loss ([0-9.]+)", want)]
    assert [s for s, _ in got] == [0, 2] and len(wl) == 2
    np.testing.assert_allclose([l for _, l in got], wl, rtol=FP8_LOSS_TOL)
    assert got[-1][1] < got[0][1]
    scales = [float(m) for m in re.findall(r"x_scale ([0-9.eE+-]+)", out)]
    assert scales[-1] != 1.0 and "final loss" in out


DCGAN_ARGS = ["--steps", "3", "--batch", "8", "--image-size", "16", "--ngf",
              "8", "--ndf", "8"]


def _jax_dcgan_init(steps, batch, size, nz, ngf, ndf):
    """The JAX script's flax modules, keys and data draws."""
    import flax.linen as nn

    class Generator(nn.Module):
        @nn.compact
        def __call__(self, z):
            s0 = size // 8
            x = nn.Dense(s0 * s0 * ngf * 4)(z)
            x = x.reshape(z.shape[0], s0, s0, ngf * 4)
            for mult in (2, 1):
                x = nn.relu(nn.GroupNorm(num_groups=8)(x))
                x = nn.ConvTranspose(ngf * mult, (4, 4), strides=(2, 2))(x)
            x = nn.relu(nn.GroupNorm(num_groups=8)(x))
            x = nn.ConvTranspose(3, (4, 4), strides=(2, 2))(x)
            return jnp.tanh(x)

    class Discriminator(nn.Module):
        @nn.compact
        def __call__(self, x):
            for mult in (1, 2, 4):
                x = nn.Conv(ndf * mult, (4, 4), strides=(2, 2))(x)
                x = nn.leaky_relu(x, 0.2)
            return nn.Dense(1)(x.reshape(x.shape[0], -1))[:, 0]

    kG, kD, kdata = jax.random.split(jax.random.PRNGKey(0), 3)
    pG = Generator().init(kG, jnp.zeros((batch, nz)))
    pD = Discriminator().init(kD, jnp.zeros((batch, size, size, 3)))
    reals, zs = [], []
    for _ in range(steps):
        kdata, kx, kz = jax.random.split(kdata, 3)
        reals.append(jax.random.uniform(kx, (batch, size, size, 3),
                                        minval=-1.0, maxval=1.0))
        zs.append(jax.random.normal(kz, (batch, nz)))
    return pD, pG, np.stack(reals), np.stack(zs)


def test_dcgan_matches_jax_script(tmp_path, capsys):
    from apex_tpu_torch.examples.dcgan import main_amp

    pD, pG, real, z = _jax_dcgan_init(3, 8, 16, 100, 8, 8)
    path = tmp_path / "init.npz"
    np.savez(path, real=real, z=z, **_flat(pD, "paramsD"),
             **_flat(pG, "paramsG"))
    want = _run_jax_script(("dcgan", "main_amp.py"),
                           ["--cpu", "1"] + DCGAN_ARGS)
    got = main_amp.main(["--cpu", "1", "--init", str(path)] + DCGAN_ARGS)
    out = capsys.readouterr().out
    wl = [(float(d), float(g)) for d, g in re.findall(
        r"Loss_D ([0-9.]+) Loss_G ([0-9.]+)", want)]
    assert [it for it, _, _ in got] == [0, 2] and len(wl) == 2
    np.testing.assert_allclose([(d, g) for _, d, g in got], wl,
                               rtol=AMP_LOSS_TOL)
    assert "done." in out and all(np.isfinite(v) for row in got
                                  for v in row[1:])


LONG_ARGS = ["--seq", "256", "--steps", "3", "--layers", "2", "--hidden",
             "64", "--heads", "4", "--vocab", "128", "--batch", "2"]
#: the JAX script prints its losses to 4 decimals
PRINTED_LOSS_ATOL = 1e-4


@pytest.mark.parametrize("zigzag", ["--zigzag", "--no-zigzag"])
def test_long_context_matches_jax_script(tmp_path, zigzag):
    """A5.7.2: the long-context script at ``--cpu 4`` (JAX) and ``--world
    4`` (a gloo world of 4 CPU processes), the JAX script's initial
    weights and tokens handed over with ``--init``; every step's loss."""
    from apex_tpu.transformer.testing import GPTConfig, init_gpt_params
    from apex_tpu_torch.examples.long_context import train_long_context

    cfg = GPTConfig(num_layers=2, hidden_size=64, num_attention_heads=4,
                    vocab_size=128, max_position_embeddings=256,
                    hidden_dropout=0.0, attention_dropout=0.0,
                    apply_query_key_layer_scaling=False)
    params = init_gpt_params(cfg, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 256), 0, 128)
    path = tmp_path / "init.npz"
    np.savez(path, tokens=np.asarray(tokens), **_flat(params, "params"))
    want = _run_jax_script(("long_context", "train_long_context.py"),
                           ["--cpu", "4", zigzag] + LONG_ARGS)
    wl = [float(m) for m in re.findall(r"step \d+: loss ([0-9.]+)", want)]
    got = train_long_context.main(["--world", "4", "--device", "cpu",
                                   "--init", str(path), zigzag] + LONG_ARGS)
    assert [it for it, *_ in got] == [0, 1, 2] and len(wl) == 3
    np.testing.assert_allclose([l for _, l, _, _ in got], wl,
                               atol=PRINTED_LOSS_ATOL)
    assert got[-1][1] < got[0][1]
