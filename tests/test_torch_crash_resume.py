"""Crash/resume bit-exactness of the port (the counterpart of
``tests/test_crash_resume.py``), on the CPU.

A training run (packed FusedAdam + masters, dynamic scaler, a carried
``torch.Generator`` for dropout, IndexedBatches, telemetry counters — see
``tests/_torch_resilience_train.py``) is hard-killed mid-run
(``os._exit``, no cleanup: async checkpoint threads die mid-write) and
resumed from the manager. The per-step loss records of crashed-prefix +
resumed-suffix must be **byte-identical** to an uninterrupted run —
covering packed optimizer state, scaler state, generator state and
data-iterator position in one assertion. A second test delivers a real
SIGTERM and proves the emergency-flush / resume path end to end; a third
holds one step of the harness against the JAX harness's step
(``tests/_resilience_train.py``'s ``train_step`` body) on the same batch,
converted params and dropout mask.
"""
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

import _torch_resilience_train as H  # noqa: E402

SCRIPT = str(Path(__file__).parent / "_torch_resilience_train.py")
STEPS = 11


def _run(*args, timeout=120):
    return subprocess.run(
        [sys.executable, SCRIPT, *map(str, args)],
        capture_output=True, text=True, timeout=timeout)


def _loss_lines(path):
    """{step: full line} for the per-step records, plus the final
    summary line (or None)."""
    steps, final = {}, None
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("S "):
                steps[int(line.split()[1])] = line
            elif line.startswith("F "):
                final = line
    return steps, final


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The uninterrupted run's records, computed once for the file."""
    d = tmp_path_factory.mktemp("torch_crash_ref")
    base = _run("--steps", STEPS, "--root", d / "ckpt",
                "--losses", d / "ref.txt")
    assert base.returncode == 0, base.stderr
    ref, ref_final = _loss_lines(d / "ref.txt")
    assert sorted(ref) == list(range(STEPS)) and ref_final
    return ref, ref_final


@pytest.mark.parametrize("die_at", [7, 8, 10])
def test_crash_resume_loss_curve_bit_exact(tmp_path, reference, die_at):
    """``die_at`` past the second save (step 6): the save before it was
    barriered there, so a committed step is on disk whatever the timing
    of the save in flight when the process dies."""
    ref, ref_final = reference
    # crashed run: hard os._exit after step die_at's loss record — an
    # async save in flight dies mid-write (its tmp dir left behind)
    crash = _run("--steps", STEPS, "--root", tmp_path / "ckpt",
                 "--losses", tmp_path / "crash.txt", "--die-at", die_at)
    assert crash.returncode == 13, crash.stderr
    crashed, crashed_final = _loss_lines(tmp_path / "crash.txt")
    assert crashed_final is None  # it really died mid-run
    assert sorted(crashed) == list(range(die_at))

    # resume from the manager (automatic: resume_or_init)
    resume = _run("--steps", STEPS, "--root", tmp_path / "ckpt",
                  "--losses", tmp_path / "resume.txt")
    assert resume.returncode == 0, resume.stderr
    resumed, resumed_final = _loss_lines(tmp_path / "resume.txt")

    # the resumed run restarted from a checkpointed step < die_at, not
    # from scratch
    first_resumed = min(resumed)
    assert 0 < first_resumed < die_at
    assert sorted(resumed) == list(range(first_resumed, STEPS))
    # BYTE-identical loss curve: replayed overlap AND new suffix both
    # match the uninterrupted run exactly (hex-formatted f32 losses)
    for s in range(first_resumed, die_at):
        assert resumed[s] == crashed[s], f"replay diverged at step {s}"
    assert {**crashed, **resumed} == ref
    # telemetry counters (total_steps) and scaler state continued too
    assert resumed_final == ref_final


def test_sigterm_preemption_flush_and_resume(tmp_path, reference):
    """A real SIGTERM mid-run flushes an emergency checkpoint (exit 17);
    the next invocation resumes from it and its records equal the
    uninterrupted run's byte for byte."""
    ref, ref_final = reference
    losses = tmp_path / "pre.txt"
    proc = subprocess.Popen(
        [sys.executable, SCRIPT, "--steps", "100000",
         "--root", str(tmp_path / "ckpt"), "--losses", str(losses),
         "--preemptable", "--step-sleep", "0.05"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if losses.exists() and len(losses.read_text().splitlines()) >= 4:
                break
            if proc.poll() is not None:
                pytest.fail(f"train process died early: "
                            f"{proc.communicate()[1]}")
            time.sleep(0.05)
        else:
            pytest.fail("train process produced no steps in time")
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
        assert proc.returncode == 17, err  # clean preempted exit
    finally:
        if proc.poll() is None:
            proc.kill()

    import json

    root = tmp_path / "ckpt"
    step_dirs = sorted(d for d in os.listdir(root)
                       if d.startswith("step_") and ".tmp-" not in d)
    assert step_dirs
    with open(root / step_dirs[-1] / "meta.json") as f:
        newest = json.load(f)
    assert newest["emergency"] is True
    pre, _ = _loss_lines(losses)
    assert newest["step"] <= max(pre) + 1

    done = _run("--steps", STEPS, "--root", root,
                "--losses", tmp_path / "post.txt")
    assert done.returncode == 0, done.stderr
    resumed, final = _loss_lines(tmp_path / "post.txt")
    assert min(resumed) == newest["step"]
    assert sorted(resumed) == list(range(newest["step"], STEPS))
    assert {**{s: v for s, v in pre.items() if s < STEPS},
            **resumed} == ref
    assert final == ref_final


#: one step of the two harnesses on the same batch, params and mask: the
#: loss within 1e-6 relative (an fp32 mean over the same bf16
#: activations); the fp32 masters within 1e-6 absolute and the bf16
#: params equal; the moments within 2^-7 of their buffer's largest entry:
#: they hold the bf16 gradients, whose GEMMs the two packages sum in
#: different orders, so a gradient element can round to the next bf16
#: value (2^-8 relative; measured 4.9e-3 and 3.6e-3 of the largest entry)
LOSS_RTOL, MASTER_ATOL, MOMENT_TOL = 1e-6, 1e-6, 2.0 ** -7


def _jax_step(x, y, keep):
    """The JAX harness's ``train_step`` body (``tests/_resilience_train.py``)
    with its dropout mask given, from its step-0 state over the port's
    initial params."""
    import jax
    import jax.numpy as jnp

    from apex_tpu import telemetry as jtel
    from apex_tpu.amp.scaler import LossScaler
    from apex_tpu.optimizers import FusedAdam
    from apex_tpu.telemetry import numerics as jnum

    params = {k: jnp.asarray(np.asarray(v, np.float32), jnp.bfloat16)
              for k, v in H.init_params_np().items()}
    opt = FusedAdam(lr=1e-2, packed=True, packed_interpret=True,
                    packed_chunk_size=256, master_weights=True)
    sc = LossScaler("dynamic", init_scale=2.0 ** 8, scale_window=5)
    mon = jnum.NumericsMonitor(params, max_consecutive_skips=4)
    opt_state, sstate, nstate = opt.init(params), sc.init_state(), mon.init()
    metrics = jtel.init_metrics()

    def loss_fn(p):
        h = jnp.tanh(x.astype(jnp.bfloat16) @ p["w1"] + p["b1"])
        h = jnp.where(keep, h, 0).astype(jnp.bfloat16)
        pred = h @ p["w2"]
        return jnp.mean((pred.astype(jnp.float32) - y) ** 2)

    def scaled(p):
        loss = loss_fn(p)
        return sc.scale_loss(sstate, loss), loss

    (_, loss), grads = jax.value_and_grad(scaled, has_aux=True)(params)
    grads, new_ss, nstate = sc.unscale(sstate, grads, numerics=(mon, nstate))
    params, opt_state = opt.step(grads, opt_state, params,
                                 found_inf=new_ss.found_inf)
    new_ss, metrics, nstate = sc.update_scale(new_ss, metrics=metrics,
                                              numerics=nstate)
    return params, opt_state, new_ss, loss


def test_one_step_against_the_jax_harness():
    x, y = H.batch_fn(0)
    keep = torch.from_numpy(
        np.random.default_rng(5).random((H.BATCH, H.HID)) < H.KEEP)
    opt, sc, mon = H.build()
    step = H.make_train_step(opt, sc, mon)
    params = H.init_params()
    from apex_tpu_torch import telemetry

    p1, o1, s1, _, _, loss = step(
        params, opt.init(params), sc.init_state("cpu"), mon.init("cpu"),
        telemetry.init_metrics("cpu"), None, x, y, keep=keep)
    jp, jo, js, jloss = _jax_step(x.numpy(), y.numpy(), keep.numpy())
    assert abs(float(loss) - float(jloss)) <= LOSS_RTOL * abs(float(jloss))
    for name in ("exp_avg", "exp_avg_sq", "master_params"):
        got = getattr(o1, name).numpy()
        want = np.asarray(getattr(jo, name))
        assert got.shape == want.shape, name
        tol = (MASTER_ATOL if name == "master_params"
               else MOMENT_TOL * np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=tol,
                                   err_msg=name)
    for k in p1:
        np.testing.assert_array_equal(
            p1[k].float().numpy(), np.asarray(jp[k], np.float32), err_msg=k)
    assert float(s1.loss_scale) == float(js.loss_scale)
    assert bool(s1.found_inf) == bool(js.found_inf)
