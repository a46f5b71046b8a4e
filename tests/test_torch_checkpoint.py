"""The port's ``checkpoint`` against the JAX package's.

The port writes its own format (``arrays.bin`` through the host IO
engine, ``index.json`` for the structure), so the comparison with the
JAX package is on values: the same numpy-seeded tree saved and loaded
by ``apex_tpu.checkpoint`` (orbax) and by the port gives the same
leaves bit for bit, the same dtypes and the same scalars. Beyond that
the port is held to what the JAX package's tests state:

- round trips of tensors of every dtype, the optimizers' named-tuple
  states, the packed optimizer state (its ``PackSpec`` rebuilt from the
  index) and Python scalars, bit for bit;
- ``target`` puts each leaf on the target leaf's device and dtype and
  reuses a packed state's ``PackSpec``;
- ``overwrite=False`` refuses before anything is staged;
- the stale sweep removes a dead writer's ``.tmp-<pid>`` and keeps a
  live one's;
- a failure mid-save (an unsaveable leaf, a write that raises) leaves
  the previous checkpoint loadable and no staging tree behind (what the
  JAX package's ``test_atomic_save_failure_keeps_previous`` states);
- a truncated ``arrays.bin`` or a missing index raises
  ``CheckpointCorruptError`` with the cause attached; a missing path
  raises ``FileNotFoundError``.
"""
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

from apex_tpu_torch import checkpoint as ck
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.checkpoint import (
    CheckpointCorruptError,
    load_checkpoint,
    save_checkpoint,
)
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB, FusedSGD
from apex_tpu_torch.optimizers._packed import PackedState


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "w": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(ml_dtypes.bfloat16),
            "h": rng.standard_normal((3, 2)).astype(np.float16),
        },
        "ids": [rng.integers(0, 100, (4,), dtype=np.int32),
                rng.integers(0, 2, (6,)).astype(np.bool_)],
        "step": 3,
        "lr": 1.5e-4,
    }


def _tensor(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().view(-1).view(torch.uint8).numpy().tobytes() \
        if t.numel() else b""


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return _tensor(tree)
    return tree


def _equal_trees(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    elif isinstance(a, PackedState):
        assert isinstance(b, PackedState)
        assert a.spec.total == b.spec.total
        assert a.spec.shapes == b.spec.shapes
        assert a.spec.dtypes == b.spec.dtypes
        assert a.spec.offsets == b.spec.offsets
        for f in ("step", "exp_avg", "exp_avg_sq", "master_params"):
            _equal_trees(getattr(a, f), getattr(b, f))
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal_trees(x, y)
    else:
        assert type(a) is type(b) and a == b


def _train_state(seed=1):
    """Params, a pytree and a packed optimizer state after one step each,
    a loss scaler state and scalars."""
    g = torch.Generator().manual_seed(seed)
    params = {"w": torch.randn(40, 30, generator=g),
              "b": [torch.randn(30, generator=g), torch.randn(3, 3,
                                                              generator=g)]}
    grads = {"w": torch.randn(40, 30, generator=g),
             "b": [torch.randn(30, generator=g), torch.randn(3, 3,
                                                             generator=g)]}
    adam = FusedAdam(lr=1e-3, packed=True, master_weights=True)
    pstate = adam.init(params)
    new_params, pstate = adam.step(grads, pstate, params)
    lamb = FusedLAMB(lr=1e-3)
    lstate = lamb.init(params)
    _, lstate = lamb.step(grads, lstate, params)
    sgd = FusedSGD(lr=0.1, momentum=0.9, packed=True)
    sstate = sgd.init(params)
    _, sstate = sgd.step(grads, sstate, params)
    scaler = LossScaler().init_state("cpu")
    return {"params": new_params,
            "bf16": {k: v.to(torch.bfloat16) for k, v in
                     [("w", new_params["w"])]},
            "adam": pstate, "lamb": lstate, "sgd": sstate,
            "scaler": scaler, "step": 1, "name": "run", "none": None,
            "flags": (True, 2, 0.5)}


def test_roundtrip_bit_for_bit(tmp_path):
    state = _train_state()
    p = str(tmp_path / "ck")
    save_checkpoint(p, state)
    assert sorted(os.listdir(p)) == ["arrays.bin", "index.json"]
    back = load_checkpoint(p)
    _equal_trees(state, back)
    assert type(back["lamb"]).__name__ == "FusedLAMBState"
    assert type(back["scaler"]).__name__ == "LossScaleState"
    assert back["sgd"].exp_avg_sq is None
    assert all(t.device.type == "cpu" for t in
               [back["params"]["w"], back["adam"].exp_avg])


def test_target_places_leaves_and_casts(tmp_path):
    state = _train_state(2)
    p = str(tmp_path / "ck")
    save_checkpoint(p, state)
    target = dict(state)
    target["params"] = {"w": torch.zeros(40, 30, dtype=torch.float64),
                        "b": [torch.zeros(30, dtype=torch.bfloat16),
                              torch.zeros(3, 3)]}
    back = load_checkpoint(p, target=target)
    assert back["params"]["w"].dtype == torch.float64
    assert torch.equal(back["params"]["w"],
                       state["params"]["w"].double())
    assert torch.equal(back["params"]["b"][0],
                       state["params"]["b"][0].to(torch.bfloat16))
    assert back["adam"].spec is state["adam"].spec
    _equal_trees(back["lamb"], state["lamb"])
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(p, target={"params": target["params"]})
    bad = dict(target)
    bad["params"] = {"w": torch.zeros(4, 4), "b": target["params"]["b"]}
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(p, target=bad)


def test_values_equal_the_jax_roundtrip(tmp_path):
    import jax.numpy as jnp

    from apex_tpu.checkpoint import load_checkpoint as jload
    from apex_tpu.checkpoint import save_checkpoint as jsave

    tree = _np_tree(3)
    jtree = {"params": {k: jnp.asarray(v) for k, v in
                        tree["params"].items()},
             "ids": [jnp.asarray(v) for v in tree["ids"]],
             "step": tree["step"], "lr": tree["lr"]}
    try:
        jsave(str(tmp_path / "jax"), jtree)
        jback = jload(str(tmp_path / "jax"), target=jtree)
    except Exception as e:  # orbax is an optional dependency here
        pytest.skip(f"the JAX package's orbax checkpoint does not run "
                    f"here: {type(e).__name__}: {e}")
    save_checkpoint(str(tmp_path / "port"), _torch_tree(tree))
    back = load_checkpoint(str(tmp_path / "port"))
    for k, v in tree["params"].items():
        want = np.asarray(jback["params"][k])
        assert want.dtype == v.dtype
        got = back["params"][k]
        assert got.shape == want.shape
        assert _bits(got) == want.tobytes(), k
    for got, want in zip(back["ids"], jback["ids"]):
        assert _bits(got) == np.asarray(want).tobytes()
    assert back["step"] == int(jback["step"]) == 3
    assert back["lr"] == float(jback["lr"])


def test_overwrite_false_refuses_before_writing(tmp_path):
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"w": torch.zeros(2)})
    with pytest.raises(FileExistsError):
        save_checkpoint(p, {"w": torch.ones(2)}, overwrite=False)
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]
    assert torch.equal(load_checkpoint(p)["w"], torch.zeros(2))
    save_checkpoint(p, {"w": torch.ones(2)})  # overwrite=True replaces
    assert torch.equal(load_checkpoint(p)["w"], torch.ones(2))


def test_unstaged_save_writes_in_place(tmp_path):
    p = str(tmp_path / "inner" / "ck")
    os.makedirs(os.path.dirname(p))
    save_checkpoint(p, {"w": torch.arange(3.0)}, staged=False)
    assert os.listdir(tmp_path / "inner") == ["ck"]
    assert torch.equal(load_checkpoint(p)["w"], torch.arange(3.0))


def _dead_pid() -> int:
    proc = subprocess.Popen([sys.executable, "-c", "pass"])
    proc.wait()
    return proc.pid


def test_stale_sweep(tmp_path):
    p = str(tmp_path / "ck")
    dead = f"{p}.tmp-{_dead_pid()}"
    live = f"{p}.tmp-{os.getppid()}"
    for d in (dead, live):
        os.makedirs(d)
        (tmp_path / os.path.basename(d) / "arrays.bin").write_bytes(b"x")
    assert ck.stale_writer(os.getpid())
    save_checkpoint(p, {"w": torch.ones(3)})
    assert not os.path.exists(dead)
    assert os.path.exists(live)
    assert torch.equal(load_checkpoint(p)["w"], torch.ones(3))


def test_failure_mid_save_keeps_previous(tmp_path, monkeypatch):
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"w": torch.arange(4.0)})

    class Unserializable:
        pass

    with pytest.raises(TypeError):
        save_checkpoint(p, {"w": Unserializable()})
    assert torch.equal(load_checkpoint(p)["w"], torch.arange(4.0))
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]

    real = ck.hostio.write_arrays

    def half_then_fail(path, arrays, offsets=None, *a, **kw):
        real(path, arrays[:1], offsets[:1])
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(ck.hostio, "write_arrays", half_then_fail)
    with pytest.raises(OSError, match="No space"):
        save_checkpoint(p, {"w": torch.ones(4), "v": torch.ones(5)})
    monkeypatch.undo()
    assert torch.equal(load_checkpoint(p)["w"], torch.arange(4.0))
    assert not [d for d in os.listdir(tmp_path) if ".tmp-" in d]


def test_truncated_checkpoint_raises_typed_error(tmp_path):
    p = str(tmp_path / "ck")
    state = {"w": torch.arange(64.0), "v": torch.ones(8)}
    save_checkpoint(p, state)
    data = os.path.join(p, "arrays.bin")
    with open(data, "r+b") as f:
        f.truncate(os.path.getsize(data) - 5)
    for target in (None, state):
        with pytest.raises(CheckpointCorruptError) as info:
            load_checkpoint(p, target=target)
        assert info.value.path == os.path.abspath(p)
        assert info.value.__cause__ is not None
        assert "runs to byte" in str(info.value)


def test_missing_pieces_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "nope"))
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"w": torch.ones(2)})
    os.remove(os.path.join(p, "index.json"))
    with pytest.raises(CheckpointCorruptError) as info:
        load_checkpoint(p)
    assert isinstance(info.value.__cause__, FileNotFoundError)
    q = str(tmp_path / "ck2")
    save_checkpoint(q, {"w": torch.ones(2)})
    os.remove(os.path.join(q, "arrays.bin"))
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(q)
    r = str(tmp_path / "ck3")
    save_checkpoint(r, {"w": torch.ones(2)})
    with open(os.path.join(r, "index.json"), "w") as f:
        f.write("{not json")
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(r)


def test_index_names_nothing_executable(tmp_path):
    """A named tuple type outside the port is refused at save, and an
    index naming a module outside the port is refused at load."""
    from collections import namedtuple

    Foreign = namedtuple("Foreign", "a")
    with pytest.raises(TypeError, match="apex_tpu_torch"):
        save_checkpoint(str(tmp_path / "x"), {"s": Foreign(torch.ones(1))})
    assert not os.path.exists(tmp_path / "x")
    p = str(tmp_path / "ck")
    save_checkpoint(p, {"s": LossScaler().init_state("cpu")})
    idx = os.path.join(p, "index.json")
    text = open(idx).read().replace("apex_tpu_torch.amp.scaler:",
                                    "os:")
    open(idx, "w").write(text)
    with pytest.raises(ValueError, match="not of apex_tpu_torch"):
        load_checkpoint(p)
