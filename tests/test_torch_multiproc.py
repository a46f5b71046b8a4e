"""``parallel.initialize_distributed`` against the JAX package's
``apex_tpu.parallel.multiproc``.

Both read ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``
and do nothing without a coordinator. With the variables set, two
spawned processes join one gloo world (over a ``FileStore`` in a
temporary directory, no TCP port; a join timeout of 120 s) and sum
their ranks. A bare ``host:port`` becomes a ``tcp://`` address and the
backend is gloo on a host without CUDA (checked with
``init_process_group`` replaced, so nothing connects).
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from apex_tpu.parallel import multiproc as jmultiproc
from apex_tpu_torch.parallel import initialize_distributed, multiproc

REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import torch
import torch.distributed as dist
from apex_tpu_torch.parallel import initialize_distributed

initialize_distributed()
t = torch.tensor([float(dist.get_rank())])
dist.all_reduce(t)
print(dist.get_world_size(), dist.get_rank(), int(t.item()), flush=True)
dist.destroy_process_group()
"""


def test_no_coordinator_is_a_noop(monkeypatch):
    monkeypatch.delenv("COORDINATOR_ADDRESS", raising=False)
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: called.append((a, k)))
    assert initialize_distributed() is None
    assert jmultiproc.initialize_distributed() is None  # the JAX one too
    assert called == [] and not dist.is_initialized()


def test_arguments_and_address_forms(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the backend is NCCL")
    called = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: called.append((a, k)))
    initialize_distributed("localhost:1234", num_processes=4, process_id=0)
    monkeypatch.setenv("COORDINATOR_ADDRESS", "file:///tmp/some-store")
    monkeypatch.setenv("NUM_PROCESSES", "2")
    monkeypatch.setenv("PROCESS_ID", "1")
    initialize_distributed()
    assert called == [
        (("gloo",), {"init_method": "tcp://localhost:1234", "world_size": 4,
                     "rank": 0}),
        (("gloo",), {"init_method": "file:///tmp/some-store",
                     "world_size": 2, "rank": 1})]


def test_env_variables_join_a_gloo_world_of_two(tmp_path):
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1",
                   COORDINATOR_ADDRESS=f"file://{tmp_path / 'store'}",
                   NUM_PROCESSES="2", PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env, cwd=str(tmp_path),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    deadline = time.monotonic() + 120
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            assert p.returncode == 0, err[-3000:]
            outs.append(out.split())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert sorted(outs) == [["2", "0", "1"], ["2", "1", "1"]]


def test_main_names_the_launcher(capsys):
    multiproc.main()
    assert "torchrun" in capsys.readouterr().err
