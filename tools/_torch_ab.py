"""Orchestration shared by the port's A/B timing tools
(``torch_kernel_ab.py``, ``torch_flash_ab.py``, ``torch_leg_ab.py`` and
``torch_serving_ab.py``); only their child scripts and summaries differ.

A side is one checkout of the port, run in fresh processes whose working
directory is that checkout and whose ``PYTHONPATH`` is that checkout
alone. Every checkout's kernels are built first, all builds started
together. The sides then run in the order given, then in reverse
(``rounds`` such blocks), so a drift of the card or the host over the call
falls on every side. Each process's whole output goes to a file of
``logs``; a child reports by printing lines ``TAG {json}``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Callable, Iterator, List, Sequence, Tuple

BUILD = "from apex_tpu_torch import _build\n_build.build()\n"


def _env(path: str) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.abspath(path))


def card() -> str:
    """Print and return the card's name and power limit."""
    line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(line, flush=True)
    return line


def build(paths: Sequence[str]) -> None:
    """Build the kernels of every checkout in ``paths``, all at once."""
    paths = sorted(set(paths))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=p,
                              env=_env(p), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for p in paths]
    for p, proc in zip(paths, procs):
        log, _ = proc.communicate(timeout=900)
        if proc.returncode:
            sys.stderr.write(log[-4000:])
            raise SystemExit(f"{p}: build exit {proc.returncode}")


def run_sides(paths: Sequence[str], child: str, tag: str, *, rounds: int,
              logs: str, argv: Callable[[int], List[str]] = lambda s: []
              ) -> Iterator[Tuple[int, int, dict]]:
    """Print the card, build every checkout, then run ``child`` in each
    side's checkout (``paths[s]``, given ``argv(s)``) forward then in
    reverse, ``rounds`` times; yield ``(run, side, record)`` for each
    ``tag`` line a child prints."""
    os.makedirs(logs, exist_ok=True)
    card()
    build(paths)
    order = (list(range(len(paths)))
             + list(reversed(range(len(paths))))) * rounds
    for i, s in enumerate(order):
        path = paths[s]
        out = subprocess.run([sys.executable, "-c", child, *argv(s)],
                             cwd=path, env=_env(path), capture_output=True,
                             text=True, timeout=900)
        with open(os.path.join(logs, f"{i}_{s}.log"), "w") as f:
            f.write(out.stdout + out.stderr)
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-4000:])
            raise SystemExit(f"{path}: exit {out.returncode}")
        for line in out.stdout.splitlines():
            if line.startswith(tag + " "):
                yield i, s, json.loads(line.split(" ", 1)[1])
