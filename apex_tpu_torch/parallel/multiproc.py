"""Multi-process launch helper (counterpart of
``apex_tpu/parallel/multiproc.py``).

The reference's ``apex/parallel/multiproc.py`` spawned one training
process per GPU; ``torchrun`` does that now. This module keeps the JAX
package's entry point: :func:`initialize_distributed` joins the
``torch.distributed`` world from its arguments or from the same
environment variables the JAX one reads.
"""
from __future__ import annotations

import os
import sys
from typing import Optional


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` from the arguments or
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``: NCCL
    when this process has a CUDA device, else gloo, over
    ``tcp://<coordinator_address>`` (an address that already names a
    scheme, such as ``file:///path``, is taken as given). With no
    coordinator it does nothing: one process."""
    import torch
    import torch.distributed as dist

    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address is None:
        return
    world = int(num_processes if num_processes is not None
                else os.environ["NUM_PROCESSES"])
    rank = int(process_id if process_id is not None
               else os.environ["PROCESS_ID"])
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(
        "nccl" if torch.cuda.is_available() else "gloo",
        init_method=init_method, world_size=world, rank=rank)


def main() -> None:  # pragma: no cover
    print("apex_tpu_torch.parallel.multiproc: launch one process per GPU "
          "with torchrun (python -m torch.distributed.run "
          "--nproc-per-node=N train.py), then call this module's "
          "initialize_distributed(), or torch.distributed's "
          "init_process_group, in each.", file=sys.stderr)


if __name__ == "__main__":  # pragma: no cover
    main()
