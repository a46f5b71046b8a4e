"""The port's export surface against the JAX package's, and the flat
ops' ``chunk_size``.

Every ``__init__.py`` of ``apex_tpu`` is parsed with ``ast``: the names
it imports from the package, the functions and classes it defines, its
other public assignments, ``__all__`` and its lazy ``_LAZY*`` names.
Each must be importable from the port's mirror (``apex_tpu.X`` ->
``apex_tpu_torch.X``), except the entries of :data:`NOT_PORTED`, each of
which names the ROADMAP.md queue item that brings it; where the port
raises for such a lazy name, its message names that item. An entry of
the allow-list that the port has after all fails the test, so the list
shrinks as the queues land. The entries of :data:`NO_COUNTERPART` give
the reason the port has none, and the port must not carry them.

The four flat ops that the JAX package marks ``accepts_chunk_size``
take ``chunk_size`` in the port too, and their outputs equal the JAX
ops' (the Pallas kernels in interpret mode, which grid over that chunk)
at a chunk of one row, the default chunk and a chunk that is not a
multiple of a row, over a buffer that is not whole rows. Tolerances:
the scale is one fp32 multiply on both sides, exact; axpby's products
and sum may be contracted into a fused multiply-add by XLA, rtol 1e-6;
sums of squares run in other orders, rtol 1e-6; maxima, counts and
flags exactly.
"""
import ast
import importlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apex_tpu_torch.multi_tensor_apply import (
    DEFAULT_CHUNK,
    ROW,
    MultiTensorApply,
)
from apex_tpu_torch.ops import packed_optimizer as T

REPO = Path(__file__).resolve().parents[1]
J = importlib.import_module("apex_tpu.ops.packed_optimizer")

#: queue items that an allow-list entry may name (ROADMAP.md)
QUEUES = {"A7", "A8"}

#: whole JAX modules the port does not mirror yet
MODULES_NOT_PORTED = {
    "apex_tpu.analysis": "A8",
}

_A7_SERVING = (
    "Channel", "FleetSupervisor", "FrameReader", "Replica", "ReplicaFleet",
    "ReplicaState", "TransportError", "WorkerUnavailable", "read_frames",
    "request_from_wire", "request_to_wire", "write_frame")
_A7_TELEMETRY = (
    "AlertManager", "AlertState", "BASE_LABELS", "ErrorBudget",
    "EscalationResponder", "FleetResponder", "HealthMonitor",
    "LogBucketHistogram", "MetricsAggregator", "SLO", "SLOTracker",
    "TickTimeline", "TraceSession", "aggregate_op_times",
    "analytic_bubble_fraction", "breakdown_table", "bubble_report",
    "categorize_op", "classify_phase", "cost_analysis_breakdown",
    "default_serving_slos", "format_labels", "label_key",
    "parse_xspace_op_times", "profile_step", "schedule_ticks",
    "short_op_name", "tick_phases", "trace_session")

#: (JAX module, name) -> the queue item that brings it to the port
NOT_PORTED = {
    ("apex_tpu", "analysis"): "A8",
    **{("apex_tpu.serving", n): "A7" for n in _A7_SERVING},
    **{("apex_tpu.telemetry", n): "A7" for n in _A7_TELEMETRY},
}

#: names of a JAX module the port mirrors (a mirrored module's functions,
#: or a package's exports) that have no counterpart there, with the
#: reason; the port must not carry them
_VMA = ("JAX's varying-manual-axes (vma) bookkeeping for shard_map's type "
        "checks; a rank of the port is a process holding plain tensors")
NO_COUNTERPART = {
    **{("apex_tpu.transformer.pipeline_parallel.utils", n): _VMA
       for n in ("pvary", "pvary_full", "pvary_union_like",
                 "vma_tracking_active")},
    ("apex_tpu.resilience", "TRANSIENT_COMPILE_POLICY"):
        "retries a remote TPU compiler's transport flakes; the port "
        "compiles its kernels with a local nvcc and has no such transport",
}

#: modules (not packages) whose public functions and classes the port
#: mirrors name for name (A6.5)
MIRRORED_MODULES = (
    "apex_tpu.transformer.context_parallel",
    "apex_tpu.transformer.pipeline_parallel.p2p_communication",
    "apex_tpu.transformer.pipeline_parallel.utils",
    "apex_tpu.transformer.pipeline_parallel._timers",
    "apex_tpu.transformer.pipeline_parallel.schedules.common",
    "apex_tpu.transformer.pipeline_parallel.schedules.fwd_bwd_1f1b",
    "apex_tpu.transformer.pipeline_parallel.schedules."
    "fwd_bwd_no_pipelining",
    "apex_tpu.transformer.pipeline_parallel.schedules."
    "fwd_bwd_pipelining_with_interleaving",
    "apex_tpu.transformer.pipeline_parallel.schedules."
    "fwd_bwd_pipelining_without_interleaving",
)

#: names the port carries under its own name: the O1 patch lists are
#: torch's functions, not jax's
RENAMED = {("apex_tpu.amp.lists", "jax_overrides"): "torch_overrides"}

#: JAX modules whose port counterpart lives elsewhere: the native host
#: IO loader sits beside the nvcc build
MIRRORS = {"apex_tpu.csrc": "apex_tpu_torch._build"}


def _jax_inits():
    return sorted(".".join(p.relative_to(REPO).parts[:-1])
                  for p in (REPO / "apex_tpu").rglob("__init__.py"))


def _public_names(module: str):
    """(names, lazy names) that the JAX ``__init__.py`` exports."""
    path = REPO.joinpath(*module.split("."), "__init__.py")
    tree = ast.parse(path.read_text())
    names, lazy = set(), set()

    def visit(body):
        for node in body:
            if isinstance(node, ast.ImportFrom) and (
                    node.level >= 1
                    or (node.module or "").startswith("apex_tpu")):
                names.update(a.asname or a.name for a in node.names)
            elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if not isinstance(t, ast.Name):
                        continue
                    if t.id == "__all__" or t.id.startswith("_LAZY"):
                        vals = {e.value for e in node.value.elts}
                        (names if t.id == "__all__" else lazy).update(vals)
                    else:
                        names.add(t.id)
            elif isinstance(node, ast.Try):
                visit(node.body)

    visit(tree.body)
    keep = {n for n in names if not n.startswith("_") or n == "__version__"}
    return keep, lazy


def test_allow_list_names_queue_items():
    for queue in list(NOT_PORTED.values()) + list(
            MODULES_NOT_PORTED.values()):
        assert queue in QUEUES, queue
    inits = set(_jax_inits())
    for module, _ in list(NOT_PORTED) + list(RENAMED):
        assert module in inits, module
    assert set(MODULES_NOT_PORTED) <= inits


@pytest.mark.parametrize("module", _jax_inits())
def test_jax_exports_importable_from_the_port(module):
    names, lazy = _public_names(module)
    assert names | lazy, module
    if module in MODULES_NOT_PORTED:
        mirror = module.replace("apex_tpu", "apex_tpu_torch", 1)
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(mirror)
        return
    port = importlib.import_module(MIRRORS.get(
        module, module.replace("apex_tpu", "apex_tpu_torch", 1)))
    for name in sorted(names | lazy):
        if (module, name) in NO_COUNTERPART:
            assert not hasattr(port, name), (module, name)
            continue
        queue = NOT_PORTED.get((module, name))
        if queue is not None:
            with pytest.raises(AttributeError) as info:
                getattr(port, name)
            if "not ported" in str(info.value):
                assert queue in str(info.value), (module, name, info.value)
            continue
        name = RENAMED.get((module, name), name)
        assert hasattr(port, name), f"{module}.{name} is missing from " \
                                    f"{port.__name__}"


def test_lazy_refusals_name_their_queue():
    import apex_tpu_torch
    import apex_tpu_torch.parallel
    import apex_tpu_torch.transformer

    for mod, name, queue in ((apex_tpu_torch, "analysis", "A8"),):
        with pytest.raises(AttributeError, match=queue.replace(".", r"\.")):
            getattr(mod, name)
    # A6.5 landed: the pipeline schedules and context parallelism import
    assert apex_tpu_torch.transformer.pipeline_parallel.run_pipeline
    from apex_tpu_torch.transformer.context_parallel import (
        ring_attention,
        ulysses_attention,
    )

    assert ring_attention and ulysses_attention
    # A6.4 landed: tensor parallelism and the samplers import
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear,
        vocab_parallel_cross_entropy,
    )

    assert ColumnParallelLinear and vocab_parallel_cross_entropy
    assert apex_tpu_torch.transformer.tensor_parallel.RowParallelLinear
    assert apex_tpu_torch.transformer._data.MegatronPretrainingSampler
    # A6.2 and A6.3 landed: the data-parallel layer imports
    for name in ("LARC", "DistributedDataParallel", "SyncBatchNorm",
                 "BucketBuffers", "convert_syncbn_model"):
        assert getattr(apex_tpu_torch.parallel, name)


def test_ops_names_are_the_functions():
    from apex_tpu_torch.ops import (
        flash_attention,
        flash_decode,
        multi_tensor_scale_flat,
    )

    fa_mod = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    assert callable(flash_attention) and flash_attention is \
        fa_mod.flash_attention
    assert flash_decode is importlib.import_module(
        "apex_tpu_torch.ops.flash_decode").flash_decode
    assert multi_tensor_scale_flat is T.multi_tensor_scale_flat


def test_top_level_subpackages():
    import apex_tpu
    import apex_tpu_torch

    assert apex_tpu_torch.__version__ == apex_tpu.__version__
    for name in ("amp", "optimizers", "normalization",
                 "multi_tensor_apply"):
        assert name in vars(apex_tpu_torch), name  # eager, as in JAX
    for name in apex_tpu._LAZY_SUBMODULES:
        assert name in dir(apex_tpu_torch)
    assert apex_tpu_torch.checkpoint.save_checkpoint
    assert apex_tpu_torch.contrib.gpu_direct_storage.GDSFile


# ---------------------------------------------------------------------------
# C8: chunk_size on the four flat ops
# ---------------------------------------------------------------------------

FLAT_OPS = ("packed_row_stats", "multi_tensor_l2norm_flat",
            "multi_tensor_scale_flat", "multi_tensor_axpby_flat")
#: one row, the reference's default chunk, a length not a row multiple
CHUNKS = (ROW, 2048 * 32, 3000)
N = 5 * ROW + 37  # not whole rows


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=N).astype(np.float32)
    y = rng.normal(size=N).astype(np.float32)
    x[ROW + 3] = np.inf  # a non-finite element in row 1
    return x, y


def _call(name, x, y, conv):
    """The op's arguments and keywords for inputs ``x``, ``y``."""
    if name == "packed_row_stats":
        return (conv(x),), {"inv_scale": 0.5}
    if name == "multi_tensor_l2norm_flat":
        return (conv(y),), {"inv_scale": 0.5}
    if name == "multi_tensor_scale_flat":
        return (conv(x), 0.25), {"per_row_flags": True}
    return (2.0, -0.5, conv(x), conv(y)), {}


def _run(name, mod, x, y, conv, **kw):
    args, kwargs = _call(name, x, y, conv)
    return getattr(mod, name)(*args, **kwargs, **kw)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", FLAT_OPS)
def test_flat_op_chunk_size_matches_jax(name, chunk):
    x, y = _inputs(chunk)
    assert getattr(T, name).accepts_chunk_size
    assert getattr(J, name).accepts_chunk_size
    want = _run(name, J, x, y, jnp.asarray, chunk_size=chunk,
                use_kernel=True, interpret=True)
    got = _run(name, T, x, y, torch.from_numpy, chunk_size=chunk)
    args, kwargs = _call(name, x, y, torch.from_numpy)
    via = MultiTensorApply(chunk)(getattr(T, name), *args, **kwargs)
    assert len(got) == len(want)
    exact = {"packed_row_stats": (False, True, True),
             "multi_tensor_l2norm_flat": (False, False),
             "multi_tensor_scale_flat": (True, True, True),
             "multi_tensor_axpby_flat": (False, True)}[name]
    for g, v, w, bit in zip(got, via, want, exact):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape, (name, g.shape, w.shape)
        torch.testing.assert_close(g, v, rtol=0, atol=0, equal_nan=True)
        if bit:
            np.testing.assert_array_equal(g.numpy(), w)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6)


@pytest.mark.parametrize("name", FLAT_OPS)
def test_flat_op_chunk_size_is_validated(name):
    x, y = _inputs(0)
    for bad in (0, -ROW):
        with pytest.raises(ValueError, match="chunk_size"):
            _run(name, T, x, y, torch.from_numpy, chunk_size=bad)
    # the results do not depend on the chunk
    a = _run(name, T, x, y, torch.from_numpy, chunk_size=ROW)
    b = _run(name, T, x, y, torch.from_numpy, chunk_size=DEFAULT_CHUNK)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("module", MIRRORED_MODULES)
def test_mirrored_module_functions_ported(module):
    """Every public function and class the JAX module defines is in the
    port's module of the same path, but the allow-listed ones, which it
    must not carry."""
    import inspect

    jm = importlib.import_module(module)
    pm = importlib.import_module(module.replace("apex_tpu", "apex_tpu_torch",
                                                1))
    names = [n for n, o in vars(jm).items()
             if (inspect.isfunction(o) or inspect.isclass(o))
             and o.__module__ == jm.__name__ and not n.startswith("_")]
    assert names, module
    for name in names:
        if (module, name) in NO_COUNTERPART:
            assert not hasattr(pm, name), (module, name)
            continue
        assert callable(getattr(pm, name, None)), (module, name)


def test_no_counterpart_entries_are_jax_names():
    inits = set(_jax_inits())
    for module, name in NO_COUNTERPART:
        if module in inits:
            assert name in _public_names(module)[0], (module, name)
            continue
        assert module in MIRRORED_MODULES
        assert callable(getattr(importlib.import_module(module), name))
