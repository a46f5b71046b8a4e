"""Every parameter name of the JAX package's exported callables is one
the port accepts (faults C9 and C10).

For each name that a JAX ``__init__.py`` exports (``test_torch_exports``'
walk) and the port has, both are callables, and ``inspect.signature``
reads both (a class: its constructor; a flax module or a dataclass: its
fields), the port must accept each named parameter of the JAX one: it
has a parameter of that name, or takes ``**kwargs``. The exceptions are
the allow-lists below, each entry with its reason: names that only mean
something to JAX or the TPU (:data:`TPU_ONLY`), and names that wait for
a queue item of ``ROADMAP.md`` or that the port takes elsewhere
(:data:`NOT_YET`). An entry that the port
accepts after all, or that no JAX signature holds, fails the test, so
the lists shrink as the port grows.

C10 in particular: ``FusedAdam(packed=True, packed_spec=buckets.spec,
packed_chunk_size=..., capturable=True, set_grad_none=True)`` builds and
steps.
"""
import importlib
import inspect

import pytest
import torch

from test_torch_exports import (
    MIRRORS,
    MODULES_NOT_PORTED,
    NOT_PORTED,
    RENAMED,
    _jax_inits,
    _public_names,
)

#: parameter names that only mean something to JAX or the TPU
TPU_ONLY = {
    "interpret": "Pallas interpret mode; the port's kernels are CUDA, and "
                 "a CPU tensor runs the plain version",
    "use_kernel": "the JAX route switch between the Pallas kernel and XLA; "
                  "the port picks the route by the tensors' device",
    "packed_interpret": "Pallas interpret mode of the packed sweeps",
    "fused_block_interpret": "Pallas interpret mode of the fused tails",
    "block_q": "flash attention's Pallas tile; the CUDA kernels pick theirs",
    "block_k": "flash attention's Pallas tile",
    "bwd_block_q": "flash attention's Pallas backward tile",
    "bwd_block_k": "flash attention's Pallas backward tile",
    "name": "flax module bookkeeping",
    "parent": "flax module bookkeeping",
    "unroll": "a lax.scan unroll factor (an XLA compile knob; the port "
              "loops in Python)",
    "layer_unroll": "a lax.scan unroll factor over the layers",
    "ce_unroll": "a lax.scan unroll factor over the loss's chunks",
    "key": "a JAX PRNG key: the port draws from a torch.Generator "
           "(generator=)",
    "dropout_key": "a JAX PRNG key: the port's dropout draws from a "
                   "torch.Generator (generator=)",
}

#: (module, name) -> {parameter: the ROADMAP.md queue item that brings
#: it, or why the port takes it elsewhere}
NOT_YET = {}

#: whole names whose port waits for a queue item
SKIPPED = {}


def _signature(obj):
    try:
        return inspect.signature(obj)
    except (TypeError, ValueError):
        return None


def _pairs(module):
    """``(name, jax object, port object)`` of the callables both packages
    export from ``module``."""
    names, lazy = _public_names(module)
    jm = importlib.import_module(module)
    pm = importlib.import_module(MIRRORS.get(
        module, module.replace("apex_tpu", "apex_tpu_torch", 1)))
    out = []
    for name in sorted(names | lazy):
        if (module, name) in NOT_PORTED or (module, name) in SKIPPED:
            continue
        jo = getattr(jm, name, None)
        po = getattr(pm, RENAMED.get((module, name), name), None)
        if jo is None or po is None or inspect.ismodule(jo) \
                or not callable(jo) or not callable(po):
            continue
        out.append((name, jo, po))
    return out


def _missing(jo, po):
    """The JAX parameter names the port does not accept, or None where a
    signature cannot be read."""
    js, ps = _signature(jo), _signature(po)
    if js is None or ps is None:
        return None
    if any(p.kind == p.VAR_KEYWORD for p in ps.parameters.values()):
        return []
    return [n for n, p in js.parameters.items()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and n not in ps.parameters]


MODULES = [m for m in _jax_inits() if m not in MODULES_NOT_PORTED]


@pytest.mark.parametrize("module", MODULES)
def test_port_accepts_every_jax_parameter(module):
    bad = {}
    for name, jo, po in _pairs(module):
        missing = _missing(jo, po) or []
        allowed = NOT_YET.get((module, name), {})
        left = [n for n in missing if n not in TPU_ONLY and n not in allowed]
        if left:
            bad[name] = left
    assert not bad, f"{module}: the port does not take {bad}"


def test_allow_lists_are_needed():
    """Every allow-listed name is one some JAX signature holds and the
    port does not take; every skipped name is exported by JAX."""
    used_tpu, used_not_yet = set(), set()
    for module in MODULES:
        for name, jo, po in _pairs(module):
            for n in _missing(jo, po) or []:
                if n in NOT_YET.get((module, name), {}):
                    used_not_yet.add((module, name, n))
                elif n in TPU_ONLY:
                    used_tpu.add(n)
    assert set(TPU_ONLY) == used_tpu, set(TPU_ONLY) - used_tpu
    want = {(m, n, p) for (m, n), ps in NOT_YET.items() for p in ps}
    assert want == used_not_yet, want - used_not_yet
    for module, name in SKIPPED:
        assert name in _public_names(module)[0] | _public_names(module)[1]


def test_fused_adam_takes_the_jax_constructor():
    """C10: the JAX constructor's arguments, the DDP handoff included."""
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.parallel import GradBuckets

    params = {"w": torch.randn(300, 40), "b": torch.randn(40)}
    buckets = GradBuckets(params, bucket_cap_mb=0.01, chunk_size=2048)
    opt = FusedAdam(lr=1e-3, packed=True, master_weights=True,
                    packed_spec=buckets.spec, packed_chunk_size=2048,
                    capturable=True, set_grad_none=True)
    state = opt.init(params)
    assert state.spec is buckets.spec
    grads = {k: torch.ones_like(v) for k, v in params.items()}
    new, state = opt.step(buckets.concat(buckets.pack(grads)), state, params)
    assert int(state.step) == 1 and new["w"].shape == params["w"].shape
    with pytest.raises(ValueError, match="packed_spec requires packed=True"):
        FusedAdam(packed_spec=buckets.spec)
    # packed_chunk_size reaches the layout
    assert FusedAdam(packed=True, packed_chunk_size=4096).init(
        params).spec.chunk_size == 4096
