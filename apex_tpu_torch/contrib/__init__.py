"""Contrib pack (counterpart of ``apex_tpu/contrib``): ``contrib.xentropy``'s
chunked LM-head cross entropy, ``contrib.clip_grad``,
``contrib.layer_norm``, the attention contribs over the flash kernels
(``contrib.fmha``: packed varlen sequences; ``contrib.multihead_attn``:
self and encoder-decoder attention; ``contrib.openfold``: pair-biased
attention, the small-shape LayerNorm and ``FusedAdamSWA``), and the
contribs in plain PyTorch: ``focal_loss``, ``group_norm``, ``groupbn``,
``cudnn_gbn``, ``conv_bias_relu``, ``bottleneck`` (``Bottleneck``, and
the spatial-parallel ``SpatialBottleneck`` over the halo exchangers),
``index_mul_2d``, ``sparsity``, ``transducer`` and ``optimizers`` (the
legacy ``FusedAdam`` / ``FusedSGD`` and the ZeRO-2
``DistributedFusedAdam`` / ``DistributedFusedLAMB``), and
``gpu_direct_storage`` (``GDSFile`` over the host IO engine).

``optimizers`` imports eagerly, the others at first attribute access,
as in the JAX package."""
from . import optimizers  # noqa: F401
from .. import _lazy_import

_LAZY = (
    "clip_grad",
    "xentropy",
    "layer_norm",
    "group_norm",
    "focal_loss",
    "index_mul_2d",
    "sparsity",
    "bottleneck",
    "gpu_direct_storage",
    "transducer",
    "fmha",
    "multihead_attn",
    "conv_bias_relu",
    "groupbn",
    "cudnn_gbn",
    "openfold",
)


def __getattr__(name):
    if name in _LAZY:
        return _lazy_import(__name__, globals(), name, {})
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
