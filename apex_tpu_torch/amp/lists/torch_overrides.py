"""Per-op autocast lists for the O1 policy (counterpart of
``apex_tpu/amp/lists/jax_overrides.py``).

The JAX package re-mapped the reference's three lists
(``apex/amp/lists/{torch,functional,tensor}_overrides.py``) onto
``jax.numpy`` / ``lax`` / ``jax.nn`` / ``jax.scipy.special`` / ``optax``.
This file maps them back onto ``torch``, ``torch.linalg``,
``torch.nn.functional`` and ``torch.special``, keeping the JAX file's
categories and its deliberate choices:

- ``LOW_PRECISION_FUNCS``: the tensor-core ops (the matmul and
  convolution families, ``F.linear``): run in bf16/fp16.
- ``FP32_FUNCS``: numerically sensitive pointwise and reduction ops (the
  exp/log/pow families, ``rsqrt``, the sum/mean/var/cumsum family, the
  norms, the softmax family, the losses): inputs are upcast to fp32.
  ``sqrt`` and ``square`` are deliberately NOT listed (the reference
  keeps them off its FP32 lists too; only ``rsqrt`` is an fp32 entry);
  under O1 they keep the input dtype like any unlisted op. The angle
  helpers (``deg2rad``, ``rad2deg``, ``angle``) are listed, as in the JAX
  file: their pi-ratio constants lose precision in bf16.
  ``torch.float_power`` is left off: it returns fp64 whatever its input,
  where ``jnp.float_power`` returns fp32.
- ``PROMOTE_FUNCS``: mixed-dtype n-ary ops. torch promotes these to the
  widest float dtype natively (bf16 op fp32 -> fp32), as JAX does, so
  they are NOT patched; the list pins the parity surface for the tests.
- ``PROMOTE_CAST_FUNCS``: the n-ary ops that torch refuses on mixed
  float dtypes (``heaviside``, ``lerp``, ``F.bilinear``). JAX needs no
  such list; here the reference's promote wrapper
  (``tensor_overrides.CASTS``) casts their float arguments to the widest
  dtype among them. ``register_promote_function`` adds to it.

Entries are ``(module, attribute-name)`` pairs, existence-filtered at
import (``_entries``) so a torch release dropping an alias cannot break
the patcher. ``JAX_COUNTERPART`` maps each entry's name
(``"torch.mm"``, ``"F.linear"``) to the JAX entry of the same category
that does the same work (``"jnp.matmul"``), or None where the JAX lists
have none; the parity tests read it. The port's own GEMM surfaces are
low-precision entries too, as the JAX file's ``_apex_low_precision``
lists ``apex_tpu``'s: ``mlp.mlp``, ``fused_dense.fused_dense``,
``fused_dense.fused_dense_gelu_dense`` and ``fused_dense.dense_no_bias``
(patched on the packages ``apex_tpu_torch.mlp`` and
``apex_tpu_torch.fused_dense``, where callers reach them).

The ops are patched only where a caller reaches them by attribute at
call time (``F.conv2d(...)``); operators and tensor methods (``a @ b``,
``x.sum()``) are not, as jnp array methods are not in the JAX package.
That is why O1 is not ``torch.autocast``: torch's own lists differ
(``gelu``, ``mean``, ``var`` and ``std`` are fp32 entries here and not
there) and it casts at the dispatcher, reaching operators too.
"""
import importlib

import torch
import torch.linalg
import torch.nn.functional as F
import torch.special

_MODULES = {"torch": torch, "torch.linalg": torch.linalg, "F": F,
            "torch.special": torch.special}

#: entry name ("torch.mm") -> its JAX counterpart ("jnp.matmul") or None
JAX_COUNTERPART = {}


def _entries(label, pairs):
    """``(module, name)`` for each ``(name, jax_name)`` of ``pairs`` that
    exists in the module labelled ``label``; records the JAX names."""
    module = _MODULES.get(label)
    out = []
    for name, jax_name in pairs:
        if module is not None and hasattr(module, name):
            out.append((module, name))
            JAX_COUNTERPART[f"{label}.{name}"] = jax_name
    return out


_CONV = "lax.conv_general_dilated"

# -- low precision: the tensor-core ops (reference FP16_FUNCS) --------------

LOW_PRECISION_FUNCS = (
    _entries("torch", [
        ("matmul", "jnp.matmul"), ("mm", "lax.dot"),
        ("bmm", "lax.batch_matmul"), ("addmm", None), ("addbmm", None),
        ("baddbmm", None), ("addmv", None), ("addr", None),
        ("mv", "jnp.dot"), ("dot", "jnp.dot"), ("vdot", "jnp.vdot"),
        ("inner", "jnp.inner"), ("outer", "jnp.outer"),
        ("ger", "jnp.outer"), ("tensordot", "jnp.tensordot"),
        ("einsum", "jnp.einsum"), ("kron", "jnp.kron"),
        ("cross", "jnp.cross"), ("chain_matmul", "jnp.linalg.multi_dot"),
        ("conv1d", _CONV), ("conv2d", _CONV), ("conv3d", _CONV),
        ("conv_transpose1d", "lax.conv_transpose"),
        ("conv_transpose2d", "lax.conv_transpose"),
        ("conv_transpose3d", "lax.conv_transpose"),
        ("conv_tbc", _CONV), ("prelu", None),
    ])
    + _entries("torch.linalg", [
        ("matmul", "jnp.linalg.matmul"), ("multi_dot", "jnp.linalg.multi_dot"),
        ("vecdot", "jnp.linalg.vecdot"), ("cross", "jnp.cross"),
    ])
    + _entries("F", [
        ("linear", "lax.dot_general"), ("conv1d", _CONV), ("conv2d", _CONV),
        ("conv3d", _CONV), ("conv_transpose1d", "lax.conv_transpose"),
        ("conv_transpose2d", "lax.conv_transpose"),
        ("conv_transpose3d", "lax.conv_transpose"), ("conv_tbc", _CONV),
    ])
)



def _port_low_precision():
    """The port's own GEMM surfaces (the JAX file's
    ``_apex_low_precision``: the reference registers its fused MLP and
    dense ops on the FP16 list)."""
    out = []
    for label, names in (
            ("mlp", [("mlp", "apex_tpu.mlp.mlp")]),
            ("fused_dense", [
                ("fused_dense", "apex_tpu.fused_dense.fused_dense"),
                ("fused_dense_gelu_dense",
                 "apex_tpu.fused_dense.fused_dense_gelu_dense"),
                ("dense_no_bias", "apex_tpu.fused_dense.dense_no_bias")])):
        _MODULES[label] = importlib.import_module(f"apex_tpu_torch.{label}")
        out += _entries(label, names)
    return out


LOW_PRECISION_FUNCS += _port_low_precision()

# -- fp32: numerically sensitive ops (reference FP32_FUNCS) -----------------

FP32_FUNCS = (
    # pointwise transcendentals; sqrt/square stay OFF the list
    _entries("torch", [
        ("exp", "jnp.exp"), ("exp2", "jnp.exp2"), ("expm1", "jnp.expm1"),
        ("log", "jnp.log"), ("log10", "jnp.log10"), ("log2", "jnp.log2"),
        ("log1p", "jnp.log1p"), ("reciprocal", "jnp.reciprocal"),
        ("rsqrt", "lax.rsqrt"), ("sinh", "jnp.sinh"), ("cosh", "jnp.cosh"),
        ("tan", "jnp.tan"), ("acos", "jnp.arccos"), ("asin", "jnp.arcsin"),
        ("atan", "jnp.arctan"), ("acosh", "jnp.arccosh"),
        ("asinh", "jnp.arcsinh"), ("atanh", "jnp.arctanh"),
        ("arccos", "jnp.arccos"), ("arcsin", "jnp.arcsin"),
        ("arctan", "jnp.arctan"), ("arccosh", "jnp.arccosh"),
        ("arcsinh", "jnp.arcsinh"), ("arctanh", "jnp.arctanh"),
        ("atan2", "jnp.arctan2"), ("arctan2", "jnp.arctan2"),
        ("hypot", "jnp.hypot"), ("pow", "jnp.power"),
        ("logaddexp", "jnp.logaddexp"), ("logaddexp2", "jnp.logaddexp2"),
        ("sinc", "jnp.sinc"), ("deg2rad", "jnp.deg2rad"),
        ("rad2deg", "jnp.rad2deg"), ("angle", "jnp.angle"), ("i0", "jnp.i0"),
        ("erf", "lax.erf"), ("erfc", "lax.erfc"), ("erfinv", "lax.erf_inv"),
        ("lgamma", "lax.lgamma"), ("digamma", "lax.digamma"),
        ("polygamma", None), ("mvlgamma", None),
        ("xlogy", "jax.scipy.special.xlogy"),
        ("logit", "jax.scipy.special.logit"),
    ])
    # reductions and the mean/var family
    + _entries("torch", [
        ("sum", "jnp.sum"), ("prod", "jnp.prod"), ("mean", "jnp.mean"),
        ("nanmean", "jnp.nanmean"), ("std", "jnp.std"), ("var", "jnp.var"),
        ("std_mean", "jnp.std"), ("var_mean", "jnp.var"),
        ("median", "jnp.median"), ("nanmedian", "jnp.nanmedian"),
        ("quantile", "jnp.quantile"), ("nanquantile", "jnp.nanquantile"),
        ("nansum", "jnp.nansum"), ("cumsum", "jnp.cumsum"),
        ("cumprod", "jnp.cumprod"), ("logcumsumexp", "lax.cumlogsumexp"),
        ("trace", "jnp.trace"), ("trapezoid", "jnp.trapezoid"),
        ("trapz", "jnp.trapezoid"), ("cumulative_trapezoid", None),
        ("logsumexp", "jax.nn.logsumexp"), ("norm", "jnp.linalg.norm"),
        ("renorm", None), ("dist", None), ("cdist", None),
        ("softmax", "jax.nn.softmax"), ("log_softmax", "jax.nn.log_softmax"),
    ])
    + _entries("torch.linalg", [
        ("norm", "jnp.linalg.norm"), ("vector_norm", "jnp.linalg.norm"),
        ("matrix_norm", "jnp.linalg.norm"), ("cond", "jnp.linalg.cond"),
        ("det", "jnp.linalg.det"), ("slogdet", "jnp.linalg.slogdet"),
    ])
    # the softmax family, norm-like activations and the losses (reference
    # functional_overrides FP32)
    + _entries("F", [
        ("softmax", "jax.nn.softmax"), ("log_softmax", "jax.nn.log_softmax"),
        ("softmin", None), ("softplus", "jax.nn.softplus"),
        ("gelu", "jax.nn.gelu"), ("logsigmoid", "jax.nn.log_sigmoid"),
        ("celu", "jax.nn.celu"), ("elu", "jax.nn.elu"),
        ("selu", "jax.nn.selu"), ("softsign", "jax.nn.soft_sign"),
        ("mish", "jax.nn.mish"), ("layer_norm", "jax.nn.standardize"),
        ("group_norm", None), ("local_response_norm", None),
        ("normalize", None), ("cosine_similarity", "optax.cosine_similarity"),
        ("pdist", None),
        ("cross_entropy", "optax.softmax_cross_entropy_with_integer_labels"),
        ("nll_loss", None), ("poisson_nll_loss", None),
        ("gaussian_nll_loss", None), ("kl_div", "optax.kl_divergence"),
        ("l1_loss", None), ("mse_loss", "optax.squared_error"),
        ("smooth_l1_loss", "optax.huber_loss"),
        ("huber_loss", "optax.huber_loss"), ("soft_margin_loss", None),
        ("multilabel_soft_margin_loss", None),
        ("multilabel_margin_loss", None), ("multi_margin_loss", None),
        ("margin_ranking_loss", None),
        ("hinge_embedding_loss", "optax.hinge_loss"),
        ("cosine_embedding_loss", "optax.cosine_distance"),
        ("triplet_margin_loss", None),
        ("binary_cross_entropy_with_logits",
         "optax.sigmoid_binary_cross_entropy"),
        ("ctc_loss", None),
    ])
    + _entries("torch.special", [
        ("erf", "jax.scipy.special.erf"), ("erfc", "jax.scipy.special.erfc"),
        ("erfinv", "jax.scipy.special.erfinv"),
        ("gammaln", "jax.scipy.special.gammaln"),
        ("gammainc", "jax.scipy.special.gammainc"),
        ("gammaincc", "jax.scipy.special.gammaincc"),
        ("digamma", "jax.scipy.special.digamma"),
        ("psi", "jax.scipy.special.digamma"), ("polygamma", None),
        ("multigammaln", None), ("xlogy", "jax.scipy.special.xlogy"),
        ("xlog1py", "jax.scipy.special.xlog1py"),
        ("logsumexp", "jax.scipy.special.logsumexp"),
        ("logit", "jax.scipy.special.logit"),
        ("ndtr", "jax.scipy.special.ndtr"),
        ("ndtri", "jax.scipy.special.ndtri"),
        ("log_ndtr", "jax.scipy.special.log_ndtr"),
        ("entr", "jax.scipy.special.entr"),
        ("zeta", "jax.scipy.special.zeta"), ("sinc", "jnp.sinc"),
        ("i0", "jnp.i0"), ("exp2", "jnp.exp2"), ("expm1", "jnp.expm1"),
        ("log1p", "jnp.log1p"), ("softmax", "jax.nn.softmax"),
        ("log_softmax", "jax.nn.log_softmax"),
    ])
)


def _port_fp32():
    """The port's own loss (the JAX file lists ``apex_tpu``'s xentropy,
    which forces fp32 internally already, so O1 users see one policy)."""
    try:
        xent = importlib.import_module("apex_tpu_torch.contrib.xentropy")
    except ImportError:  # pragma: no cover
        return []
    _MODULES["xentropy"] = xent
    return _entries("xentropy", [(
        "softmax_cross_entropy_loss",
        "apex_tpu.contrib.xentropy.softmax_cross_entropy_loss")])


FP32_FUNCS += _port_fp32()

# -- promote: mixed-dtype n-ary ops (reference tensor_overrides CASTS) ------
# torch's promotion already yields the widest float dtype for every entry
# (bf16 + fp32 -> fp32), so autocast does NOT patch these; the list pins
# the parity surface and the tests assert the native behaviour matches the
# reference wrapper's.

PROMOTE_FUNCS = _entries("torch", [
    ("add", "jnp.add"), ("sub", "jnp.subtract"),
    ("subtract", "jnp.subtract"), ("mul", "jnp.multiply"),
    ("multiply", "jnp.multiply"), ("div", "jnp.divide"),
    ("divide", "jnp.divide"), ("true_divide", "jnp.true_divide"),
    ("floor_divide", "jnp.floor_divide"), ("remainder", "jnp.remainder"),
    ("fmod", "jnp.fmod"), ("eq", "jnp.equal"), ("ne", "jnp.not_equal"),
    ("gt", "jnp.greater"), ("ge", "jnp.greater_equal"), ("lt", "jnp.less"),
    ("le", "jnp.less_equal"), ("maximum", "jnp.maximum"),
    ("minimum", "jnp.minimum"), ("fmax", "jnp.fmax"), ("fmin", "jnp.fmin"),
    ("where", "jnp.where"), ("cat", "jnp.concatenate"),
    ("concatenate", "jnp.concatenate"), ("stack", "jnp.stack"),
    ("hstack", "jnp.hstack"), ("vstack", "jnp.vstack"),
    ("dstack", "jnp.dstack"), ("column_stack", "jnp.column_stack"),
    ("copysign", "jnp.copysign"), ("nextafter", "jnp.nextafter"),
    # jnp.ldexp takes only an integer exponent: no float x float twin
    ("ldexp", None), ("addcmul", None), ("addcdiv", None),
])

#: n-ary ops torch refuses on mixed float dtypes: patched with a cast of
#: their float arguments to the widest dtype among them
PROMOTE_CAST_FUNCS = (
    _entries("torch", [("heaviside", "jnp.heaviside"), ("lerp", None)])
    + _entries("F", [("bilinear", None)])
)

# reference functional_overrides.BANNED_FUNCS: ops that silently break
# under low precision. As in the JAX package the list is empty by default
# (F.binary_cross_entropy after a sigmoid is the user's to avoid).
BANNED_FUNCS = []
