"""apex_tpu_torch.amp: mixed-precision training (counterpart of
``apex_tpu/amp``).

The O0-O3 opt-level presets and ``initialize`` (``frontend.py``), a
dynamic loss scaler with hysteresis (``scaler.py``), the O1 per-op
autocast that patches the listed ``torch``, ``torch.linalg``,
``torch.nn.functional`` and ``torch.special`` attributes while its
context is open (``amp.py``, ``lists/torch_overrides.py``), the
functional loss-scaled value-and-grad (``handle.py``), and the one-shot
inference cast the serving engine uses.
"""
from .amp import (  # noqa: F401
    autocast,
    disable_casts,
    register_bf16_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from .frontend import (  # noqa: F401
    Properties,
    cast_params_for_inference,
    initialize,
    load_state_dict,
    opt_levels,
    state_dict,
)
from .handle import (  # noqa: F401
    apply_updates_skip_on_overflow,
    scale_loss,
    scaled_value_and_grad,
)
from .scaler import LossScaler, LossScaleState  # noqa: F401
