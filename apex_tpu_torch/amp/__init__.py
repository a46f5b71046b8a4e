"""Mixed precision (counterpart of ``apex_tpu/amp``): the inference cast
and the loss scaler. The ``amp.initialize`` frontend, its op lists and
``handle.py`` are not ported yet (ROADMAP.md, queue A5)."""
from .frontend import cast_params_for_inference  # noqa: F401
from .scaler import LossScaler, LossScaleState  # noqa: F401
