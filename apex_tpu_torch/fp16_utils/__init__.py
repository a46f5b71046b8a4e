"""Legacy manual mixed-precision utilities (counterpart of
``apex_tpu/fp16_utils``; reference ``apex/fp16_utils/``)."""
from .fp16_optimizer import FP16_Optimizer  # noqa: F401
from .fp16util import (  # noqa: F401
    FP16Model,
    convert_network,
    master_params_to_model_params,
    model_grads_to_master_grads,
    network_to_half,
    prep_param_lists,
    to_python_float,
    tofp16,
)
from .loss_scaler import (  # noqa: F401
    DynamicLossScaler,
    LossScaler,
    nonfinite_leaves,
)
