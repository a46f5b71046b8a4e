"""The deprecated RNN backend (counterpart of ``apex_tpu/RNN``): the cells
as functions over parameter dicts and the stacked, bidirectional models."""
from .cells import (  # noqa: F401
    GRUCell,
    LSTMCell,
    RNNReLUCell,
    RNNTanhCell,
    mLSTMCell,
)
from .models import GRU, LSTM, ReLU, RNN, Tanh, mLSTM  # noqa: F401
