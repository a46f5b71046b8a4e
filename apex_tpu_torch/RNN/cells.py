"""RNN cells (counterpart of ``apex_tpu/RNN/cells.py``): plain functions
``cell(params, x, state) -> state``.

Parameters a cell: ``w_ih [gates*h, in]``, ``w_hh [gates*h, h]``,
optional ``b_ih`` / ``b_hh``; the mLSTM adds ``w_mih [h, in]`` and
``w_mhh [h, h]``. Gate orders are torch's: LSTM i, f, g, o; GRU r, z, n.
Each linear map is a matmul and then the bias add, two roundings, as the
JAX package's einsum and add.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _linear(x, w, b):
    y = torch.matmul(x, w.t())
    return y + b if b is not None else y


def RNNReLUCell(params, x, h):
    """``h' = relu(W_ih x + b_ih + W_hh h + b_hh)``."""
    return torch.relu(_linear(x, params["w_ih"], params.get("b_ih"))
                      + _linear(h, params["w_hh"], params.get("b_hh")))


def RNNTanhCell(params, x, h):
    return torch.tanh(_linear(x, params["w_ih"], params.get("b_ih"))
                      + _linear(h, params["w_hh"], params.get("b_hh")))


def _lstm_tail(gates, c):
    i, f, g, o = torch.chunk(gates, 4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c2 = f * c + i * g
    return torch.tanh(c2) * o, c2


def LSTMCell(params, x, state: Tuple[torch.Tensor, torch.Tensor]):
    """``(h, c) -> (h', c')``."""
    h, c = state
    gates = _linear(x, params["w_ih"], params.get("b_ih")) + _linear(
        h, params["w_hh"], params.get("b_hh"))
    return _lstm_tail(gates, c)


def GRUCell(params, x, h):
    gi = _linear(x, params["w_ih"], params.get("b_ih"))
    gh = _linear(h, params["w_hh"], params.get("b_hh"))
    i_r, i_z, i_n = torch.chunk(gi, 3, dim=-1)
    h_r, h_z, h_n = torch.chunk(gh, 3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1 - z) * n + z * h


def mLSTMCell(params, x, state: Tuple[torch.Tensor, torch.Tensor]):
    """The multiplicative LSTM: the hidden state is modulated by ``m =
    (W_mih x) * (W_mhh h)`` before the gates."""
    h, c = state
    m = _linear(x, params["w_mih"], None) * _linear(h, params["w_mhh"], None)
    gates = _linear(x, params["w_ih"], params.get("b_ih")) + _linear(
        m, params["w_hh"], params.get("b_hh"))
    return _lstm_tail(gates, c)
