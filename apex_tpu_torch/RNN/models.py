"""Stacked, optionally bidirectional RNN models over the cells
(counterpart of ``apex_tpu/RNN/models.py``).

The factories ``LSTM``, ``GRU``, ``ReLU``, ``Tanh`` and ``mLSTM`` return a
model whose ``init(generator, device=None)`` draws the parameter tree
(``{"layers": [[cell params per direction] per layer], "proj": [out,
h*dirs]}``, the JAX package's) and whose ``__call__(params, x,
initial_state=None, dropout_key=None)`` returns ``(outputs, finals)``.
Inputs are sequence-major ``[seq, batch, feature]`` unless
``batch_first``; each layer is a loop over time, the reverse direction
runs over the time-flipped input and flips its outputs back. Dropout
between layers draws its keep-mask from ``dropout_key``, a
``torch.Generator`` (the JAX package's PRNG key's place), so the two
packages agree exactly at dropout 0.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

import torch

from .._device import resolve_device
from . import cells as _cells

Tree = Any


class _RNNModel:
    """The reference's ``RNNBackend.stackedRNN``."""

    def __init__(self, cell: Callable, gates: int, input_size: int,
                 hidden_size: int, num_layers: int, bias: bool = True,
                 batch_first: bool = False, dropout: float = 0.0,
                 bidirectional: bool = False,
                 output_size: Optional[int] = None, is_lstm: bool = False,
                 multiplicative: bool = False):
        self.cell = cell
        self.gates = gates
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.batch_first = batch_first
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.output_size = output_size
        self.is_lstm = is_lstm
        self.multiplicative = multiplicative

    def _cell_params(self, gen, dev, in_size) -> Dict[str, torch.Tensor]:
        k = 1.0 / math.sqrt(self.hidden_size)
        g = self.gates * self.hidden_size

        def u(*shape):
            t = torch.empty(shape, device=gen.device)
            return t.uniform_(-k, k, generator=gen).to(dev)

        p = {"w_ih": u(g, in_size), "w_hh": u(g, self.hidden_size)}
        if self.bias:
            p["b_ih"] = u(g)
            p["b_hh"] = u(g)
        if self.multiplicative:
            p["w_mih"] = u(self.hidden_size, in_size)
            p["w_mhh"] = u(self.hidden_size, self.hidden_size)
        return p

    def init(self, generator: torch.Generator, device=None) -> Tree:
        """Parameters ``uniform(-1/sqrt(h), 1/sqrt(h))`` (the projection
        ``normal / sqrt(h * dirs)``), drawn on ``generator`` and placed on
        ``device`` (None: the card)."""
        dev = resolve_device(device)
        dirs = 2 if self.bidirectional else 1
        layers = []
        for layer in range(self.num_layers):
            in_size = (self.input_size if layer == 0
                       else self.hidden_size * dirs)
            layers.append([self._cell_params(generator, dev, in_size)
                           for _ in range(dirs)])
        out = {"layers": layers}
        if self.output_size is not None:
            w = torch.empty(self.output_size, self.hidden_size * dirs,
                            device=generator.device).normal_(
                generator=generator)
            out["proj"] = (w / math.sqrt(self.hidden_size * dirs)).to(dev)
        return out

    def _zero_state(self, batch, like):
        h = torch.zeros(batch, self.hidden_size, dtype=like.dtype,
                        device=like.device)
        return (h, torch.zeros_like(h)) if self.is_lstm else h

    def _run_dir(self, cell_params, x, reverse: bool, init_state=None):
        if reverse:
            x = torch.flip(x, dims=(0,))
        state = self._zero_state(x.shape[1], x) if init_state is None \
            else init_state
        outs = []
        for xt in x:
            state = self.cell(cell_params, xt, state)
            outs.append(state[0] if self.is_lstm else state)
        outs = torch.stack(outs)
        if reverse:
            outs = torch.flip(outs, dims=(0,))
        return outs, state

    def __call__(self, params: Tree, x: torch.Tensor, initial_state=None,
                 dropout_key: Optional[torch.Generator] = None):
        """``initial_state``: per layer a state ((h, c) for the LSTMs;
        (forward, backward) pairs when bidirectional); None: zeros."""
        if self.batch_first:
            x = x.transpose(0, 1)
        finals = []
        h = x
        for layer, layer_params in enumerate(params["layers"]):
            layer_init = (initial_state[layer] if initial_state is not None
                          else None)
            init_f = init_b = None
            if layer_init is not None:
                init_f, init_b = (layer_init if self.bidirectional
                                  else (layer_init, None))
            outs_f, fin_f = self._run_dir(layer_params[0], h, False, init_f)
            if self.bidirectional:
                outs_b, fin_b = self._run_dir(layer_params[1], h, True,
                                              init_b)
                h = torch.cat([outs_f, outs_b], dim=-1)
                finals.append((fin_f, fin_b))
            else:
                h = outs_f
                finals.append(fin_f)
            if (self.dropout > 0 and dropout_key is not None
                    and layer < self.num_layers - 1):
                keep = torch.empty(h.shape, device=h.device).bernoulli_(
                    1 - self.dropout, generator=dropout_key).bool()
                h = torch.where(keep, h / (1 - self.dropout),
                                torch.zeros((), dtype=h.dtype,
                                            device=h.device))
        if "proj" in params:
            h = torch.matmul(h, params["proj"].t())
        if self.batch_first:
            h = h.transpose(0, 1)
        return h, finals


def _factory(cell, gates, is_lstm=False, multiplicative=False):
    def make(input_size, hidden_size, num_layers, bias=True,
             batch_first=False, dropout=0.0, bidirectional=False,
             output_size=None):
        return _RNNModel(cell, gates, input_size, hidden_size, num_layers,
                         bias, batch_first, dropout, bidirectional,
                         output_size, is_lstm=is_lstm,
                         multiplicative=multiplicative)
    return make


# the reference's factories (apex/RNN/models.py:21-56)
LSTM = _factory(_cells.LSTMCell, 4, is_lstm=True)
GRU = _factory(_cells.GRUCell, 3)
ReLU = _factory(_cells.RNNReLUCell, 1)
Tanh = _factory(_cells.RNNTanhCell, 1)
mLSTM = _factory(_cells.mLSTMCell, 4, is_lstm=True, multiplicative=True)
RNN = Tanh  # the reference's RNN is tanh
