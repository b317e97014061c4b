"""Recurrent layers (counterpart of ``paddle_tpu/nn/layer/rnn.py``;
parity: python/paddle/nn/layer/rnn.py — SimpleRNN, LSTM, GRU with
``num_layers``, ``direction`` and ``time_major``).

The JAX layout: ``weight_ih_l{n}[_rev]`` ``[in, g * h]`` and
``weight_hh_l{n}[_rev]`` ``[h, g * h]`` (the transpose of
``torch.nn.LSTM``'s), zero biases, and Paddle's gate orders (LSTM i, f,
c, o; GRU r, u, c, the candidate ``tanh(xc + r * hc)`` with ``b_hh``
inside ``hc``). The input projection of every step is one matmul
before the time loop, as in JAX; the loop itself is plain torch, a step
at a time, on the card too.

Dtypes: the carry starts in float32, as JAX's does, and each matmul
promotes its operands as ``jnp.matmul`` does (torch's refuses mixed
dtypes), so a bf16 layer runs its recurrence in float32 and returns
float32 outputs and states, as the JAX layer does.
"""

from __future__ import annotations

import torch

from ...core import initializer as I
from ...core.device import current_device
from ...core.module import Layer
from ...core.random import default_generator
from ..functional.common import linear

__all__ = ["SimpleRNN", "LSTM", "GRU"]


class _RNNBase(Layer):
    GATES = 1  # the gates of a cell: 1 rnn, 4 lstm, 3 gru

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1, direction: str = "forward",
                 time_major: bool = False, weight_attr=None, *,
                 device=None, generator=None):
        super().__init__()
        if direction not in ("forward", "bidirect", "bidirectional"):
            raise ValueError(f"unknown direction {direction!r}")
        device = current_device(device)
        gen = generator if generator is not None else default_generator(
            device)
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bidirectional = direction != "forward"
        self.time_major = time_major
        ndir = 2 if self.bidirectional else 1
        g = self.GATES
        init = weight_attr or I.XavierUniform()
        kw = dict(device=device, generator=gen)
        for lyr in range(num_layers):
            in_sz = input_size if lyr == 0 else hidden_size * ndir
            for d in range(ndir):
                sfx = f"_l{lyr}" + ("_rev" if d else "")
                setattr(self, f"weight_ih{sfx}", self.create_parameter(
                    (in_sz, g * hidden_size), default_initializer=init, **kw))
                setattr(self, f"weight_hh{sfx}", self.create_parameter(
                    (hidden_size, g * hidden_size), default_initializer=init,
                    **kw))
                setattr(self, f"bias_ih{sfx}", self.create_parameter(
                    (g * hidden_size,), is_bias=True, **kw))
                setattr(self, f"bias_hh{sfx}", self.create_parameter(
                    (g * hidden_size,), is_bias=True, **kw))

    # the cell: (carry, projected input of one step) -> (carry, h_t)
    def _cell(self, carry, xp, w_hh, b_hh):
        raise NotImplementedError

    def _init_carry(self, x):
        return x.new_zeros((x.shape[0], self.hidden_size),
                           dtype=torch.float32)

    def _carry_from_states(self, initial_states, idx):
        """One (layer, direction)'s slice of the ``[layers * ndir, b, h]``
        state stack."""
        if initial_states is None:
            return None
        return initial_states[idx]

    def _run_dir(self, x, sfx, reverse: bool, carry=None):
        # x: [b, s, in], batch first inside
        w_hh = getattr(self, f"weight_hh{sfx}")
        b_hh = getattr(self, f"bias_hh{sfx}")
        # the input projection of every step at once: [b, s, g * h]
        xp = linear(x, getattr(self, f"weight_ih{sfx}"),
                    getattr(self, f"bias_ih{sfx}"))
        if carry is None:
            carry = self._init_carry(x)
        steps = range(x.shape[1] - 1, -1, -1) if reverse \
            else range(x.shape[1])
        hs = [None] * x.shape[1]
        for t in steps:
            carry, hs[t] = self._cell(carry, xp[:, t], w_hh, b_hh)
        return torch.stack(hs, dim=1), carry  # [b, s, h], carry

    def forward(self, x, initial_states=None):
        if self.time_major:
            x = x.transpose(0, 1)
        ndir = 2 if self.bidirectional else 1
        lasts = []
        out = x
        for lyr in range(self.num_layers):
            c0 = self._carry_from_states(initial_states, lyr * ndir)
            fwd, last_f = self._run_dir(out, f"_l{lyr}", reverse=False,
                                        carry=c0)
            if self.bidirectional:
                c1 = self._carry_from_states(initial_states, lyr * ndir + 1)
                bwd, last_b = self._run_dir(out, f"_l{lyr}_rev",
                                            reverse=True, carry=c1)
                out = torch.cat([fwd, bwd], dim=-1)
                lasts.extend([last_f, last_b])
            else:
                out = fwd
                lasts.append(last_f)
        if self.time_major:
            out = out.transpose(0, 1)
        return out, self._stack_states(lasts)

    def _stack_states(self, lasts):
        return torch.stack(lasts, dim=0)  # [layers * ndir, b, h]


class SimpleRNN(_RNNBase):
    """The Elman RNN, tanh (or relu)."""

    GATES = 1

    def __init__(self, *args, activation: str = "tanh", **kw):
        super().__init__(*args, **kw)
        self.activation = torch.tanh if activation == "tanh" else torch.relu

    def _cell(self, h, xp, w_hh, b_hh):
        h = self.activation(xp + linear(h, w_hh) + b_hh)
        return h, h


class LSTM(_RNNBase):
    GATES = 4  # i, f, g (cell), o: Paddle's order (i, f, c, o)

    def _init_carry(self, x):
        z = super()._init_carry(x)
        return (z, z)

    def _carry_from_states(self, initial_states, idx):
        if initial_states is None:
            return None
        h, c = initial_states
        return (h[idx], c[idx])

    def _cell(self, carry, xp, w_hh, b_hh):
        h, c = carry
        z = xp + linear(h, w_hh) + b_hh
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h

    def _stack_states(self, lasts):
        hs = torch.stack([h for h, _ in lasts], dim=0)
        cs = torch.stack([c for _, c in lasts], dim=0)
        return (hs, cs)


class GRU(_RNNBase):
    GATES = 3  # r (reset), u (update), c (candidate): Paddle's order

    def _cell(self, h, xp, w_hh, b_hh):
        hp = linear(h, w_hh, b_hh)
        xr, xu, xc = torch.chunk(xp, 3, dim=-1)
        hr, hu, hc = torch.chunk(hp, 3, dim=-1)
        r = torch.sigmoid(xr + hr)
        u = torch.sigmoid(xu + hu)
        c = torch.tanh(xc + r * hc)
        h = u * h + (1 - u) * c
        return h, h
