"""A small MLP of nn.Linear layers and tanh-approximated GELU: the hook
test's fixture (the counterpart of gemmul8_tpu/models/mlp.py, whose
jax.nn.gelu is the tanh approximation by default). Its matmuls are
F.linear calls, which the interposer intercepts when installed."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..core import _device


class MLP(nn.Module):
    """sizes = [in, h1, ..., out]: Linear layers with GELU between them.
    Weights ~ N(0, 1) / sqrt(fan_in) from `seed`, biases zero, as the JAX
    fixture's init_params draws them (not its values). The weights are
    drawn on the CPU, so a seed gives the same model on every device. The
    module lives on `device`: the card unless the caller passes "cpu"."""

    def __init__(self, sizes, *, seed: int = 0, dtype=torch.float32,
                 device="cuda"):
        super().__init__()
        device = _device(device)
        gen = torch.Generator().manual_seed(seed)
        self.layers = nn.ModuleList()
        for din, dout in zip(sizes[:-1], sizes[1:]):
            layer = nn.Linear(din, dout, dtype=dtype, device=device)
            with torch.no_grad():
                layer.weight.copy_(torch.randn((dout, din), generator=gen,
                                               dtype=dtype)
                                   / float(np.sqrt(din)))
                layer.bias.zero_()
            self.layers.append(layer)
        self.act = nn.GELU(approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i + 1 < len(self.layers):
                x = self.act(x)
        return x


def from_jax_params(params, *, dtype=None, device="cuda") -> MLP:
    """The MLP holding a JAX fixture's [(W, b), ...] (W of shape (in, out),
    as numpy arrays) on `device`; nn.Linear stores W^T."""
    ws = [np.asarray(w) for w, _ in params]
    sizes = [ws[0].shape[0]] + [w.shape[1] for w in ws]
    dtype = dtype or torch.from_numpy(np.array(ws[0][:0])).dtype
    model = MLP(sizes, dtype=dtype, device=device)
    with torch.no_grad():
        for layer, (w, b) in zip(model.layers, params):
            layer.weight.copy_(torch.from_numpy(np.array(w).T))
            layer.bias.copy_(torch.from_numpy(np.array(b)))
    return model
