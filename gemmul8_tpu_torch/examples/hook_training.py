"""Train a small MLP with EVERY matmul (forward and backward) routed through
the emulator by the interposer: bitwise-reproducible training (the port of
examples/hook_training.py).

Analog of the reference's LD_PRELOAD hook use case (README.md:258-268,
src/hook.cu): an unmodified training loop gains reproducible high-precision
GEMMs. Inside gemmul8_tpu_torch.emulate the nn.Linear products run through
an autograd Function, so the gradient GEMMs are emulated too. The initial
weights and the batch are the JAX script's default_rng(0) draws.

    python -m gemmul8_tpu_torch.examples.hook_training [--device cpu]
"""
import numpy as np
import torch
from torch import nn

import gemmul8_tpu_torch as gt

from . import cli, device_of, to_numpy


class MLP(nn.Module):
    """32 -> 64 -> 8, tanh between, no biases: tanh(x W1^T) W2^T."""

    def __init__(self, w1: np.ndarray, w2: np.ndarray, device):
        super().__init__()
        self.fc1 = nn.Linear(*w1.shape, bias=False, dtype=torch.float32,
                             device=device)
        self.fc2 = nn.Linear(*w2.shape, bias=False, dtype=torch.float32,
                             device=device)
        with torch.no_grad():         # nn.Linear stores W^T
            self.fc1.weight.copy_(torch.from_numpy(w1.T.copy()))
            self.fc2.weight.copy_(torch.from_numpy(w2.T.copy()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.tanh(self.fc1(x)))


def main(device=None) -> dict:
    device = device_of(device)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((64, 32)).astype(
        np.float32)).to(device)
    yb = torch.from_numpy(rng.standard_normal((64, 8)).astype(
        np.float32)).to(device)
    w1 = (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((64, 8)) * 0.1).astype(np.float32)

    def loss(model):
        return torch.mean((model(xb) - yb) ** 2)

    def train():
        model = MLP(w1, w2, device)
        for _ in range(20):
            model.zero_grad()
            loss(model).backward()
            with torch.no_grad():             # plain SGD, lr 0.1
                for p in model.parameters():
                    p.sub_(0.1 * p.grad)
        with torch.no_grad():
            return float(loss(model)), [to_numpy(p) for p in
                                        model.parameters()]

    with gt.emulate(num_moduli=8) as mode:
        l1, p1 = train()
        l2, p2 = train()

    same = all(np.array_equal(a, b) for a, b in zip(p1, p2))
    print(f"final loss: {l1:.6f}; two runs bit-identical: {same}")
    print(f"products intercepted: {mode.intercepted}")
    assert same, "training must be bitwise reproducible under the hook"
    assert mode.intercepted > 0
    print("OK")
    # the weights as the JAX script keeps them: w1 (32, 64), w2 (64, 8)
    return dict(loss=l1, loss2=l2, w1=p1[0].T, w2=p1[1].T, w1_2=p2[0].T,
                w2_2=p2[1].T, same=same, intercepted=mode.intercepted)


if __name__ == "__main__":
    cli(main)
