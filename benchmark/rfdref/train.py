"""The reference train step: ISCNet's training forward in train mode,
its loss, backward, and Adam as optax computes it (moments, the bias
corrections 1 - b^t in f32, eps outside the square root; L2 weight decay
added to the gradient)."""

from __future__ import annotations

import torch


class Adam:
    """Adam over named parameters, one set of hyperparameters."""

    def __init__(self, named_params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.names = [n for n, _ in named_params]
        self.params = [p for _, p in named_params]
        self.betas, self.eps, self.weight_decay = betas, eps, weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.count += 1
        one = torch.ones((), dtype=torch.float32,
                         device=self.params[0].device)
        b1, b2 = self.betas
        for i, p in enumerate(self.params):
            g = p.grad
            if self.weight_decay:
                g = g + self.weight_decay * p
            self.mu[i] = (1 - b1) * g + b1 * self.mu[i]
            self.nu[i] = (1 - b2) * g ** 2 + b2 * self.nu[i]
            corr1 = 1 - (b1 * one) ** self.count
            corr2 = 1 - (b2 * one) ** self.count
            u = (self.mu[i] / corr1) / (torch.sqrt(self.nu[i] / corr2)
                                        + self.eps)
            p.add_((-lr * one) * u)


def trainable(model) -> list:
    """Every parameter of `model` set to take a gradient: [(name, p)]."""
    model.requires_grad_(True)
    return list(model.named_parameters())


def train_step(model, optimizer: Adam, batch: dict, lr: float,
               completion_weight: float, eps) -> dict:
    """Forward in train mode with the posterior noise `eps`, the loss
    terms, backward, Adam. Returns the loss terms, detached."""
    for p in optimizer.params:
        p.grad = None
    model.train()
    out = model(batch, eps=eps)
    losses = model.loss(out, batch, completion_weight)
    losses["total"].backward()
    optimizer.step(lr)
    return {k: v.detach() for k, v in losses.items()}
