"""Adam's moments as optax keeps them, for the optimizers built on them:
m = b1 m + (1 - b1) g, v = b2 v + (1 - b2) g^2, each bias-corrected by
the step count before ``update`` uses it."""
import torch


class Moments:
    def __init__(self, o):
        self.o = o
        self.t = 0
        self.m, self.v = {}, {}

    @torch.no_grad()
    def step(self, params, grads):
        o = self.o
        self.t += 1
        b1, b2 = o['b1'], o['b2']
        for k, p in params.items():
            g = grads[k]
            m = self.m.setdefault(k, torch.zeros_like(p))
            v = self.v.setdefault(k, torch.zeros_like(p))
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * g * (1 - b2))
            self.update(p, m / (1 - b1 ** self.t), v / (1 - b2 ** self.t))

    def update(self, p, m_hat, v_hat):
        raise NotImplementedError
