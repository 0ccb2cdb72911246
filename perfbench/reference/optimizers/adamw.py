"""``optax.adamw``: p -= lr (m_hat / (sqrt(v_hat) + eps) + wd p)."""
from perfbench.reference.optim import Moments


class Plain(Moments):
    def update(self, p, m_hat, v_hat):
        o = self.o
        p.sub_(o['learning_rate'] * (m_hat / (v_hat.sqrt() + o['eps']) +
                                     o['weight_decay'] * p))
