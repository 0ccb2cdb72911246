"""``optax.lamb``: u = m_hat / (sqrt(v_hat + eps_root) + eps) + wd p,
then p -= lr r u with r = ||p|| / ||u|| per leaf (1 where either is
0)."""
from perfbench.reference.optim import Moments


class Plain(Moments):
    def update(self, p, m_hat, v_hat):
        o = self.o
        u = m_hat / ((v_hat + o.get('eps_root', 0.0)).sqrt() + o['eps']) \
            + o['weight_decay'] * p
        pn, un = p.norm(), u.norm()
        r = pn / un if float(pn) > 0 and float(un) > 0 else 1.0
        p.sub_(o['learning_rate'] * r * u)
