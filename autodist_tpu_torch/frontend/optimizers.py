"""Optimizers for the symbolic frontend, with optax's numerics in torch.

The counterpart of ``autodist_tpu/frontend/optimizers.py``, which wraps
optax transforms; the port cannot import optax, so each update rule is
written out here, step for step as optax computes it (the moment
updates ``(1 - decay) * g**k + decay * t``, bias corrections
``1 - decay**count`` in f32, the learning rate applied last as
``update * -lr``). Slot state is per variable, a dict of tensors shaped
like the variable (plus an integer step ``count`` where the rule has
one), so the strategy layer can shard it like the variable.

Capture is structural, as in the JAX package: constructing an optimizer
registers ``(class, args, kwargs)`` on the active graph, and
``apply_gradients`` records grad->target pairs.
"""
import itertools

import numpy as np
import torch

from autodist_tpu_torch.frontend import graph as fe

_UID = itertools.count()


def _bias_correction(decay, count):
    """``1 - decay**count`` in f32, as optax computes it."""
    return float(np.float32(1) - np.float32(decay) ** np.int32(count))


def _moment(g, t, decay, order):
    return (1 - decay) * g ** order + decay * t


class Optimizer:
    """An update rule applied per variable.

    Subclasses define ``init_leaf(value) -> state`` and
    ``update(grad, state, value) -> (update, new_state)``; the new value
    is ``value + update``.
    """

    # Row-lazy update (LazyAdam/LazyMomentum): for sparse-read 2-D
    # variables, apply the update ONLY to rows whose gradient is
    # nonzero, keeping untouched rows (weights and slot state) as they
    # are.
    lazy_rows = False

    def __init__(self, name=None, _capture=None):
        self.uid = 'opt_%d' % next(_UID)
        self.name = name or type(self).__name__
        g = fe.get_default_graph()
        g.optimizers.append(_capture or (type(self).__name__, (), {}))

    # -- symbolic API ------------------------------------------------------
    def apply_gradients(self, grads_and_vars):
        """Create the train-op node (records grad->target pairs)."""
        return fe.ApplyGradients(self, list(grads_and_vars))

    def minimize(self, loss, var_list=None):
        if var_list is None:
            var_list = [v for v in fe.get_default_graph().variables.values()
                        if v.trainable]
        grads = fe.gradients(loss, var_list)
        return self.apply_gradients(zip(grads, var_list))

    # -- the rule ----------------------------------------------------------
    def init_leaf(self, value):
        return {}

    def update(self, grad, state, value):
        raise NotImplementedError

    # -- state management (called by the Session) --------------------------
    def init_slot_state(self, variables, var_values):
        """Per-variable slot state: {var name: state}."""
        return {v.name: self.init_leaf(torch.as_tensor(var_values[v.name]))
                for v in variables}

    def _apply(self, grads_and_vars, env):
        """Evaluate the update. Returns {Variable: new value}.

        Gradients arriving as :class:`~autodist_tpu_torch.parallel.plan.
        ShardedGrad` update only the local (ZeRO) shard of the variable
        and its slot state; an ``UpdateShard`` (weight-update sharding)
        updates this replica's flat shard, re-gathered afterwards by the
        ApplyGradients evaluation.
        """
        from autodist_tpu_torch.parallel.plan import ShardedGrad
        slots = dict(env.opt_state.get(self.uid, {}))
        new_values = {}
        for grad, var in grads_and_vars:
            state = slots[var.name]
            if getattr(grad, 'is_update_shard', False):
                value = grad.slice_param(env.var_values[var.name])
                new_shard, slots[var.name] = self.shard_update(
                    grad.value, state, value, group=grad.plan.group)
                new_values[var] = grad.with_value(new_shard)
                continue
            if isinstance(grad, ShardedGrad):
                value = env.var_shards[var.name]
                update, new_state = self.update(grad.value, state, value)
            else:
                value = env.var_values[var.name]
                if self.lazy_rows and getattr(var, 'sparse_read', False) \
                        and grad.dim() == 2 and \
                        tuple(grad.shape) == tuple(value.shape):
                    new_values[var], slots[var.name] = \
                        self._lazy_row_update(grad, state, value)
                    continue
                update, new_state = self.update(grad, state, value)
            new_values[var] = value + update
            slots[var.name] = new_state
        env.opt_updates[self.uid] = slots
        return new_values

    def shard_update(self, grad, state, value, group=None):
        """Optimizer step over ONE weight-update shard. Exact for the
        elementwise rules; :class:`LAMB` overrides it."""
        update, new_state = self.update(grad, state, value)
        return value + update, new_state

    def _lazy_row_update(self, grad, state, value):
        """Row-masked update: rows with an all-zero gradient keep their
        weights and (same-shaped) slot state; scalar slots (the Adam
        step count) advance globally, as TF's LazyAdam."""
        mask = (grad != 0).any(dim=1, keepdim=True)
        update, new_state = self.update(grad, state, value)
        kept = {}
        for k, new in new_state.items():
            if torch.is_tensor(new) and new.shape == value.shape:
                new = torch.where(mask, new, state[k])
            kept[k] = new
        return torch.where(mask, value + update, value), kept


# -- the rules ---------------------------------------------------------------
class _Sgd:
    """optax.sgd: trace t = g + m*t (nesterov: g + m*t again), * -lr."""

    def _sgd_init(self, value):
        return {'trace': torch.zeros_like(value)} if self._momentum else {}

    def _sgd_update(self, grad, state):
        if not self._momentum:
            return grad * -self._lr, {}
        trace = grad + self._momentum * state['trace']
        u = grad + self._momentum * trace if self._nesterov else trace
        return u * -self._lr, {'trace': trace}


class SGD(_Sgd, Optimizer):
    """Plain / momentum / Nesterov SGD."""

    def __init__(self, learning_rate=0.01, momentum=0.0, nesterov=False,
                 name=None):
        super().__init__(name, _capture=(
            'SGD', (learning_rate,),
            {'momentum': momentum, 'nesterov': nesterov}))
        self._lr, self._momentum = learning_rate, momentum or 0.0
        self._nesterov = nesterov

    def init_leaf(self, value):
        return self._sgd_init(value)

    def update(self, grad, state, value):
        return self._sgd_update(grad, state)


GradientDescent = SGD


class Momentum(SGD):
    def __init__(self, learning_rate=0.01, momentum=0.9, **kw):
        super().__init__(learning_rate, momentum=momentum, **kw)


class _AdamRule:
    """optax.scale_by_adam (eps outside the sqrt; ``nesterov`` = Nadam)."""

    def _adam_init(self, value):
        return {'count': 0, 'mu': torch.zeros_like(value),
                'nu': torch.zeros_like(value)}

    def _adam_direction(self, grad, state):
        b1, b2 = self._b1, self._b2
        mu = _moment(grad, state['mu'], b1, 1)
        nu = _moment(grad, state['nu'], b2, 2)
        count = state['count'] + 1
        if self._nesterov:
            mu_hat = b1 * (mu / _bias_correction(b1, count + 1)) + \
                (1 - b1) * (grad / _bias_correction(b1, count))
        else:
            mu_hat = mu / _bias_correction(b1, count)
        nu_hat = nu / _bias_correction(b2, count)
        u = mu_hat / (torch.sqrt(nu_hat) + self._eps)
        return u, {'count': count, 'mu': mu, 'nu': nu}


class Adam(_AdamRule, Optimizer):
    _nesterov = False
    _wd = 0.0

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-7, name=None, _capture=None):
        super().__init__(name, _capture=_capture or (
            'Adam', (learning_rate,),
            {'beta_1': beta_1, 'beta_2': beta_2, 'epsilon': epsilon}))
        self._lr, self._b1, self._b2, self._eps = (learning_rate, beta_1,
                                                   beta_2, epsilon)

    def init_leaf(self, value):
        return self._adam_init(value)

    def update(self, grad, state, value):
        u, new_state = self._adam_direction(grad, state)
        if self._wd:
            u = u + self._wd * value
        return u * -self._lr, new_state


class LazyAdam(Adam):
    """Adam that updates ONLY rows with nonzero gradient on sparse-read
    (embedding) variables; dense variables get plain Adam. The step
    count is global, like TF's LazyAdam."""

    lazy_rows = True

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-7, name=None):
        super().__init__(learning_rate, beta_1, beta_2, epsilon, name,
                         _capture=('LazyAdam', (learning_rate,),
                                   {'beta_1': beta_1, 'beta_2': beta_2,
                                    'epsilon': epsilon}))


class LazyMomentum(_Sgd, Optimizer):
    """Momentum SGD with row-lazy updates on sparse-read variables."""

    lazy_rows = True
    _nesterov = False

    def __init__(self, learning_rate=0.01, momentum=0.9, name=None):
        super().__init__(name, _capture=('LazyMomentum', (learning_rate,),
                                         {'momentum': momentum}))
        self._lr, self._momentum = learning_rate, momentum or 0.0

    def init_leaf(self, value):
        return self._sgd_init(value)

    def update(self, grad, state, value):
        return self._sgd_update(grad, state)


class AdamW(Adam):
    def __init__(self, learning_rate=0.001, weight_decay=0.01, beta_1=0.9,
                 beta_2=0.999, epsilon=1e-7, name=None):
        super().__init__(learning_rate, beta_1, beta_2, epsilon, name,
                         _capture=('AdamW', (learning_rate,),
                                   {'weight_decay': weight_decay}))
        self._wd = weight_decay


class Nadam(Adam):
    """Adam with Nesterov momentum (optax.nadam)."""

    _nesterov = True

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-7, name=None):
        super().__init__(learning_rate, beta_1, beta_2, epsilon, name,
                         _capture=('Nadam', (learning_rate,),
                                   {'beta_1': beta_1, 'beta_2': beta_2}))


class Adagrad(Optimizer):
    """optax.adagrad: sum of squares from ``initial_accumulator_value``,
    update g * rsqrt(sum + eps) where the sum is positive."""

    def __init__(self, learning_rate=0.001, initial_accumulator_value=0.1,
                 epsilon=1e-7, name=None):
        super().__init__(name, _capture=('Adagrad', (learning_rate,), {}))
        self._lr, self._acc0, self._eps = (learning_rate,
                                           initial_accumulator_value,
                                           epsilon)

    def init_leaf(self, value):
        return {'sum_of_squares': torch.full_like(value, self._acc0)}

    def update(self, grad, state, value):
        sos = grad * grad + state['sum_of_squares']
        inv = torch.where(sos > 0, torch.rsqrt(sos + self._eps),
                          torch.zeros_like(sos))
        return (inv * grad) * -self._lr, {'sum_of_squares': sos}


class RMSProp(_Sgd, Optimizer):
    """optax.rmsprop: nu = (1-rho) g^2 + rho nu, g * rsqrt(nu + eps),
    times -lr, then the momentum trace (optax's order)."""

    _nesterov = False

    def __init__(self, learning_rate=0.001, rho=0.9, momentum=0.0,
                 epsilon=1e-7, name=None):
        super().__init__(name, _capture=('RMSProp', (learning_rate,),
                                         {'rho': rho, 'momentum': momentum}))
        self._lr, self._rho, self._eps = learning_rate, rho, epsilon
        self._momentum = momentum or 0.0

    def init_leaf(self, value):
        state = {'nu': torch.zeros_like(value)}
        if self._momentum:
            state['trace'] = torch.zeros_like(value)
        return state

    def update(self, grad, state, value):
        nu = _moment(grad, state['nu'], self._rho, 2)
        u = (torch.rsqrt(nu + self._eps) * grad) * -self._lr
        if not self._momentum:
            return u, {'nu': nu}
        trace = u + self._momentum * state['trace']
        return trace, {'nu': nu, 'trace': trace}


class Adadelta(Optimizer):
    """optax.adadelta."""

    def __init__(self, learning_rate=0.001, rho=0.95, epsilon=1e-7,
                 name=None):
        super().__init__(name, _capture=('Adadelta', (learning_rate,), {}))
        self._lr, self._rho, self._eps = learning_rate, rho, epsilon

    def init_leaf(self, value):
        return {'e_g': torch.zeros_like(value),
                'e_x': torch.zeros_like(value)}

    def update(self, grad, state, value):
        e_g = _moment(grad, state['e_g'], self._rho, 2)
        u = (torch.sqrt(state['e_x'] + self._eps) /
             torch.sqrt(e_g + self._eps)) * grad
        e_x = _moment(u, state['e_x'], self._rho, 2)
        return u * -self._lr, {'e_g': e_g, 'e_x': e_x}


class Adamax(Optimizer):
    """optax.adamax: infinity-norm second moment, no bias correction
    of it."""

    def __init__(self, learning_rate=0.001, beta_1=0.9, beta_2=0.999,
                 epsilon=1e-7, name=None):
        super().__init__(name, _capture=('Adamax', (learning_rate,), {}))
        self._lr, self._b1, self._b2, self._eps = (learning_rate, beta_1,
                                                   beta_2, epsilon)

    def init_leaf(self, value):
        return {'count': 0, 'mu': torch.zeros_like(value),
                'nu': torch.zeros_like(value)}

    def update(self, grad, state, value):
        count = state['count'] + 1
        mu = _moment(grad, state['mu'], self._b1, 1)
        nu = torch.maximum(grad.abs() + self._eps, self._b2 * state['nu'])
        u = (mu / _bias_correction(self._b1, count)) / nu
        return u * -self._lr, {'count': count, 'mu': mu, 'nu': nu}


class Ftrl(Optimizer):
    """FTRL-proximal (TF keras Ftrl semantics), with the l1 shrinkage
    that zeroes small weights."""

    def __init__(self, learning_rate=0.001, learning_rate_power=-0.5,
                 initial_accumulator_value=0.1,
                 l1_regularization_strength=0.0,
                 l2_regularization_strength=0.0, beta=0.0, name=None):
        super().__init__(name, _capture=(
            'Ftrl', (learning_rate,),
            {'l1': l1_regularization_strength,
             'l2': l2_regularization_strength}))
        self._lr, self._power = learning_rate, learning_rate_power
        self._acc0 = initial_accumulator_value
        self._l1, self._l2 = (l1_regularization_strength,
                              l2_regularization_strength)
        self._beta = beta

    def init_leaf(self, value):
        return {'n': torch.full_like(value, self._acc0),
                'z': torch.zeros_like(value)}

    def update(self, grad, state, value):
        n, z = state['n'], state['z']
        n_new = n + grad * grad
        p = -self._power
        pow_old, pow_new = n ** p, n_new ** p
        sigma = (pow_new - pow_old) / self._lr
        z_new = z + grad - sigma * value
        denom = (self._beta + pow_new) / self._lr + 2.0 * self._l2
        w_new = torch.where(
            z_new.abs() <= self._l1, torch.zeros_like(z_new),
            -(z_new - torch.sign(z_new) * self._l1) / denom)
        return w_new - value, {'n': n_new, 'z': z_new}


class LAMB(_AdamRule, Optimizer):
    """Layer-wise adaptive optimizer (optax.lamb): the Adam direction
    plus weight decay, scaled by ||param|| / ||update|| per variable."""

    _nesterov = False

    def __init__(self, learning_rate=0.001, weight_decay=0.0, beta_1=0.9,
                 beta_2=0.999, epsilon=1e-6, name=None):
        super().__init__(name, _capture=('LAMB', (learning_rate,),
                                         {'weight_decay': weight_decay}))
        self._lr, self._wd = learning_rate, weight_decay
        self._b1, self._b2, self._eps = beta_1, beta_2, epsilon

    def init_leaf(self, value):
        return self._adam_init(value)

    def _direction(self, grad, state, value):
        u, new_state = self._adam_direction(grad, state)
        if self._wd:
            u = u + self._wd * value
        return u, new_state

    @staticmethod
    def _scaled(u, p_norm, u_norm):
        # optax scale_by_trust_ratio: zero param or update norm -> 1
        zero = (p_norm == 0.0) | (u_norm == 0.0)
        ratio = torch.where(zero, torch.ones_like(p_norm), p_norm / u_norm)
        return u * ratio

    def update(self, grad, state, value):
        u, new_state = self._direction(grad, state, value)
        u = self._scaled(u, torch.linalg.vector_norm(value),
                         torch.linalg.vector_norm(u))
        return u * -self._lr, new_state

    def shard_update(self, grad, state, value, group=None):
        """Shard-local LAMB step: both norms from a sum of the shards'
        squared sums over the group (the zero-padded tail adds 0)."""
        if group is None:
            return super().shard_update(grad, state, value)
        u, new_state = self._direction(grad, state, value)
        sq = group.all_reduce(torch.stack([(value * value).sum(),
                                           (u * u).sum()]))
        u = self._scaled(u, torch.sqrt(sq[0]), torch.sqrt(sq[1]))
        return value + u * -self._lr, new_state
