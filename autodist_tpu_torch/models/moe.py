"""Mixture-of-experts MLP for the port.

The counterpart of ``autodist_tpu/models/moe.py``: the Switch/GShard
dense-dispatch formulation. A router in f32 picks the top-k experts of
each token; a token's place in its expert's buffer is a cumulative count
over the sequence's (token, choice) order, and a token past the
expert's capacity is dropped. Dispatch and combine are dense
``[b, s, e, cap]`` tensors in the model dtype, contracted with the
activations in four einsums, so every expert's work has a static shape.
The load-balance loss (Switch eq. 4, ``e * sum_e f_e * P_e``, where
``f`` counts first choices only) is returned beside the output.

Data parallelism: the JAX package's ``f`` is a mean over the global
batch. Each rank here holds a slice, so ``f`` is averaged over the
data-parallel group of the step (:func:`core.mean_over_batch`, a
constant: it comes from a one-hot), and each rank differentiates
``e * sum f_global * P_rank``; the Trainer's mean over the ranks is
then the JAX value, with its gradients. Under sequence parallelism
that group is the data axis alone: ``f`` and ``P`` are the rank's seq
slice's, over the global batch, as GSPMD computes them inside the JAX
step's manual seq region, and the Trainer's mean over the whole grid
is then the JAX ``pmean`` of the aux over the seq axis.

Dispatch and combine are built as ``[b, s, e, cap]`` by one contraction
over the k choices each (a token's k choices name k different experts,
so at most one term of each sum is nonzero and the values are the JAX
package's bit for bit), without the ``[b, s, k, e, cap]`` products the
JAX code forms first.

Expert and tensor parallelism: rank e of a live expert group holds
experts ``[e · E / ep, (e + 1) · E / ep)`` of ``up`` and ``down``, and
under a live model axis each rank of the model group holds its slice of
those experts' ``mlp`` dim, so one leaf may be sharded on two dims over
two groups. Every rank of the expert x model group sees the same tokens
(the JAX batch rides the data axis alone), so the routing runs
replicated, the activations and the gate values enter the rank's
experts through :func:`mesh.copy_to` over that group (its backward sums
the gradients the other ranks' experts give the router and the input),
dispatch and combine are built for the local experts only, and the
output is the local experts' partial sum, reduced over the group
(:func:`mesh.reduce_from`). No all-to-all is needed: that is what the
JAX layout computes. The aux loss comes from replicated values and
stays as it is.
"""
import torch
import torch.nn.functional as F

from autodist_tpu_torch.models.core import (Dense, Module, ParamDef,
                                            live_spec, mean_over_batch,
                                            mesh_group)
from autodist_tpu_torch.parallel.mesh import copy_to, reduce_from
from autodist_tpu_torch.telemetry import core as _telemetry
from autodist_tpu_torch.utils.device import resolve_device


class MoeMlp(Module):
    """Top-k routed expert MLP. Input/output: [batch, seq, dim]; ``apply``
    returns ``(y, aux)``."""

    def __init__(self, dim, hidden, n_experts, top_k=2, capacity_factor=2.0,
                 dtype=torch.float32, device=None, stack=()):
        super().__init__(stack)
        self.dim, self.hidden = dim, hidden
        self.n_experts = n_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.dtype = dtype
        self.router = Dense(dim, n_experts, 'embed', None, use_bias=False,
                            dtype=torch.float32, device=device, stack=stack)
        self._register(resolve_device(device))

    def param_defs(self):
        return {
            'router': self.router,
            'up': ParamDef((self.n_experts, self.dim, self.hidden),
                           ('expert', 'embed', 'mlp'), 'fan_in'),
            'down': ParamDef((self.n_experts, self.hidden, self.dim),
                             ('expert', 'mlp', 'embed'), 'fan_in'),
        }

    def capacity(self, s):
        """Buffer slots per expert for a sequence of ``s`` tokens."""
        return max(1, int(self.capacity_factor * s * self.top_k
                          / self.n_experts))

    def route(self, params, x):
        """Routing of ``x`` [b, s, dim]: (probs [b, s, e] f32, gate values
        [b, s, k] renormalised, expert index [b, s, k], buffer position
        [b, s, k]); a position >= ``capacity(s)`` is a dropped choice."""
        b, s, _ = x.shape
        e, k = self.n_experts, self.top_k
        logits = self.router.apply(params['router'], x.float())
        probs = torch.softmax(logits, dim=-1)
        gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
        gate_vals = gate_vals / torch.clamp(
            gate_vals.sum(-1, keepdim=True), min=1e-9)
        flat = F.one_hot(gate_idx, e).reshape(b, s * k, e)
        pos = torch.cumsum(flat, dim=1) - flat
        pos = (pos * flat).sum(-1).reshape(b, s, k)
        return probs, gate_vals, gate_idx, pos

    def apply(self, params, x):
        b, s, _ = x.shape
        e, dt = self.n_experts, self.dtype
        cap = self.capacity(s)
        probs, gate_vals, gate_idx, pos = self.route(params, x)

        # the local experts [lo, lo + n) and the group over which their
        # products are partial (None: every expert here, unsharded)
        expert_axis, _, mlp_axis = live_spec(('expert', 'embed', 'mlp'))
        n = params['up'].shape[0]
        lo = mesh_group(expert_axis).rank * n if expert_axis else 0
        group = mesh_group(expert_axis, mlp_axis)
        xin = copy_to(group, x)
        gate_vals = copy_to(group, gate_vals)

        # choice [b, s, k, n] (dropped choices zeroed) and slot [b, s, k,
        # cap] one-hots; a position past capacity matches no slot, as
        # jax.nn.one_hot gives a zero row there. The spans let a profile
        # of the forward (and its remat recompute) attribute device time
        # to the dense dispatch.
        tel = _telemetry.get()
        choice_oh = F.one_hot(gate_idx, e)
        with tel.span('moe/dispatch'):
            choice = choice_oh[..., lo:lo + n].to(dt) * \
                (pos < cap)[..., None].to(dt)
            slot = (pos[..., None] == torch.arange(cap, device=x.device)) \
                .to(dt)
            disp = torch.einsum('bske,bskc->bsec', choice, slot)
            combine = torch.einsum('bske,bskc->bsec',
                                   choice * gate_vals.to(dt)[..., None], slot)
            xe = torch.einsum('bsec,bsd->becd', disp, xin.to(dt))
        with tel.span('moe/experts'):
            h = F.gelu(torch.einsum('becd,edh->bech', xe,
                                    params['up'].to(dt)), approximate='tanh')
            ye = torch.einsum('bech,ehd->becd', h, params['down'].to(dt))
        with tel.span('moe/combine'):
            y = reduce_from(group, torch.einsum('bsec,becd->bsd', combine,
                                                ye))

        # load-balance aux loss (Switch eq. 4): e * sum_e f_e * P_e, f over
        # first choices, averaged over the data-parallel batch
        f = mean_over_batch(
            (choice_oh[:, :, 0].sum(1).float() / s).mean(0))
        p = probs.mean(dim=(0, 1))
        return y, e * (f * p).sum()
