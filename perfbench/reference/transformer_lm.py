"""A pre-LN transformer language model in plain PyTorch, float32.

Embedding plus learned positions, ``n_layers`` blocks of
``x + out(attn(LN1(x)))`` then ``x + down(gelu_tanh(up(LN2(x))))``,
attention over a fused qkv product laid out [b, s, 3, h, d] with
softmax(q k^T / sqrt(d)) (causal or full), a final LayerNorm (eps 1e-6)
and a head tied to the token table; the loss is the token NLL
logsumexp(logits) - logits[target]. Every matmul goes through ``mm``, so
the control can run the same model at a lower precision. Configurations
whose ``reference`` is ``transformer_lm`` run this model.
"""
import math

import torch

LN_EPS = 1e-6


def param_specs(m):
    """{path: (shape, init)} of every leaf, in the layout the program's
    ``Trainer.init(params=...)`` takes (nested by '/', layers stacked on
    a leading axis). init: ('normal', std), or ('offset', 1.0) for a
    LayerNorm scale (1 plus a normal of std 0.02)."""
    d, f, L = m['dim'], m['dim'] * m['mlp_ratio'], m['n_layers']
    small = ('normal', 0.02)
    return {
        'embed/table': ((m['vocab'], d), small),
        'pos_embed/table': ((m['max_len'], d), small),
        'ln_f/scale': ((d,), ('offset', 1.0)),
        'ln_f/bias': ((d,), small),
        'blocks/ln1/scale': ((L, d), ('offset', 1.0)),
        'blocks/ln1/bias': ((L, d), small),
        'blocks/ln2/scale': ((L, d), ('offset', 1.0)),
        'blocks/ln2/bias': ((L, d), small),
        'blocks/attn/qkv/kernel': ((L, d, 3 * d), ('normal', d ** -0.5)),
        'blocks/attn/out/kernel': ((L, d, d), ('normal', d ** -0.5)),
        'blocks/mlp/up/kernel': ((L, d, f), ('normal', d ** -0.5)),
        'blocks/mlp/up/bias': ((L, f), small),
        'blocks/mlp/down/kernel': ((L, f, d), ('normal', f ** -0.5)),
        'blocks/mlp/down/bias': ((L, d), small),
    }


def plain_mm(a, b):
    return torch.matmul(a, b)


def layer_norm(x, scale, bias):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) *
                                       (x + 0.044715 * x ** 3)))


def attention(q, k, v, causal, mm):
    """q, k, v [b, h, s, d] -> [b, h, s, d]."""
    s = mm(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        n = s.shape[-1]
        keep = torch.ones(n, n, dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, float('-inf'))
    return mm(torch.softmax(s, dim=-1), v)


def nll_sum(p, m, tokens, targets, mm=plain_mm):
    """The summed token NLL of a block of rows; ``p`` {path: tensor}."""
    b, s = tokens.shape
    d, h = m['dim'], m['n_heads']
    x = p['embed/table'][tokens] + p['pos_embed/table'][:s][None]
    for i in range(m['n_layers']):
        y = layer_norm(x, p['blocks/ln1/scale'][i], p['blocks/ln1/bias'][i])
        qkv = mm(y, p['blocks/attn/qkv/kernel'][i]).reshape(b, s, 3, h,
                                                            d // h)
        q, k, v = qkv.permute(2, 0, 3, 1, 4).unbind(0)
        o = attention(q, k, v, m['causal'], mm)
        x = x + mm(o.transpose(1, 2).reshape(b, s, d),
                   p['blocks/attn/out/kernel'][i])
        y = layer_norm(x, p['blocks/ln2/scale'][i], p['blocks/ln2/bias'][i])
        y = gelu_tanh(mm(y, p['blocks/mlp/up/kernel'][i]) +
                      p['blocks/mlp/up/bias'][i])
        x = x + mm(y, p['blocks/mlp/down/kernel'][i]) + \
            p['blocks/mlp/down/bias'][i]
    x = layer_norm(x, p['ln_f/scale'], p['ln_f/bias'])
    logits = mm(x, p['embed/table'].t())
    gold = logits.gather(-1, targets[..., None])[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()
