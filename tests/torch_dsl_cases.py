"""The port's side of the DSL parity tests: programs written against
``autodist_tpu_torch``, run on the CPU in this process (world 1) or on
every rank of a gloo group (``torch_dsl_worlds.run_group``).

Each function is called as ``fn(rank, world, **kwargs)`` and returns
numpy values; the feeds are this rank's contiguous share of the global
batch (``chip_smoke.local_slice``), which is the share of the global
batch the JAX package's replica ``rank`` sees. This module imports no
jax.
"""
import os

import numpy as np
import torch

import autodist_tpu_torch as ad
import chip_smoke as cs
from autodist_tpu_torch.frontend import graph as fe

CPU = 'cpu'


def fresh(builder, n_gpus=1, **kw):
    return cs.fresh_autodist(builder, CPU, n_gpus, **kw)


def builder_named(name):
    return dict(cs.C0_STRATEGIES)[name]()


# -- test_linear_regression.py ---------------------------------------------
def c0_matrix(rank, world):
    return cs.c0_matrix(CPU, rank, world)


def c0_step_count(rank, world):
    autodist = fresh(ad.AllReduce(), world)
    cs.run_linear_regression(autodist, rank, world)
    return autodist._session.step_count


def c0_replicas(rank, world, n_gpus):
    """The c0 program under a spec of ``n_gpus`` devices: (replicas
    the run took, (loss, W, b))."""
    autodist = fresh(ad.AllReduce(), n_gpus)
    out = cs.run_linear_regression(autodist, rank, world)
    return autodist._transformed[2].num_replicas, out


def batched_fetch(rank, world):
    autodist = fresh(ad.AllReduce(), world)
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        W = ad.Variable(2.0, name='W')
        pred = ad.ops.reshape(W * x, (-1,))
        sess = autodist.create_distributed_session()
        return sess.run(pred, {x: cs.local_slice(
            np.arange(8, dtype=np.float32), rank, world)})


def shared_optimizer(rank, world):
    autodist = fresh(ad.AllReduce(), world)
    with autodist.scope():
        a = ad.Variable(1.0, name='a')
        c = ad.Variable(2.0, name='c')
        opt = ad.optimizers.Adam(0.1)
        t1 = opt.minimize(ad.ops.square(a.read()), [a])
        t2 = opt.minimize(ad.ops.square(c.read()), [c])
        sess = autodist.create_distributed_session()
        sess.run([t1, t2])
        return sess.get_variable_value(a), sess.get_variable_value(c)


def matrix_regression(rank, world, builder, d=12, steps=3):
    """Multi-feature regression by Adam (the JAX test's
    run_matrix_regression): (W after the steps, the W plan's
    (state_sharded, pad, padded_dim), this rank's state shape)."""
    autodist = fresh(builder_named(builder) if isinstance(builder, str)
                     else builder, world)
    np.random.seed(7)
    X = np.random.randn(64, d).astype(np.float32)
    y = np.random.randn(64, 1).astype(np.float32)
    with autodist.scope():
        xp = ad.placeholder(shape=[None, d], dtype=np.float32, name='x')
        yp = ad.placeholder(shape=[None, 1], dtype=np.float32, name='y')
        W = ad.Variable(np.linspace(-1, 1, d)[:, None].astype(np.float32),
                        name='W')
        loss = ad.ops.reduce_mean(
            ad.ops.square(ad.ops.matmul(xp, W) - yp))
        train_op = ad.optimizers.Adam(0.05).minimize(loss, [W])
        sess = autodist.create_distributed_session()
        for _ in range(steps):
            sess.run(train_op, {xp: cs.local_slice(X, rank, world),
                                yp: cs.local_slice(y, rank, world)})
        W_val = sess.get_variable_value(W)
    p = autodist._transformed[2].plan_for('W')
    return (W_val, (p.state_sharded, p.pad, p.padded_dim),
            tuple(sess._var_state['W'].shape))


def ef_residual(rank, world):
    """c0 under HorovodCompressorEF: this replica's W residual."""
    autodist = fresh(ad.AllReduce(compressor='HorovodCompressorEF'), world)
    cs.run_linear_regression(autodist, rank, world)
    return autodist._session._aux_state['compressor/W']['residual'].numpy()


def loose_raises(rank, world):
    """The message a relaxed-consistency PS strategy across processes
    raises with under a peer-failure policy of the loose plane's second
    half (membership changes are not ported); it raises before any
    coord service is brought up."""
    os.environ['AUTODIST_PEER_FAILURE_POLICY'] = 'exclude'
    try:
        cs.run_linear_regression(fresh(ad.PS(staleness=2), world))
    except NotImplementedError as e:
        return str(e)
    finally:
        del os.environ['AUTODIST_PEER_FAILURE_POLICY']
    return None


# -- test_model_cases.py: c4, c6, CNN --------------------------------------
def run_c4(autodist, rank=0, world=1, epochs=3):
    """Case c4: sigmoid(W*state + b) iterated 3 times under a bounded
    while_loop, trained through the loop; the lifted plain loop is the
    cross-check of the lowering. Returns (losses, W, b)."""
    np.random.seed(123)
    inputs = np.random.randn(256).astype(np.float32)
    outputs = (inputs * 3.0 + 2.0 + np.random.randn(256)).astype(np.float32)
    feed_x = cs.local_slice(inputs, rank, world)
    feed_y = cs.local_slice(outputs, rank, world)
    with autodist.scope():
        x = ad.placeholder(shape=[None], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        W = ad.Variable(5.0, name='W')
        b = ad.Variable(0.0, name='b')
        wl = ad.ops.while_loop(
            lambda carry: carry[0] < 3,
            lambda carry: (carry[0] + 1,
                           torch.sigmoid(carry[1] * carry[2] + carry[3]),
                           carry[2], carry[3]),
            (ad.ops.constant(0), x, W, b), max_iters=3)
        pred = wl[1]
        loss = ad.ops.reduce_mean(ad.ops.square(pred - y))

        def iterated(w_v, b_v, x_v):
            for _ in range(3):
                x_v = torch.sigmoid(w_v * x_v + b_v)
            return x_v

        wl_mean = ad.ops.reduce_mean(pred)
        pred_mean = ad.ops.reduce_mean(ad.ops.lift(iterated)(W, b, x))
        train_op = ad.optimizers.SGD(0.01).minimize(loss, [W, b])
        sess = autodist.create_distributed_session()
        losses = []
        for _ in range(epochs):
            lv, _ = sess.run([loss, train_op], {x: feed_x, y: feed_y})
            losses.append(float(lv))
        W_val, b_val, pred_m, wl_m = sess.run(
            [W, b, pred_mean, wl_mean], {x: feed_x, y: feed_y})
        assert abs(float(pred_m) - float(wl_m)) <= 1e-6
    return losses, float(W_val), float(b_val)


C6_BATCH, C6_T, C6_STATE = 6, 4, 5


def run_c6(autodist, rank=0, world=1):
    """Case c6: a dynamic LSTM (per-example lengths masking the state)
    lifted as a torch function, a matmul head, Adam. Returns the four
    variables after 2 steps."""
    rng = np.random.RandomState(0)
    x_seq = rng.rand(C6_BATCH, C6_T, C6_STATE).astype(np.float32)
    seq_len = rng.randint(1, C6_T + 1, size=C6_BATCH).astype(np.int32)
    y_true = rng.rand(1, C6_STATE).astype(np.float32)
    wx0 = rng.uniform(-0.2, 0.2, (C6_STATE, 4 * C6_STATE)).astype(np.float32)
    wh0 = rng.uniform(-0.2, 0.2, (C6_STATE, 4 * C6_STATE)).astype(np.float32)
    with autodist.scope():
        x = ad.placeholder(shape=[None, C6_T, C6_STATE], dtype=np.float32,
                           name='x')
        lens = ad.placeholder(shape=[None], dtype=np.int32, name='lens')
        Wx = ad.Variable(wx0, name='Wx')
        Wh = ad.Variable(wh0, name='Wh')
        bias = ad.Variable(np.zeros(4 * C6_STATE, np.float32), name='bias')
        QQ = ad.Variable(np.zeros((C6_STATE, C6_STATE), np.float32),
                         name='QQ')

        def lstm_mean_state(wx, wh, b_v, xs, ls):
            h = xs.new_zeros((xs.shape[0], C6_STATE))
            c = h
            for t in range(xs.shape[1]):
                gates = xs[:, t] @ wx + h @ wh + b_v
                i, f, g, o = torch.split(gates, C6_STATE, dim=-1)
                c_new = torch.sigmoid(f) * c + \
                    torch.sigmoid(i) * torch.tanh(g)
                h_new = torch.sigmoid(o) * torch.tanh(c_new)
                live = (t < ls)[:, None]
                h = torch.where(live, h_new, h)
                c = torch.where(live, c_new, c)
            return h.mean(dim=0, keepdim=True)

        state_mean = ad.ops.lift(lstm_mean_state)(Wx, Wh, bias, x, lens)
        logits = ad.ops.matmul(state_mean, QQ)
        loss = ad.ops.reduce_mean(
            ad.ops.softmax_cross_entropy_with_logits(
                labels=ad.ops.constant(y_true), logits=logits))
        train_op = ad.optimizers.Adam(0.1).minimize(loss,
                                                    [Wx, Wh, bias, QQ])
        sess = autodist.create_distributed_session()
        for _ in range(2):
            sess.run([train_op, logits],
                     {x: cs.local_slice(x_seq, rank, world),
                      lens: cs.local_slice(seq_len, rank, world)})
        return [np.asarray(v) for v in sess.run([Wx, Wh, bias, QQ])]


def run_cnn(autodist, rank=0, world=1, epochs=2):
    """The c1/c5 role: conv/pool CNN through the DSL image ops, SGD.
    Returns (losses, the six variables)."""
    rng = np.random.RandomState(7)
    images = rng.rand(16, 16, 16, 3).astype(np.float32)
    labels = rng.randint(0, 10, (16,)).astype(np.int32)
    f1_0 = rng.uniform(-0.1, 0.1, (3, 3, 3, 8)).astype(np.float32)
    f2_0 = rng.uniform(-0.1, 0.1, (3, 3, 8, 8)).astype(np.float32)
    w0 = rng.uniform(-0.1, 0.1, (128, 10)).astype(np.float32)
    with autodist.scope():
        x = ad.placeholder(shape=[None, 16, 16, 3], dtype=np.float32,
                           name='x')
        y = ad.placeholder(shape=[None], dtype=np.int32, name='y')
        F1 = ad.Variable(f1_0, name='F1')
        b1 = ad.Variable(np.zeros(8, np.float32), name='b1')
        F2 = ad.Variable(f2_0, name='F2')
        b2 = ad.Variable(np.zeros(8, np.float32), name='b2')
        W = ad.Variable(w0, name='W')
        bo = ad.Variable(np.zeros(10, np.float32), name='bo')
        h = ad.ops.relu(ad.ops.bias_add(ad.ops.conv2d(x, F1), b1))
        h = ad.ops.max_pool(h, 2)
        h = ad.ops.relu(ad.ops.bias_add(ad.ops.conv2d(h, F2), b2))
        h = ad.ops.avg_pool(h, 2)
        h = ad.ops.reshape(h, (-1, 128))
        logits = ad.ops.matmul(h, W) + bo
        loss = ad.ops.reduce_mean(
            ad.ops.sparse_softmax_cross_entropy_with_logits(
                labels=y, logits=logits))
        train_op = ad.optimizers.SGD(0.1).minimize(
            loss, [F1, b1, F2, b2, W, bo])
        sess = autodist.create_distributed_session()
        losses = []
        feed = {x: cs.local_slice(images, rank, world),
                y: cs.local_slice(labels, rank, world)}
        for _ in range(epochs):
            lv, _ = sess.run([loss, train_op], feed)
            losses.append(float(lv))
        vals = sess.run([F1, b1, F2, b2, W, bo])
    return losses, [np.asarray(v) for v in vals]


MODELS = {'c4': run_c4, 'c6': run_c6, 'cnn': run_cnn}


def model_matrix(rank, world, model):
    """``model`` under every builder entry: {name: its result}."""
    return {name: MODELS[model](fresh(builder(), world), rank, world)
            for name, builder in cs.C0_STRATEGIES}


def model_case(rank, world, model, builder='AllReduce'):
    return MODELS[model](fresh(builder_named(builder), world), rank, world)


# -- test_bucketing.py / test_schedule_ir.py / test_compressor.py ----------
def _plan_over(shapes, builder, world, dtype=np.float32):
    """(plan, sources) for variables of ``shapes`` under ``builder``'s
    strategy, over the default group."""
    from autodist_tpu_torch.graph_item import GraphItem
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    from autodist_tpu_torch.runtime.cluster import world_and_rank
    from autodist_tpu_torch.parallel.plan import ExecutionPlan
    from autodist_tpu_torch.resource_spec import ResourceSpec
    gi = GraphItem(graph=fe.Graph())
    with gi.graph:
        for i, s in enumerate(shapes):
            ad.Variable(np.zeros(s, dtype), name='v%02d' % i)
    gi.prepare()
    rs = ResourceSpec(resource_info={'nodes': [{
        'address': 'localhost', 'chief': True, 'cpus': [0],
        'gpus': list(range(world)), 'network_bandwidth': 100}]})
    strategy = builder.build(gi, rs)
    size, rank = world_and_rank()
    plan = ExecutionPlan(strategy, gi, ReplicaGroup(size, rank))
    return plan, list(gi.trainable_var_op_to_var.values())


def _rank_grads(shapes, rank, world, dtype, seed=0):
    """This rank's row of per-replica gradient stacks (replica r's
    gradients are row r)."""
    rng = np.random.RandomState(seed)
    out = []
    for s in shapes:
        g = torch.from_numpy(rng.randn(world, *s).astype('f4')[rank])
        out.append(g.to(dtype))
    return out


def sync(rank, world, shapes, builder, cap, dtype='float32', spy=False):
    """One ``sync_gradients`` over this rank's gradients: (synced
    values as f32 numpy, last_bucket_stats, reduce calls' sizes, the
    static schedule of the strategy)."""
    from autodist_tpu_torch.parallel import plan as plan_mod
    from autodist_tpu_torch.parallel.plan import static_collective_schedule
    os.environ['AUTODIST_BUCKET_BYTES'] = str(cap)
    calls = []
    orig = plan_mod.ExecutionPlan._reduce_fn
    try:
        if spy:
            def spied(self, spec, hier_groups=None):
                fn = orig(self, spec, hier_groups)

                def wrapped(g):
                    calls.append(int(g.numel()))
                    return fn(g)
                return wrapped
            plan_mod.ExecutionPlan._reduce_fn = spied
        dt = getattr(torch, dtype)
        plan, sources = _plan_over(shapes, builder, world)
        grads = _rank_grads(shapes, rank, world, dt)
        out = plan.sync_gradients(sources, grads, fe.Env({}, {}))
        vals = [(o.value if hasattr(o, 'value') else o).float().numpy()
                for o in out]
        static = static_collective_schedule(plan.strategy, plan.graph_item,
                                            world)
        return vals, plan.last_bucket_stats, calls, static
    finally:
        plan_mod.ExecutionPlan._reduce_fn = orig
        os.environ.pop('AUTODIST_BUCKET_BYTES', None)


def bucket_cases(rank, world):
    AR = ad.AllReduce
    out = {
        'per_bucket': sync(rank, world, [(100,)] * 6, AR(chunk_size=128),
                           1000, spy=True),
        'oversized': sync(rank, world, [(100,), (1000,), (50,)],
                          AR(chunk_size=128), 800, spy=True),
        'mean': sync(rank, world, [(32,), (16, 4)], AR(chunk_size=128), 64),
        'zero_capped': sync(rank, world, [(16, 16)], ad.PartitionedPS(),
                            256),
        'zero_whole': sync(rank, world, [(16, 16)], ad.PartitionedPS(),
                           1 << 30),
    }
    shapes = [(40,), (8, 16), (3, 5, 7), (64,), (11,)]
    for dtype in ('float32', 'bfloat16'):
        for cname in ('NoneCompressor', 'HorovodCompressor'):
            for cap in (600, 1):
                out['eq/%s/%s/%d' % (dtype, cname, cap)] = sync(
                    rank, world, shapes,
                    AR(chunk_size=128, compressor=cname), cap, dtype)
    return out


def trained_bitwise(rank, world):
    """The CNN and c6 trained at world 2 with the default bucket cap and
    with AUTODIST_BUCKET_BYTES=1 (every gradient its own collective)."""
    out = {}
    for cap in ('default', '1'):
        if cap == '1':
            os.environ['AUTODIST_BUCKET_BYTES'] = '1'
        try:
            _, cnn = run_cnn(fresh(ad.AllReduce(), world), rank, world)
            c6 = run_c6(fresh(ad.AllReduce(), world), rank, world)
        finally:
            os.environ.pop('AUTODIST_BUCKET_BYTES', None)
        out[cap] = (cnn, c6)
    return out


def ir_lowering(rank, world):
    """Each flat schedule lowered through ``schedule_ir.execute`` and,
    by hand, the collectives it stands for; and ``execute_generic``
    on the same reduction programs. Returns {label: (IR, hand, verify errors)}."""
    from autodist_tpu_torch.parallel import compressor as comp
    from autodist_tpu_torch.parallel import plan as plan_mod
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    group = ReplicaGroup(world, rank)
    n = world
    x = torch.from_numpy(np.random.RandomState(20).randn(
        n, 128).astype(np.float32)[rank])
    nb = x.numel() * 4

    def bp(kind, cname=None, spec='AUTO', wus=False):
        return sir.bucket_program(kind, nb, 'float32', cname, spec, n,
                                  wus=wus)

    cases = {
        'flat/psum': (bp('all_reduce'), lambda g: group.all_reduce(g) / n),
        'flat/ring': (bp('all_reduce', spec='RING'),
                      lambda g: plan_mod.ring_all_reduce(g, group) / n),
        'int8/flat': (bp('all_reduce', 'Int8RingCompressor'),
                      lambda g: comp.int8_ring_all_reduce(g, group) / n),
        'zero/flat': (bp('psum_scatter'),
                      lambda g: group.reduce_scatter(g) / n),
        'wus/scatter': (bp('psum_scatter', wus=True),
                        lambda g: group.reduce_scatter(g) / n),
        'wus/gather': (bp('all_gather', wus=True),
                       lambda g: group.all_gather(g)),
    }
    out = {}
    for label, (prog, hand) in cases.items():
        out[label] = (sir.execute(prog, x, group).numpy(),
                      hand(x).numpy(), sir.verify(prog))
        # the generic interpreter reads its input as the whole
        # program buffer, so the gather programs (whose input is a
        # shard) are not its case
        if sir.executable_generic(prog) and 'gather' not in label:
            out['generic/' + label] = (
                sir.execute_generic(prog, x, group).numpy(),
                out[label][0], [])
    return out


def two_level_lowering(rank, world):
    """A two-level all-reduce program over node groups [[0, 1], [2, 3]]
    executed on this rank's row, beside the flat program on the same row:
    (two-level, flat, the lowering's tag, verify findings)."""
    from autodist_tpu_torch.parallel import schedule_ir as sir
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    group = ReplicaGroup(world, rank)
    x = torch.from_numpy(np.random.RandomState(21).randint(
        -8, 8, (world, 128)).astype(np.float32)[rank])
    prog = sir.bucket_program('all_reduce', 4 * 128, 'float32', None,
                              'AUTO', world, hier=2)
    flat = sir.bucket_program('all_reduce', 4 * 128, 'float32', None,
                              'AUTO', world)
    return (sir.execute(prog, x, group).numpy(),
            sir.execute(flat, x, group).numpy(), sir.lowering_of(prog),
            sir.verify(prog))


def hierarchical_choice(rank, world):
    """Under AUTODIST_HIERARCHY_NODES=2 (set by the caller), a plan whose
    cost model picks two levels (hierarchical='always'): its node groups,
    its bucket records, and its synced gradients beside a flat plan's."""
    grads = [torch.from_numpy(np.random.RandomState(22 + i).randint(
        -8, 8, (world,) + s).astype(np.float32)[rank])
        for i, s in enumerate([(64,), (32,)])]
    out = {}
    for knob in ('always', 'never'):
        plan, sources = _plan_over([(64,), (32,)],
                                   ad.AllReduce(hierarchical=knob), world)
        synced = plan.sync_gradients(sources, grads, fe.Env({}, {}))
        out[knob] = (plan.hier_groups,
                     [b['hier'] for b in plan.last_bucket_stats],
                     [g.numpy() for g in synced])
    return out


def int8_ring(rank, world):
    from autodist_tpu_torch.parallel.compressor import int8_ring_all_reduce
    from autodist_tpu_torch.parallel.mesh import ReplicaGroup
    x = np.random.RandomState(0).randn(world, 1000).astype('f4')
    got = int8_ring_all_reduce(torch.from_numpy(x[rank]),
                               ReplicaGroup(world, rank))
    return got.numpy(), x.sum(axis=0)


def _regression(autodist, rank, world, steps, lr=0.05, opt='SGD'):
    rng = np.random.RandomState(0)
    true_w = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
    xs = rng.randn(512, 4).astype(np.float32)
    ys = xs @ true_w
    with autodist.scope():
        W = ad.Variable(np.zeros(4, np.float32), name='W')
        x = ad.placeholder(shape=[None, 4], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        pred = ad.ops.squeeze(
            ad.ops.matmul(x, ad.ops.reshape(W, (4, 1))), axis=1)
        loss = ad.ops.reduce_mean(ad.ops.square(pred - y))
        train_op = getattr(ad.optimizers, opt)(lr).minimize(loss)
        sess = autodist.create_distributed_session()
    feed = {x: cs.local_slice(xs, rank, world),
            y: cs.local_slice(ys, rank, world)}
    losses = [float(sess.run([loss, train_op], feed)[0])
              for _ in range(steps)]
    return losses, sess.run(W), sess


def int8_training(rank, world):
    from autodist_tpu_torch.parallel.compressor import Int8RingCompressor
    old = Int8RingCompressor.MIN_SIZE
    Int8RingCompressor.MIN_SIZE = 1
    try:
        losses, w, sess = _regression(
            fresh(ad.AllReduce(compressor='Int8RingCompressor'), world),
            rank, world, 40)
        res = sess._aux_state['compressor/W']['residual'].numpy()
    finally:
        Int8RingCompressor.MIN_SIZE = old
    return losses, w, res


def powersgd(rank, world):
    """Matrix regression (12 x 3 weight) under PowerSGD: W after 3
    steps."""
    return matrix_regression(rank, world, ad.AllReduce(
        compressor='PowerSGDCompressor'), d=12)[0]


def compressor_cases(rank, world):
    return {'int8_ring': int8_ring(rank, world),
            'int8_training': int8_training(rank, world),
            'powersgd': powersgd(rank, world)}


# -- test_weight_update_sharding.py ----------------------------------------
WUS_SHAPES = {'W': (4, 6), 'V': (6,), 'b': (3,)}


def wus_train(rank, world, builder_kw, opt, shapes=None, steps=3, seed=0,
              integral=False, opt_kw=None):
    """The JAX test's _train: a two-matmul regression under
    ``AllReduce(**builder_kw)``. Returns (values, slots as var-shaped
    arrays, {var: (update_sharded, wus_pad, wus_padded)}, this rank's
    slot leaf shapes)."""
    shapes = shapes or WUS_SHAPES
    autodist = fresh(ad.AllReduce(**builder_kw), world)
    rng = np.random.RandomState(seed)
    din = shapes['W'][0]
    if integral:
        xs = rng.randint(-3, 4, size=(64, din)).astype(np.float32)
        ys = rng.randint(-3, 4, size=(64,)).astype(np.float32)
    else:
        xs = rng.randn(64, din).astype(np.float32)
        ys = rng.randn(64).astype(np.float32)
    with autodist.scope():
        variables = {}
        for name, shape in shapes.items():
            init = rng.randint(-2, 3, size=shape).astype(np.float32) \
                if integral else rng.randn(*shape).astype(np.float32)
            variables[name] = ad.Variable(init, name=name)
        x = ad.placeholder(shape=[None, din], dtype=np.float32, name='x')
        y = ad.placeholder(shape=[None], dtype=np.float32, name='y')
        h = ad.ops.matmul(x, variables['W'])
        hidden = shapes['W'][1]
        pred = ad.ops.squeeze(ad.ops.matmul(
            h, ad.ops.reshape(variables['V'], (hidden, 1))), axis=1)
        if 'b' in variables:
            pred = pred + ad.ops.reduce_sum(variables['b'])
        loss = ad.ops.reduce_mean(ad.ops.square(pred - y))
        train = getattr(ad.optimizers, opt)(**(opt_kw or {})).minimize(loss)
        sess = autodist.create_distributed_session()
        for _ in range(steps):
            sess.run(train, feed_dict={x: cs.local_slice(xs, rank, world),
                                       y: cs.local_slice(ys, rank, world)})
        values = {name: sess.get_variable_value(v)
                  for name, v in variables.items()}
    plan = sess._plan
    slots, shard_shapes = {}, {}
    for by_var in sess._opt_state.values():
        for vname, state in by_var.items():
            vp = plan.var_plans[vname]
            flat, shp = [], []
            for k in sorted(state):
                leaf = state[k]
                if not torch.is_tensor(leaf):
                    continue
                shp.append(tuple(leaf.shape))
                if vp.update_sharded:
                    leaf = plan.group.all_gather(leaf)
                    leaf = leaf[:int(np.prod(vp.var.shape))].reshape(
                        vp.var.shape)
                flat.append(leaf.numpy())
            slots[vname], shard_shapes[vname] = flat, shp
    geometry = {n: (p.update_sharded, p.wus_pad, p.wus_padded)
                for n, p in plan.var_plans.items()}
    return values, slots, geometry, shard_shapes


def wus_cases(rank, world):
    adam = {'learning_rate': 0.05}
    lamb = {'learning_rate': 0.05, 'weight_decay': 0.01}
    always = {'weight_update_sharding': 'always'}
    uneven = {'W': (5, 7), 'V': (7,), 'b': (3,)}
    return {
        'int_base': wus_train(rank, world, {}, 'Adam', steps=1,
                              integral=True, opt_kw=adam),
        'int_wus': wus_train(rank, world, always, 'Adam', steps=1,
                             integral=True, opt_kw=adam),
        'rand_base': wus_train(rank, world, {}, 'Adam', steps=4,
                               opt_kw=adam),
        'rand_wus': wus_train(rank, world, always, 'Adam', steps=4,
                              opt_kw=adam),
        'uneven_base': wus_train(rank, world, {}, 'Adam', uneven, steps=1,
                                 integral=True, opt_kw=adam),
        'uneven_wus': wus_train(rank, world, always, 'Adam', uneven,
                                steps=1, integral=True, opt_kw=adam),
        'lamb_base': wus_train(rank, world, {}, 'LAMB', steps=4,
                               opt_kw=lamb),
        'lamb_wus': wus_train(rank, world, always, 'LAMB', steps=4,
                              opt_kw=lamb),
    }


# -- test_sparse_embedding.py ----------------------------------------------
VOCAB, DIM, EMB_BATCH = 512, 8, 32


def run_embedding_model(autodist, rank=0, world=1, steps=2):
    """c2: embedding rows times a dense weight, seeded feeds, SGD.
    Returns (table, w, {var: sparse_synced}, the variables the last
    step's recorded collectives carried)."""
    rng = np.random.RandomState(7)
    table_init = rng.randn(VOCAB, DIM).astype(np.float32) * 0.1
    w_init = rng.randn(DIM).astype(np.float32)
    ids_batches = [rng.randint(0, VOCAB, size=EMB_BATCH).astype(np.int32)
                   for _ in range(steps)]
    target_batches = [rng.randn(EMB_BATCH).astype(np.float32)
                      for _ in range(steps)]
    with autodist.scope():
        ids = ad.placeholder(shape=[None], dtype=np.int32, name='ids')
        tgt = ad.placeholder(shape=[None], dtype=np.float32, name='tgt')
        emb = ad.Variable(table_init, name='emb')
        w = ad.Variable(w_init, name='w')
        rows = ad.ops.embedding_lookup(emb, ids)
        pred = ad.ops.reduce_sum(rows * w.read(), axis=1)
        loss = ad.ops.reduce_mean(ad.ops.square(pred - tgt))
        train_op = ad.optimizers.SGD(0.5).minimize(loss, [emb, w])
        sess = autodist.create_distributed_session()
        for i in range(steps):
            sess.run(train_op, {
                ids: cs.local_slice(ids_batches[i], rank, world),
                tgt: cs.local_slice(target_batches[i], rank, world)})
        table = sess.get_variable_value('emb')
        w_val = sess.get_variable_value('w')
    plan = autodist._transformed[2]
    return table, w_val, {n: p.sparse_synced
                          for n, p in plan.var_plans.items()}, \
        bucket_members(plan)


def bucket_members(plan):
    """Sorted names of the variables in ``plan.last_bucket_stats``."""
    return sorted({m for e in plan.last_bucket_stats for m in e['members']})


def run_dense_use(autodist, rank=0, world=1):
    """A looked-up table that also has a dense consumer (weight decay):
    (table, emb sparse_synced, the variables the recorded collectives
    carried)."""
    rng = np.random.RandomState(11)
    table_init = rng.randn(64, 4).astype(np.float32)
    ids_b = rng.randint(0, 64, size=16).astype(np.int32)
    with autodist.scope():
        ids = ad.placeholder(shape=[None], dtype=np.int32, name='ids')
        emb = ad.Variable(table_init, name='emb')
        loss = ad.ops.reduce_mean(ad.ops.embedding_lookup(emb, ids)) + \
            0.01 * ad.ops.reduce_sum(ad.ops.square(emb.read()))
        train_op = ad.optimizers.SGD(0.1).minimize(loss, [emb])
        sess = autodist.create_distributed_session()
        sess.run(train_op, {ids: cs.local_slice(ids_b, rank, world)})
        table = sess.get_variable_value('emb')
    plan = autodist._transformed[2]
    return table, plan.var_plans['emb'].sparse_synced, bucket_members(plan)


SPARSE_STRATEGIES = ('AllReduce', 'PS', 'PartitionedPS',
                     'UnevenPartitionedPS', 'Parallax')


def sparse_cases(rank, world):
    out = {name: run_embedding_model(fresh(builder_named(name), world),
                                     rank, world)
           for name in SPARSE_STRATEGIES}
    out['dense_use'] = run_dense_use(fresh(ad.AllReduce(), world), rank,
                                     world)
    out['lazy_adam'] = lazy_rows(rank, world, 'LazyAdam')
    out['lazy_momentum'] = lazy_rows(rank, world, 'LazyMomentum')
    return out


def lazy_rows(rank, world, opt):
    """A lazy optimizer on the c2 table: (table before, after 2 steps,
    the ids the steps looked up)."""
    rng = np.random.RandomState(5)
    table_init = rng.randn(VOCAB, DIM).astype(np.float32)
    ids_b = [rng.randint(0, VOCAB, size=EMB_BATCH).astype(np.int32)
             for _ in range(2)]
    autodist = fresh(ad.AllReduce(), world)
    with autodist.scope():
        ids = ad.placeholder(shape=[None], dtype=np.int32, name='ids')
        emb = ad.Variable(table_init, name='emb')
        loss = ad.ops.reduce_mean(ad.ops.square(
            ad.ops.embedding_lookup(emb, ids) - 1.0))
        train_op = getattr(ad.optimizers, opt)(0.1).minimize(loss)
        sess = autodist.create_distributed_session()
        for b in ids_b:
            sess.run(train_op, {ids: cs.local_slice(b, rank, world)})
        table = sess.get_variable_value('emb')
    return table_init, table, np.concatenate(ids_b)


def load_roundtrip(rank, world):
    """A ZeRO-sharded (padded) variable loaded and read back, and the
    step after the load: (read-back value, this rank's shard, W after
    one SGD step from the loaded value)."""
    autodist = fresh(ad.UnevenPartitionedPS(), world)
    value = np.arange(13, dtype=np.float32)[:, None] / 13
    with autodist.scope():
        W = ad.Variable(np.zeros((13, 1), np.float32), name='W')
        x = ad.placeholder(shape=[None, 13], dtype=np.float32, name='x')
        train_op = ad.optimizers.SGD(0.1).minimize(
            ad.ops.reduce_sum(ad.ops.matmul(x, W)))
        sess = autodist.create_distributed_session()
        sess.load_variable_value(W, value)
        back = sess.get_variable_value('W')
        shard = sess._var_state['W'].numpy()
        sess.run(train_op, {x: np.ones((2, 13), np.float32)})
        return back, shard, sess.get_variable_value(W)
