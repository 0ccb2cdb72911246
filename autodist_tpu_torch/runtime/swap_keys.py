"""Strategy-distribution epoch key schema: the wire vocabulary of the
stage -> ack-quorum -> boundary-arm -> swap handshake.

A copy of ``autodist_tpu/runtime/swap_keys.py`` (framework-neutral), the
one place the port spells the coordinator key names of the epoch-swap
handshake. The loose session (chief staging, peer ack, boundary apply)
and the tests build keys through these helpers, so a JAX worker and a
port worker on one service read each other's stages, acks and
boundaries.

Key layout (all under the session namespace ``<ns>/``):

  swap/gen                monotone generation counter (INCR by the
                          chief at stage time; restarted peers discover
                          the live generation by reading it)
  swap/<g>/plan           staged plan payload (SET chief, GET peers,
                          DELNS on cancel and at run end)
  swap/<g>/ack/<w>        peer <w> validated the staged plan
  swap/<g>/nack/<w>       peer <w> rejected it (payload = reason);
                          any NACK cancels the stage
  swap/<g>/B              the armed commit boundary (SET chief once
                          the ack quorum is full; GET by every member
                          piggybacked on the staleness-gate poll)
  swap/<g>/ready          chief finished re-keying the authoritative
                          PS copies under the new plan; non-chief
                          members wait on it before their first
                          new-plan pull

Generation hygiene: staging generation ``g`` purges every ``swap/<g-1>/``
key (exactly one staged generation is ever visible), a cancelled stage
deletes its own ``swap/<g>/`` subtree, and the chief's run-end namespace
purge (session ``close()``) plus the init-time ``purge_all`` sweep
guarantee a restarted run never sees a stale staged plan.

The plan payload is the JAX package's: a JSON envelope around a pickled
Strategy whose classes are named by the JAX package's module paths
(``autodist_tpu.strategy.base``). The port pickles its own Strategy
under those names and maps them back to its own modules when it reads
one, so the two packages stage and read plans of the same bytes; the
strategy's ``path`` (a file under each package's own working directory)
is the one field that differs, and a decoded plan takes this package's.
"""
import base64
import io
import json
import os
import pickle

#: Shipped key templates -> abstract symbols of the JAX package's
#: verified protocol model (its ``analysis/epoch_swap_model.py``); kept
#: equal to the JAX table so the two key schemas cannot drift apart.
MODEL_SYMBOLS = {
    'swap/<g>/plan': 'swap/stage',
    'swap/<g>/ack/<w>': 'swap/acks',
    'swap/<g>/nack/<w>': 'swap/nacks',
    'swap/<g>/B': 'swap/B',
}

PREFIX = 'swap/'


def gen_key():
    """The generation counter key (relative to the session ns)."""
    return 'swap/gen'


def plan_key(gen):
    return 'swap/%d/plan' % gen


def ack_key(gen, worker):
    return 'swap/%d/ack/%d' % (gen, worker)


def nack_key(gen, worker):
    return 'swap/%d/nack/%d' % (gen, worker)


def boundary_key(gen):
    return 'swap/%d/B' % gen


def ready_key(gen):
    return 'swap/%d/ready' % gen


def gen_prefix(gen):
    """Prefix covering every key of one staged generation."""
    return 'swap/%d/' % gen


def compute_boundary(floors, staleness):
    """The commit boundary ``B = prefix_min(published) + staleness + 2``.

    ``floors`` are the published step/round counters of the LIVE
    members (excluded members' floors must already be dropped by the
    caller — quorum re-evaluation over live membership).  The model's
    safety argument: a member executing step ``s`` implies every
    member published ``>= s - staleness - 1``, so at arm time no
    member can have started step ``B``; every member's step-``B``
    start check therefore observes the armed marker.
    """
    if not floors:
        raise ValueError('compute_boundary: no live members')
    return min(floors) + staleness + 2


_JAX_PKG = 'autodist_tpu'
_PKG = __name__.split('.', 1)[0]
_RENAMED = {}


class _PlanPickler(pickle._Pickler):
    """The standard pickler (its pure-Python form, whose output equals
    the C pickler's), except that a class of this package is written
    under the JAX package's module path, without importing that."""

    def save_global(self, obj, name=None):
        module = getattr(obj, '__module__', '') or ''
        if self.proto < 4 or not (
                module == _PKG or module.startswith(_PKG + '.')):
            return super().save_global(obj, name)
        # pickle._Pickler.save_global's protocol >= 4 branch; one string
        # object per module, so the memo shares it as the C pickler's
        # memo shares a class's __module__
        self.save(_RENAMED.setdefault(module,
                                      _JAX_PKG + module[len(_PKG):]))
        self.save(name or obj.__qualname__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _PlanUnpickler(pickle.Unpickler):
    """Reads a plan pickled by either package into this package's
    classes."""

    def find_class(self, module, name):
        if module == _JAX_PKG or module.startswith(_JAX_PKG + '.'):
            module = _PKG + module[len(_JAX_PKG):]
        return super().find_class(module, name)


def encode_plan(gen, world, strategy):
    """Serialize a staged plan payload (JSON envelope, pickled
    strategy) for the ``swap/<g>/plan`` key."""
    buf = io.BytesIO()
    _PlanPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(strategy)
    blob = base64.b64encode(buf.getvalue()).decode('ascii')
    # compact separators: the coord KV value is the rest of one
    # protocol line, so the payload must stay newline-free
    return json.dumps({'gen': gen, 'world': world, 'strategy': blob},
                      separators=(',', ':'))


def decode_plan(payload):
    """Inverse of :func:`encode_plan`; returns ``(gen, world,
    strategy)``."""
    from autodist_tpu_torch.const import DEFAULT_SERIALIZATION_DIR
    doc = json.loads(payload)
    strategy = _PlanUnpickler(
        io.BytesIO(base64.b64decode(doc['strategy']))).load()
    if hasattr(strategy, 'id'):
        strategy.path = os.path.join(DEFAULT_SERIALIZATION_DIR,
                                     strategy.id)
    return doc['gen'], doc['world'], strategy


def stage_plan(client, ns, gen, world, strategy):
    """Chief: publish generation ``gen``'s plan, purging the previous
    generation's keys first (exactly one staged generation visible)."""
    if gen > 1:
        client.delete_namespace('%s/%s' % (ns, gen_prefix(gen - 1)))
    client.set('%s/%s' % (ns, plan_key(gen)),
               encode_plan(gen, world, strategy))
    # the counter moves LAST so a peer that observes the new
    # generation always finds the plan payload already staged
    cur = client.incr('%s/%s' % (ns, gen_key()), 0)
    if cur < gen:
        client.incr('%s/%s' % (ns, gen_key()), gen - cur)


def current_gen(client, ns):
    """The latest staged generation (0 = nothing ever staged)."""
    return client.incr('%s/%s' % (ns, gen_key()), 0)


def read_plan(client, ns, gen):
    """Fetch + decode a staged plan; None if not (or no longer)
    staged."""
    payload = client.get('%s/%s' % (ns, plan_key(gen)))
    if not payload:
        return None
    return decode_plan(payload)


def write_ack(client, ns, gen, worker):
    client.set('%s/%s' % (ns, ack_key(gen, worker)), '1')


def write_nack(client, ns, gen, worker, reason):
    # one protocol line: the reason must stay newline-free
    client.set('%s/%s' % (ns, nack_key(gen, worker)),
               str(reason).replace('\n', ' ')[:512])


def read_acks(client, ns, gen, workers):
    """Poll the ack/nack state for ``workers`` (the LIVE membership at
    poll time — re-evaluated by the caller on every epoch change).
    Returns ``(acked, nacks)`` where ``nacks`` is ``{worker:
    reason}``."""
    acked, nacks = set(), {}
    for w in workers:
        if client.get('%s/%s' % (ns, ack_key(gen, w))):
            acked.add(w)
        reason = client.get('%s/%s' % (ns, nack_key(gen, w)))
        if reason:
            nacks[w] = reason
    return acked, nacks


def arm(client, ns, gen, boundary):
    """Chief: arm the commit marker.  After this every member's gate
    poll observes the boundary and applies the staged plan at the
    start of step ``boundary``."""
    client.set('%s/%s' % (ns, boundary_key(gen)), str(int(boundary)))


def read_boundary(client, ns, gen):
    """The armed boundary for ``gen``, or 0 if not (or no longer)
    armed."""
    raw = client.get('%s/%s' % (ns, boundary_key(gen)))
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


def cancel(client, ns, gen):
    """Delete a staged generation (NACK or ack-timeout): the plan,
    acks, nacks and any armed marker all vanish atomically enough —
    peers key every decision off the plan payload's presence."""
    client.delete_namespace('%s/%s' % (ns, gen_prefix(gen)))


def purge_all(client, ns):
    """Remove every staged plan and the generation counter (run end /
    fresh-run init): a restarted run must never observe a stale staged
    plan."""
    client.delete_namespace('%s/%s' % (ns, PREFIX))


def mark_ready(client, ns, gen):
    client.set('%s/%s' % (ns, ready_key(gen)), '1')


def wait_ready(client, ns, gen, timeout_s):
    """Non-chief members: block until the chief finished re-keying the
    authoritative PS copies under the new plan (bounded)."""
    return client.wait_key('%s/%s' % (ns, ready_key(gen)),
                           timeout_s=timeout_s)
