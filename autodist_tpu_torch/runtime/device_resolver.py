"""Abstract -> concrete device resolution.

The counterpart of ``autodist_tpu/runtime/device_resolver.py``. The
reference maps AutoDist device strings ``ip:GPU:0`` to TF device strings
``/job:worker/task:i/device:GPU:0``; the JAX package maps them to jax
devices. The port runs one process per device, so an abstract string
resolves to the ``torch.distributed`` rank that runs it and the
``torch.device`` that rank computes on: nodes are numbered chief first
(the launchers' ``AUTODIST_PROCESS_ID`` order), and a node's ranks
follow its device list in order.
"""
import torch


class ResolvedDevice:
    """One resolved device: canonical string, rank and torch device."""

    def __init__(self, canonical, rank, device):
        self.canonical = canonical
        self.rank = rank
        self.device = device

    def __str__(self):
        return self.canonical

    def __repr__(self):
        return '<ResolvedDevice %s rank=%s>' % (self.canonical, self.rank)


class DeviceResolver:
    """Callable resolver bound to a resource spec and the run's ranks.

    ``resolver('10.0.0.2:GPU:1')`` returns the reference-format canonical
    string ``/job:worker/task:1/device:GPU:1``; :meth:`resolve` also
    gives the rank and device (rank None when the run has no such rank).

    Args:
        resource_spec: the run's :class:`ResourceSpec`.
        world_size: processes in the run (one per device).
        device_type: ``'cuda'`` or ``'cpu'``: where the ranks compute.
    """

    _LOCAL_ALIASES = ('localhost', '127.0.0.1', '0.0.0.0')

    def __init__(self, resource_spec, world_size=1, device_type='cuda'):
        nodes = list(resource_spec.nodes)
        chief = resource_spec.chief
        ordered = [chief] + [n for n in nodes if n != chief]
        self._task_of = {addr: i for i, addr in enumerate(ordered)}
        if len(nodes) == 1:
            for alias in self._LOCAL_ALIASES:
                self._task_of.setdefault(alias, 0)
        # per-node accelerator ordinals, in the spec's order
        by_node = {}
        for name, _ in resource_spec.accelerator_devices:
            host, _, idx = name.split(':')
            by_node.setdefault(host, []).append(int(idx))
        self._ordinals = [sorted(by_node.get(addr, [])) for addr in ordered]
        self._offsets, off = [], 0
        for ords in self._ordinals:
            self._offsets.append(off)
            off += len(ords) or 1
        self.world_size = int(world_size)
        self.device_type = device_type

    def ranks_per_node(self):
        """Ranks on each node, in rank order (the node groups of the
        two-level schedules)."""
        return [len(o) or 1 for o in self._ordinals]

    def __call__(self, abstract):
        """Resolve to the canonical string (StrategyCompiler hook)."""
        r = self.resolve(abstract)
        return r.canonical if r is not None else abstract

    def resolve(self, abstract):
        """'host:KIND:i' (or an already-canonical string) ->
        ResolvedDevice, or None if unresolvable."""
        s = str(abstract)
        if s.startswith('/job:'):
            try:
                task = int(s.split('/task:')[1].split('/')[0])
                kind, idx = s.split('/device:')[1].split(':')
                idx = int(idx)
            except (IndexError, ValueError):
                return None
        else:
            parts = s.split(':')
            if len(parts) != 3:
                return None
            try:
                host, kind, idx = parts[0], parts[1], int(parts[2])
            except ValueError:
                return None
            task = self._task_of.get(host)
            if task is None:
                return None
        canonical = '/job:worker/task:%d/device:%s:%d' % (task, kind, idx)
        if task >= len(self._ordinals):
            return ResolvedDevice(canonical, None, None)
        ords = self._ordinals[task]
        pos = ords.index(idx) if idx in ords else (0 if not ords else None)
        rank = None if pos is None else self._offsets[task] + pos
        if rank is not None and rank >= self.world_size:
            rank = None
        if self.device_type == 'cuda' and kind.upper() == 'GPU':
            count = torch.cuda.device_count()
            device = torch.device('cuda', idx % count) if count else None
        else:
            device = torch.device('cpu')
        return ResolvedDevice(canonical, rank, device)
