"""Cluster management: process identity + the process group.

The counterpart of ``autodist_tpu/runtime/cluster.py``. Its jobs:

1. identity: which process am I, who is chief;
2. bringing up ``torch.distributed`` across the run's processes (the
   JAX package calls ``jax.distributed.initialize``): NCCL when the
   replicas compute on ``cuda``, gloo otherwise.

Identity comes from ``AUTODIST_PROCESS_ID`` / ``AUTODIST_NUM_PROCESSES``
or, under ``torchrun``, from ``RANK`` / ``WORLD_SIZE``. A process group
the caller initialized already is used as it is.
"""
import ipaddress
import os
import socket

import torch.distributed as dist

from autodist_tpu_torch.const import DEFAULT_JAX_COORD_PORT, ENV
from autodist_tpu_torch.utils import logging


def is_local_address(address):
    """True for this host's names (JAX ``cluster.py:22-55``, reference
    utils/network.py:22-57): ``localhost``, ``0.0.0.0``, a literal
    loopback IP, or this host's name. Unlike the JAX copy it asks no
    resolver: a name it cannot tell from this host's own is remote."""
    if address in ('localhost', '0.0.0.0', socket.gethostname()):
        return True
    try:
        return ipaddress.ip_address(address).is_loopback
    except ValueError:
        return False


def process_identity():
    """(rank, world size) from ``AUTODIST_PROCESS_ID`` /
    ``AUTODIST_NUM_PROCESSES``, else torchrun's ``RANK`` /
    ``WORLD_SIZE``, else (0, 1)."""
    if os.environ.get(ENV.AUTODIST_NUM_PROCESSES.name):
        return ENV.AUTODIST_PROCESS_ID.val, ENV.AUTODIST_NUM_PROCESSES.val
    if os.environ.get('WORLD_SIZE'):
        return int(os.environ.get('RANK', 0)), int(os.environ['WORLD_SIZE'])
    return 0, 1


def world_and_rank():
    """(world size, rank) of the default group, or of the process
    identity when no group is formed yet."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    rank, world = process_identity()
    return world, rank


class Cluster:
    """Identity + ``torch.distributed`` bring-up for one process."""

    def __init__(self, resource_spec):
        self._resource_spec = resource_spec
        self._started = False
        self._owns_group = False
        worker_addr = ENV.AUTODIST_WORKER.val
        self._local_address = worker_addr or resource_spec.chief

    @property
    def is_chief(self):
        return world_and_rank()[1] == 0

    def get_local_address(self):
        """This process's node address (reference cluster.py:98-147)."""
        return self._local_address

    @property
    def cluster_spec(self):
        """{'worker': [addr, ...]} with chief first (cluster.py:70-82)."""
        nodes = list(self._resource_spec.nodes)
        chief = self._resource_spec.chief
        ordered = [chief] + [n for n in nodes if n != chief]
        return {'worker': ordered}

    @property
    def num_nodes(self):
        return len(list(self._resource_spec.nodes))

    def start(self, device_type='cuda'):
        """Form the default process group when the run has several
        processes and none exists yet. Returns (world size, rank)."""
        if dist.is_available() and dist.is_initialized():
            self._started = True
            return world_and_rank()
        rank, world = process_identity()
        if world > 1 and not self._started:
            addr = (ENV.AUTODIST_COORDINATOR_ADDR.val or
                    self._resource_spec.coordinator_address or
                    '%s:%d' % (self._resource_spec.chief,
                               DEFAULT_JAX_COORD_PORT))
            if os.environ.get('MASTER_ADDR') and \
                    not ENV.AUTODIST_COORDINATOR_ADDR.val:
                addr = '%s:%s' % (os.environ['MASTER_ADDR'],
                                  os.environ.get('MASTER_PORT', '29500'))
            backend = 'nccl' if device_type == 'cuda' else 'gloo'
            logging.info('init_process_group(%s, tcp://%s, %d, %d)',
                         backend, addr, world, rank)
            dist.init_process_group(backend, init_method='tcp://' + addr,
                                    world_size=world, rank=rank)
            self._owns_group = True
        self._started = True
        return world, rank

    def terminate(self):
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False
        self._started = False
