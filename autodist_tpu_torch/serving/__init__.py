"""Read-only serving tier over the PS data plane (the counterpart of
``autodist_tpu/serving``).

A ``Session``-less replica fleet that serves lookup and forward queries
against the LIVE training namespace while the cohort keeps pushing.
Dense variables refresh as epoch-consistent whole-model snapshots pinned
to one published step (the seqlock pin -> pull -> revalidate protocol in
:mod:`~autodist_tpu_torch.serving.replica`) and are held as tensors on
the replica's device; sparse embedding tables serve through an LRU+TTL
row cache backed by on-demand ``vmgetrows``. Replicas are NON-VOTING: no
fence bind, no step publish, no gate participation, invisible to
``live_members_on_plane`` — a reader's death never stalls training.
"""
from autodist_tpu_torch.serving.fleet import (ServingFleet, serve_loop,
                                              serving_autoscale_policy)
from autodist_tpu_torch.serving.replica import ServingReplica, SnapshotView
from autodist_tpu_torch.serving.row_cache import RowCache

__all__ = ['RowCache', 'ServingFleet', 'ServingReplica', 'SnapshotView',
           'serve_loop', 'serving_autoscale_policy']
