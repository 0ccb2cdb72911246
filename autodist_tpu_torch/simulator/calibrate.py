"""Measured mode: refine α-β constants from a short real run.

The analytic defaults in :class:`CostModelParams` come from topology
hints; a 3-step profiled run gives ground truth. The feed is
:func:`autodist_tpu_torch.utils.profiling.collective_timeline` — one row
per distinct collective (with bucketed sync, one per bucket) as
``(descriptor, total ns, count)``. The descriptor
(:class:`~autodist_tpu_torch.utils.profiling.Collective`) is read from
the trace's collective records (kind, result bytes, group ranks), where
the JAX package parses HLO text; a least-squares fit of per-occurrence
time against the KIND-AWARE cost shape (ring all-reduce
``2(n-1)α + 2(n-1)/n·B·β``, reduce-scatter/all-gather
``(n-1)α + (n-1)/n·B·β``, permute ``α + B·β``) yields α and β for the
link class. The fit and its fallbacks are the JAX package's code.

Degrades gracefully: no trace, no collective rows, or a degenerate fit
(all samples the same size, or one rank: no link) leaves the analytic
constants in place with a logged warning — such runs calibrate nothing
and lose nothing.
"""
from autodist_tpu_torch.utils import logging


def _result_bytes_and_kind(desc):
    """(wire bytes, collective kind) of one timeline descriptor, or
    None. The descriptor (:class:`~autodist_tpu_torch.utils.profiling.
    Collective`) carries the RESULT bytes — a reduce-scatter's shard, an
    all-gather's full buffer, as an HLO result shape does — and the
    HLO-named kind the cost shapes below are keyed on."""
    kind = getattr(desc, 'kind', None)
    nbytes = int(getattr(desc, 'nbytes', 0) or 0)
    if _kind_factors(kind, 2) is None or nbytes <= 0:
        return None
    return nbytes, kind


def _replica_groups(desc):
    """The collective's group as ``[[global ranks]]``, or None for the
    global group (the whole world, what a flat collective runs over)."""
    ranks = getattr(desc, 'ranks', None)
    return [list(ranks)] if ranks else None


def samples_from_timeline(timeline):
    """``[(wire_bytes, kind, seconds_per_occurrence)]`` from timeline
    rows (rows of an unknown kind or no bytes dropped — see
    :func:`_result_bytes_and_kind`)."""
    samples = []
    for name, ns, cnt in timeline:
        bk = _result_bytes_and_kind(name)
        if bk is None or not cnt or ns <= 0:
            continue
        samples.append((bk[0], bk[1], ns / 1e9 / cnt))
    return samples


def tiered_samples_from_timeline(timeline, devices_per_node):
    """Split timeline rows by LINK CLASS for per-tier calibration.

    A hierarchical schedule's timeline mixes collectives on two
    physically different links: the intra-node phases run over groups
    that stay within one node, the inter-node phase over groups that
    span nodes. Fitting one α-β through both mispriced exactly the
    flat-vs-hierarchical ranking calibration exists to sharpen, so
    each row is classified by its group's ranks: a group within one
    node (``rank // devices_per_node`` constant) -> ICI; a cross-node
    group — including the global group a flat collective runs over,
    which spans nodes by construction on a multi-node run — -> DCN.

    Returns ``(ici, dcn)`` sample lists; each sample is
    ``(wire_bytes, kind, seconds, group_size)`` with the group size
    the fit's hop count must use (an intra-node ring has ``g-1`` hops,
    not ``n-1``).
    """
    g = max(1, int(devices_per_node))
    ici, dcn = [], []
    for name, ns, cnt in timeline:
        bk = _result_bytes_and_kind(name)
        if bk is None or not cnt or ns <= 0:
            continue
        t = ns / 1e9 / cnt
        groups = _replica_groups(name)
        if groups is None:
            dcn.append((bk[0], bk[1], t, 0))
            continue
        cross = any(len({i // g for i in grp}) > 1 for grp in groups)
        size = len(groups[0])
        (dcn if cross else ici).append((bk[0], bk[1], t, size))
    return ici, dcn


#: (hop multiplier, byte multiplier as a fraction of (n-1)/n·B) per
#: collective kind — the kind-specific cost shapes the fit inverts.
#: all-reduce is the ring (two phases); RS/AG are one phase each;
#: a permute is one hop moving the full buffer once.
def _kind_factors(kind, n):
    if kind == 'all-reduce':
        return 2.0 * (n - 1), 2.0 * (n - 1) / n
    if kind in ('reduce-scatter', 'all-gather', 'all-to-all'):
        return float(n - 1), float(n - 1) / n
    if kind == 'collective-permute':
        return 1.0, 1.0
    return None


def fit_alpha_beta(samples, num_replicas):
    """Least-squares (α, β) over kind-aware cost shapes.

    Each sample contributes ``t ≈ h(kind)·α + w(kind)·B·β`` with the
    hop/byte multipliers of ITS collective kind — so reduce-scatter/
    all-gather rows (a ZeRO run's whole timeline) are not mispriced
    through the ring-all-reduce formula. A sample may carry a fourth
    element, its own replica-GROUP size (hierarchical schedules run
    intra-node collectives over ``g`` devices, not ``n``); 0 or absent
    falls back to ``num_replicas``. Returns ``(alpha_s,
    beta_s_per_byte)`` or None when the fit is degenerate (fewer than
    2 distinct byte sizes, or a non-positive β — measurement noise on
    tiny collectives).
    """
    import numpy as np

    n = max(2, int(num_replicas))
    rows = []
    for s in samples:
        b, kind, t = s[0], s[1], s[2]
        n_s = int(s[3]) if len(s) > 3 and s[3] else n
        f = _kind_factors(kind, max(2, n_s))
        if f is None:
            continue
        rows.append((f[0], f[1] * b, t))
    if len({w for _, w, _ in rows}) < 2:
        return None
    design = np.asarray([(h, w) for h, w, _ in rows], dtype=np.float64)
    ts = np.asarray([t for _, _, t in rows], dtype=np.float64)
    (alpha, beta), *_ = np.linalg.lstsq(design, ts, rcond=None)
    if beta <= 0:
        return None
    return float(max(alpha, 0.0)), float(beta)


def tier_links(params, host_scale=None):
    """Per-tier ``{tier: (alpha, beta)}`` for schedule-IR pricing
    (:func:`cost_model.program_time`'s ``links`` argument). The ICI
    and DCN tiers come straight from ``params`` — calibrated constants
    when a fit ran, analytic otherwise. The intermediate ``host`` tier
    (cross-host but intra-slice; no legacy schedule runs collectives
    there, so nothing calibrates it directly) defaults to the
    geometric mean of the two measured tiers — the standard
    interpolation for an unmeasured middle link — or to
    ``host_scale`` × the ICI constants when the caller knows the
    ratio."""
    ai, bi = params.link(cross_node=False)
    ad, bd = params.link(cross_node=True)
    if host_scale:
        host = (ai * float(host_scale), bi * float(host_scale))
    else:
        host = ((ai * ad) ** 0.5, (bi * bd) ** 0.5)
    return {'local': (0.0, 0.0), 'ici': (ai, bi), 'host': host,
            'dcn': (ad, bd)}


def samples_from_drift(table):
    """Entry-labeled ``(ici, dcn)`` sample lists from a roofline
    drift table (:func:`autodist_tpu_torch.telemetry.roofline.drift_table`).

    Each sample is ``(full_buffer_bytes, hlo kind, seconds,
    group_size)`` — tier-labeled BY THE SCHEDULE ENTRY, not by the
    replica-groups heuristic, and carrying the schedule's FULL buffer
    bytes rather than the result shape. That second point is the
    correctness fix: a reduce-scatter's result is the 1/n shard,
    so the unlabeled path (:func:`tiered_samples_from_timeline` /
    :func:`samples_from_timeline`) feeds ``B/n`` into a cost shape
    priced over ``B`` and fits a β inflated by ``n`` — a ZeRO or
    weight-update-sharded trace calibrated through it overprices
    every reduce-scatter/all-gather by the replica count
    (``tests/test_roofline.py`` pins the divergence in the JAX package).
    """
    ici, dcn = [], []
    for tier, full_b, hlo_kind, seconds, group in \
            (table or {}).get('samples', ()):
        row = (full_b, hlo_kind, seconds, group)
        (dcn if tier == 'dcn' else ici).append(row)
    return ici, dcn


def calibrate_from_drift(params, table, num_replicas,
                         devices_per_node=0):
    """Refined copy of ``params`` from an entry-labeled drift table —
    the roofline observatory's replacement for the unlabeled-row
    heuristic classification.

    The ICI and DCN tiers are fitted from the table's entry-labeled
    samples (:func:`samples_from_drift`) under the same
    fallback rules as :func:`calibrate_from_timeline`'s tiered path:
    a tier with a degenerate fit borrows the group-aware shared fit,
    a tier ABSENT from the table keeps its analytic constants, and an
    empty table returns ``params`` untouched (warned).
    """
    ici, dcn = samples_from_drift(table)
    if not (ici or dcn):
        logging.warning(
            'calibrate: drift table carries no joinable samples — '
            'keeping analytic α-β constants')
        return params
    shared = fit_alpha_beta(ici + dcn, num_replicas)
    return _apply_tier_fits(params, ici, dcn, shared, num_replicas,
                            devices_per_node or num_replicas)


def _apply_tier_fits(params, ici, dcn, shared, num_replicas,
                     devices_per_node):
    """Per-tier least-squares application with the shared-fit /
    analytic fallback rules (the one implementation behind
    :func:`calibrate_from_timeline`'s tiered path and
    :func:`calibrate_from_drift`)."""
    import dataclasses

    fit_i = fit_alpha_beta(ici, devices_per_node) if ici else None
    fit_d = fit_alpha_beta(dcn, num_replicas) if dcn else None
    out = params
    for tier, fit, nrows in (('ICI', fit_i, len(ici)),
                             ('DCN', fit_d, len(dcn))):
        if fit is None:
            # a tier with SOME rows but a degenerate fit borrows
            # the group-aware shared fit (its own rows are in it);
            # a tier ABSENT from the trace keeps its analytic
            # constants — assigning an all-DCN shared fit to an
            # unmeasured ICI tier would make the model reject
            # every two-level schedule, the opposite of what
            # calibration is for
            if nrows == 0 or shared is None:
                logging.info(
                    'calibrate: %s tier has no usable fit (%d '
                    'rows%s) — keeping its analytic constants',
                    tier, nrows,
                    '' if nrows else ', tier absent from trace')
                continue
            logging.info(
                'calibrate: %s tier has too few samples (%d '
                'rows); falling back to the shared fit', tier,
                nrows)
            fit = shared
        alpha, beta = fit
        if tier == 'DCN':
            out = dataclasses.replace(
                out, alpha_dcn_s=alpha, beta_dcn_s_per_byte=beta,
                calibrated=True)
        else:
            out = dataclasses.replace(
                out, alpha_ici_s=alpha, beta_ici_s_per_byte=beta,
                calibrated=True)
        logging.info(
            'calibrate: fitted %s tier alpha=%.3gs beta=%.3gs/B '
            '(%d rows)', tier, alpha, beta, nrows)
    return out


def calibrate_from_timeline(params, timeline, num_replicas,
                            cross_node=False, devices_per_node=0):
    """Refined copy of ``params`` from collective timeline rows.

    With ``devices_per_node > 1`` (a multi-node run whose node shape
    the caller knows), the ICI and DCN tiers are fitted SEPARATELY:
    rows are split by replica-group span
    (:func:`tiered_samples_from_timeline`) and each tier gets its own
    least-squares α-β, so the flat-vs-hierarchical ranking is
    calibrated per link class. A tier with too few samples for its own
    fit falls back to the SHARED fit over all rows (the pre-tier
    behavior); when that is degenerate too, the analytic constants for
    that tier stay in place.

    Without ``devices_per_node``, the single shared fit lands on the
    tier ``cross_node`` selects, exactly as before.

    Leaves ``params`` untouched (and returns it as-is, warned) when the
    timeline yields no usable fit at all.
    """
    import dataclasses

    samples = samples_from_timeline(timeline or [])
    shared = fit_alpha_beta(samples, num_replicas) if samples else None
    if devices_per_node and devices_per_node > 1:
        ici, dcn = tiered_samples_from_timeline(timeline or [],
                                                devices_per_node)
        # the tier fallback inverts through each row's OWN group size
        # (a group-aware shared fit), not the legacy flat-n assumption
        shared = fit_alpha_beta(ici + dcn, num_replicas) or shared \
            if (ici or dcn) else shared
        out = _apply_tier_fits(params, ici, dcn, shared, num_replicas,
                               devices_per_node)
        if not out.calibrated:
            logging.warning(
                'calibrate: no usable collective samples in either '
                'tier (%d rows) — keeping analytic α-β constants',
                len(timeline or []))
        return out
    if shared is None:
        logging.warning(
            'calibrate: no usable collective samples (%d rows, %d '
            'parsed) — keeping analytic α-β constants', len(timeline or []),
            len(samples))
        return params
    alpha, beta = shared
    if cross_node:
        out = dataclasses.replace(params, alpha_dcn_s=alpha,
                                  beta_dcn_s_per_byte=beta,
                                  calibrated=True)
    else:
        out = dataclasses.replace(params, alpha_ici_s=alpha,
                                  beta_ici_s_per_byte=beta,
                                  calibrated=True)
    logging.info('calibrate: fitted alpha=%.3gs beta=%.3gs/B from %d '
                 'collective samples (%s link)', alpha, beta,
                 len(samples), 'DCN' if cross_node else 'ICI')
    return out


def calibrate_from_trace(params, trace_dir, num_replicas,
                         cross_node=False, devices_per_node=0,
                         expected_collectives=0):
    """Refined copy of ``params`` from a captured profiler trace dir
    (``Trainer.profile`` output, a ``torch.profiler`` Chrome trace).
    Degrades to the analytic constants when the trace has no collective
    rows (a one-rank run, where the Trainer syncs nothing, or a missing
    trace). ``devices_per_node`` > 1 fits the ICI and DCN tiers
    separately (see :func:`calibrate_from_timeline`).
    ``expected_collectives`` (the plan's statically-known emission
    count, e.g. ``len(grad_bucket_layout(...))``) makes a
    zero-collective parse on a run that emitted buckets log loudly
    instead of silently keeping analytic constants."""
    from autodist_tpu_torch.utils.profiling import collective_timeline
    timeline = collective_timeline(
        trace_dir, expected_collectives=expected_collectives)
    return calibrate_from_timeline(params, timeline, num_replicas,
                                   cross_node=cross_node,
                                   devices_per_node=devices_per_node)
