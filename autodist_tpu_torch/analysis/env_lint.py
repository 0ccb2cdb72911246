"""Env-knob lint: no undeclared ``AUTODIST_*`` reads, no silently
unforwarded knobs, no docs drift.

Three invariants over the whole tree:

1. **Declaration** — every ``AUTODIST_*`` environment read (Python
   ``os.environ[...]``/``os.environ.get``/``os.getenv``, C++
   ``getenv``) must name a member of ``const.py``'s typed ENV
   registry, or carry an explicit entry in :data:`ALLOWED_RAW_READS`
   with a reason. A raw read of an undeclared name is a knob with no
   validation, no documentation surface and no forwarding decision —
   exactly how ``AUTODIST_FUSED_CONV`` and ``AUTODIST_PP_STASH_LIMIT_MB``
   lived unregistered for several PRs.
2. **Forwarding** — every ENV member must either ride the
   coordinator's ``_FORWARDED_FLAGS`` (worker-affecting knobs reach
   every launched worker) or appear in :data:`FORWARD_EXEMPT` with the
   reason it deliberately does not (per-worker identity, chief-side
   only, security transport, explicit-install chaos knobs). A knob in
   neither set is a finding: an operator exporting it on the chief
   would silently configure only the chief.
3. **Documentation** — every ``AUTODIST_*`` ENV member must be
   mentioned somewhere under ``docs/`` (the generated ``docs/api/``
   pages don't count: they mirror docstrings, so they can't catch a
   knob the hand-written docs forgot — ``docs/usage/env-knobs.md`` is
   the catch-all reference), and a choice-validated knob
   (``_choice`` in const.py, e.g. ``AUTODIST_STRAGGLER_POLICY``) must
   enumerate the SAME choice set in the docs near its mention —
   findings name the knob and the missing/stale side.

Writes (``os.environ[k] = v``, ``.setdefault``, ``.pop``, ``del``,
``monkeypatch.setenv``) are not reads and are ignored.
"""
import glob
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: Scanned roots, relative to the repo (the port's tree: its package,
#: its examples, its card script and its tests; glob patterns allowed).
SCAN_ROOTS = ('autodist_tpu_torch', 'examples_torch', 'chip_smoke.py',
              'tests/test_torch_*.py', 'tests/torch_*.py')

#: Undeclared raw reads allowed, with the reason. Empty on HEAD: every
#: knob the tree reads is registered. Add entries only for names that
#: deliberately must not enter the registry (none known today).
ALLOWED_RAW_READS = {}

#: ENV members that deliberately do NOT ride ``_FORWARDED_FLAGS``,
#: with the reason. Everything else must be forwarded.
FORWARD_EXEMPT = {
    'AUTODIST_WORKER':
        'per-worker identity, set explicitly by Coordinator._worker_env',
    'AUTODIST_STRATEGY_ID':
        'per-launch value, set explicitly by Coordinator._worker_env',
    'AUTODIST_PROCESS_ID':
        'per-worker identity, set explicitly by Coordinator._worker_env',
    'AUTODIST_NUM_PROCESSES':
        'per-launch value, set explicitly by Coordinator._worker_env',
    'AUTODIST_COORDINATOR_ADDR':
        'per-launch value, set explicitly by Coordinator._worker_env',
    'AUTODIST_RUN_ID':
        'per-launch nonce, issued and set explicitly by the launcher',
    'AUTODIST_DEBUG_REMOTE':
        'chief-side launcher behavior (print instead of ssh)',
    'AUTODIST_DUMP_GRAPHS':
        'per-process debug dumps; divergence is harmless',
    'AUTODIST_COORD_TOKEN':
        'deliberately not forwarded: env assignments ride the remote '
        'ssh command line (world-readable in ps); the secret ships as '
        'a mode-0600 file via AUTODIST_COORD_TOKEN_FILE instead',
    'AUTODIST_COORD_TOKEN_FILE':
        'set explicitly per worker after the token file is copied',
    'AUTODIST_ELASTIC_JOIN':
        'set per joiner by Coordinator.scale_up, never on the launch '
        'cohort',
    'AUTODIST_AUTO_CHECKPOINT_EVERY':
        'chief-side checkpoint backstop; workers never act on it',
    'AUTODIST_FAULT_PLAN':
        'chaos-only: honored only where a FaultLine is explicitly '
        'installed; production sessions never read it',
    'AUTODIST_STRAGGLER_POLICY':
        'chief-side monitor verdict policy: workers only emit spans '
        '(AUTODIST_TELEMETRY is forwarded) and never act on verdicts',
    'AUTODIST_MONITOR_WINDOW':
        'chief-side monitor statistics window; no worker reads it',
    'AUTODIST_RECALIBRATE_EVERY':
        "chief-side recalibration cadence; the refit constants feed "
        "only the chief's re-rank",
}

_PY_READ = re.compile(
    r'''os\.environ\.get\(\s*['"](AUTODIST_\w+)['"]'''
    r'''|os\.getenv\(\s*['"](AUTODIST_\w+)['"]'''
    r'''|(?<!del )os\.environ\[['"](AUTODIST_\w+)['"]\](?![ \t]*=[^=])''')
_CC_READ = re.compile(r'getenv\("(AUTODIST_\w+)"\)')


def _iter_sources():
    for root in SCAN_ROOTS:
        if any(c in root for c in '*?['):
            yield from sorted(glob.glob(os.path.join(REPO, root)))
            continue
        path = os.path.join(REPO, root)
        if os.path.isfile(path):
            yield path
            continue
        for dirpath, dirnames, filenames in os.walk(path):
            dirnames[:] = [d for d in dirnames
                           if d not in ('__pycache__', '.git')]
            for fn in filenames:
                if fn.endswith(('.py', '.cc', '.h')):
                    yield os.path.join(dirpath, fn)


def raw_reads(files=None):
    """``[(relpath, lineno, name)]`` for every AUTODIST_* env read.

    Scans whole-file text (not per-line) so a call wrapped across lines
    for the 72-column style — ``os.environ.get(\\n    'AUTODIST_X')`` —
    still matches."""
    out = []
    own = os.path.abspath(__file__)
    for path in (files if files is not None else _iter_sources()):
        if os.path.abspath(path) == own:
            continue   # this module's own regex literals are not reads
        pat = _CC_READ if path.endswith(('.cc', '.h')) else _PY_READ
        with open(path, encoding='utf-8', errors='replace') as f:
            text = f.read()
        for m in pat.finditer(text):
            name = next(g for g in m.groups() if g)
            out.append((os.path.relpath(path, REPO),
                        text.count('\n', 0, m.start()) + 1, name))
    return out


def declared_env():
    from autodist_tpu_torch.const import ENV
    return {e.name for e in ENV}


#: Hand-written docs roots the documentation invariant scans;
#: ``docs/api`` is excluded on purpose (generated from docstrings —
#: it cannot catch a knob the written docs forgot).
DOCS_EXCLUDE = ('api',)


def docs_text(root=None):
    """Concatenated hand-written docs (``docs/**/*.md|rst`` minus the
    generated API pages)."""
    root = root or os.path.join(REPO, 'docs')
    chunks = []
    for dirpath, dirnames, filenames in os.walk(root):
        if dirpath == root:
            # only the TOP-LEVEL docs/api is generated; a hand-written
            # nested dir that happens to be named 'api' still counts
            dirnames[:] = [d for d in dirnames if d not in DOCS_EXCLUDE]
        for fn in sorted(filenames):
            if fn.endswith(('.md', '.rst')):
                with open(os.path.join(dirpath, fn),
                          encoding='utf-8', errors='replace') as f:
                    chunks.append(f.read())
    return '\n'.join(chunks)


def choice_sets(src=None):
    """``{knob: (choices...)}`` for every ``_choice``-validated ENV
    member, parsed from const.py's AST (robust to quoting, the lambda
    parameter name, and call formatting — a regex here once meant a
    reformatted call silently dropped its knob from the invariant).
    A ``_choice`` call whose name or choice tuple is not a static
    literal maps to ``None``, which :func:`check_docs` reports as a
    finding instead of silently skipping the knob."""
    import ast
    if src is None:
        src_path = os.path.join(REPO, 'autodist_tpu_torch', 'const.py')
        with open(src_path, encoding='utf-8') as f:
            src = f.read()
    out = {}
    for node in ast.walk(ast.parse(src)):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == '_choice'):
            continue
        name = node.args[0] if node.args else None
        allowed = node.args[3] if len(node.args) > 3 else None
        name = name.value if (isinstance(name, ast.Constant)
                              and isinstance(name.value, str)) else None
        if allowed is not None and isinstance(
                allowed, (ast.Tuple, ast.List)) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in allowed.elts):
            choices = tuple(e.value for e in allowed.elts)
        else:
            choices = None
        if name is None:
            # a dynamic knob name: surface it under a sentinel so the
            # lint still complains instead of skipping the call
            name = '<dynamic _choice call at line %d>' % node.lineno
            choices = None
        out[name] = choices
    return out


def _doc_windows(docs, knob, radius=700):
    """Text windows around every docs mention of ``knob`` — the
    neighborhood a choice enumeration must live in."""
    wins = []
    for m in re.finditer(re.escape(knob), docs):
        wins.append(docs[max(0, m.start() - radius):
                         m.end() + radius])
    return wins


#: An enumeration-looking token run in PROSE: words separated by ``/``
#: or ``|``, with optional backticks.
_ENUM = re.compile(r'`?(\w+)`?(?:\s*[/|]\s*`?(\w+)`?)+')
#: The same inside one markdown TABLE CELL, where a bare ``|`` is the
#: cell delimiter and a literal pipe separator is escaped as ``\|``.
_ENUM_CELL = re.compile(r'`?(\w+)`?(?:\s*(?:/|\\\|)\s*`?(\w+)`?)+')


def _enum_runs(blob):
    """Enumeration-looking token runs in ``blob``, table-aware: on a
    markdown table row the scan runs per CELL (a bare ``|`` delimits
    cells there, so a run must not chain across the boundary and
    swallow the next cell's first word as a phantom choice)."""
    out = []
    for line in blob.splitlines():
        if line.lstrip().startswith('|'):
            for cell in re.split(r'(?<!\\)\|', line):
                out.extend(m.group(0)
                           for m in _ENUM_CELL.finditer(cell))
        else:
            out.extend(m.group(0) for m in _ENUM.finditer(line))
    return out


def check_docs(declared=None, choices=None, docs=None):
    """The documentation invariant. Returns finding strings (empty =
    clean). ``declared``/``choices``/``docs`` are injectable for
    tests."""
    findings = []
    declared = declared if declared is not None else declared_env()
    choices = choices if choices is not None else choice_sets()
    docs = docs if docs is not None else docs_text()
    for name in sorted(declared):
        if not name.startswith('AUTODIST_'):
            continue    # SYS_* reference-parity paths judged by hand
        # word-bounded: a mention of AUTODIST_TELEMETRY_DIR must not
        # satisfy AUTODIST_TELEMETRY (the registry has real prefix
        # pairs)
        if not re.search(r'\b%s\b' % re.escape(name), docs):
            findings.append(
                'env knob %s is registered in const.py ENV but never '
                'mentioned under docs/ (generated api/ pages '
                'excluded) — missing side: docs '
                '(docs/usage/env-knobs.md is the catch-all reference)'
                % name)
    for knob, allowed in sorted(choices.items()):
        if allowed is None:
            findings.append(
                'choice knob %s: const.py\'s choice set is not a '
                'static literal — the docs-sync invariant cannot '
                'verify it (make the _choice call name the knob and '
                'its tuple of string literals inline)' % knob)
            continue
        wins = _doc_windows(docs, knob)
        if not wins:
            continue    # already reported as undocumented above
        blob = '\n'.join(wins)
        for choice in allowed:
            if not re.search(r'\b%s\b' % re.escape(choice), blob):
                findings.append(
                    'choice knob %s: docs near its mention never name '
                    'the choice %r — missing side: docs (the '
                    'validator in const.py accepts %s)'
                    % (knob, choice, '|'.join(allowed)))
        # a docs enumeration that names 2+ real choices IS the choice
        # list; any extra member of it is stale on the docs side.
        # Judge only enum runs on LINES that mention this knob — the
        # ±700-char windows reach into neighboring knobs' rows, and a
        # neighbor sharing 2+ choice tokens (off/warn/... are common)
        # must not get its own valid choices flagged as this knob's
        # stale ones. One finding per stale token: mention lines can
        # repeat across overlapping windows.
        bound = re.compile(r'\b%s\b' % re.escape(knob))
        knob_lines = '\n'.join(
            ln for ln in blob.splitlines() if bound.search(ln))
        stale = set()
        for run in _enum_runs(knob_lines):
            # only lowercase word tokens can be choice values (knob
            # names and surrounding prose are not), so judge only those
            toks = [t for t in re.split(r'[^\w]+', run)
                    if t and re.fullmatch(r'[a-z][a-z0-9_]*', t)]
            hits = [t for t in toks if t in allowed]
            if len(set(hits)) < 2:
                continue
            stale.update(t for t in toks if t not in allowed)
        for t in sorted(stale):
            findings.append(
                'choice knob %s: docs enumerate choice %r, '
                'which const.py\'s validator does not accept '
                '(%s) — stale side: docs'
                % (knob, t, '|'.join(allowed)))
    return findings


def forwarded_env():
    from autodist_tpu_torch.runtime.coordinator import _FORWARDED_FLAGS
    return {e.name for e in _FORWARDED_FLAGS}


def analyze(files=None):
    """Run all three invariants. Returns finding strings (empty =
    clean)."""
    findings = []
    declared = declared_env()
    for relpath, lineno, name in raw_reads(files):
        if name in declared:
            continue
        if name in ALLOWED_RAW_READS:
            continue
        findings.append(
            '%s:%d: reads undeclared env knob %s — register it in '
            "const.py's ENV (typed, validated, forwardable) or "
            'allowlist it in analysis/env_lint.py with a reason'
            % (relpath, lineno, name))
    for name in sorted(set(ALLOWED_RAW_READS) & declared):
        findings.append(
            'env_lint.ALLOWED_RAW_READS lists %s, which IS declared in '
            "const.py's ENV — stale allowlist entry" % name)
    forwarded = forwarded_env()
    for name in sorted(declared):
        if not name.startswith('AUTODIST_'):
            continue    # SYS_* reference-parity paths judged by hand
        in_fwd = name in forwarded
        in_exempt = name in FORWARD_EXEMPT
        if in_fwd and in_exempt:
            findings.append(
                'env knob %s is BOTH in coordinator._FORWARDED_FLAGS '
                'and env_lint.FORWARD_EXEMPT — resolve the conflict'
                % name)
        elif not in_fwd and not in_exempt:
            findings.append(
                'env knob %s is declared but neither forwarded '
                '(coordinator._FORWARDED_FLAGS) nor exempted with a '
                'reason (env_lint.FORWARD_EXEMPT): an operator '
                'exporting it on the chief silently configures only '
                'the chief' % name)
    for name in sorted(set(FORWARD_EXEMPT) - declared):
        findings.append(
            'env_lint.FORWARD_EXEMPT lists %s, which is not an ENV '
            'member — stale exemption' % name)
    if files is None:   # doctored-source probes lint only their files
        findings.extend(check_docs(declared=declared))
    return findings
