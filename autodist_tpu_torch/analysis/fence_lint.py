"""Fence-coverage + payload-bound lint over the native coord-service
dispatcher.

Statically parses ``native/coord_service.cc`` and proves, per
dispatched command, the writer-fencing contract the elastic-recovery
protocol rests on: every MUTATING command must check
``is_fenced``/``is_fenced_locked`` and have an ``ERR fenced``
(``kFencedErr``) reply path, and every tensor-mutating ``B*`` command
must ALSO re-check under the tensor lock
(``reject_fenced_under_tensor_lock``) so one in-flight zombie frame
cannot commit after its fence bump.

It also generalizes the BGETROWS hardening into a rule: every
command whose header DECLARES a size (payload bytes to buffer, or
reply dimensions to allocate) must bound that declaration against
``kMaxPayload`` BEFORE any buffer is sized from it — an unvalidated
product can ``bad_alloc`` (or wrap ``size_t``) and kill the whole
control plane. Request-side declarations are bounded in
``payload_size()`` (returning ``kBadPayload``); reply-side
declarations are bounded inside the command's own dispatcher block.
The :data:`PAYLOAD_BOUNDED` table is the ground truth; a dispatcher
block that touches the request ``payload`` without a table entry is a
finding, so a new payload-bearing command forces an explicit bounding
decision.

The classification tables below are the lint's ground truth: a
command the dispatcher matches that appears in NO table is a finding —
adding a protocol command forces an explicit fencing decision here
(and a model-checker look; see ``docs/design/static-analysis.md``).

Absorbs ``tools/check_protocol.py``: the header comment's command
table must match the dispatcher's ``cmd == "..."`` set, and the header
paragraph enumerating the fenced mutating commands must match the
MUTATING table (BSTAT and BSADD have each drifted out of the header
before).
"""
import os
import re

SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))),
    'autodist_tpu_torch', 'native', 'coord_service.cc')

#: Commands that mutate durable state: each must be fence-checked with
#: an ERR fenced path. Values are the rationale (documentation the
#: lint enforces reading when the table changes).
MUTATING = {
    'SET': 'writes kv state',
    'DEL': 'erases a key/counter — a zombie delete corrupts state as '
           'surely as a write',
    'DELNS': 'purges a whole namespace',
    'INCR': 'advances counters (step publishes, claims, epochs); '
            'delta-0 reads are exempt inside the handler',
    'BSET': 'overwrites tensor data',
    'BADD': 'accumulates into tensor data',
    'BSADD': 'row-sparse scatter-add into tensor data',
    'BSTEP': 'applies an optimizer update to PS-resident state',
}

#: Tensor-mutating commands additionally re-check the fence under the
#: tensor lock: the global-mu check alone leaves a window where a
#: zombie frame already past it commits after the fence bump.
TENSOR_MUTATING = ('BSET', 'BADD', 'BSADD', 'BSTEP')

#: Commands allowed to skip the fence check, with the reason. Reads
#: and waits never fence (a zombie observing the world is harmless).
ALLOWED_UNFENCED = {
    'GET': 'read',
    'BGET': 'read (torn-read version contract)',
    'BSTAT': 'read (tensor introspection)',
    'BGETROWS': 'read (row fetch)',
    'WAITGE': 'wait (no mutation)',
    'MINWAIT': 'wait (no mutation)',
    'PING': 'liveness probe',
    'FENCE': 'binds the generation itself (rejects superseded binds)',
    'BARRIER': 'transient rendezvous arrivals only — withdrawn on '
               'timeout, never durable state; completing a round '
               'still needs k-1 live parties',
    'SHUTDOWN': 'operator action (sets the shutting_down flag only)',
}

#: AUTH is consumed by the connection handshake (serve_conn) before any
#: command reaches handle(); it belongs in the header but can never
#: appear in the dispatcher.
HANDSHAKE_ONLY = {'AUTH'}

#: The epoch-swap handshake's key schema (runtime/swap_keys.py) and the
#: protocol verbs each key rides, with the fencing rationale. The swap
#: handshake introduces NO new protocol commands — every write rides a
#: verb the MUTATING table already fences, which is exactly the
#: property :func:`check_swap_keys` proves: a zombie chief (superseded
#: fence generation) cannot stage, cancel, or arm a swap, because SET/
#: INCR/DELNS all reject it. Key templates use ``<g>`` for the staged
#: generation and ``<w>`` for a worker ordinal.
SWAP_KEY_VERBS = {
    'swap/gen': 'INCR — monotone generation counter; the stage bump '
                'is fenced, discovery reads are delta-0',
    'swap/<g>/plan': 'SET/GET/DELNS — staged plan payload; staging '
                     'and cancel are fenced writes',
    'swap/<g>/ack/<w>': 'SET/GET/DELNS — peer validation ack '
                        '(fenced: a zombie peer cannot fill a quorum)',
    'swap/<g>/nack/<w>': 'SET/GET/DELNS — peer rejection + reason '
                         '(fenced: a zombie cannot cancel a live '
                         'swap)',
    'swap/<g>/B': 'SET/GET/DELNS — the armed commit boundary; arming '
                  'is a fenced write',
    'swap/<g>/ready': 'SET/GET/DELNS — chief finished re-keying the '
                      'authoritative PS copies (GET via wait_key '
                      'polling)',
}

#: DELNS prefixes in swap_keys.py — namespace sweeps, not keys; they
#: cover whole generations (cancel / previous-generation purge) or the
#: whole subtree (run-end purge).
SWAP_KEY_PREFIXES = {'swap/', 'swap/<g>/'}

#: coord_client methods the swap-key module may call, mapped to the
#: protocol verb each one speaks (wait_key is a GET poll loop).
_SWAP_CLIENT_VERBS = {
    'set': 'SET',
    'get': 'GET',
    'incr': 'INCR',
    'delete_namespace': 'DELNS',
    'wait_key': 'GET',
}

#: Commands whose header line declares a size. 'request' = the
#: declared payload bytes are buffered before handle() runs, so the
#: bound must live in ``payload_size()`` (return ``kBadPayload`` past
#: ``kMaxPayload``); 'reply' = the block allocates a reply buffer from
#: declared dimensions, so the bound must live in the block itself
#: (the BGETROWS fix: a 256 GB nrows*ncols declaration must be
#: refused before the allocation, not discovered as bad_alloc).
PAYLOAD_BOUNDED = {
    'BSET': ('request',),
    'BADD': ('request',),
    'BSTEP': ('request',),
    'BSADD': ('request',),
    'BGETROWS': ('request', 'reply'),
}


def _read(text=None):
    if text is None:
        with open(SRC) as f:
            text = f.read()
    return text


def documented_commands(text):
    """Commands listed in the header comment's protocol table: lines of
    the form ``//   CMD <args...> -> reply`` before the first
    ``#include``."""
    header = text.split('#include', 1)[0]
    return set(re.findall(r'^//   ([A-Z][A-Z0-9]*)\b', header, re.M))


def header_fenced_commands(text):
    """The mutating-command enumeration in the header's writer-fencing
    paragraph ('every mutating command on the connection — X, Y — is
    rejected ...')."""
    header = text.split('#include', 1)[0]
    m = re.search(r'every mutating command[^—]*—([^—]+)—', header,
                  re.S)
    if not m:
        return None
    return set(re.findall(r'\b([A-Z][A-Z0-9]*)\b', m.group(1)))


def _fn_body(text, pattern):
    """The balanced-brace body of the first function whose signature
    matches ``pattern``, or None."""
    m = re.search(pattern, text)
    if not m:
        return None
    i = text.index('{', m.end())
    depth = 0
    for j in range(i, len(text)):
        if text[j] == '{':
            depth += 1
        elif text[j] == '}':
            depth -= 1
            if depth == 0:
                return text[i:j + 1]
    return None


def _handle_body(text):
    """The body of the ``handle()`` function (the dispatcher) — scoped
    so ``payload_size``'s own ``cmd ==`` matches don't alias."""
    return _fn_body(text, r'std::string handle\(')


def payload_size_branches(text):
    """``{command: branch source}`` inside ``payload_size()`` — the
    function that decides how many request-payload bytes to buffer
    from a header declaration. A branch runs from the first line
    mentioning the command to the next command's first line (commands
    sharing one guard line — the BSET/BADD/BSTEP tail — share the
    remainder). None when the function is missing."""
    body = _fn_body(text, r'size_t payload_size\(')
    if body is None:
        return None
    by_line = {}
    for m in re.finditer(r'cmd [=!]= "([A-Z][A-Z0-9]*)"', body):
        ls = body.rfind('\n', 0, m.start()) + 1
        by_line.setdefault(ls, []).append(m.group(1))
    first = {}
    for ls in sorted(by_line):
        for cmd in by_line[ls]:
            first.setdefault(cmd, ls)
    starts = sorted(set(first.values()))
    out = {}
    for cmd, ls in first.items():
        nxt = [s for s in starts if s > ls]
        out[cmd] = body[ls:nxt[0] if nxt else len(body)]
    return out


def dispatched_blocks(text):
    """``{command: block source}`` for every ``if (cmd == "X")`` in the
    dispatcher — the braced block, or the single statement for
    brace-less arms (PING)."""
    body = _handle_body(text)
    if body is None:
        return {}
    blocks = {}
    for m in re.finditer(r'if \(cmd == "([A-Z][A-Z0-9]*)"\)', body):
        cmd = m.group(1)
        k = m.end()
        while k < len(body) and body[k] in ' \n':
            k += 1
        if k < len(body) and body[k] == '{':
            depth = 0
            for j in range(k, len(body)):
                if body[j] == '{':
                    depth += 1
                elif body[j] == '}':
                    depth -= 1
                    if depth == 0:
                        blocks[cmd] = body[k:j + 1]
                        break
        else:
            blocks[cmd] = body[k:body.index(';', k) + 1]
    return blocks


def dispatched_commands(text):
    """Commands the dispatcher actually matches."""
    return set(dispatched_blocks(text))


def find_drift(text=None):
    """The absorbed ``check_protocol`` check: header command table vs
    dispatcher. Returns human-readable problems (empty = in sync)."""
    text = _read(text)
    doc = documented_commands(text)
    disp = dispatched_commands(text)
    problems = []
    for cmd in sorted(disp - doc):
        problems.append('dispatched but not documented in the header '
                        'comment: %s' % cmd)
    for cmd in sorted(doc - disp - HANDSHAKE_ONLY):
        problems.append('documented in the header comment but not '
                        'dispatched: %s' % cmd)
    if not doc:
        problems.append('no documented commands found — the header '
                        'comment table moved or changed format')
    return problems


def _strip_comments(src):
    """Drop ``//`` line and ``/* */`` block comments: a bound that
    exists only in prose must not satisfy the lint."""
    src = re.sub(r'/\*.*?\*/', '', src, flags=re.S)
    return re.sub(r'//[^\n]*', '', src)


def check_payload_bounds(text, blocks=None):
    """The generalized BGETROWS hardening: every size-declaring command's
    declared allocation is bounded against ``kMaxPayload`` before any
    buffer is sized from it, and every dispatcher block that touches
    the request ``payload`` carries a :data:`PAYLOAD_BOUNDED` entry.
    Returns finding strings (empty = clean)."""
    if blocks is None:
        blocks = dispatched_blocks(text)
    findings = []
    branches = payload_size_branches(text)
    for cmd in sorted(set(PAYLOAD_BOUNDED) - set(blocks)):
        findings.append(
            'coord_service.cc: %s is classified in '
            'analysis/fence_lint.py PAYLOAD_BOUNDED but no longer '
            'dispatched — stale table entry' % cmd)
    for cmd in sorted(set(PAYLOAD_BOUNDED) & set(blocks)):
        roles = PAYLOAD_BOUNDED[cmd]
        if 'request' in roles:
            if branches is None or cmd not in branches:
                findings.append(
                    'coord_service.cc: %s declares a request payload '
                    'size but payload_size() never sizes it — the '
                    'declared bytes are buffered unbounded' % cmd)
            else:
                seg = _strip_comments(branches[cmd])
                if 'kMaxPayload' not in seg or 'kBadPayload' not in seg:
                    findings.append(
                        'coord_service.cc: %s\'s request-size '
                        'declaration is not bounded against '
                        'kMaxPayload (with a kBadPayload refusal) in '
                        'payload_size() before the bytes are buffered '
                        '— an unvalidated declaration can bad_alloc/'
                        'wrap and kill the whole control plane' % cmd)
        if 'reply' in roles and \
                'kMaxPayload' not in _strip_comments(blocks[cmd]):
            findings.append(
                'coord_service.cc: %s allocates a reply from declared '
                'dimensions without bounding them against kMaxPayload '
                'inside its dispatcher block (the BGETROWS '
                'hardening: refuse the declaration, don\'t discover '
                'it as bad_alloc)' % cmd)
    for cmd in sorted(set(blocks) - set(PAYLOAD_BOUNDED)):
        if re.search(r'\bpayload\b', _strip_comments(blocks[cmd])):
            findings.append(
                'coord_service.cc: dispatched command %s touches the '
                'request payload but is not classified in '
                'analysis/fence_lint.py PAYLOAD_BOUNDED — a new '
                'payload-bearing command needs an explicit '
                'size-bounding decision' % cmd)
    return findings


def check_read_only_client(mutating=None):
    """The read-only-client invariant, machine-checked: the
    serving tier's reader connections refuse every verb this lint
    classifies as MUTATING, plus FENCE (not a write, but it BINDS a
    writer generation — a reader holding one would enter the cohort's
    zombie-detection protocol). The guard lives in coord_client's
    ``READ_ONLY_BLOCKED``; if a new mutating command lands in the
    service without a matching entry there, the reader guard silently
    stops covering the write surface — this check turns that drift
    into a finding instead of folklore. Returns finding strings."""
    from autodist_tpu_torch.runtime import coord_client
    mutating = set(MUTATING if mutating is None else mutating)
    blocked = set(coord_client.READ_ONLY_BLOCKED)
    findings = []
    for cmd in sorted(mutating - blocked):
        findings.append(
            'coord_client.py: mutating command %s (%s) is missing from '
            'READ_ONLY_BLOCKED — a read-only serving connection could '
            'mutate the training namespace' % (cmd, MUTATING.get(
                cmd, 'classified mutating by fence_lint')))
    if 'FENCE' not in blocked:
        findings.append(
            'coord_client.py: FENCE is missing from READ_ONLY_BLOCKED '
            '— a read-only connection could bind a writer generation, '
            'and readers must never take writer fences')
    for cmd in sorted(blocked - mutating - {'FENCE'}):
        findings.append(
            'coord_client.py: READ_ONLY_BLOCKED lists %s, which '
            'fence_lint does not classify as mutating (and is not '
            'FENCE) — stale entry, or a new mutating command missing '
            'from the MUTATING table' % cmd)
    return findings


def _swap_keys_source():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), 'runtime', 'swap_keys.py')
    with open(path) as f:
        return f.read()


def _normalize_swap_template(lit):
    """A ``swap/...`` string literal from swap_keys.py in the table's
    ``<g>``/``<w>`` template form: the first ``%d`` is the generation,
    a second is a worker ordinal."""
    out = lit.replace('%d', '<g>', 1)
    return out.replace('%d', '<w>', 1)


def check_swap_keys(src=None):
    """The epoch-swap key-schema classification: statically
    parse ``runtime/swap_keys.py`` and prove (a) every coordinator
    verb it speaks is classified (MUTATING or ALLOWED_UNFENCED — its
    writes all ride fenced verbs, so a zombie chief cannot stage,
    cancel, or arm a swap), and (b) every ``swap/*`` key template it
    builds has a :data:`SWAP_KEY_VERBS` entry (and vice versa) — a new
    swap key or verb forces an explicit fencing decision here instead
    of drifting in silently. Returns finding strings."""
    import ast
    src = _swap_keys_source() if src is None else src
    tree = ast.parse(src)
    findings = []
    methods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == 'client':
            methods.add(node.func.attr)
    for m in sorted(methods - set(_SWAP_CLIENT_VERBS)):
        findings.append(
            'swap_keys.py: calls coord-client method %s, which '
            'fence_lint does not map to a protocol verb '
            '(_SWAP_CLIENT_VERBS) — a new verb in the swap handshake '
            'needs an explicit fencing decision' % m)
    for m in sorted(methods & set(_SWAP_CLIENT_VERBS)):
        verb = _SWAP_CLIENT_VERBS[m]
        if verb not in MUTATING and verb not in ALLOWED_UNFENCED:
            findings.append(
                'swap_keys.py: speaks verb %s (via client.%s) which '
                'is classified in neither MUTATING nor '
                'ALLOWED_UNFENCED — the swap handshake must ride '
                'classified verbs only' % (verb, m))
    # the values of swap_keys.MODEL_SYMBOLS are ABSTRACT model-side
    # symbols (epoch_swap_model vocabulary), not coordinator keys —
    # collect them so the literal sweep below skips them
    abstract = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == 'MODEL_SYMBOLS'
                for t in node.targets) and \
                isinstance(node.value, ast.Dict):
            for v in node.value.values:
                if isinstance(v, ast.Constant) and \
                        isinstance(v.value, str):
                    abstract.add(v.value)
    lits = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and \
                isinstance(node.value, str) and \
                node.value.startswith('swap/') and \
                node.value not in abstract:
            lits.add(_normalize_swap_template(node.value))
    keys = lits - SWAP_KEY_PREFIXES
    for k in sorted(keys - set(SWAP_KEY_VERBS)):
        findings.append(
            'swap_keys.py: builds swap key %s with no '
            'SWAP_KEY_VERBS classification in analysis/fence_lint.py '
            '— a new swap/<gen> key needs an explicit fencing '
            'decision' % k)
    for k in sorted(set(SWAP_KEY_VERBS) - keys):
        findings.append(
            'fence_lint.py: SWAP_KEY_VERBS classifies %s, which '
            'swap_keys.py no longer builds — stale table entry' % k)
    for p in sorted(SWAP_KEY_PREFIXES - lits):
        findings.append(
            'fence_lint.py: SWAP_KEY_PREFIXES lists %s, which '
            'swap_keys.py no longer uses — stale prefix entry' % p)
    return findings


def analyze(text=None):
    """Full fence-coverage lint. Returns finding strings (empty =
    clean)."""
    text = _read(text)
    findings = ['coord_service.cc: ' + p for p in find_drift(text)]
    findings.extend(check_read_only_client())
    findings.extend(check_swap_keys())
    blocks = dispatched_blocks(text)
    if not blocks:
        return findings + ['coord_service.cc: could not locate the '
                           'handle() dispatcher — the lint must be '
                           'updated with the new layout']
    classified = set(MUTATING) | set(ALLOWED_UNFENCED)
    for cmd in sorted(set(blocks) - classified):
        findings.append(
            'coord_service.cc: dispatched command %s is not classified '
            'in analysis/fence_lint.py (MUTATING or ALLOWED_UNFENCED) '
            '— a new protocol command needs an explicit fencing '
            'decision' % cmd)
    for cmd in sorted(classified - set(blocks)):
        findings.append(
            'coord_service.cc: %s is classified in '
            'analysis/fence_lint.py but no longer dispatched — stale '
            'table entry' % cmd)
    for cmd in sorted(set(MUTATING) & set(blocks)):
        block = blocks[cmd]
        if 'is_fenced_locked(' not in block and \
                'is_fenced(' not in block:
            findings.append(
                'coord_service.cc: mutating command %s (%s) has no '
                'fence check (is_fenced/is_fenced_locked)'
                % (cmd, MUTATING[cmd]))
        if 'kFencedErr' not in block:
            findings.append(
                'coord_service.cc: mutating command %s has no ERR '
                'fenced reply path (kFencedErr)' % cmd)
        if cmd in TENSOR_MUTATING and \
                'reject_fenced_under_tensor_lock(' not in block:
            findings.append(
                'coord_service.cc: tensor-mutating command %s does not '
                're-check the fence under the tensor lock '
                '(reject_fenced_under_tensor_lock) — one in-flight '
                'zombie frame could commit after its fence bump' % cmd)
    findings.extend(check_payload_bounds(text, blocks))
    hdr = header_fenced_commands(text)
    if hdr is None:
        findings.append(
            'coord_service.cc: the header\'s writer-fencing paragraph '
            '("every mutating command ... — X, Y — is rejected") was '
            'not found — keep the enumeration, the lint pins it to '
            'the MUTATING table')
    else:
        for cmd in sorted(set(MUTATING) - hdr):
            findings.append(
                'coord_service.cc: header writer-fencing paragraph '
                'does not list mutating command %s' % cmd)
        for cmd in sorted(hdr - set(MUTATING)):
            findings.append(
                'coord_service.cc: header writer-fencing paragraph '
                'lists %s, which the lint does not classify as '
                'mutating' % cmd)
    return findings
