"""protocheck — static contract analyzer for the distributed fabric
(port of ``paddle_tpu/analysis/protocheck.py``, pointed at
``paddle_tpu_torch/``: its corpora are the port's tests and
``chip_smoke.py`` for arming, and ``docs/TORCH_RELIABILITY.md`` for
knobs).

The fleet half of the system now spans three wire transports (the
``ProcessReplica`` stdio pipe, the ``RemoteReplica`` socket fabric,
and the train-fabric coordinator/worker protocol), a hand-maintained
typed-error registry (``cluster/net.WIRE_ERRORS``), a 21-point fault
registry, dozens of metrics counters, and a sprawl of
``PADDLE_TPU_*`` environment knobs. Each of those is a *vocabulary*
two or more modules must agree on, and nothing but care kept
them in sync — the ``handoff`` verb had to be added
to all three transports by hand, and a verb (or typed error) missing
on one transport fails only at run time, on that transport, under
traffic.

racecheck and numcheck proved the countermeasure: a
pure-AST analyzer — nothing imported, nothing compiled, trivially
JAX_PLATFORMS=cpu-safe — with a CLI, reasoned suppressions, and a
selfcheck teeth-gate. protocheck applies it to the protocol
vocabularies, five rule families over ``cluster/``, ``serving/``,
``resilience/`` and ``tools/``:

``verb-parity``
    request verbs *issued* by transport clients (``{"type": "..."}``
    frame literals in ``ProcessReplica`` / ``RemoteReplica`` /
    ``WorkerClient`` / ``provision_from_remote``) versus verbs
    *dispatched* by the matching servers (``msg.get("type")``
    comparisons in ``proc_worker`` / ``ReplicaServer`` /
    ``TrainWorkerServer``). A verb sent but unserved is an ERROR
    (``verb-unserved`` — the request can only come back as a typed
    protocol refusal); a dispatch arm no client ever exercises is a
    WARNING (``verb-dead``); a verb served by only a strict subset of
    the pipe/socket replica-transport family is a WARNING
    (``verb-asymmetric`` — the ``handoff`` class).
``wire-error``
    typed exception classes in the ``ServingError`` family (or
    deriving from any registered wire error, e.g. ``ValueError``)
    that runtime code raises but ``net.WIRE_ERRORS`` /
    ``net.register_wire_error`` never registers → ERROR
    (``wire-error-unregistered``): across the wire they silently
    degrade to a bare ``ServingError``, and callers catching the
    typed class stop matching exactly when the replica moves to
    another host.
``fault-point``
    ``faultinject.fires("<point>")`` (and ``arm``/``FaultSpec``)
    sites naming a point not in ``KNOWN_POINTS`` → ERROR
    (``fault-point-unknown``); a registered point that no test or
    tool ever arms → WARNING (``fault-point-dead`` — a chaos hook
    nothing exercises is dead weight that will rot).
``counter-vocab``
    counter names incremented (``metrics.incr("x")``,
    ``self._counters["x"] += 1``, ``self._incr("x")``) but never
    read, asserted, or documented anywhere else → WARNING
    (``counter-dead``); pairs of names at edit distance 1 → WARNING
    (``counter-near-miss`` — the classic silent-typo split brain
    where increments land on one spelling and dashboards read the
    other).
``knob-registry``
    every ``PADDLE_TPU_*`` getenv site in the whole package gathered
    into one registry (rendered as the docs/RELIABILITY.md reference
    table by ``tools/protolint.py --knobs-table``); a knob read by
    code but absent from ``docs/*.md`` → WARNING
    (``knob-undocumented``).

Suppression uses the shared grammar (analysis/suppress.py) with the
``protocheck:`` tag::

    # protocheck: ok(<rule-or-code>[, ...]) — <non-empty reason>

on the finding's line or the comment block above it. Either the
specific code (``verb-dead``) or its family (``verb-parity``)
matches. The CLI is this module::

    python -m paddle_tpu_torch.analysis.protocheck          # the port's tree
    python -m paddle_tpu_torch.analysis.protocheck --json   # one JSON document
    python -m paddle_tpu_torch.analysis.protocheck --knobs-table

Exit status is 1 iff an unsuppressed error-level finding exists.
"""
import ast
import os
import re

from .diagnostics import ERROR, WARNING, SourceDiagnostic
from .suppress import Suppressions as _Suppressions

__all__ = ["RULES", "FAMILY", "TRANSPORTS", "DEFAULT_TARGETS",
           "ProtoReport", "analyze_source", "analyze_files",
           "default_target_files", "run_tree", "render_knobs_table",
           "KNOBS_BEGIN", "KNOBS_END"]

# code → rule family (the family name is also a valid suppression rule)
FAMILY = {
    "verb-unserved": "verb-parity",
    "verb-dead": "verb-parity",
    "verb-asymmetric": "verb-parity",
    "wire-error-unregistered": "wire-error",
    "fault-point-unknown": "fault-point",
    "fault-point-dead": "fault-point",
    "counter-dead": "counter-vocab",
    "counter-near-miss": "counter-vocab",
    "knob-undocumented": "knob-registry",
}
RULES = tuple(FAMILY)

# analyzed packages: package-relative dirs (the port has no tools/ of
# its own to add)
DEFAULT_TARGETS = ("cluster", "serving", "resilience")
REPO_TARGETS = ()
# the corpora: what arms fault points (the port's tests and the chip
# script) and the document the knob registry must appear in
ARMING_GLOBS = ("tests/test_torch_*.py", "tests/torch_*.py",
                "chip_smoke.py")
KNOBS_DOC = os.path.join("docs", "TORCH_RELIABILITY.md")

# The wire-protocol transports: who issues request frames (client
# scopes collect `{"type": <const>}` dict literals) and who dispatches
# them (server scopes collect `msg.get("type") == <const>`
# comparisons). A scope of None means the whole module; otherwise the
# named top-level class or function. Paths are suffix-matched so
# fixtures can use short paths like "cluster/replica.py".
TRANSPORTS = {
    "pipe": {
        "clients": (("cluster/replica.py", "ProcessReplica"),),
        "servers": (("cluster/proc_worker.py", None),),
    },
    "socket": {
        "clients": (("cluster/remote.py", None),
                    ("cluster/net_worker.py", "provision_from_remote")),
        "servers": (("cluster/net_worker.py", "ReplicaServer"),),
    },
    "train": {
        "clients": (("cluster/train_fabric.py", None),
                    ("cluster/net_worker.py", "provision_from_remote")),
        "servers": (("cluster/train_worker.py", None),),
    },
}
# transports that serve the same Replica data plane — the
# verb-asymmetric rule compares dispatch arms across this family
PARITY_FAMILY = ("pipe", "socket")

# the root of the typed wire-error hierarchy (cluster/net.py registers
# its subclasses for typed re-raise on the client side)
_WIRE_ROOT = "ServingError"

_KNOB_RE = re.compile(r"^PADDLE_TPU_[A-Z0-9_]+$")
_COUNTERS_NAME_RE = re.compile(r"_COUNTERS$")

KNOBS_BEGIN = ("<!-- protolint:knobs — generated by `python -m "
               "paddle_tpu_torch.analysis.protocheck --knobs-table`; "
               "do not edit by hand -->")
KNOBS_END = "<!-- /protolint:knobs -->"


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dotted(node):
    """`a.b.c` / `self.x` / `name` → tuple of name parts, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return tuple(parts)
    return None


def _const_str(node):
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _last_name(node):
    d = _dotted(node)
    return d[-1] if d else None


def _edit_distance_1(a, b):
    """True iff Levenshtein(a, b) == 1 (one sub/insert/delete)."""
    if a == b:
        return False
    la, lb = len(a), len(b)
    if abs(la - lb) > 1:
        return False
    if la == lb:
        return sum(x != y for x, y in zip(a, b)) == 1
    if la > lb:
        a, b, lb = b, a, la
    return any(b[:i] + b[i + 1:] == a for i in range(lb))


def _norm(path):
    return path.replace(os.sep, "/")


def _scope_node(tree, scope):
    """The top-level ClassDef/FunctionDef named ``scope`` (None →
    whole module)."""
    if scope is None:
        return tree
    for node in tree.body:
        if isinstance(node, (ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) \
                and node.name == scope:
            return node
    return None


def _is_get_type(call):
    """``<expr>.get("type")`` call?"""
    return (isinstance(call, ast.Call)
            and isinstance(call.func, ast.Attribute)
            and call.func.attr == "get"
            and call.args
            and _const_str(call.args[0]) == "type")


def _issued_verbs(scope):
    """Request verbs a client scope issues: ``{"type": <const>}``
    dict-literal frames."""
    out = []
    for sub in ast.walk(scope):
        if not isinstance(sub, ast.Dict):
            continue
        for key, val in zip(sub.keys, sub.values):
            if key is not None and _const_str(key) == "type":
                verb = _const_str(val)
                if verb is not None:
                    out.append((verb, sub.lineno))
    return out


def _dispatched_verbs(scope):
    """Verbs a server scope dispatches: comparisons of
    ``msg.get("type")`` (directly or via a variable bound to it)
    against string constants."""
    type_vars = set()
    for sub in ast.walk(scope):
        if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                and isinstance(sub.targets[0], ast.Name) \
                and _is_get_type(sub.value):
            type_vars.add(sub.targets[0].id)
    out = []
    for sub in ast.walk(scope):
        if not isinstance(sub, ast.Compare):
            continue
        left = sub.left
        is_type = _is_get_type(left) or (
            isinstance(left, ast.Name) and left.id in type_vars)
        if not is_type:
            continue
        for op, comp in zip(sub.ops, sub.comparators):
            if not isinstance(op, (ast.Eq, ast.NotEq, ast.In)):
                continue
            verb = _const_str(comp)
            if verb is not None:
                out.append((verb, sub.lineno))
            elif isinstance(comp, (ast.Tuple, ast.List, ast.Set)):
                for elt in comp.elts:
                    v = _const_str(elt)
                    if v is not None:
                        out.append((v, sub.lineno))
    return out


# ---------------------------------------------------------------------------
# per-file fact extraction
# ---------------------------------------------------------------------------


class _FileFacts:
    """Everything one source file contributes to the cross-file
    vocabularies. ``knobs_only`` files (the package-wide knob sweep
    beyond the runtime targets) contribute getenv sites only."""

    def __init__(self, path, source, knobs_only=False):
        self.path = path
        self.source = source
        self.knobs_only = knobs_only
        self.tree = ast.parse(source, filename=path)
        self.suppress = _Suppressions(source, path, tag="protocheck")
        self.findings = []
        # verb-parity facts: transport -> role -> [(verb, line)]
        self.issued = {}
        self.dispatched = {}
        # wire-error facts
        self.registered = []        # [(class name, line)]
        self.classes = {}           # name -> (base last-names, line)
        self.raised = {}            # name -> first raise line
        # fault-point facts
        self.known_points = []      # [(point, line)] from KNOWN_POINTS
        self.fire_sites = []        # [(point, line, via)]
        # counter facts
        self.incr_sites = {}        # name -> [line]
        self.decl_sites = {}        # name -> [line]
        self.str_consts = {}        # value -> set(lines)  (exact strings)
        # knob facts
        self.knob_sites = {}        # name -> [(line, default_repr)]
        self._collect()

    def emit(self, level, code, message, line, hint=None):
        self.findings.append(SourceDiagnostic(
            level, code, message, self.path, line, hint=hint))

    # -- collection ------------------------------------------------------

    def _collect(self):
        # module-level `_SOME_ENV = "PADDLE_TPU_X"` aliases, so env
        # reads through the alias still register the knob
        self._knob_alias = {}
        for node in self.tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                val = _const_str(node.value)
                if val and _KNOB_RE.match(val):
                    self._knob_alias[node.targets[0].id] = val
        norm = _norm(self.path)
        if not self.knobs_only:
            for transport, spec in TRANSPORTS.items():
                for suffix, scope in spec["clients"]:
                    if norm.endswith(suffix):
                        node = _scope_node(self.tree, scope)
                        if node is not None:
                            self.issued.setdefault(transport, []).extend(
                                _issued_verbs(node))
                for suffix, scope in spec["servers"]:
                    if norm.endswith(suffix):
                        node = _scope_node(self.tree, scope)
                        if node is not None:
                            self.dispatched.setdefault(
                                transport, []).extend(
                                _dispatched_verbs(node))
        for sub in ast.walk(self.tree):
            if isinstance(sub, ast.Subscript):
                d = _dotted(sub.value)
                if d and d[-1] == "environ":
                    name = _const_str(sub.slice)
                    if name and _KNOB_RE.match(name):
                        self.knob_sites.setdefault(name, []).append(
                            (sub.lineno, None))
            if isinstance(sub, ast.Call):
                self._collect_call(sub)
            elif isinstance(sub, ast.Assign):
                self._collect_assign(sub)
            elif not self.knobs_only:
                if isinstance(sub, ast.ClassDef):
                    bases = tuple(b for b in
                                  (_last_name(base)
                                   for base in sub.bases) if b)
                    self.classes[sub.name] = (bases, sub.lineno)
                elif isinstance(sub, ast.Raise) and sub.exc is not None:
                    exc = sub.exc
                    name = (_last_name(exc.func)
                            if isinstance(exc, ast.Call)
                            else _last_name(exc))
                    if name:
                        self.raised.setdefault(name, sub.lineno)
                elif isinstance(sub, ast.AugAssign) \
                        and isinstance(sub.target, ast.Subscript):
                    d = _dotted(sub.target.value)
                    if d and d[-1].endswith("_counters"):
                        name = _const_str(sub.target.slice)
                        if name:
                            self.incr_sites.setdefault(name, []).append(
                                sub.lineno)
            if isinstance(sub, ast.Constant) \
                    and isinstance(sub.value, str) \
                    and not self.knobs_only:
                self.str_consts.setdefault(sub.value, set()).add(
                    sub.lineno)

    def _collect_call(self, call):
        func_last = _last_name(call.func)
        d = _dotted(call.func)
        # knob getenv sites (collected in every file, knobs_only
        # too): os.environ.get/setdefault, os.getenv, and the local
        # `_env_float("PADDLE_TPU_X", default)`-style wrappers —
        # anything env-named called with a knob-constant first arg
        if d and (d[-2:] == ("environ", "get")
                  or d[-2:] == ("environ", "setdefault")
                  or "env" in d[-1].lower()):
            name = _const_str(call.args[0]) if call.args else None
            if name is None and call.args \
                    and isinstance(call.args[0], ast.Name):
                name = self._knob_alias.get(call.args[0].id)
            if name and _KNOB_RE.match(name):
                default = None
                if len(call.args) > 1 \
                        and isinstance(call.args[1], ast.Constant):
                    default = repr(call.args[1].value)
                for kw in call.keywords:
                    if kw.arg == "default" \
                            and isinstance(kw.value, ast.Constant):
                        default = repr(kw.value.value)
                self.knob_sites.setdefault(name, []).append(
                    (call.lineno, default))
        if self.knobs_only:
            return
        if func_last == "register_wire_error":
            for arg in call.args:
                name = _last_name(arg)
                if name:
                    self.registered.append((name, call.lineno))
        elif func_last in ("fires", "arm", "FaultSpec"):
            point = _const_str(call.args[0]) if call.args else None
            if point is not None:
                self.fire_sites.append((point, call.lineno, func_last))
        elif func_last in ("incr", "_incr") and call.args:
            arg = call.args[0]
            names = []
            name = _const_str(arg)
            if name:
                names.append(name)
            elif isinstance(arg, ast.IfExp):
                names.extend(n for n in (_const_str(arg.body),
                                         _const_str(arg.orelse)) if n)
            for n in names:
                self.incr_sites.setdefault(n, []).append(call.lineno)
        # counter declarations via extra_counters=(...)
        for kw in call.keywords:
            if kw.arg == "extra_counters" \
                    and isinstance(kw.value, (ast.Tuple, ast.List)):
                for elt in kw.value.elts:
                    n = _const_str(elt)
                    if n:
                        self.decl_sites.setdefault(n, []).append(
                            elt.lineno)

    def _collect_assign(self, assign):
        if len(assign.targets) != 1:
            return
        tgt = assign.targets[0]
        if self.knobs_only:
            return
        if isinstance(tgt, ast.Name):
            if tgt.id == "WIRE_ERRORS":
                self._collect_wire_map(assign.value)
            elif tgt.id == "KNOWN_POINTS" \
                    and isinstance(assign.value, (ast.Tuple, ast.List)):
                for elt in assign.value.elts:
                    p = _const_str(elt)
                    if p:
                        self.known_points.append((p, elt.lineno))
            elif _COUNTERS_NAME_RE.search(tgt.id) \
                    and isinstance(assign.value, (ast.Tuple, ast.List)):
                for elt in assign.value.elts:
                    n = _const_str(elt)
                    if n:
                        self.decl_sites.setdefault(n, []).append(
                            elt.lineno)
        elif isinstance(tgt, ast.Attribute) \
                and tgt.attr.endswith("_counters") \
                and isinstance(assign.value, ast.Dict):
            for key in assign.value.keys:
                n = _const_str(key) if key is not None else None
                if n:
                    self.decl_sites.setdefault(n, []).append(key.lineno)

    def _collect_wire_map(self, value):
        """Registered names from ``WIRE_ERRORS = {cls.__name__: cls
        for cls in (A, B, ...)}`` or a plain string-keyed dict."""
        if isinstance(value, ast.DictComp) and value.generators:
            it = value.generators[0].iter
            if isinstance(it, (ast.Tuple, ast.List)):
                for elt in it.elts:
                    name = _last_name(elt)
                    if name:
                        self.registered.append((name, elt.lineno))
        elif isinstance(value, ast.Dict):
            for key, val in zip(value.keys, value.values):
                name = (_const_str(key) if key is not None else None) \
                    or _last_name(val)
                if name:
                    self.registered.append((name, value.lineno))


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


class Analyzer:
    """Cross-file vocabulary assembly over a loaded file set.

    ``arming_text`` is the fault-arming corpus (tests/ + tools/ raw
    text), ``docs_text`` the documentation corpus (docs/*.md), and
    both double as counter-reference corpora. Empty corpora (the
    ``analyze_source`` unit-test default) simply mean "nothing is
    armed/documented elsewhere".
    """

    def __init__(self, arming_text="", docs_text=""):
        self.files = []
        self.arming_text = arming_text
        self.docs_text = docs_text

    # -- loading ---------------------------------------------------------

    def add_source(self, source, path, knobs_only=False):
        fa = _FileFacts(path, source, knobs_only=knobs_only)
        self.files.append(fa)
        return fa

    def add_file(self, path, knobs_only=False):
        with open(path, "r", encoding="utf-8") as f:
            return self.add_source(f.read(), path,
                                   knobs_only=knobs_only)

    # -- analysis --------------------------------------------------------

    def analyze(self):
        self._verb_parity()
        self._wire_errors()
        self._fault_points()
        self._counters()
        knobs = self._knobs()
        findings, suppressed = [], []
        for fa in self.files:
            findings.extend(fa.suppress.bad)
            for d in fa.findings:
                reason = fa.suppress.match(d.line, d.code) \
                    or fa.suppress.match(d.line, FAMILY.get(d.code,
                                                            d.code))
                if reason is None:
                    findings.append(d)
                else:
                    suppressed.append((d, reason))
        findings.sort(key=lambda d: (d.path, d.line, d.code))
        return findings, suppressed, knobs

    # -- rule family: verb-parity ---------------------------------------

    def _verb_parity(self):
        issued, dispatched = {}, {}     # transport -> verb -> (fa, line)
        for fa in self.files:
            for t, verbs in fa.issued.items():
                for verb, line in verbs:
                    issued.setdefault(t, {}).setdefault(verb, (fa, line))
            for t, verbs in fa.dispatched.items():
                for verb, line in verbs:
                    dispatched.setdefault(t, {}).setdefault(verb,
                                                            (fa, line))
        present = [t for t in TRANSPORTS
                   if t in issued or t in dispatched]
        for t in present:
            sent = issued.get(t, {})
            served = dispatched.get(t, {})
            # a transport with a client but no loaded server (or vice
            # versa) can't be judged — analyze_source on one file
            if sent and served:
                for verb in sorted(set(sent) - set(served)):
                    fa, line = sent[verb]
                    fa.emit(ERROR, "verb-unserved",
                            f"transport '{t}': verb '{verb}' is sent "
                            "by the client but no server dispatch arm "
                            "serves it — on the wire it can only come "
                            "back as a protocol refusal",
                            line,
                            hint="add a dispatch arm for the verb to "
                                 "the transport's server (and to its "
                                 "siblings: 'handoff' had to be added "
                                 "to all three by hand)")
                for verb in sorted(set(served) - set(sent)):
                    fa, line = served[verb]
                    fa.emit(WARNING, "verb-dead",
                            f"transport '{t}': dispatch arm for verb "
                            f"'{verb}' is never exercised by any "
                            "client of this transport",
                            line,
                            hint="delete the arm, or suppress with "
                                 "the reason the verb is kept "
                                 "(operator tooling, forward compat)")
        # family asymmetry: a verb real traffic uses (issued on some
        # family transport) served by a strict subset of the family
        fam = [t for t in PARITY_FAMILY
               if t in issued and t in dispatched]
        if len(fam) == len(PARITY_FAMILY):
            fam_issued = set()
            for t in fam:
                fam_issued.update(issued[t])
            for verb in sorted(fam_issued):
                serving = [t for t in fam if verb in dispatched[t]]
                if serving and len(serving) < len(fam):
                    missing = [t for t in fam if t not in serving]
                    fa, line = dispatched[serving[0]][verb]
                    fa.emit(WARNING, "verb-asymmetric",
                            f"verb '{verb}' is served only on "
                            f"transport(s) {', '.join(serving)} — "
                            f"{', '.join(missing)} has no dispatch "
                            "arm for it",
                            line,
                            hint="implement the verb on every replica "
                                 "transport, or suppress with the "
                                 "reason the asymmetry is deliberate")

    # -- rule family: wire-error ----------------------------------------

    def _wire_errors(self):
        registered = {}             # name -> (fa, line)
        classes = {}                # name -> (bases, fa, line)
        raised = {}                 # name -> (fa, line)
        # tools/ raises never cross the wire; everything else loaded
        # (runtime packages, fixtures, inline sources) is in scope
        toolsish = re.compile(r"(^|/)tools/")
        for fa in self.files:
            for name, line in fa.registered:
                registered.setdefault(name, (fa, line))
            if fa.knobs_only or toolsish.search(_norm(fa.path)):
                continue
            for name, (bases, line) in fa.classes.items():
                classes.setdefault(name, (bases, fa, line))
            for name, line in fa.raised.items():
                raised.setdefault(name, (fa, line))
        if not registered:
            return                  # no WIRE_ERRORS map in the set
        # transitive family closure over base names
        family = {_WIRE_ROOT} | set(registered)
        changed = True
        while changed:
            changed = False
            for name, (bases, _fa, _line) in classes.items():
                if name not in family and any(b in family
                                              for b in bases):
                    family.add(name)
                    changed = True
        for name in sorted(family - set(registered) - {_WIRE_ROOT}):
            if name not in classes or name not in raised:
                continue
            _bases, fa, line = classes[name]
            fa.emit(ERROR, "wire-error-unregistered",
                    f"typed error {name} is raised by runtime code "
                    "but never registered in net.WIRE_ERRORS — "
                    "across the wire it degrades to a bare "
                    "ServingError and typed except clauses stop "
                    "matching",
                    line,
                    hint="add the class to the WIRE_ERRORS literal "
                         "in cluster/net.py, or call "
                         "net.register_wire_error(<cls>) right after "
                         "the class definition")

    # -- rule family: fault-point ---------------------------------------

    def _fault_points(self):
        known = {}                  # point -> (fa, line)
        for fa in self.files:
            for point, line in fa.known_points:
                known.setdefault(point, (fa, line))
        for fa in self.files:
            for point, line, via in fa.fire_sites:
                if known and point not in known:
                    fa.emit(ERROR, "fault-point-unknown",
                            f"{via}('{point}') names a fault point "
                            "that is not in faultinject.KNOWN_POINTS "
                            "— the check can never fire (and arm() "
                            "would raise at run time)",
                            line,
                            hint="register the point in KNOWN_POINTS "
                                 "or fix the spelling")
        for point, (fa, line) in sorted(known.items()):
            if point not in self.arming_text:
                fa.emit(WARNING, "fault-point-dead",
                        f"fault point '{point}' has no arming site "
                        "in tests/ or tools/ — a chaos hook nothing "
                        "exercises is dead weight that will rot",
                        line,
                        hint="arm it from a chaos test "
                             "(faultinject.arm/PADDLE_TPU_FAULTS) or "
                             "delete the point")

    # -- rule family: counter-vocab -------------------------------------

    def _counters(self):
        incr = {}                   # name -> (fa, line)
        sites = {}                  # name -> set((path, line)) incr+decl
        declared = set()
        for fa in self.files:
            for name, lines in fa.incr_sites.items():
                incr.setdefault(name, (fa, lines[0]))
                sites.setdefault(name, set()).update(
                    (fa.path, ln) for ln in lines)
            for name, lines in fa.decl_sites.items():
                declared.add(name)
                sites.setdefault(name, set()).update(
                    (fa.path, ln) for ln in lines)

        def referenced(name):
            if name in self.arming_text or name in self.docs_text:
                return True
            for fa in self.files:
                for line in fa.str_consts.get(name, ()):
                    if (fa.path, line) not in sites.get(name, ()):
                        return True
            return False

        for name in sorted(incr):
            if not referenced(name):
                fa, line = incr[name]
                fa.emit(WARNING, "counter-dead",
                        f"counter '{name}' is incremented but never "
                        "read, asserted, or documented anywhere — "
                        "nobody would notice if it stopped counting",
                        line,
                        hint="assert it in a test, surface it in a "
                             "bench/stats view, or document it in "
                             "docs/ — or delete the counter")
        vocab = sorted(set(incr) | declared)
        for i, a in enumerate(vocab):
            for b in vocab[i + 1:]:
                if _edit_distance_1(a, b):
                    name = b if b in incr else a
                    fa, line = incr.get(name) or incr.get(a) \
                        or incr.get(b) or (None, None)
                    if fa is None:
                        continue
                    fa.emit(WARNING, "counter-near-miss",
                            f"counter names '{a}' and '{b}' differ "
                            "by one character — increments landing "
                            "on one spelling while readers watch the "
                            "other is the silent-typo split brain",
                            line,
                            hint="unify the spelling (or suppress "
                                 "with the reason both are real)")

    # -- rule family: knob-registry -------------------------------------

    def _knobs(self):
        reg = {}        # name -> {"default": str|None, "paths": set,
        #                          "first": (fa, line)}
        for fa in self.files:
            for name, sites in fa.knob_sites.items():
                row = reg.setdefault(name, {"default": None,
                                            "paths": set(),
                                            "first": (fa, sites[0][0])})
                row["paths"].add(_rel_module(fa.path))
                for _line, default in sites:
                    if default is not None and row["default"] is None:
                        row["default"] = default
        for name in sorted(reg):
            if name not in self.docs_text:
                fa, line = reg[name]["first"]
                fa.emit(WARNING, "knob-undocumented",
                        f"knob {name} is read by code but documented "
                        "in no docs/*.md — operators can't discover "
                        "it",
                        line,
                        hint="regenerate the reference table: "
                             "python -m paddle_tpu_torch.analysis."
                             "protocheck --knobs-table (committed into "
                             "docs/TORCH_RELIABILITY.md)")
        return [{"name": name,
                 "default": reg[name]["default"],
                 "paths": sorted(reg[name]["paths"])}
                for name in sorted(reg)]


def _rel_module(path):
    """Repo-relative module path for the knobs table (stable across
    checkouts; no line numbers, so the table doesn't churn)."""
    norm = _norm(path)
    for anchor in ("paddle_tpu_torch/", "tools/"):
        idx = norm.rfind("/" + anchor)
        if idx >= 0:
            return norm[idx + 1:]
        if norm.startswith(anchor):
            return norm
    return norm


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class ProtoReport:
    """findings = unsuppressed diagnostics; suppressed = (diag,
    reason); knobs = the PADDLE_TPU_* registry rows."""

    def __init__(self, findings, suppressed, files, knobs):
        self.findings = findings
        self.suppressed = suppressed
        self.files = files
        self.knobs = knobs

    def errors(self):
        return [d for d in self.findings if d.level == ERROR]

    def to_dict(self):
        counts = {}
        for d in self.findings:
            counts[d.code] = counts.get(d.code, 0) + 1
        return {
            "files": len(self.files),
            "error_count": len(self.errors()),
            "finding_count": len(self.findings),
            "suppressed_count": len(self.suppressed),
            "counts_by_code": counts,
            "findings": [d.to_dict() for d in self.findings],
            "suppressed": [dict(d.to_dict(), reason=reason)
                           for d, reason in self.suppressed],
            "knobs": self.knobs,
        }


def render_knobs_table(knobs):
    """The marker-delimited markdown reference table committed into
    docs/TORCH_RELIABILITY.md (a test diffs a regenerated copy against
    the committed one)."""
    lines = [KNOBS_BEGIN,
             "| Knob | Default | Read in |",
             "|---|---|---|"]
    for row in knobs:
        default = f"`{row['default']}`" if row["default"] is not None \
            else "—"
        paths = ", ".join(f"`{p}`" for p in row["paths"])
        lines.append(f"| `{row['name']}` | {default} | {paths} |")
    lines.append(KNOBS_END)
    return "\n".join(lines) + "\n"


def _report(analyzer):
    findings, suppressed, knobs = analyzer.analyze()
    return ProtoReport(findings, suppressed,
                       [fa.path for fa in analyzer.files
                        if not fa.knobs_only], knobs)


def analyze_source(source, path="<source>", arming_text="",
                   docs_text=""):
    """Analyze one source string — the fixture/test entrypoint. Give
    ``path`` a transport suffix (e.g. ``cluster/replica.py``) to put
    the source in a transport scope."""
    an = Analyzer(arming_text=arming_text, docs_text=docs_text)
    an.add_source(source, path)
    return _report(an)


def analyze_files(paths, root=None, with_corpora=True):
    """Analyze explicit files against the repo's real corpora (docs,
    test/tool arming text, package-wide knob sweep)."""
    pkg, repo = _roots(root)
    an = Analyzer(*(_corpora(repo) if with_corpora else ("", "")))
    loaded = set()
    for p in paths:
        an.add_file(p)
        loaded.add(os.path.abspath(p))
    if with_corpora:
        for p in _package_files(pkg):
            if os.path.abspath(p) not in loaded:
                an.add_file(p, knobs_only=True)
    return _report(an)


def _roots(root):
    pkg = root or os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    return pkg, os.path.dirname(pkg)


def _walk_py(top):
    out = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py") and not name.startswith("test_"):
                out.append(os.path.join(dirpath, name))
    return out


def _package_files(pkg):
    return _walk_py(pkg)


def _corpora(repo):
    """(arming_text, docs_text): the raw text of the port's tests and
    ``chip_smoke.py`` (:data:`ARMING_GLOBS`), and of
    :data:`KNOBS_DOC`."""
    import glob
    arming, docs = [], []
    for pattern in ARMING_GLOBS:
        for path in sorted(glob.glob(os.path.join(repo, pattern))):
            with open(path, "r", encoding="utf-8",
                      errors="replace") as f:
                arming.append(f.read())
    doc = os.path.join(repo, KNOBS_DOC)
    if os.path.isfile(doc):
        with open(doc, "r", encoding="utf-8", errors="replace") as f:
            docs.append(f.read())
    return "\n".join(arming), "\n".join(docs)


def default_target_files(root=None):
    """The packages protocheck gates, as concrete file paths:
    cluster/, serving/ and resilience/."""
    pkg, repo = _roots(root)
    out = []
    for rel in DEFAULT_TARGETS:
        out.extend(_walk_py(os.path.join(pkg, rel)))
    for rel in REPO_TARGETS:
        top = os.path.join(repo, rel)
        if os.path.isdir(top):
            out.extend(_walk_py(top))
    return sorted(out)


def run_tree(root=None):
    """Analyze the port's own runtime packages against the real
    corpora."""
    return analyze_files(default_target_files(root), root=root)


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def main(argv=None):
    import sys
    from .diagnostics import CODES
    from .racecheck import cli_parser, cli_print, cli_report
    prog = "python -m paddle_tpu_torch.analysis.protocheck"
    ap = cli_parser(prog, "static contract analyzer for the port's "
                          "distributed fabric")
    ap.add_argument("--knobs-table", action="store_true",
                    help="print the marker-delimited PADDLE_TPU_* knob "
                         "reference table (the block committed into "
                         "docs/TORCH_RELIABILITY.md) and exit 0")
    args = ap.parse_args(argv)
    if args.list_rules:
        for code in RULES:
            level, meaning = CODES[code]
            print(f"{code:24s} [{level:7s}] ({FAMILY[code]}) {meaning}")
        return 0
    report = cli_report(sys.modules[__name__], args, prog)
    if args.knobs_table:
        sys.stdout.write(render_knobs_table(report.knobs))
        return 0
    return cli_print(report, args, "protocheck",
                     extra=f"{len(report.knobs)} knob(s), ")


if __name__ == "__main__":
    import sys
    sys.exit(main())
