"""racecheck — static concurrency analyzer for the serving runtime
(port of ``paddle_tpu/analysis/racecheck.py``, pointed at
``paddle_tpu_torch/``).

A canary drill surfaced a process-global scope race (a replica
rebuild loading params into a neighbor's scope) that only showed under
live traffic. The IR already refuses to run an unverified program
(analysis/verify.py); this module gives the *runtime* packages the
same discipline: an AST-level pass suite over ``cluster/``,
``serving/``, ``resilience/``, ``io/`` and ``core/executor.py`` that
emits :class:`~paddle_tpu_torch.analysis.diagnostics.SourceDiagnostic`
records (file:line + fix hint) for the concurrency bug classes we have
actually been bitten by:

``run-without-scope``
    a program-execution ``Executor.run`` call without an explicit
    ``scope=`` — it binds to the process-global scope and races with
    any concurrent rebuild (the canary bug class, enforced forever).
``global-mutation``
    ``scope_guard(...)`` / ``force_cpu(...)`` / ``os.environ``
    mutation inside a function body. Module import time is the only
    sanctioned moment to flip process-global state.
``unlocked-mutation``
    per class, infer which ``self.*`` attributes are mutated under a
    ``with self.<lock>:`` block, then flag sites that mutate the same
    attribute with the lock NOT held. Attributes touched only in
    ``__init__`` (pre-publication) are exempt.
``blocking-under-lock``
    ``time.sleep``, socket/pipe frame I/O, queue get/put, thread
    joins, subprocess waits and retry loops inside a ``with lock:``
    body. ``Condition.wait`` on (or on a Condition built over) the
    held lock is legal — it releases the lock — and is whitelisted.
``lock-order-cycle``
    a lock-ordering digraph whose nodes are ``Class.lock_attr`` and
    whose edges mean "acquired while holding": nested ``with``,
    self-method calls that take another lock, and calls into
    attribute-typed collaborator classes whose methods take their own
    lock. Any cycle — including a non-reentrant self-reacquisition —
    is a deadlock waiting for the right interleaving.
``thread-hygiene``
    ``threading.Thread`` started with no shutdown story: non-daemon
    with no ``.join`` path is an error; a daemon whose target loops
    forever with no stop-event/flag check is a warning.

Suppression: a finding whose line (or the line above) carries::

    # racecheck: ok(<rule>[, <rule>...]) — <non-empty reason>

is reported as *suppressed*, not as a finding. The reason is
mandatory; a reason-less ``ok(...)`` is itself a ``bad-suppression``
warning. The grammar parser lives in ``analysis/suppress.py`` (the
reference's numlint shares it under the ``numcheck:`` tag).
The CLI is this module::

    python -m paddle_tpu_torch.analysis.racecheck          # the port's tree
    python -m paddle_tpu_torch.analysis.racecheck --json   # one JSON document
    python -m paddle_tpu_torch.analysis.racecheck a.py d/  # these paths only
    python -m paddle_tpu_torch.analysis.racecheck --list-rules

Exit status is 1 iff an unsuppressed error-level finding exists.
Pure AST analysis: nothing is imported or run.
"""
import ast
import os
import re

from .diagnostics import ERROR, WARNING, SourceDiagnostic
from .suppress import Suppressions as _Suppressions

__all__ = ["RULES", "DEFAULT_TARGETS", "RaceReport", "analyze_source",
           "analyze_files", "default_target_files", "run_tree"]

RULES = ("run-without-scope", "global-mutation", "unlocked-mutation",
         "blocking-under-lock", "lock-order-cycle", "thread-hygiene")

# analyzed packages, relative to the paddle_tpu_torch package root
DEFAULT_TARGETS = ("cluster", "serving", "resilience", "io",
                   "core/executor.py")

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}
_MUTATOR_METHODS = {"append", "appendleft", "extend", "add", "discard",
                    "remove", "insert", "pop", "popleft", "popitem",
                    "clear", "update", "setdefault"}
_FRAME_IO = {"send_frame", "recv_frame", "read_frame", "write_frame",
             "open_conn", "provision_from_remote"}
_SOCKET_METHODS = {"recv", "recv_into", "accept", "connect", "sendall",
                   "makefile"}
_STOPISH_RE = re.compile(
    r"stop|closed|close|shutdown|done|quit|exit|crash", re.I)
_THREADISH_RE = re.compile(
    r"thread|worker|proc|acceptor|monitor|reader|sweeper", re.I)
_QUEUEISH_RE = re.compile(r"(^|_)q(ueue)?$|queue", re.I)


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


def _self_attr(node):
    """`self.X` → "X", else None (only the two-part form)."""
    d = _dotted(node)
    if d is not None and len(d) == 2 and d[0] == "self":
        return d[1]
    return None


def _kw(call, name):
    for k in call.keywords:
        if k.arg == name:
            return k.value
    return None


def _has_kwsplat(call):
    return any(k.arg is None for k in call.keywords)


# ---------------------------------------------------------------------------
# per-class model
# ---------------------------------------------------------------------------


class _ClassInfo:
    def __init__(self, node, path):
        self.node = node
        self.name = node.name
        self.path = path
        self.methods = {}           # name -> FunctionDef
        self.lock_attrs = {}        # attr -> "lock"|"rlock"|"condition"
        self.cv_base = {}           # condition attr -> wrapped lock attr
        self.thread_attrs = {}      # attr -> dict(line, daemon, target)
        self.attr_ctor = {}         # attr -> ctor last-name (raw)
        self.attr_types = {}        # attr -> _ClassInfo (resolved later)
        self.method_locks = {}      # method name -> set of lock attrs taken
        self.mutations = {}         # attr -> list[(line, locked, method)]
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
        self._collect_attr_bindings()

    def _collect_attr_bindings(self):
        for meth in self.methods.values():
            for sub in ast.walk(meth):
                if not isinstance(sub, ast.Assign):
                    continue
                if len(sub.targets) != 1:
                    continue
                attr = _self_attr(sub.targets[0])
                if attr is None or not isinstance(sub.value, ast.Call):
                    continue
                ctor = _dotted(sub.value.func)
                if ctor is None:
                    continue
                last = ctor[-1]
                if last in _LOCK_CTORS and (
                        len(ctor) == 1 or ctor[-2] == "threading"):
                    self.lock_attrs[attr] = _LOCK_CTORS[last]
                    if last == "Condition" and sub.value.args:
                        base = _self_attr(sub.value.args[0])
                        if base is not None:
                            self.cv_base[attr] = base
                elif last == "Thread" and (
                        len(ctor) == 1 or ctor[-2] == "threading"):
                    self.thread_attrs[attr] = _thread_spec(sub.value,
                                                           sub.lineno)
                else:
                    self.attr_ctor[attr] = last

    def canon_lock(self, attr):
        """Condition attrs count as their wrapped lock."""
        return self.cv_base.get(attr, attr)

    def lock_kind(self, attr):
        return self.lock_attrs.get(self.cv_base.get(attr, attr),
                                   self.lock_attrs.get(attr))

    def joins_attr(self, attr):
        """Does any method call self.<attr>.join(...)?"""
        for meth in self.methods.values():
            for sub in ast.walk(meth):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "join"
                        and _self_attr(sub.func.value) == attr):
                    return True
        return False


def _thread_spec(call, lineno):
    daemon = _kw(call, "daemon")
    target = _kw(call, "target")
    tname = None
    if target is not None:
        d = _dotted(target)
        if d is not None and len(d) == 2 and d[0] == "self":
            tname = d[1]
        elif d is not None and len(d) == 1:
            tname = d[0]
    return {"line": lineno,
            "daemon": bool(isinstance(daemon, ast.Constant)
                           and daemon.value),
            "target": tname}


def _mentions_stop_signal(func):
    """Does the function consult any stop event/flag, or do all its
    infinite loops break/return on their own?"""
    for sub in ast.walk(func):
        if isinstance(sub, ast.Attribute) and (
                _STOPISH_RE.search(sub.attr)
                or sub.attr in ("is_set",)):
            return True
        if isinstance(sub, ast.Name) and _STOPISH_RE.search(sub.id):
            return True
    # no explicit signal: accept if every `while True` self-terminates
    loops = [s for s in ast.walk(func) if isinstance(s, ast.While)]
    if not loops:
        return True                 # straight-line target ends by itself
    for loop in loops:
        infinite = (isinstance(loop.test, ast.Constant)
                    and bool(loop.test.value))
        if not infinite:
            continue
        if not any(isinstance(s, (ast.Break, ast.Return))
                   for s in ast.walk(loop)):
            return False
    return True


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


class _FileAnalysis:
    def __init__(self, path, source):
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.suppress = _Suppressions(source, path)
        self.classes = []           # _ClassInfo
        self.findings = []          # raw SourceDiagnostic (pre-suppression)
        self.lock_edges = []        # (src_node, dst_node, line, path, why)
        for node in self.tree.body:
            if isinstance(node, ast.ClassDef):
                self.classes.append(_ClassInfo(node, path))

    def emit(self, level, code, message, line, hint=None):
        self.findings.append(SourceDiagnostic(
            level, code, message, self.path, line, hint=hint))


class Analyzer:
    """Whole-target-set analysis; cross-file class table feeds the
    lock-ordering graph."""

    def __init__(self):
        self.files = []             # _FileAnalysis
        self.class_table = {}       # class name -> _ClassInfo

    # -- loading ---------------------------------------------------------
    def add_source(self, source, path):
        fa = _FileAnalysis(path, source)
        self.files.append(fa)
        for ci in fa.classes:
            self.class_table.setdefault(ci.name, ci)
        return fa

    def add_file(self, path):
        with open(path, "r", encoding="utf-8") as f:
            return self.add_source(f.read(), path)

    # -- analysis --------------------------------------------------------
    def analyze(self):
        for ci in self.class_table.values():
            for attr, ctor in ci.attr_ctor.items():
                target = self.class_table.get(ctor)
                if target is not None:
                    ci.attr_types[attr] = target
        # pre-pass over EVERY class first: which own locks does each
        # method take? Cross-class edges consult collaborators'
        # method_locks, so all of them must exist before any walk.
        for fa in self.files:
            for ci in fa.classes:
                for name, meth in ci.methods.items():
                    taken = set()
                    for sub in ast.walk(meth):
                        if isinstance(sub, ast.With):
                            for item in sub.items:
                                attr = _self_attr(item.context_expr)
                                if attr is not None \
                                        and ci.lock_kind(attr):
                                    taken.add(ci.canon_lock(attr))
                    ci.method_locks[name] = taken
        for fa in self.files:
            self._analyze_file(fa)
        self._lock_cycles()
        findings, suppressed = [], []
        for fa in self.files:
            findings.extend(fa.suppress.bad)
            for d in fa.findings:
                reason = fa.suppress.match(d.line, d.rule)
                if reason is None:
                    findings.append(d)
                else:
                    suppressed.append((d, reason))
        return findings, suppressed

    def _analyze_file(self, fa):
        # module-level functions (worker entrypoints, helpers)
        for node in fa.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                _FunctionWalker(self, fa, None, node.name).walk(node)
        for ci in fa.classes:
            for name, meth in ci.methods.items():
                _FunctionWalker(self, fa, ci, name).walk(meth)
            self._class_verdicts(fa, ci)

    # -- per-class verdicts ---------------------------------------------
    def _class_verdicts(self, fa, ci):
        for attr, sites in sorted(ci.mutations.items()):
            locked = [s for s in sites if s[1]]
            unlocked = [s for s in sites if not s[1]]
            if not locked or not unlocked:
                continue
            lock_names = sorted({s[3] for s in locked})
            for line, _, meth, _ in unlocked:
                fa.emit(
                    ERROR, "unlocked-mutation",
                    f"{ci.name}.{meth} mutates self.{attr} without "
                    f"holding self.{lock_names[0]}, but "
                    f"{ci.name}.{locked[0][2]} (line {locked[0][0]}) "
                    f"guards the same attribute with it",
                    line,
                    hint=f"wrap the write in `with self."
                         f"{lock_names[0]}:` (or prove it runs before "
                         f"the object is shared and suppress with "
                         f"`# racecheck: ok(unlocked-mutation) — "
                         f"<reason>`)")
        for attr, spec in sorted(ci.thread_attrs.items()):
            self._thread_verdict(fa, ci, spec,
                                 joined=ci.joins_attr(attr),
                                 where=f"{ci.name}.{attr}")

    def _thread_verdict(self, fa, ci, spec, joined, where):
        target_fn = None
        if spec["target"] and ci is not None:
            target_fn = ci.methods.get(spec["target"])
        has_stop = (_mentions_stop_signal(target_fn)
                    if target_fn is not None else None)
        if not spec["daemon"] and not joined:
            fa.emit(
                ERROR, "thread-hygiene",
                f"non-daemon thread {where} is never joined — process "
                f"exit will hang on it",
                spec["line"],
                hint="join it on the shutdown path, or make it a "
                     "daemon with a stop event")
        elif spec["daemon"] and has_stop is False and not joined:
            fa.emit(
                WARNING, "thread-hygiene",
                f"daemon thread {where} runs an unbounded loop with "
                f"no stop event, flag, or join path — close() cannot "
                f"retire it",
                spec["line"],
                hint="check a threading.Event (or a closed/stop flag) "
                     "in the loop condition and join on close()")

    # -- lock-ordering graph --------------------------------------------
    def _lock_cycles(self):
        edges = {}                  # src -> list[(dst, line, path, why)]
        for fa in self.files:
            for src, dst, line, path, why in fa.lock_edges:
                edges.setdefault(src, []).append((dst, line, path, why))
        # self-loops (non-reentrant reacquisition) are emitted at the
        # walk site; here we only hunt multi-node cycles
        seen_cycles = set()

        def dfs(node, stack, stack_set):
            for dst, line, path, why in edges.get(node, ()):
                if dst in stack_set:
                    cyc = stack[stack.index(dst):] + [dst]
                    key = frozenset(cyc)
                    if key in seen_cycles:
                        continue
                    seen_cycles.add(key)
                    fa = next(f for f in self.files if f.path == path)
                    fa.emit(
                        ERROR, "lock-order-cycle",
                        "lock acquisition cycle: "
                        + " -> ".join(cyc) + f" (closing edge: {why})",
                        line,
                        hint="pick one global acquisition order for "
                             "these locks and restructure the calls "
                             "so every thread takes them in it")
                elif dst not in stack_set:
                    dfs(dst, stack + [dst], stack_set | {dst})

        for start in list(edges):
            dfs(start, [start], {start})


class _FunctionWalker:
    """Walks one function/method body tracking the held-lock set."""

    def __init__(self, analyzer, fa, ci, func_name):
        self.an = analyzer
        self.fa = fa
        self.ci = ci
        self.func = func_name
        self.local_locks = {}       # local var name -> kind
        self.local_threads = []     # (spec, varname|None, func node)

    # -- entry -----------------------------------------------------------
    def walk(self, func):
        self._body(func.body, held=frozenset())
        self._local_thread_verdicts(func)

    # -- statements ------------------------------------------------------
    def _body(self, stmts, held):
        for s in stmts:
            self._stmt(s, held)

    def _stmt(self, node, held):
        if isinstance(node, ast.With):
            add = set()
            for item in node.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    if lock in held and self._nonreentrant(lock):
                        self.fa.emit(
                            ERROR, "lock-order-cycle",
                            f"non-reentrant lock {lock} re-acquired "
                            f"while already held — self-deadlock",
                            node.lineno,
                            hint="use threading.RLock, or split the "
                                 "locked region so the inner call "
                                 "runs lock-free")
                    add.add(lock)
                self._expr(item.context_expr, held)
            self._body(node.body, held | add)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: body runs later, not under the current locks
            self._body(node.body, frozenset())
        elif isinstance(node, ast.ClassDef):
            pass
        elif isinstance(node, (ast.If, ast.For, ast.AsyncFor,
                               ast.While)):
            self._expr(getattr(node, "test", None) or
                       getattr(node, "iter", None), held)
            self._body(node.body, held)
            self._body(node.orelse, held)
        elif isinstance(node, ast.Try):
            self._body(node.body, held)
            for h in node.handlers:
                self._body(h.body, held)
            self._body(node.orelse, held)
            self._body(node.finalbody, held)
        elif isinstance(node, ast.Assign):
            self._assign(node, held)
        elif isinstance(node, ast.AugAssign):
            self._mutation_target(node.target, node.lineno, held)
            self._expr(node.value, held)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                self._mutation_target(t, node.lineno, held,
                                      delete=True)
        elif isinstance(node, ast.Expr):
            self._expr(node.value, held)
        elif isinstance(node, ast.Return):
            self._expr(node.value, held)
        elif isinstance(node, ast.Raise):
            self._expr(node.exc, held)
        else:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.expr):
                    self._expr(child, held)
                elif isinstance(child, ast.stmt):
                    self._stmt(child, held)

    def _assign(self, node, held):
        self._expr(node.value, held)
        for t in node.targets:
            self._mutation_target(t, node.lineno, held)
        # track local lock/thread bindings
        if len(node.targets) == 1 and isinstance(node.targets[0],
                                                 ast.Name):
            var = node.targets[0].id
            if isinstance(node.value, ast.Call):
                ctor = _dotted(node.value.func)
                if ctor is not None:
                    last = ctor[-1]
                    if last in _LOCK_CTORS and (
                            len(ctor) == 1 or ctor[-2] == "threading"):
                        self.local_locks[var] = _LOCK_CTORS[last]
                    elif last == "Thread" and (
                            len(ctor) == 1 or ctor[-2] == "threading"):
                        self.local_threads.append(
                            (_thread_spec(node.value, node.lineno),
                             var))

    # -- mutation recording ----------------------------------------------
    def _record_mutation(self, attr, line, held):
        if self.ci is None or self.func == "__init__":
            return
        if attr in self.ci.lock_attrs or attr in self.ci.cv_base:
            return
        if not self.ci.lock_attrs:
            return                  # lock-free class: out of scope
        lock = next(iter(sorted(held)), None)
        self.ci.mutations.setdefault(attr, []).append(
            (line, bool(held), self.func, lock))

    def _mutation_target(self, node, line, held, delete=False):
        attr = _self_attr(node)
        if attr is not None:
            self._record_mutation(attr, line, held)
            return
        if isinstance(node, ast.Subscript):
            attr = _self_attr(node.value)
            if attr is not None:
                self._record_mutation(attr, line, held)
            else:
                self._expr(node.value, held)
            self._expr(node.slice, held)

    # -- expressions ------------------------------------------------------
    def _expr(self, node, held):
        if node is None:
            return
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self._call(sub, held)
            elif isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                pass                # deferred bodies: handled by _stmt

    # -- calls: all four rule families meet here --------------------------
    def _call(self, call, held):
        chain = _dotted(call.func)
        line = call.lineno
        # mutation via self.<attr>.<mutator>(...)
        if (chain is not None and len(chain) == 3
                and chain[0] == "self" and chain[2] in _MUTATOR_METHODS):
            # dict.get-style lookups are not mutations; .pop IS
            self._record_mutation(chain[1], line, held)
        if chain is None:
            return
        last = chain[-1]
        # --- rule: scope discipline --------------------------------------
        if last == "run" and isinstance(call.func, ast.Attribute):
            recv = chain[:-1]
            looks_exec = any(_kw(call, k) is not None
                             for k in ("fetch_list", "feed"))
            is_subprocess = recv and recv[-1] == "subprocess"
            if looks_exec and not is_subprocess \
                    and _kw(call, "scope") is None \
                    and not _has_kwsplat(call):
                self.fa.emit(
                    ERROR, "run-without-scope",
                    f"{'.'.join(chain)}(...) executes a program "
                    f"without an explicit scope= — it binds the "
                    f"process-global scope and races with concurrent "
                    f"rebuilds (the canary drill's scope bug)",
                    line,
                    hint="pass scope=<this replica's Scope>; serving "
                         "code must never run against global_scope()")
        if last in ("scope_guard", "force_cpu"):
            self.fa.emit(
                ERROR, "global-mutation",
                f"{last}(...) swaps process-global state inside a "
                f"function body — every other thread sees the flip",
                line,
                hint="thread an explicit scope=/config through the "
                     "call path instead; process entrypoints that own "
                     "the whole process may suppress with a reason")
        if (len(chain) >= 3 and chain[-3:-1] == ("os", "environ")
                and last in ("setdefault", "update", "pop", "clear",
                             "popitem")):
            self.fa.emit(
                ERROR, "global-mutation",
                f"os.environ.{last}(...) mutates the process "
                f"environment at runtime",
                line,
                hint="set env at module import or in the child's "
                     "entrypoint before threads exist; suppress with "
                     "a reason if this IS such an entrypoint")
        # --- rule: blocking under a held lock ----------------------------
        if held:
            why = self._blocking_reason(call, chain, held)
            if why is not None:
                locks = ", ".join(sorted(held))
                self.fa.emit(
                    ERROR, "blocking-under-lock",
                    f"{why} while holding {locks} — every other "
                    f"acquirer stalls behind this call",
                    line,
                    hint="move the blocking call outside the critical "
                         "section (snapshot state under the lock, act "
                         "after release), or suppress with the "
                         "invariant that bounds the stall")
            self._lock_edges_for_call(call, chain, held, line)

    def _blocking_reason(self, call, chain, held):
        last = chain[-1]
        recv = chain[:-1]
        if last == "sleep" and recv and recv[-1] == "time":
            return "time.sleep"
        if last in _FRAME_IO:
            return f"frame I/O ({last})"
        if last in _SOCKET_METHODS and recv:
            return f"socket/pipe {last}()"
        if last in ("call", "check_call", "check_output") and recv \
                and recv[-1] == "subprocess":
            return f"subprocess.{last}"
        if last == "communicate":
            return "subprocess communicate()"
        if last == "with_retries":
            return "with_retries (backoff sleeps between attempts)"
        if last == "wait":
            tgt = _self_attr(call.func.value) \
                if isinstance(call.func, ast.Attribute) else None
            if tgt is not None and self.ci is not None:
                kind = self.ci.lock_attrs.get(tgt)
                if kind == "condition" \
                        and self.ci.canon_lock(tgt) in held:
                    return None     # Condition.wait releases the lock
            return "blocking wait()"
        if last == "join":
            tgt = _self_attr(call.func.value) \
                if isinstance(call.func, ast.Attribute) else None
            if tgt is not None and self.ci is not None \
                    and tgt in self.ci.thread_attrs:
                return f"join() on thread self.{tgt}"
            if len(recv) == 1 and _THREADISH_RE.search(recv[0]):
                return f"join() on {recv[0]}"
            return None             # str.join etc.
        if last in ("get", "put"):
            if call.args and isinstance(call.args[0], ast.Constant) \
                    and isinstance(call.args[0].value, str):
                return None         # dict.get("key")
            if recv and _QUEUEISH_RE.search(recv[-1]):
                return f"queue {last}()"
        return None

    # -- lock-ordering edges ----------------------------------------------
    def _lock_edges_for_call(self, call, chain, held, line):
        if self.ci is None or not isinstance(call.func, ast.Attribute):
            return
        src_nodes = [f"{self.ci.name}.{lk}" for lk in held]
        # self.method() that takes another own lock
        if len(chain) == 2 and chain[0] == "self":
            meth = chain[1]
            for dst_lock in self.ci.method_locks.get(meth, ()):
                if dst_lock in held:
                    if self.ci.lock_attrs.get(dst_lock) == "lock":
                        self.fa.emit(
                            ERROR, "lock-order-cycle",
                            f"self.{meth}() re-acquires non-reentrant "
                            f"{dst_lock} already held here — "
                            f"self-deadlock",
                            line,
                            hint=f"make {dst_lock} an RLock or give "
                                 f"{meth} a _locked variant called "
                                 f"under the lock")
                    continue
                for src in src_nodes:
                    self.fa.lock_edges.append(
                        (src, f"{self.ci.name}.{dst_lock}", line,
                         self.fa.path,
                         f"self.{meth}() takes {dst_lock}"))
        # collaborator call: self.<attr>.<meth>() into a typed class
        if len(chain) == 3 and chain[0] == "self":
            attr, meth = chain[1], chain[2]
            target = self.ci.attr_types.get(attr)
            if target is not None:
                for dst_lock in target.method_locks.get(meth, ()):
                    for src in src_nodes:
                        self.fa.lock_edges.append(
                            (src, f"{target.name}.{dst_lock}", line,
                             self.fa.path,
                             f"self.{attr}.{meth}() takes "
                             f"{target.name}.{dst_lock}"))

    # -- held-lock resolution ---------------------------------------------
    def _lock_of(self, expr):
        attr = _self_attr(expr)
        if attr is not None and self.ci is not None \
                and self.ci.lock_kind(attr):
            return self.ci.canon_lock(attr)
        if isinstance(expr, ast.Name) and expr.id in self.local_locks:
            return expr.id
        return None

    def _nonreentrant(self, lock):
        if self.ci is not None and lock in self.ci.lock_attrs:
            return self.ci.lock_attrs[lock] == "lock"
        return self.local_locks.get(lock) == "lock"

    # -- local (function-scope) threads -----------------------------------
    def _local_thread_verdicts(self, func):
        for spec, var in self.local_threads:
            joined = any(
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == "join"
                and isinstance(sub.func.value, ast.Name)
                and sub.func.value.id == var
                for sub in ast.walk(func))
            # resolve target against the enclosing class when possible
            tf = None
            if spec["target"] and self.ci is not None:
                tf = self.ci.methods.get(spec["target"])
            has_stop = (_mentions_stop_signal(tf)
                        if tf is not None else None)
            if not spec["daemon"] and not joined:
                self.fa.emit(
                    ERROR, "thread-hygiene",
                    f"non-daemon local thread ({var or 'anonymous'}) "
                    f"started without a join",
                    spec["line"],
                    hint="join before returning, or daemonize with a "
                         "stop signal")
            elif spec["daemon"] and has_stop is False and not joined:
                self.fa.emit(
                    WARNING, "thread-hygiene",
                    f"daemon local thread ({var or 'anonymous'}) "
                    f"loops forever with no stop signal",
                    spec["line"],
                    hint="check a stop event/flag in the loop")


# ---------------------------------------------------------------------------
# statement-level os.environ[...] writes (not calls)
# ---------------------------------------------------------------------------


def _environ_subscript_writes(tree, fa):
    """`os.environ[...] = v` / `del os.environ[...]` inside any
    function body (module level is import time and allowed)."""
    def scan(body, in_func):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scan(node.body, True)
                continue
            if isinstance(node, ast.ClassDef):
                scan(node.body, in_func)
                continue
            if in_func:
                targets = []
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = getattr(node, "targets", None) \
                        or [node.target]
                elif isinstance(node, ast.Delete):
                    targets = node.targets
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and _dotted(t.value) == ("os", "environ"):
                        fa.emit(
                            ERROR, "global-mutation",
                            "os.environ[...] assignment inside a "
                            "function body — process-global state "
                            "flipped at runtime",
                            node.lineno,
                            hint="move to module import or a process "
                                 "entrypoint; suppress with a reason "
                                 "if this function IS the sanctioned "
                                 "global switch")
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.stmt):
                    scan([child], in_func)
                elif hasattr(child, "body") and \
                        isinstance(getattr(child, "body", None), list):
                    scan(child.body, in_func)
    scan(tree.body, False)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


class RaceReport:
    """findings = unsuppressed diagnostics; suppressed = (diag, reason)."""

    def __init__(self, findings, suppressed, files):
        self.findings = findings
        self.suppressed = suppressed
        self.files = files

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
        }


def _analyze(analyzer):
    for fa in analyzer.files:
        _environ_subscript_writes(fa.tree, fa)
    findings, suppressed = analyzer.analyze()
    findings.sort(key=lambda d: (d.path, d.line, d.code))
    return RaceReport(findings, suppressed,
                      [fa.path for fa in analyzer.files])


def analyze_source(source, path="<source>"):
    """Analyze one source string — the fixture/test entrypoint."""
    an = Analyzer()
    an.add_source(source, path)
    return _analyze(an)


def analyze_files(paths):
    an = Analyzer()
    for p in paths:
        an.add_file(p)
    return _analyze(an)


def default_target_files(root=None):
    """The runtime packages racecheck gates, as concrete file paths."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = []
    for rel in DEFAULT_TARGETS:
        full = os.path.join(root, *rel.split("/"))
        if os.path.isfile(full):
            out.append(full)
            continue
        for dirpath, _dirnames, filenames in os.walk(full):
            for name in sorted(filenames):
                if name.endswith(".py") \
                        and not name.startswith("test_"):
                    out.append(os.path.join(dirpath, name))
    return sorted(out)


def run_tree(root=None):
    """Analyze the repo's own runtime packages."""
    return analyze_files(default_target_files(root))


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------


def expand_paths(paths):
    """Files and directories as the ``.py`` files they hold."""
    out = []
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                out.extend(os.path.join(dirpath, n)
                           for n in sorted(filenames)
                           if n.endswith(".py"))
        else:
            out.append(p)
    return out


def cli_report(module, args, prog):
    """Shared body of the two checkers' command lines: the report over
    the positional paths (replacing the default tree), the default tree
    widened by ``--paths``, or the default tree."""
    if args.paths:
        files = expand_paths(args.paths)
        if args.extra_paths:
            files += expand_paths(args.extra_paths)
        return module.analyze_files(files)
    if args.extra_paths:
        files = module.default_target_files()
        extra = [p for p in expand_paths(args.extra_paths)
                 if p not in set(files)]
        return module.analyze_files(files + extra)
    return module.run_tree()


def cli_parser(prog, description):
    import argparse
    ap = argparse.ArgumentParser(prog=prog, description=description)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the port's "
                         "runtime packages)")
    ap.add_argument("--paths", dest="extra_paths", nargs="+",
                    default=None, metavar="PATH",
                    help="widen the analyzed tree: the default packages "
                         "plus these files/dirs (positional paths "
                         "replace the defaults)")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON document instead of text")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings (text mode)")
    return ap


def cli_print(report, args, prog, extra=""):
    """Print a report as JSON or text; the exit status (1 iff an
    unsuppressed error-level finding exists)."""
    import json
    import sys
    errs = report.errors()
    if args.json:
        doc = report.to_dict()
        doc["ok"] = not errs
        json.dump(doc, sys.stdout, indent=2, sort_keys=True)
        print()
    else:
        for d in report.findings:
            print(d.format())
        if args.show_suppressed:
            for d, reason in report.suppressed:
                print(f"suppressed[{d.code}] {d.path}:{d.line} — "
                      f"{reason}")
        warn = len(report.findings) - len(errs)
        print(f"{prog}: {len(report.files)} file(s), {extra}"
              f"{len(errs)} error(s), {warn} warning(s), "
              f"{len(report.suppressed)} suppressed")
    return 1 if errs else 0


def main(argv=None):
    from .diagnostics import CODES
    prog = "python -m paddle_tpu_torch.analysis.racecheck"
    args = cli_parser(prog, "static concurrency analyzer for the port's "
                            "serving runtime").parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            level, meaning = CODES[rule]
            print(f"{rule:22s} [{level:7s}] {meaning}")
        return 0
    import sys
    return cli_print(cli_report(sys.modules[__name__], args, prog),
                     args, "racecheck")


if __name__ == "__main__":
    import sys
    sys.exit(main())
