"""racecheck — the static concurrency analyzer, the torch port
(paddle_tpu_torch/analysis/racecheck.py) on the cases of
tests/test_racecheck.py.

Per-rule fixtures (positive + negative + suppression), the canary
scope-bug regression fixture, and the self-gate: the port's own
runtime packages must carry zero unsuppressed error-level findings.
Against the JAX package: over every source the reference's tests
analyze, its fixture file and the reference's own tree, the port gives
the reference's findings — code, level, path and line.
"""
import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu.analysis import racecheck as jracecheck
from paddle_tpu_torch.analysis import racecheck
from paddle_tpu_torch.analysis.diagnostics import ERROR, WARNING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's CLI: ``python -m paddle_tpu_torch.analysis.racecheck``
RACELINT = ["-m", "paddle_tpu_torch.analysis.racecheck"]
SCOPE_BUG_FIXTURE = os.path.join(REPO, "tests", "fixtures",
                            "racecheck_pr12_scope_bug.py")


def check(src):
    return racecheck.analyze_source(textwrap.dedent(src), "snippet.py")


def codes(report):
    return [d.code for d in report.findings]


# ---------------------------------------------------------------------------
# rule: run-without-scope
# ---------------------------------------------------------------------------


def test_run_without_scope_flagged():
    rep = check("""
        class Engine:
            def step(self, feed):
                return self.exe.run(self.program, feed=feed,
                                    fetch_list=self.fetch_list)
        """)
    assert codes(rep) == ["run-without-scope"]
    assert rep.findings[0].level == ERROR
    assert rep.findings[0].line == 4


def test_run_with_scope_clean():
    rep = check("""
        class Engine:
            def step(self, feed):
                return self.exe.run(self.program, feed=feed,
                                    fetch_list=self.fetch_list,
                                    scope=self.scope)
        """)
    assert codes(rep) == []


def test_subprocess_run_not_confused():
    rep = check("""
        import subprocess
        def launch(cmd, feed):
            return subprocess.run(cmd, feed=feed)
        """)
    assert codes(rep) == []


def test_run_without_scope_suppression():
    rep = check("""
        class Engine:
            def step(self, feed):
                # racecheck: ok(run-without-scope) — single-threaded
                # training script, no serving path can race it
                return self.exe.run(self.program, feed=feed,
                                    fetch_list=self.fetch_list)
        """)
    assert codes(rep) == []
    assert len(rep.suppressed) == 1
    diag, reason = rep.suppressed[0]
    assert diag.code == "run-without-scope"
    assert "single-threaded" in reason


# ---------------------------------------------------------------------------
# rule: global-mutation
# ---------------------------------------------------------------------------


def test_scope_guard_in_function_flagged():
    rep = check("""
        from paddle_tpu_torch.core.executor import scope_guard
        def rebuild(scope, load):
            with scope_guard(scope):
                load()
        """)
    assert codes(rep) == ["global-mutation"]


def test_environ_write_in_function_flagged():
    rep = check("""
        import os
        def hijack():
            os.environ["JAX_PLATFORMS"] = "cpu"
        def nudge():
            os.environ.setdefault("A", "1")
        """)
    assert codes(rep) == ["global-mutation", "global-mutation"]


def test_module_level_environ_is_import_time():
    rep = check("""
        import os
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        """)
    assert codes(rep) == []


def test_environ_read_clean():
    rep = check("""
        import os
        def flag():
            return os.environ.get("PADDLE_TPU_OPTIMIZE", "0")
        """)
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# rule: unlocked-mutation
# ---------------------------------------------------------------------------

_DUAL_MODE = """
    import threading
    class Pool:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []
        def add(self, x):
            with self._lock:
                self.items.append(x)
        def sneak(self, x):
            {sneak_line}
    """


def test_unlocked_mutation_flagged():
    rep = check(_DUAL_MODE.format(sneak_line="self.items.append(x)"))
    assert codes(rep) == ["unlocked-mutation"]
    d = rep.findings[0]
    assert d.level == ERROR and "items" in d.message
    assert "_lock" in d.message


def test_consistently_locked_clean():
    rep = check(_DUAL_MODE.format(
        sneak_line="self.items.pop()" ).replace(
        "def sneak(self, x):\n            self.items.pop()",
        "def sneak(self, x):\n            with self._lock:\n"
        "                self.items.pop()"))
    assert codes(rep) == []


def test_init_assignment_not_dual_mode():
    # __init__ writes happen before the object is shared
    rep = check("""
        import threading
        class Pool:
            def __init__(self):
                self._lock = threading.Lock()
                self.total = 0
            def bump(self):
                with self._lock:
                    self.total += 1
        """)
    assert codes(rep) == []


def test_condition_counts_as_its_wrapped_lock():
    rep = check("""
        import threading
        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
                self._q = []
            def put(self, x):
                with self._cv:
                    self._q.append(x)
            def drain(self):
                with self._lock:
                    self._q.clear()
        """)
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# rule: blocking-under-lock
# ---------------------------------------------------------------------------


def test_sleep_under_lock_flagged():
    rep = check("""
        import threading, time
        class Backoff:
            def __init__(self):
                self._lock = threading.Lock()
            def retry(self):
                with self._lock:
                    time.sleep(0.5)
        """)
    assert codes(rep) == ["blocking-under-lock"]
    assert "time.sleep" in rep.findings[0].message


def test_condition_wait_on_held_lock_whitelisted():
    # Condition.wait releases the lock — the ONE legal blocking call
    rep = check("""
        import threading
        class Q:
            def __init__(self):
                self._lock = threading.Lock()
                self._cv = threading.Condition(self._lock)
            def take(self):
                with self._cv:
                    self._cv.wait(0.1)
        """)
    assert codes(rep) == []


def test_frame_io_under_local_lock_flagged():
    rep = check("""
        import threading
        def serve(sock, net):
            write_lock = threading.Lock()
            def send(obj):
                with write_lock:
                    net.send_frame(sock, obj)
            return send
        """)
    assert codes(rep) == ["blocking-under-lock"]


def test_sleep_after_release_clean():
    rep = check("""
        import threading, time
        class Backoff:
            def __init__(self):
                self._lock = threading.Lock()
            def retry(self):
                with self._lock:
                    delay = 0.5
                time.sleep(delay)
        """)
    assert codes(rep) == []


def test_dict_get_not_a_queue_get():
    rep = check("""
        import threading
        class R:
            def __init__(self):
                self._lock = threading.Lock()
            def kind(self, msg):
                with self._lock:
                    return msg.get("type")
        """)
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# rule: lock-order-cycle
# ---------------------------------------------------------------------------


def test_self_deadlock_flagged():
    rep = check("""
        import threading
        class P:
            def __init__(self):
                self._lock = threading.Lock()
            def outer(self):
                with self._lock:
                    self.inner()
            def inner(self):
                with self._lock:
                    pass
        """)
    assert codes(rep) == ["lock-order-cycle"]
    assert "self-deadlock" in rep.findings[0].message


def test_rlock_reentry_clean():
    rep = check("""
        import threading
        class P:
            def __init__(self):
                self._lock = threading.RLock()
            def outer(self):
                with self._lock:
                    self.inner()
            def inner(self):
                with self._lock:
                    pass
        """)
    assert codes(rep) == []


def test_cross_class_cycle_flagged():
    rep = check("""
        import threading
        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self.b = B()
            def ping(self):
                with self._lock:
                    self.b.pong()
            def poke(self):
                with self._lock:
                    pass
        class B:
            def __init__(self):
                self._lock = threading.Lock()
                self.a = A()
            def pong(self):
                with self._lock:
                    pass
            def nudge(self):
                with self._lock:
                    self.a.poke()
        """)
    assert "lock-order-cycle" in codes(rep)
    cyc = [d for d in rep.findings if d.code == "lock-order-cycle"]
    assert any("A._lock" in d.message and "B._lock" in d.message
               for d in cyc)


def test_one_way_collaboration_clean():
    rep = check("""
        import threading
        class A:
            def __init__(self):
                self._lock = threading.Lock()
                self.b = B()
            def ping(self):
                with self._lock:
                    self.b.pong()
        class B:
            def __init__(self):
                self._lock = threading.Lock()
            def pong(self):
                with self._lock:
                    pass
        """)
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# rule: thread-hygiene
# ---------------------------------------------------------------------------


def test_nondaemon_unjoined_flagged():
    rep = check("""
        import threading
        class S:
            def start(self):
                self._t = threading.Thread(target=self._loop)
                self._t.start()
            def _loop(self):
                while True:
                    pass
        """)
    assert codes(rep) == ["thread-hygiene"]
    assert rep.findings[0].level == ERROR


def test_daemon_forever_loop_warned():
    rep = check("""
        import threading
        class S:
            def start(self):
                self._t = threading.Thread(target=self._loop,
                                           daemon=True)
                self._t.start()
            def _loop(self):
                while True:
                    self.tick()
        """)
    assert codes(rep) == ["thread-hygiene"]
    assert rep.findings[0].level == WARNING


def test_stop_event_and_join_clean():
    rep = check("""
        import threading
        class S:
            def start(self):
                self._stop = threading.Event()
                self._t = threading.Thread(target=self._loop,
                                           daemon=True)
                self._t.start()
            def _loop(self):
                while not self._stop.is_set():
                    self.tick()
            def close(self):
                self._stop.set()
                self._t.join(5.0)
        """)
    assert codes(rep) == []


def test_breaking_loop_counts_as_stop_path():
    rep = check("""
        import threading
        class S:
            def start(self):
                self._t = threading.Thread(target=self._loop,
                                           daemon=True)
                self._t.start()
            def _loop(self):
                while True:
                    if self.step() is None:
                        break
        """)
    assert codes(rep) == []


# ---------------------------------------------------------------------------
# suppression hygiene
# ---------------------------------------------------------------------------


def test_reasonless_suppression_is_a_finding():
    rep = check("""
        import threading, time
        class B:
            def __init__(self):
                self._lock = threading.Lock()
            def retry(self):
                with self._lock:
                    time.sleep(0.5)  # racecheck: ok(blocking-under-lock)
        """)
    assert sorted(codes(rep)) == ["bad-suppression",
                                  "blocking-under-lock"]


def test_wrong_rule_suppression_does_not_match():
    rep = check("""
        import threading, time
        class B:
            def __init__(self):
                self._lock = threading.Lock()
            def retry(self):
                # racecheck: ok(thread-hygiene) — wrong rule on purpose
                with self._lock:
                    time.sleep(0.5)
        """)
    assert "blocking-under-lock" in codes(rep)


def test_multiline_comment_suppression_attaches_to_next_code_line():
    rep = check("""
        import threading, time
        class B:
            def __init__(self):
                self._lock = threading.Lock()
            def retry(self):
                with self._lock:
                    # racecheck: ok(blocking-under-lock) — bounded by
                    # the 10ms poll budget; nothing else contends
                    time.sleep(0.01)
        """)
    assert codes(rep) == []
    assert len(rep.suppressed) == 1


# ---------------------------------------------------------------------------
# the scope-bug regression fixture and the self-gate
# ---------------------------------------------------------------------------


def test_pr12_fixture_still_fails():
    """The jarred canary scope bug must trip all three scope rules
    forever."""
    rep = racecheck.analyze_files([SCOPE_BUG_FIXTURE])
    got = sorted(codes(rep))
    assert got == ["global-mutation", "global-mutation",
                   "run-without-scope"]
    assert all(d.level == ERROR for d in rep.findings)


def test_racelint_cli_exits_1_on_pr12_fixture():
    proc = subprocess.run(
        [sys.executable, *RACELINT, "--json", SCOPE_BUG_FIXTURE],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert '"run-without-scope"' in proc.stdout


def test_repo_tree_has_zero_unsuppressed_errors():
    """The CI gate: our own runtime packages are clean."""
    report = racecheck.run_tree()
    assert report.files, "target set resolved to nothing"
    msgs = "\n".join(d.format() for d in report.errors())
    assert not report.errors(), f"unsuppressed racecheck errors:\n{msgs}"
    # the fix sweep left real suppressions in the tree — each must
    # carry its reason
    assert report.suppressed
    assert all(reason for _d, reason in report.suppressed)


def test_report_json_roundtrip():
    report = racecheck.run_tree()
    doc = report.to_dict()
    assert doc["error_count"] == 0
    assert doc["files"] == len(report.files)
    assert isinstance(doc["suppressed"], list)
    for entry in doc["suppressed"]:
        assert entry["reason"]

# ---------------------------------------------------------------------------
# the port against the JAX package: the reference's own fixture sources
# ---------------------------------------------------------------------------


def _reference_sources(test_file, helpers):
    """Every source the reference's test module ``test_file`` hands its
    helpers (``check(src, path=...)``, ``multi((path, src), ...)``): the
    literal arguments, with names resolved to the string constants of
    the enclosing function or the module, and ``.replace`` of constants
    applied. Returns ``[(label, [(path, src), ...], arming, docs)]``."""
    import ast
    tree = ast.parse(open(os.path.join(REPO, "tests", test_file)).read())

    def strings(body, env):
        env = dict(env)
        for node in body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                v = value(node.value, env)
                if v is not None:
                    env[node.targets[0].id] = v
        return env

    def value(node, env):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        if isinstance(node, ast.Name):
            return env.get(node.id)
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "replace" and len(node.args) == 2:
            base = value(node.func.value, env)
            a, b = (value(x, env) for x in node.args)
            if None not in (base, a, b):
                return base.replace(a, b)
        return None

    module_env = strings(tree.body, {})
    out = []
    for fn in [n for n in tree.body if isinstance(n, ast.FunctionDef)]:
        env = strings(fn.body, module_env)
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in helpers):
                continue
            kw = {k.arg: value(k.value, env) for k in node.keywords}
            if node.func.id == "multi":
                files = [(value(a.elts[0], env), value(a.elts[1], env))
                         for a in node.args
                         if isinstance(a, ast.Tuple) and len(a.elts) == 2]
            elif node.args:
                files = [(kw.get("path") or helpers[node.func.id],
                          value(node.args[0], env))]
            else:
                files = []
            if not files or any(p is None or src is None
                                for p, src in files):
                continue
            out.append((f"{test_file}:{node.lineno}", files,
                        kw.get("arming") or "", kw.get("docs") or ""))
    return out


def _key(report):
    return (sorted((d.code, d.level, d.path, d.line)
                   for d in report.findings),
            sorted((d.code, d.level, d.path, d.line, reason)
                   for d, reason in report.suppressed))


_RACE_SOURCES = _reference_sources("test_racecheck.py",
                                   {"check": "snippet.py"})


def test_reference_sources_were_found():
    assert len(_RACE_SOURCES) == 26


@pytest.mark.parametrize("label,files,arming,docs", _RACE_SOURCES,
                         ids=[c[0] for c in _RACE_SOURCES])
def test_findings_equal_the_reference_on_its_sources(label, files,
                                                     arming, docs):
    (path, src), = files
    src = textwrap.dedent(src)
    assert _key(racecheck.analyze_source(src, path)) == \
        _key(jracecheck.analyze_source(src, path))


def test_findings_equal_the_reference_on_its_fixture_and_tree():
    assert _key(racecheck.analyze_files([SCOPE_BUG_FIXTURE])) == \
        _key(jracecheck.analyze_files([SCOPE_BUG_FIXTURE]))
    ref_pkg = os.path.join(REPO, "paddle_tpu")
    assert racecheck.default_target_files(ref_pkg) == \
        jracecheck.default_target_files()
    got, want = racecheck.run_tree(ref_pkg), jracecheck.run_tree()
    assert _key(got) == _key(want)
    assert len(want.suppressed) > 0
