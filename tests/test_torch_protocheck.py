"""protocheck — the static contract analyzer, the torch port
(paddle_tpu_torch/analysis/protocheck.py) on the cases of
tests/test_protocheck.py, its corpora the port's tests and
chip_smoke.py (arming) and docs/TORCH_RELIABILITY.md (knobs). Against
the JAX package: over every source the reference's tests analyze, its
teeth fixture and the reference's own tree (without corpora), the port
gives the reference's findings — code, level, path and line.

Per-family fixtures (positive + negative + suppression) for all five
rule families, the jarred teeth fixture through the real CLI, the
committed-knob-table drift check, and the self-gate: the port's own
tree must carry zero unsuppressed error-level findings.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from paddle_tpu.analysis import protocheck as jprotocheck
from paddle_tpu_torch.analysis import protocheck
from paddle_tpu_torch.analysis.diagnostics import ERROR, WARNING

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port's CLI: ``python -m paddle_tpu_torch.analysis.protocheck``
PROTOLINT = ["-m", "paddle_tpu_torch.analysis.protocheck"]
TEETH = os.path.join(REPO, "tests", "fixtures", "protocheck_teeth.py")


def check(src, path="cluster/snippet.py", arming="", docs=""):
    return protocheck.analyze_source(textwrap.dedent(src), path,
                                     arming_text=arming,
                                     docs_text=docs)


def multi(*files, arming="", docs=""):
    """Analyze several (path, source) pairs as one file set — the
    cross-file verb-parity cases."""
    an = protocheck.Analyzer(arming_text=arming, docs_text=docs)
    for path, src in files:
        an.add_source(textwrap.dedent(src), path)
    findings, suppressed, knobs = an.analyze()
    return protocheck.ProtoReport(
        findings, suppressed, [f[0] for f in files], knobs)


def codes(report):
    return [d.code for d in report.findings]


# ---------------------------------------------------------------------------
# family: verb-parity
# ---------------------------------------------------------------------------

PIPE_CLIENT = """
    class ProcessReplica:
        def submit(self, feed):
            self._send({"type": "submit", "id": 1, "feed": feed})

        def frobnicate(self):
            self._send({"type": "frobnicate", "id": 2})
"""

PIPE_SERVER = """
    def main():
        while True:
            msg = read_frame(stdin)
            kind = msg.get("type")
            if kind == "submit":
                serve(msg)
"""


def test_verb_unserved_flagged():
    r = multi(("cluster/replica.py", PIPE_CLIENT),
              ("cluster/proc_worker.py", PIPE_SERVER))
    errs = [d for d in r.findings if d.code == "verb-unserved"]
    assert len(errs) == 1
    assert errs[0].level == ERROR
    assert "frobnicate" in errs[0].message
    # anchored at the client's send site
    assert errs[0].path == "cluster/replica.py"


def test_verb_parity_clean():
    server = PIPE_SERVER.replace(
        'if kind == "submit":',
        'if kind in ("submit", "frobnicate"):')
    r = multi(("cluster/replica.py", PIPE_CLIENT),
              ("cluster/proc_worker.py", server))
    assert "verb-unserved" not in codes(r)


def test_verb_dead_warned():
    server = PIPE_SERVER + """
            elif kind == "ping":
                serve(msg)
    """
    r = multi(("cluster/replica.py", PIPE_CLIENT.replace(
                  "frobnicate", "submit")),
              ("cluster/proc_worker.py", server))
    dead = [d for d in r.findings if d.code == "verb-dead"]
    assert len(dead) == 1 and dead[0].level == WARNING
    assert "ping" in dead[0].message


def test_verb_dead_suppression_by_family_name():
    server = PIPE_SERVER + """
            # protocheck: ok(verb-parity) — operator liveness probe
            elif kind == "ping":
                serve(msg)
    """
    r = multi(("cluster/replica.py", PIPE_CLIENT.replace(
                  "frobnicate", "submit")),
              ("cluster/proc_worker.py", server))
    assert "verb-dead" not in codes(r)
    assert any(d.code == "verb-dead" for d, _ in r.suppressed)


def test_verb_asymmetric_across_family():
    # 'handoff' exists on pipe, the socket sibling never serves it
    sock_client = """
        class RemoteReplica:
            def submit(self, feed):
                self._send({"type": "submit", "id": 1})
    """
    sock_server = """
        class ReplicaServer:
            def _serve(self, msg):
                kind = msg.get("type")
                if kind == "submit":
                    pass
    """
    pipe_client = PIPE_CLIENT.replace("frobnicate", "handoff")
    pipe_server = PIPE_SERVER.replace(
        'if kind == "submit":',
        'if kind in ("submit", "handoff"):')
    r = multi(("cluster/replica.py", pipe_client),
              ("cluster/proc_worker.py", pipe_server),
              ("cluster/remote.py", sock_client),
              ("cluster/net_worker.py", sock_server))
    asym = [d for d in r.findings if d.code == "verb-asymmetric"]
    assert len(asym) == 1 and asym[0].level == WARNING
    assert "handoff" in asym[0].message


def test_client_alone_not_judged():
    # no server loaded for the transport: parity can't be judged
    r = check(PIPE_CLIENT, path="cluster/replica.py")
    assert not any(c.startswith("verb-") for c in codes(r))


# ---------------------------------------------------------------------------
# family: wire-error
# ---------------------------------------------------------------------------


def test_wire_error_unregistered_flagged():
    r = check("""
        class ServingError(RuntimeError):
            pass

        class TornWriteError(ServingError):
            pass

        WIRE_ERRORS = {c.__name__: c for c in (ServingError,)}

        def save():
            raise TornWriteError("torn")
    """)
    errs = [d for d in r.findings
            if d.code == "wire-error-unregistered"]
    assert len(errs) == 1 and errs[0].level == ERROR
    assert "TornWriteError" in errs[0].message


def test_wire_error_in_registry_clean():
    r = check("""
        class ServingError(RuntimeError):
            pass

        class TornWriteError(ServingError):
            pass

        WIRE_ERRORS = {c.__name__: c
                       for c in (ServingError, TornWriteError)}

        def save():
            raise TornWriteError("torn")
    """)
    assert "wire-error-unregistered" not in codes(r)


def test_wire_error_register_call_clean():
    # the register_wire_error() path (modules above net in the import
    # graph: router, train_fabric)
    r = check("""
        class ServingError(RuntimeError):
            pass

        class OverloadError(ServingError):
            pass

        register_wire_error(OverloadError)

        def admit():
            raise OverloadError("shed")
    """)
    assert "wire-error-unregistered" not in codes(r)


def test_wire_error_unraised_clean():
    # defined but never raised by the analyzed code: no finding
    r = check("""
        class ServingError(RuntimeError):
            pass

        class NeverRaisedError(ServingError):
            pass
    """)
    assert "wire-error-unregistered" not in codes(r)


def test_wire_error_suppression():
    r = check("""
        class ServingError(RuntimeError):
            pass

        WIRE_ERRORS = {c.__name__: c for c in (ServingError,)}

        # protocheck: ok(wire-error-unregistered) — in-process only,
        # raised and caught inside one engine call, never crosses
        class LocalOnlyError(ServingError):
            pass

        def f():
            raise LocalOnlyError("local")
    """)
    assert "wire-error-unregistered" not in codes(r)
    assert len(r.suppressed) == 1


# ---------------------------------------------------------------------------
# family: fault-point
# ---------------------------------------------------------------------------

FAULT_SRC = """
    KNOWN_POINTS = (
        "save_torn",
        "net_drop",
    )

    def fires(kind):
        return kind in KNOWN_POINTS

    def save():
        if fires("save_torn"):
            raise IOError("torn")
        if fires("net_dorp"):
            raise IOError("dropped")
"""


def test_fault_point_unknown_flagged():
    r = check(FAULT_SRC, path="resilience/faultinject.py",
              arming="save_torn net_drop")
    errs = [d for d in r.findings if d.code == "fault-point-unknown"]
    assert len(errs) == 1 and errs[0].level == ERROR
    assert "net_dorp" in errs[0].message


def test_fault_point_dead_warned():
    # net_drop is registered but nothing in the arming corpus arms it
    r = check(FAULT_SRC.replace("net_dorp", "net_drop"),
              path="resilience/faultinject.py", arming="save_torn")
    dead = [d for d in r.findings if d.code == "fault-point-dead"]
    assert len(dead) == 1 and dead[0].level == WARNING
    assert "net_drop" in dead[0].message


def test_fault_point_armed_clean():
    r = check(FAULT_SRC.replace("net_dorp", "net_drop"),
              path="resilience/faultinject.py",
              arming="arm('save_torn'); arm('net_drop')")
    assert not any(c.startswith("fault-point") for c in codes(r))


# ---------------------------------------------------------------------------
# family: counter-vocab
# ---------------------------------------------------------------------------


def test_counter_dead_warned():
    r = check("""
        class Server:
            def handle(self):
                self.metrics.incr("orphan_requests_total")
    """)
    dead = [d for d in r.findings if d.code == "counter-dead"]
    assert len(dead) == 1 and dead[0].level == WARNING
    assert "orphan_requests_total" in dead[0].message


def test_counter_documented_clean():
    r = check("""
        class Server:
            def handle(self):
                self.metrics.incr("requests_total")
    """, docs="| `requests_total` | requests accepted |")
    assert "counter-dead" not in codes(r)


def test_counter_read_in_code_clean():
    # a non-increment read site in runtime code counts as a reference
    r = check("""
        class Server:
            def handle(self):
                self.metrics.incr("requests_total")

            def stats(self):
                return {"n": self.counters["requests_total"]}
    """)
    assert "counter-dead" not in codes(r)


def test_counter_near_miss_warned():
    r = check("""
        class Server:
            def a(self):
                self.metrics.incr("requests_total")

            def b(self):
                self.metrics.incr("request_total")
    """, docs="requests_total request_total")
    near = [d for d in r.findings if d.code == "counter-near-miss"]
    assert near and near[0].level == WARNING


def test_counter_suppression():
    r = check("""
        class Server:
            def handle(self):
                # protocheck: ok(counter-dead) — dashboard-only, the
                # fleet scraper reads it out of band
                self.metrics.incr("scrape_only_total")
    """)
    assert "counter-dead" not in codes(r)
    assert len(r.suppressed) == 1


# ---------------------------------------------------------------------------
# family: knob-registry
# ---------------------------------------------------------------------------


def test_knob_undocumented_warned_and_registered():
    r = check("""
        import os
        LIMIT = float(os.environ.get("PADDLE_TPU_TEST_LIMIT", "3.5"))
    """)
    undoc = [d for d in r.findings if d.code == "knob-undocumented"]
    assert len(undoc) == 1 and undoc[0].level == WARNING
    assert [k["name"] for k in r.knobs] == ["PADDLE_TPU_TEST_LIMIT"]
    assert r.knobs[0]["default"] == "'3.5'"   # repr of the const


def test_knob_documented_clean():
    r = check("""
        import os
        LIMIT = os.getenv("PADDLE_TPU_TEST_LIMIT")
    """, docs="| `PADDLE_TPU_TEST_LIMIT` | — |")
    assert "knob-undocumented" not in codes(r)
    assert [k["name"] for k in r.knobs] == ["PADDLE_TPU_TEST_LIMIT"]


def test_knob_module_alias_resolved():
    # reading through a module-level name alias still registers
    r = check("""
        import os
        _KNOB = "PADDLE_TPU_ALIASED_KNOB"

        def setting():
            return os.environ.get(_KNOB)
    """, docs="PADDLE_TPU_ALIASED_KNOB")
    assert [k["name"] for k in r.knobs] == ["PADDLE_TPU_ALIASED_KNOB"]


def test_knob_env_wrapper_detected():
    # _env_float-style wrappers count as getenv sites
    r = check("""
        def _env_float(name, default):
            import os
            return float(os.environ.get(name, default))

        DELAY = _env_float("PADDLE_TPU_WRAPPED_KNOB", 0.25)
    """, docs="PADDLE_TPU_WRAPPED_KNOB")
    assert "PADDLE_TPU_WRAPPED_KNOB" in [k["name"] for k in r.knobs]


def test_knobs_table_render_is_marked_and_stable():
    r = check("""
        import os
        A = os.getenv("PADDLE_TPU_B_KNOB")
        B = os.getenv("PADDLE_TPU_A_KNOB", "1")
    """, docs="PADDLE_TPU_A_KNOB PADDLE_TPU_B_KNOB")
    table = protocheck.render_knobs_table(r.knobs)
    assert table.startswith(protocheck.KNOBS_BEGIN)
    assert table.rstrip().endswith(protocheck.KNOBS_END)
    # sorted by name, defaults rendered, deterministic
    assert table.index("PADDLE_TPU_A_KNOB") \
        < table.index("PADDLE_TPU_B_KNOB")
    assert protocheck.render_knobs_table(r.knobs) == table


# ---------------------------------------------------------------------------
# the real tree, the real CLI, the committed table
# ---------------------------------------------------------------------------


def test_repo_tree_has_zero_unsuppressed_errors():
    report = protocheck.run_tree()
    assert report.errors() == [], \
        "\n".join(d.format() for d in report.errors())


def test_teeth_fixture_fails_the_cli():
    proc = subprocess.run(
        [sys.executable, *PROTOLINT, "--json", TEETH],
        capture_output=True, text=True, cwd=REPO)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    doc = json.loads(proc.stdout)
    got = {d["code"] for d in doc["findings"]
           if d["level"] == "error"}
    assert {"wire-error-unregistered", "fault-point-unknown"} <= got


def test_committed_knob_table_matches_tree():
    fresh = protocheck.render_knobs_table(
        protocheck.run_tree().knobs)
    with open(os.path.join(REPO, protocheck.KNOBS_DOC),
              encoding="utf-8") as f:
        text = f.read()
    b = text.find(protocheck.KNOBS_BEGIN)
    e = text.find(protocheck.KNOBS_END)
    assert b >= 0 and e >= 0, "knob-table markers missing from docs"
    committed = text[b:e + len(protocheck.KNOBS_END)]
    assert committed.strip() == fresh.strip(), \
        "knob table drifted — regenerate with " \
        "`python -m paddle_tpu_torch.analysis.protocheck --knobs-table`"


def test_report_json_roundtrip():
    r = check(FAULT_SRC, path="resilience/faultinject.py")
    doc = json.loads(json.dumps(r.to_dict()))
    assert doc["files"] == 1
    assert {d["code"] for d in doc["findings"]} \
        == {d.code for d in r.findings}
    assert all({"code", "level", "path", "line"} <= set(d)
               for d in doc["findings"])

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


_PROTO_SOURCES = _reference_sources(
    "test_protocheck.py", {"check": "cluster/snippet.py", "multi": None})


def test_reference_sources_were_found():
    assert len(_PROTO_SOURCES) == 23
    assert sum(len(files) > 1 for _, files, _, _ in _PROTO_SOURCES) == 3


@pytest.mark.parametrize("label,files,arming,docs", _PROTO_SOURCES,
                         ids=[c[0] for c in _PROTO_SOURCES])
def test_findings_equal_the_reference_on_its_sources(label, files,
                                                     arming, docs):
    keys = []
    for mod in (protocheck, jprotocheck):
        an = mod.Analyzer(arming_text=textwrap.dedent(arming),
                          docs_text=textwrap.dedent(docs))
        for path, src in files:
            an.add_source(textwrap.dedent(src), path)
        findings, suppressed, knobs = an.analyze()
        keys.append((_key(mod.ProtoReport(findings, suppressed, [],
                                          knobs)), knobs))
    assert keys[0] == keys[1]


def test_findings_equal_the_reference_on_its_fixture_and_tree():
    for files in ([TEETH], None):
        ref_pkg = os.path.join(REPO, "paddle_tpu")
        if files is None:
            files = [f for f in jprotocheck.default_target_files()
                     if f.startswith(ref_pkg + os.sep)]
        got = protocheck.analyze_files(files, root=ref_pkg,
                                       with_corpora=False)
        want = jprotocheck.analyze_files(files, root=ref_pkg,
                                         with_corpora=False)
        assert _key(got) == _key(want)
        assert [e.code for e in got.errors()] == \
            [e.code for e in want.errors()]
