"""Shared lint-suppression grammar for the source-level analyzers
(port of ``paddle_tpu/analysis/suppress.py``).

racecheck established the comment form::

    # <tag>: ok(<rule>[, <rule>...]) — <non-empty reason>

either trailing the flagged line or in a comment block immediately
above it. numlint reuses the identical grammar with the
``numcheck:`` tag (its findings anchor to IR ops rather than source
lines, so numlint matches suppressions file-scoped — any line of the
file being linted). This module is the single parser both consult:
one grammar, one ``bad-suppression`` policy (a reason-less ``ok(...)``
is itself a WARNING — reasons are mandatory because reason-less
suppressions rot).
"""
import re

from .diagnostics import WARNING, SourceDiagnostic

__all__ = ["Suppressions"]

_REASON_RE = re.compile(r"^\s*[-—–:]*\s*(\S.*)$")


def _suppress_re(tag):
    return re.compile(
        r"#\s*" + re.escape(tag) +
        r":\s*ok\(\s*([A-Za-z0-9_\-\s,]*?)\s*\)(.*)$")


class Suppressions:
    """``# <tag>: ok(rule, ...) — reason`` comments, by line.

    ``by_line`` maps line number → (set of rules, reason); ``bad``
    collects :class:`SourceDiagnostic` records for malformed
    suppressions; ``used`` records the lines whose suppression
    matched at least one finding (an analyzer may warn on unused
    ones).
    """

    def __init__(self, source, path, tag="racecheck"):
        self.path = path
        self.tag = tag
        self.by_line = {}           # line -> (set(rules), reason)
        self.bad = []               # SourceDiagnostic for malformed ones
        self.used = set()           # lines whose suppression matched
        pat = _suppress_re(tag)
        lines = source.splitlines()
        for i, text in enumerate(lines, start=1):
            m = pat.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            rm = _REASON_RE.match(m.group(2) or "")
            reason = rm.group(1).strip() if rm else ""
            if not rules or not reason:
                self.bad.append(SourceDiagnostic(
                    WARNING, "bad-suppression",
                    "suppression comment needs both a rule list and a "
                    f"reason: '# {tag}: ok(<rule>) — <why this is "
                    "safe>'", path, i,
                    hint="state the invariant that makes the flagged "
                         "line safe; reason-less suppressions rot"))
                continue
            entry = (rules, reason)
            self.by_line.setdefault(i, entry)   # same-line trailing form
            # a comment-line suppression attaches to the next line of
            # actual code (the comment block may continue for several
            # lines — the reason is encouraged to be a full sentence)
            if text.lstrip().startswith("#"):
                j = i
                while j < len(lines) and \
                        lines[j].strip().startswith("#"):
                    j += 1
                if j < len(lines) and lines[j].strip():
                    self.by_line.setdefault(j + 1, entry)

    def match(self, line, rule):
        """Suppression on the finding's line, the line above, or a
        comment block ending just above it."""
        for ln in (line, line - 1):
            entry = self.by_line.get(ln)
            if entry and (rule in entry[0] or "all" in entry[0]):
                self.used.add(ln)
                return entry[1]
        return None

    def match_any(self, rule):
        """File-scoped match: a suppression for ``rule`` anywhere in
        the file (the numlint form — its findings anchor to IR ops,
        not source lines, so any line of the linted file may carry
        the suppression)."""
        for ln in sorted(self.by_line):
            rules, reason = self.by_line[ln]
            if rule in rules or "all" in rules:
                self.used.add(ln)
                return reason
        return None
