"""graftlint: the AST invariant checker, aimed at the port.

Port of `dgraph_tpu/analysis/__init__.py`. It is the `go vet` of this
package: a pluggable AST lint framework with the invariants the
reference established PR by PR, as code: a deadline checkpoint in every
hot loop, one resilience wrapper for every outbound RPC, monotonic
clocks in budget arithmetic, retries that never re-spend an expired
budget, documented metrics, pure captured programs, atomic durable
writes, lock discipline, governed caches and SLO names inside their
inventory (R1-R8 and R13-R15 in `rules.py`, the lock-discipline rules
R9-R12 in `guards.py`). `tests/test_torch_lint.py` runs it over the
whole port, so a refactor that drops an invariant fails the build.

Waivers: a finding is suppressed by an inline comment on the offending
line or the line directly above it::

    # graftlint: allow(<rule>[, <rule>...]): <reason>

The reason is mandatory: a waiver without one is itself a finding (rule
`waiver-syntax`) and waives nothing.

The analyzer also extracts a facts inventory (`facts.py`: the hand
kernels with their sources and launch sites, the captured programs,
span and metric sites, lock classes, guarded fields, and the port's
runtime inventories), which `chip_smoke.py` holds against what a run on
the card did.

Nothing here imports torch or anything of the reference: the analyzer
reads source files, and a fresh process scans the port in a few
seconds::

    python -m dgraph_tpu_torch.analysis [--format=text|json] [paths...]
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

__all__ = ["Finding", "FileContext", "Rule", "Analyzer", "run",
           "default_paths", "WAIVER_RE", "WAIVER_SYNTAX", "PACKAGE",
           "BENCH_SCRIPT"]

PACKAGE = "dgraph_tpu_torch"
# the port's bench-role script: it takes the reference's bench.py place
# in the default scan set (R5's metric scan, R7 and R15 read it)
BENCH_SCRIPT = "chip_smoke.py"

WAIVER_RE = re.compile(
    r"#\s*graftlint:\s*allow\(\s*(?P<rules>[a-z0-9_,\s\-]+?)\s*\)"
    r"(?:\s*:\s*(?P<reason>\S.*))?")
WAIVER_SYNTAX = "waiver-syntax"


@dataclasses.dataclass
class Finding:
    """One rule violation at one site. Waived findings are kept (the
    CLI can show them, and their counts are reported) but never fail
    the build."""

    rule: str
    path: str          # repo-relative, "/"-separated
    line: int
    msg: str
    waived: bool = False
    reason: str = ""   # the waiver's reason when waived

    def format(self) -> str:
        tag = f"  [waived: {self.reason}]" if self.waived else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}{tag}"


class FileContext:
    """One scanned file: source, parsed tree, and its waiver map. Rules
    that share a per-file analysis (the lock-discipline inference, the
    parent map) keep it in `memo`, so it is computed once a file."""

    def __init__(self, rel: str, source: str):
        self.rel = rel
        self.source = source
        self.tree = ast.parse(source, filename=rel)
        self.lines = source.splitlines()
        self.memo: dict = {}
        # line number → (set of waived rules, reason, has_reason)
        self.waivers: dict[int, tuple[set[str], str, bool]] = {}
        for i, ln in enumerate(self.lines, start=1):
            if "graftlint" not in ln:
                continue
            m = WAIVER_RE.search(ln)
            if not m:
                continue
            rules = {r.strip() for r in m.group("rules").split(",")
                     if r.strip()}
            reason = (m.group("reason") or "").strip()
            self.waivers[i] = (rules, reason, bool(reason))
        self._effective = dict(self.waivers)
        for line, w in self.waivers.items():
            for ln in self._reach(line):
                self._effective.setdefault(ln, w)

    def nodes(self, *types) -> list:
        """Every node of the tree in `ast.walk` order, or those of the
        given types: one walk a file, shared by every rule."""
        index = self.memo.get("nodes")
        if index is None:
            index = self._walk()
        key = types or None
        got = index.get(key)
        if got is None:
            got = index[key] = [n for n in index[None]
                                if isinstance(n, types)]
        return got

    def parents(self) -> dict:
        """id(node) → its parent node, over the whole tree."""
        if "parents" not in self.memo:
            self._walk()
        return self.memo["parents"]

    def _walk(self) -> dict:
        """One breadth-first walk (`ast.walk`'s order) that fills both
        the node index and the parent map."""
        order, par = [self.tree], {}
        i = 0
        while i < len(order):
            node = order[i]
            i += 1
            for child in ast.iter_child_nodes(node):
                par[id(child)] = node
                order.append(child)
        index = self.memo["nodes"] = {None: order}
        self.memo["parents"] = par
        return index

    def _stmt_spans(self) -> list:
        """(first line, last line, header's last line) of every
        statement, computed once."""
        spans = self.memo.get("stmt_spans")
        if spans is None:
            spans = []
            for node in self.nodes(ast.stmt):
                end = getattr(node, "end_lineno", node.lineno)
                body = getattr(node, "body", None)
                hdr_end = (body[0].lineno - 1
                           if isinstance(body, list) and body
                           and isinstance(body[0], ast.stmt)
                           else end)
                spans.append((node.lineno, end, hdr_end))
            self.memo["stmt_spans"] = spans
        return spans

    def _reach(self, line: int):
        """Lines a waiver at `line` covers beyond itself. A waiver on a
        comment-only line flows DOWN through the rest of its comment
        block to the next statement: the full span of a simple
        statement (a multi-line call keeps its finding on a
        continuation line), the header only of a compound one (a
        waiver above a `while` must not silence findings in its
        body). A trailing waiver on a code line covers that line."""
        if not self.lines[line - 1].lstrip().startswith("#"):
            return
        c = line + 1
        while c <= len(self.lines) and (
                not self.lines[c - 1].strip()
                or self.lines[c - 1].lstrip().startswith("#")):
            c += 1
        if c > len(self.lines):
            return
        best = None  # smallest statement span containing line c
        for lo, end, hdr_end in self._stmt_spans():
            if lo <= c <= end and (best is None
                                   or end - lo < best[1] - best[0]):
                best = (lo, end, hdr_end)
        if best is None:
            yield c
            return
        lo_stmt, end, hdr_end = best
        lo = max(c, lo_stmt)
        hi = hdr_end if hdr_end >= lo else end
        yield from range(lo, hi + 1)

    def waiver_for(self, rule: str, line: int) -> str | None:
        """The reason string if `rule` is waived at `line` (same line,
        the line directly above, or within reach of a comment-block
        waiver), else None. A reasonless waiver does NOT waive: it
        surfaces as a `waiver-syntax` finding."""
        for ln in (line, line - 1):
            w = self._effective.get(ln)
            if w and rule in w[0] and w[2]:
                return w[1]
        return None


class Rule:
    """Base class: subclasses set `name`/`doc`, implement `check_file`,
    and may implement `finalize` for repo-level findings (rules that
    aggregate across files, like the metric-docs README pass)."""

    name = "base"
    doc = ""

    def applies(self, rel: str) -> bool:
        return rel.startswith(PACKAGE + "/")

    def check_file(self, ctx: FileContext) -> list[Finding]:
        return []

    def finalize(self, analyzer: "Analyzer") -> list[Finding]:
        return []


class Analyzer:
    """Drives a rule set over a file set; applies waivers; collects
    the facts inventory. `readme_text` is injectable for tests."""

    def __init__(self, rules: list[Rule] | None = None,
                 repo_root: pathlib.Path | None = None,
                 readme_text: str | None = None):
        if rules is None:
            from dgraph_tpu_torch.analysis.rules import default_rules
            rules = default_rules()
        self.rules = rules
        self.repo_root = repo_root
        self._readme_text = readme_text
        self.contexts: list[FileContext] = []
        self.findings: list[Finding] = []
        self.facts: dict = {}

    @property
    def readme_text(self) -> str:
        if self._readme_text is None:
            p = ((self.repo_root or pathlib.Path(".")) / "README.md")
            self._readme_text = p.read_text() if p.exists() else ""
        return self._readme_text

    # -- scanning ------------------------------------------------------------
    def add_source(self, rel: str, source: str) -> None:
        ctx = FileContext(rel, source)
        self.contexts.append(ctx)
        for line, (rules, _reason, has_reason) in ctx.waivers.items():
            if not has_reason:
                self.findings.append(Finding(
                    WAIVER_SYNTAX, rel, line,
                    f"waiver for {sorted(rules)} carries no reason "
                    f"string — write `# graftlint: allow(rule): why`"))
        for rule in self.rules:
            if not rule.applies(rel):
                continue
            for f in rule.check_file(ctx):
                reason = ctx.waiver_for(f.rule, f.line)
                if reason is not None:
                    f.waived, f.reason = True, reason
                self.findings.append(f)

    def run(self, paths: list[pathlib.Path],
            repo_root: pathlib.Path | None = None) -> list[Finding]:
        """Scan files/trees under `paths`; then run repo-level
        finalizers and extract facts. Returns ALL findings (filter on
        `.waived` for the failing set)."""
        if repo_root is not None:
            self.repo_root = repo_root
        root = self.repo_root or pathlib.Path(".")
        files: list[pathlib.Path] = []
        for p in paths:
            if p.is_dir():
                files.extend(sorted(p.rglob("*.py")))
            elif p.suffix == ".py":
                files.append(p)
        for f in files:
            if "__pycache__" in f.parts:
                continue
            try:
                rel = f.resolve().relative_to(root.resolve()).as_posix()
            except ValueError:
                # another checkout of the port: name its files from the
                # package down, so the rules' scopes apply to them
                parts = f.resolve().parts
                if PACKAGE in parts:
                    i = len(parts) - 1 - parts[::-1].index(PACKAGE)
                    rel = "/".join(parts[i:])
                else:
                    rel = f.as_posix()
            self.add_source(rel, f.read_text())
        self.finish()
        return self.findings

    def finish(self) -> None:
        """Repo-level passes: rule finalizers + the facts inventory."""
        for rule in self.rules:
            self.findings.extend(rule.finalize(self))
        from dgraph_tpu_torch.analysis.facts import extract_facts
        self.facts = extract_facts(self.contexts)

    # -- reporting -----------------------------------------------------------
    def unwaived(self) -> list[Finding]:
        return [f for f in self.findings if not f.waived]

    def counts(self) -> dict[str, dict[str, int]]:
        """{"findings": {rule: unwaived}, "waived": {rule: waived}}.
        Every active rule is pre-seeded at 0, so a clean rule shows as
        clean instead of missing."""
        out = {"findings": {r.name: 0 for r in self.rules},
               "waived": {r.name: 0 for r in self.rules}}
        for f in self.findings:
            bucket = "waived" if f.waived else "findings"
            out[bucket][f.rule] = out[bucket].get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "findings": [dataclasses.asdict(f) for f in self.findings
                         if not f.waived],
            "waived": [dataclasses.asdict(f) for f in self.findings
                       if f.waived],
            "counts": self.counts(),
            "facts": self.facts,
        }


def default_paths(repo_root: pathlib.Path) -> list[pathlib.Path]:
    """What `python -m dgraph_tpu_torch.analysis` (and the tests) scan:
    the whole port, plus chip_smoke.py for the metric-docs pass."""
    paths = [repo_root / PACKAGE]
    bench = repo_root / BENCH_SCRIPT
    if bench.exists():
        paths.append(bench)
    return paths


def run(repo_root: pathlib.Path | None = None) -> Analyzer:
    """One-call entry: scan the default file set with the default
    rules."""
    if repo_root is None:
        repo_root = pathlib.Path(__file__).resolve().parents[2]
    a = Analyzer(repo_root=repo_root)
    a.run(default_paths(repo_root), repo_root=repo_root)
    return a
