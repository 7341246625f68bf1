#!/usr/bin/env python
"""Stdlib static-analysis + style gate (run-checks step).

The reference gate runs gofmt/vet/golint (reference run-checks:41-52);
the image this build runs in has NO third-party linter (no ruff/flake8/
pyflakes — pip installs are disallowed), so this is a self-contained
AST-based equivalent covering the checks that catch real bugs:

  F401  unused import            (textual whole-word usage scan: an
                                  import is flagged only when its bound
                                  name appears nowhere else in the file)
  E722  bare `except:`
  E711  comparison to None/True/False with ==/!=
  F811  redefinition of a function/class in the same scope
        (decorated defs are exempt: @property/@overload pairs)
  W191  tab in indentation
  W291  trailing whitespace
  W605  invalid escape sequence in a str literal (DeprecationWarning
        at compile time, SyntaxError in a future Python)

`# noqa` on the offending line suppresses any finding.  Exit code 1 on
findings, 0 clean.  Usage: python tools/lint.py [paths...]
"""

from __future__ import annotations

import ast
import re
import sys
import warnings
from pathlib import Path

DEFAULT_PATHS = ["snappy_tpu", "tests", "tools", "bench.py", "chip_smoke.py",
                 "__graft_entry__.py"]


def _word_re(name: str) -> re.Pattern:
    return re.compile(r"\b%s\b" % re.escape(name))


def check_file(path: Path) -> list[str]:
    src = path.read_text()
    lines = src.splitlines()
    out: list[str] = []

    def noqa(lineno: int) -> bool:
        return 0 < lineno <= len(lines) and "noqa" in lines[lineno - 1]

    def emit(lineno: int, code: str, msg: str) -> None:
        if not noqa(lineno):
            out.append(f"{path}:{lineno}: {code} {msg}")

    # style: tabs in indentation, trailing whitespace
    for i, ln in enumerate(lines, 1):
        body = ln.lstrip()
        indent = ln[: len(ln) - len(body)]
        if "\t" in indent:
            emit(i, "W191", "tab in indentation")
        if ln != ln.rstrip():
            emit(i, "W291", "trailing whitespace")

    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always", SyntaxWarning)
        try:
            tree = ast.parse(src, filename=str(path))
        except SyntaxError as e:
            return [f"{path}:{e.lineno}: E999 {e.msg}"]
    for w in wlist:
        if "invalid escape sequence" in str(w.message):
            emit(getattr(w, "lineno", 1) or 1, "W605", str(w.message))

    # F401: unused imports (module scope only; __init__.py re-exports
    # are API surface and exempt)
    if path.name != "__init__.py":
        imports: list[tuple[int, str]] = []  # (lineno, bound name)
        for node in tree.body:
            if isinstance(node, ast.Import):
                for a in node.names:
                    imports.append(
                        (node.lineno,
                         a.asname or a.name.split(".")[0]))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue  # compiler directive, never "used"
                for a in node.names:
                    if a.name == "*":
                        continue
                    imports.append((node.lineno, a.asname or a.name))
        for lineno, name in imports:
            pat = _word_re(name)
            uses = sum(
                1 for i, ln in enumerate(lines, 1)
                if i != lineno and pat.search(ln)
            )
            if uses == 0:
                emit(lineno, "F401", f"'{name}' imported but unused")

    class V(ast.NodeVisitor):
        def visit_ExceptHandler(self, node):
            if node.type is None:
                emit(node.lineno, "E722", "bare 'except:'")
            self.generic_visit(node)

        def visit_Compare(self, node):
            for op, right in zip(node.ops, node.comparators):
                if isinstance(op, (ast.Eq, ast.NotEq)) and (
                    isinstance(right, ast.Constant)
                    and (right.value is None or right.value is True
                         or right.value is False)
                ):
                    emit(node.lineno, "E711",
                         "comparison to None/True/False with ==/!= "
                         "(use is / is not)")
            self.generic_visit(node)

        def _scope(self, body, where):
            seen: dict[str, int] = {}
            for st in body:
                if isinstance(st, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef)):
                    if st.decorator_list:
                        continue  # @property/@overload pairs
                    if st.name in seen:
                        emit(st.lineno, "F811",
                             f"redefinition of '{st.name}' "
                             f"(first at line {seen[st.name]}) in {where}")
                    seen[st.name] = st.lineno

        def visit_Module(self, node):
            self._scope(node.body, "module")
            self.generic_visit(node)

        def visit_ClassDef(self, node):
            self._scope(node.body, f"class {node.name}")
            self.generic_visit(node)

    V().visit(tree)
    return out


def main(argv: list[str]) -> int:
    roots = [Path(p) for p in (argv or DEFAULT_PATHS)]
    files: list[Path] = []
    for r in roots:
        if r.is_dir():
            files.extend(sorted(r.rglob("*.py")))
        elif r.suffix == ".py":
            files.append(r)
    findings: list[str] = []
    for f in files:
        findings.extend(check_file(f))
    for line in findings:
        print(line)
    print(f"lint: {len(files)} files, {len(findings)} findings")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
