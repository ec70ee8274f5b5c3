"""Source-tree lint passes (counterpart of ``repro/analysis/lint.py``).

- **LN001** — bare ``assert`` in ``src/``. Library code runs under
  ``python -O`` with every assert compiled out, so a tiling or shape
  assert is a check that silently disappears exactly when someone turns
  on optimizations for a big run. Kernel preconditions must raise
  ``ValueError`` with shape context instead.

AST-based, not regex: comments and docstrings mentioning ``assert`` do
not count, only real ``Assert`` nodes.
"""

from __future__ import annotations

import ast
import pathlib

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AnalysisContext, register_pass


def default_src_root() -> pathlib.Path:
    """The ``src/repro_torch`` tree this very module was imported from."""
    return pathlib.Path(__file__).resolve().parent.parent


def iter_bare_asserts(src_root) -> list:
    """(relative path, line, source text) of every assert under src_root."""
    root = pathlib.Path(src_root)
    out = []
    for path in sorted(root.rglob("*.py")):
        text = path.read_text()
        try:
            tree = ast.parse(text, filename=str(path))
        except SyntaxError as exc:
            raise ValueError(f"{path}: not parseable: {exc}") from exc
        lines = text.splitlines()
        for node in ast.walk(tree):
            if isinstance(node, ast.Assert):
                src = lines[node.lineno - 1].strip() \
                    if node.lineno <= len(lines) else ""
                rel = path.relative_to(root.parent).as_posix()
                out.append((rel, node.lineno, src))
    return out


@register_pass("lint-asserts", "lint", ("LN001",),
               doc="no bare assert statements in library code (they "
                   "vanish under python -O)")
def asserts_pass(ctx: AnalysisContext) -> list:
    src_root = ctx.src_root or default_src_root()
    findings = []
    for rel, lineno, src in iter_bare_asserts(src_root):
        findings.append(Finding(
            rule="LN001", severity="warning", target=f"lint:{rel}",
            location=f"L{lineno}",
            message=f"bare assert in library code: `{src}` is compiled "
                    f"out under python -O",
            fix_hint="raise ValueError (with the offending shapes/values "
                     "in the message) instead"))
    return findings
