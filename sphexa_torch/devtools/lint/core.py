"""Analyzer scaffolding of torchlint (the JAX package's
devtools/lint/core.py): the parsed module, the rule registry and the
suppressions.

- One ``ModuleInfo`` per file: source, AST, import-alias map, dotted
  module name and the suppression table of its comments. Rules are
  stateless checks of a ``ModuleInfo`` that return ``Finding``s; the
  analyzer applies the suppressions and the rule selection.
- Alias resolution is syntactic: ``import torch.distributed as dist``
  makes ``dist.all_reduce`` resolve to ``torch.distributed.all_reduce``,
  so rules match canonical dotted paths whatever the import style. No
  code is imported.
"""

import ast
import dataclasses
from pathlib import Path, PurePosixPath
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from sphexa_torch.devtools.common import (
    Finding,
    SuppressionTable,
    make_disable_re,
)
from sphexa_torch.devtools.common import parse_suppressions as _parse_suppressions

__all__ = ["Finding", "ModuleInfo", "Rule", "register", "all_rules", "Analyzer",
           "lint_paths", "parse_suppressions", "TOOL"]

#: the directive's tool name: ``# torchlint: disable=JXL002 -- reason``
TOOL = "torchlint"
_DISABLE_RE = make_disable_re(TOOL)

#: the package root a module's dotted name starts from
PACKAGE_ROOTS = ("sphexa_torch",)


def parse_suppressions(source: str) -> SuppressionTable:
    return _parse_suppressions(source, _DISABLE_RE)


def module_name(path: str) -> str:
    """Dotted module name of ``path`` from its last package root
    (``.../sphexa_torch/parallel/mesh.py`` -> ``sphexa_torch.parallel.mesh``);
    the file's stem when no root is on the path."""
    parts = list(PurePosixPath(path).with_suffix("").parts)
    start = max((i for i, p in enumerate(parts) if p in PACKAGE_ROOTS), default=len(parts) - 1)
    names = parts[start:]
    if len(names) > 1 and names[-1] == "__init__":
        names = names[:-1]
    return ".".join(names)


class ModuleInfo:
    """A parsed source file plus the lookups every rule needs."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.source = source
        self.tree = tree
        self.lines = source.splitlines()
        self.name = module_name(path)
        self.suppressions = parse_suppressions(source)
        self.aliases = self._collect_aliases(tree)

    @classmethod
    def from_file(cls, path: str) -> "ModuleInfo":
        source = Path(path).read_text()
        return cls(Path(path).as_posix(), source, ast.parse(source, filename=path))

    @staticmethod
    def _collect_aliases(tree: ast.Module) -> Dict[str, str]:
        """Local names to canonical dotted paths, from every import of the
        file at any depth (the package imports inside functions)."""
        aliases: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0])
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for a in node.names:
                    aliases[a.asname or a.name] = f"{node.module}.{a.name}"
        return aliases

    def qualname(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, its root
        resolved through the import aliases; None for any other
        expression in the chain."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(self.aliases.get(node.id, node.id))
        return ".".join(reversed(parts))

    def line_at(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule, path=self.path, line=line,
                       col=getattr(node, "col_offset", 0), message=message,
                       snippet=self.line_at(line))


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    description: str
    check: Callable[[ModuleInfo], List[Finding]]


_REGISTRY: Dict[str, Rule] = {}


def register(id: str, name: str, description: str):
    """Decorator: register ``check(module) -> [Finding]`` under a rule id."""

    def deco(fn: Callable[[ModuleInfo], List[Finding]]):
        if id in _REGISTRY:
            raise ValueError(f"duplicate rule id {id}")
        _REGISTRY[id] = Rule(id=id, name=name, description=description, check=fn)
        return fn

    return deco


def all_rules() -> Dict[str, Rule]:
    import sphexa_torch.devtools.lint.rules  # noqa: F401 - the rules register

    return dict(_REGISTRY)


class Analyzer:
    """The selected rules over modules: (active, suppressed) findings, and
    as errors (rule ``JXL000``) the files that do not parse and the
    suppression directives that give no reason."""

    def __init__(self, select: Optional[Sequence[str]] = None):
        rules = all_rules()
        if select:
            unknown = set(select) - set(rules)
            if unknown:
                raise ValueError(f"unknown rule id(s): {sorted(unknown)}")
            rules = {k: v for k, v in rules.items() if k in select}
        self.rules = rules

    def run_module(self, module: ModuleInfo) -> Tuple[List[Finding], List[Finding]]:
        """(active, suppressed) findings of one parsed module."""
        active: List[Finding] = []
        suppressed: List[Finding] = []
        for rule in self.rules.values():
            for f in rule.check(module):
                (suppressed if module.suppressions.is_suppressed(f.rule, f.line)
                 else active).append(f)
        key = lambda f: (f.path, f.line, f.col, f.rule)  # noqa: E731
        return sorted(active, key=key), sorted(suppressed, key=key)

    @staticmethod
    def directive_errors(module: ModuleInfo) -> List[Finding]:
        """A ``JXL000`` error for each directive with no reason."""
        return [Finding(rule="JXL000", path=module.path, line=line, col=0,
                        message=f"{TOOL} directive without a reason (add `-- <why>`)",
                        snippet=module.line_at(line))
                for line in module.suppressions.unreasoned()]

    def run_paths(self, paths: Iterable[str]
                  ) -> Tuple[List[Finding], List[Finding], List[Finding]]:
        """(active, suppressed, errors) over files and directory trees."""
        active: List[Finding] = []
        suppressed: List[Finding] = []
        errors: List[Finding] = []
        for path in sorted(self._expand(paths)):
            try:
                module = ModuleInfo.from_file(path)
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                errors.append(Finding(
                    rule="JXL000", path=Path(path).as_posix(),
                    line=getattr(e, "lineno", None) or 1, col=0,
                    message=f"could not parse: {e.__class__.__name__}: {e}"))
                continue
            a, s = self.run_module(module)
            active += a
            suppressed += s
            errors += self.directive_errors(module)
        return active, suppressed, errors

    @staticmethod
    def _expand(paths: Iterable[str]) -> List[str]:
        out: List[str] = []
        for p in paths:
            pp = Path(p)
            if pp.is_dir():
                out += [str(f) for f in pp.rglob("*.py") if "__pycache__" not in f.parts]
            else:
                out.append(str(pp))
        return out


def lint_paths(paths: Iterable[str], select: Optional[Sequence[str]] = None):
    """(active, suppressed, errors) in one call."""
    return Analyzer(select=select).run_paths(paths)
