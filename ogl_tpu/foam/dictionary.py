"""OpenFOAM dictionary parser.

The reference's user-facing config IS the fvSolution dictionary
(README.md:70-123); to be drop-in, this module parses OpenFOAM dictionary
syntax into plain Python dicts that feed config.parse_controls:

    solvers
    {
        p
        {
            solver          GKOCG;
            executor        cuda;
            tolerance       1e-06;
            preconditioner  { preconditioner BJ; maxBlockSize 8; }
        }
    }

Supports: // and /* */ comments, nested sub-dicts, `key value;` entries,
`(a b c)` lists, quoted strings, bare multi-token values (kept as a list),
`#include`-free single files.  Numbers parse to int/float, on/off/yes/no/
true/false to bool.
"""

from __future__ import annotations

import re

__all__ = ["parse", "parse_file", "solver_controls"]

_TOKEN = re.compile(
    r"""
    "(?:[^"\\]|\\.)*"          # quoted string
  | /\*.*?\*/                  # block comment
  | //[^\n]*                   # line comment
  | [{}();]                    # structural
  | [^\s{}();]+                # word / number
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokens(text: str):
    for m in _TOKEN.finditer(text):
        t = m.group(0)
        if t.startswith("//") or t.startswith("/*"):
            continue
        yield t


def _convert(tok: str):
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    low = tok.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok


class _Parser:
    def __init__(self, toks):
        self.toks = list(toks)
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self):
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of dictionary")
        self.i += 1
        return t

    def parse_dict(self, top=False) -> dict:
        out: dict = {}
        while True:
            t = self.peek()
            if t is None:
                if top:
                    return out
                raise ValueError("missing closing '}'")
            if t == "}":
                self.next()
                return out
            key = self.next()
            if key.startswith('"') and key.endswith('"'):
                key = key[1:-1]  # quoted (regex) keys, e.g. "(p|pFinal)"
            t = self.peek()
            if t == "{":
                self.next()
                out[key] = self.parse_dict()
            else:
                vals = []
                while True:
                    t = self.peek()
                    if t is None:
                        raise ValueError(f"missing ';' after entry {key!r}")
                    if t == ";":
                        self.next()
                        break
                    if t == "(":
                        self.next()
                        vals.append(self.parse_list())
                    elif t == "{":
                        # rare: `key word { ... }` — treat dict as the value
                        self.next()
                        vals.append(self.parse_dict())
                    else:
                        vals.append(_convert(self.next()))
                if len(vals) == 1:
                    out[key] = vals[0]
                elif len(vals) == 0:
                    out[key] = True  # bare switch
                else:
                    out[key] = vals

    def parse_list(self) -> list:
        out = []
        while True:
            t = self.peek()
            if t is None:
                raise ValueError("missing closing ')'")
            if t == ")":
                self.next()
                return out
            if t == "(":
                self.next()
                out.append(self.parse_list())
            else:
                out.append(_convert(self.next()))


def parse(text: str) -> dict:
    """Parse dictionary text into nested dicts."""
    return _Parser(_tokens(text)).parse_dict(top=True)


def parse_file(path: str) -> dict:
    with open(path) as f:
        return parse(f.read())


def solver_controls(fv_solution: dict, field: str) -> dict:
    """Extract the solver sub-dict for a field from a parsed fvSolution,
    honouring OpenFOAM's `"(p|pFinal)"`-style regex keys."""
    solvers = fv_solution.get("solvers", fv_solution)
    if field in solvers:
        return solvers[field]
    # OpenFOAM searches pattern keys in REVERSE insertion order (the last
    # matching entry wins), so a later `"p.*"` overrides an earlier
    # `"(p|pFinal)"` — mirror that here
    for key, sub in reversed(list(solvers.items())):
        if isinstance(sub, dict):
            try:
                if re.fullmatch(key, field):
                    return sub
            except re.error:
                continue
    raise KeyError(f"no solver entry for field {field!r}")
