"""The integer constants of the port's CUDA sources, as the sources state
them, for the tests that mirror a kernel's layout on the CPU.

`constexpr int NAME = <expression>;` is evaluated in Python, the names it
uses resolved the same way (C's `/` as `//`, `a ? b : c` as a conditional),
and a `NERO_*` macro takes the value its `#ifndef` default gives unless
`defines` gives another: the value a build with those `-D` flags has. The
module is imported by its own name (not through `tests.`), as the other
helpers of the port's tests.
"""
from __future__ import annotations

import os
import re

from nero_tpu_torch.ops import cuda_build


def _python(expr: str) -> str:
    expr = re.sub(r"\(size_t\)", "", expr).replace("/", "//")
    m = re.fullmatch(r"(.+?)\?(.+?):(.+)", expr)
    if m:
        return f"(({_python(m.group(2))}) if ({m.group(1)}) else ({_python(m.group(3))}))"
    return expr


def _split(body: str) -> list:
    """`A = x, B = y` at the commas outside parentheses."""
    parts, depth, cur = [], 0, ""
    for ch in body:
        depth += (ch == "(") - (ch == ")")
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


class _Names(dict):
    def __init__(self, text: str, defines: dict):
        super().__init__(defines)
        self.exprs = {}
        for body in re.findall(r"constexpr (?:int|size_t) ([^;(]+=[^;]+);", text):
            for part in _split(body):
                name, expr = (x.strip() for x in part.split("=", 1))
                self.exprs.setdefault(name, expr)
        self.macros = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)", text)}

    def __missing__(self, name):
        if name in self.macros:
            value = self.macros[name]
        elif name in self.exprs:
            value = int(eval(_python(self.exprs[name]), {}, self))
        else:
            raise KeyError(name)
        self[name] = value
        return value


def source_constants(files, names, defines=None) -> dict:
    """{name: value} of csrc/<file>'s constants (the files read in order,
    as one text; the first statement of a name counts), at the build with
    `defines` ({macro: value}; the sources' defaults otherwise)."""
    text = ""
    for fn in files:
        with open(os.path.join(cuda_build.CSRC, fn)) as f:
            text += f.read()
    env = _Names(text, dict(defines or {}))
    return {name: env[name] for name in names}
