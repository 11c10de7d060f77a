"""DQL lexer (port of `dgraph_tpu/dql/lexer.py`, unchanged).

Reference parity: `lex/lexer.go` (state-function lexer) + the token set
`gql/state.go` consumes. A single compiled-regex scanner is the Pythonic
equivalent; the state-function machinery exists to avoid allocations in Go
and buys nothing here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<regex>/(?:[^/\\\n]|\\.)+/[a-z]*)
  | (?P<number>0[xX][0-9a-fA-F]+|-?\d+\.\d+(?:[eE][+-]?\d+)?|-?\d+(?:[eE][+-]?\d+)?)
  | (?P<name>[~$]?<[^>]+>|[~$]?[A-Za-z_][\w.]*)
  | (?P<op><=|>=|==|!=|&&|\|\||[{}()\[\]:,@*+\-/%<>=.])
""", re.VERBOSE)


@dataclass
class Token:
    kind: str   # string | regex | number | name | op | eof
    text: str
    pos: int


class LexError(ValueError):
    pass


def tokenize(src: str) -> list[Token]:
    out: list[Token] = []
    i = 0
    n = len(src)
    while i < n:
        m = TOKEN_RE.match(src, i)
        if not m:
            raise LexError(f"unexpected character {src[i]!r} at offset {i}")
        kind = m.lastgroup
        text = m.group()
        if kind not in ("ws", "comment"):
            # `/` is ambiguous (division vs regex); regex only valid after
            # `,` or `(` — the parser's regexp() argument position.
            if kind == "regex" and out and out[-1].text not in (",", "("):
                # re-lex as division operator
                out.append(Token("op", "/", i))
                i += 1
                continue
            out.append(Token(kind, text, i))
        i = m.end()
    out.append(Token("eof", "", n))
    return out
