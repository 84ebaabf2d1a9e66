"""The event-query language: `tm.event = 'Tx' AND tx.height = 5`.

Counterpart: tendermint_tpu/pubsub/query.py:1-172 (reference:
internal/pubsub/query/{query.go,syntax/}): a conjunctive language over
event tags. Conditions: `tag = 'string'`, numeric comparisons
(= < <= > >=), `tag CONTAINS 'sub'`, `tag EXISTS`, joined by AND. Events
are flattened into a tag map `{"type.attr_key": [values...]}`; a
condition matches if ANY value of its tag satisfies it (reference:
internal/pubsub/query/query.go:157-191).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

__all__ = ["Query", "QuerySyntaxError", "compile_query", "query_for_event"]


class QuerySyntaxError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<op><=|>=|=|<|>)
      | (?P<and>\bAND\b)
      | (?P<exists>\bEXISTS\b)
      | (?P<contains>\bCONTAINS\b)
      | (?P<string>'[^']*')
      | (?P<number>-?\d+(?:\.\d+)?)
      | (?P<tag>[A-Za-z_][A-Za-z0-9_.\-]*)
    )""",
    re.VERBOSE,
)

_OP_EQ = "="
_OP_LT = "<"
_OP_LE = "<="
_OP_GT = ">"
_OP_GE = ">="
_OP_CONTAINS = "CONTAINS"
_OP_EXISTS = "EXISTS"


@dataclass(frozen=True)
class _Condition:
    tag: str
    op: str
    arg: Optional[object]  # str for =/CONTAINS on strings, float for numerics

    def matches(self, values: Sequence[str]) -> bool:
        if self.op == _OP_EXISTS:
            return len(values) > 0
        for v in values:
            if self.op == _OP_CONTAINS:
                if str(self.arg) in v:
                    return True
            elif self.op == _OP_EQ and isinstance(self.arg, str):
                if v == self.arg:
                    return True
            else:  # numeric comparison
                try:
                    x = float(v)
                except ValueError:
                    continue
                t = float(self.arg)  # type: ignore[arg-type]
                if (
                    (self.op == _OP_EQ and x == t)
                    or (self.op == _OP_LT and x < t)
                    or (self.op == _OP_LE and x <= t)
                    or (self.op == _OP_GT and x > t)
                    or (self.op == _OP_GE and x >= t)
                ):
                    return True
        return False


class Query:
    """A compiled conjunctive query over event tags."""

    def __init__(self, source: str, conditions: List[_Condition]) -> None:
        self._source = source
        self._conditions = conditions

    def __str__(self) -> str:
        return self._source

    def __repr__(self) -> str:
        return f"Query({self._source!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and self._source == other._source

    def __hash__(self) -> int:
        return hash(self._source)

    def matches(self, tags: Dict[str, List[str]]) -> bool:
        return all(c.matches(tags.get(c.tag, ())) for c in self._conditions)


def _tokenize(s: str):
    pos = 0
    out = []
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip():
                raise QuerySyntaxError(f"unexpected input at: {s[pos:]!r}")
            break
        pos = m.end()
        kind = m.lastgroup
        out.append((kind, m.group(kind)))
    return out


def compile_query(source: str) -> Query:
    tokens = _tokenize(source)
    if not tokens:
        raise QuerySyntaxError("empty query")
    conditions: List[_Condition] = []
    i = 0
    while i < len(tokens):
        kind, val = tokens[i]
        if kind != "tag":
            raise QuerySyntaxError(f"expected tag, got {val!r}")
        tag = val
        i += 1
        if i >= len(tokens):
            raise QuerySyntaxError(f"dangling tag {tag!r}")
        kind, val = tokens[i]
        if kind == "exists":
            conditions.append(_Condition(tag, _OP_EXISTS, None))
            i += 1
        elif kind == "contains":
            i += 1
            if i >= len(tokens) or tokens[i][0] != "string":
                raise QuerySyntaxError("CONTAINS needs a string operand")
            conditions.append(_Condition(tag, _OP_CONTAINS, tokens[i][1][1:-1]))
            i += 1
        elif kind == "op":
            op = val
            i += 1
            if i >= len(tokens):
                raise QuerySyntaxError(f"operator {op!r} needs an operand")
            okind, oval = tokens[i]
            if okind == "string":
                if op != _OP_EQ:
                    raise QuerySyntaxError(
                        f"operator {op!r} not valid for strings"
                    )
                conditions.append(_Condition(tag, _OP_EQ, oval[1:-1]))
            elif okind == "number":
                conditions.append(_Condition(tag, op, float(oval)))
            else:
                raise QuerySyntaxError(f"bad operand {oval!r}")
            i += 1
        else:
            raise QuerySyntaxError(f"expected operator after {tag!r}, got {val!r}")
        if i < len(tokens):
            kind, val = tokens[i]
            if kind != "and":
                raise QuerySyntaxError(f"expected AND, got {val!r}")
            i += 1
            if i >= len(tokens):
                raise QuerySyntaxError("dangling AND")
    return Query(source, conditions)


def query_for_event(event_value: str) -> Query:
    """reference: types/events.go QueryForEvent."""
    return compile_query(f"tm.event = '{event_value}'")
