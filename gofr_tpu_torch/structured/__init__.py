"""Structured (grammar-constrained) decoding: JSON schema -> token DFA
(counterpart of gofr_tpu/structured/__init__.py, copied: host-only numpy
code, kept line for line so tables, keys and error messages match).

A constrained generation must be valid under its grammar BY CONSTRUCTION:
instead of sampling freely and validating after the fact (reject/retry
burns decode throughput and still fails at max_new_tokens), the grammar
is compiled ON THE HOST into a token-level DFA and shipped to the device
as a dense transition table. Every sampling site in the engine's
programs (decode chunks, unified steps, speculative verify; the ``...g``
program families of ``gofr_tpu_torch.llm``) then masks the logits of a
constrained slot to the tokens its current DFA state admits and advances
the state with the token actually sampled — so constrained and
unconstrained requests mix in ONE device program, and the output parses
under the schema no matter what the weights say.

The pipeline, all host-side and model-free:

1. **schema -> byte regex** (`_schema_ast`): a supported JSON-schema
   subset (object/array/string/number/integer/boolean/null/enum/const/
   anyOf, bounded repetition, fixed required-property order) lowers to a
   small regex AST over BYTES. Optional JSON whitespace is admitted at
   the structural positions. A second front-end (`_RegexParser` /
   `compile_regex`, the OpenAI edge's ``response_format={"type":
   "regex"}``) lowers a DFA-safe regex pattern STRING to the same AST —
   both ride one NFA/DFA/token-table pipeline.
2. **regex -> DFA** (`_RegexCompiler`): Thompson NFA -> subset
   construction -> prune states that cannot reach an accepting state.
3. **byte DFA -> token DFA** (`compile_token_table`): for each DFA state
   and vocabulary token, walk the token's bytes; the result is a dense
   ``int32 [n_states, vocab]`` table where entry ``< 0`` means "token not
   admitted here". Accepting byte-states admit the EOS token into a
   terminal DONE state, so a completed value can only end the stream.
   A final fixpoint prunes token-states from which no token path reaches
   DONE (the vocabulary may be unable to realize a byte path), so every
   live state always admits at least one token — the device mask can
   never go empty.

The engine guarantees (tests/test_torch_structured.py): greedy
constrained output parses and validates; constrained spec-on is
token-identical to constrained spec-off; the drafter's proposals are
pre-filtered by the same DFA (`TokenGrammar.filter_draft`).

Knobs: ``TPU_LLM_CONSTRAINED`` (engine support, on by default),
``TPU_LLM_CONSTRAINED_MAX_STATES`` (compile-time state bound),
``TPU_LLM_CONSTRAINED_GRAMMARS`` (resident grammar table slots).
"""

from __future__ import annotations

import hashlib
import json
import threading
from dataclasses import dataclass, field
from typing import Any, Iterable

import numpy as np

__all__ = [
    "JsonSchemaError",
    "RegexError",
    "TokenGrammar",
    "compile_json_schema",
    "compile_regex",
    "vocab_from_tokenizer",
    "grammar_cache",
]

DONE = -2  # token-table terminal marker (EOS consumed; nothing follows)
_WS = b" \t\n\r"


class JsonSchemaError(ValueError):
    """Unsupported/malformed schema, or a vocabulary that cannot realize
    it. Carries status_code so the serving edges surface it as a 400 —
    a client bug, never a server error."""

    status_code = 400


class RegexError(JsonSchemaError):
    """Malformed/unsupported regex pattern. Subclasses JsonSchemaError so
    every existing edge catch (grammar compile -> 400) covers the regex
    front-end too."""


# ---------------------------------------------------------------------------
# regex AST over bytes
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class _Lit:
    data: bytes


@dataclass(frozen=True)
class _Class:
    allowed: frozenset  # of int bytes


@dataclass(frozen=True)
class _Seq:
    parts: tuple


@dataclass(frozen=True)
class _Alt:
    options: tuple


@dataclass(frozen=True)
class _Rep:
    node: Any
    lo: int
    hi: int | None  # None = unbounded


_EPS = _Seq(())


def _seq(*parts) -> Any:
    flat = [p for p in parts if not (isinstance(p, _Seq) and not p.parts)]
    return flat[0] if len(flat) == 1 else _Seq(tuple(flat))


def _alt(*options) -> Any:
    return options[0] if len(options) == 1 else _Alt(tuple(options))


def _cls(byte_values: Iterable[int]) -> _Class:
    return _Class(frozenset(byte_values))


# ---------------------------------------------------------------------------
# schema -> regex AST
# ---------------------------------------------------------------------------

# printable ASCII string content, minus the quote and backslash that end
# or escape it. Multi-byte UTF-8 is deliberately not generated: the
# grammar guarantees the OUTPUT is valid JSON text, and ASCII keeps the
# byte DFA small and the guarantee tokenizer-independent.
_STR_CHARS = frozenset(range(0x20, 0x7F)) - {0x22, 0x5C}
_DIGITS = frozenset(range(0x30, 0x3A))
_DIGITS19 = frozenset(range(0x31, 0x3A))
_MAX_DEPTH = 12


_WS_MAX = 2  # longest admitted whitespace run at a structural position


def _ws(opt: bool) -> Any:
    # BOUNDED optional whitespace: an unbounded ws* self-loop hands a
    # greedy model an attractor (space is a high-probability token) it
    # can spin in until max_new_tokens — the bound forces a structural
    # token after at most _WS_MAX blanks, so constrained decoding always
    # makes grammatical progress
    return _Rep(_cls(_WS), 0, _WS_MAX) if opt else _EPS


def _string_ast(schema: dict) -> Any:
    max_len = schema.get("maxLength")
    min_len = int(schema.get("minLength", 0) or 0)
    char = _alt(
        _cls(_STR_CHARS),
        _seq(_Lit(b"\\"), _cls(frozenset(b'"\\/bfnrt'))),
    )
    hi = int(max_len) if max_len is not None else None
    if hi is not None and hi < min_len:
        raise JsonSchemaError(
            f"maxLength {hi} < minLength {min_len}"
        )
    return _seq(_Lit(b'"'), _Rep(char, min_len, hi), _Lit(b'"'))


def _number_ast(integer: bool) -> Any:
    # bounded digit runs keep the DFA small AND bound how long a greedy
    # model can ride the digit attractor before the grammar forces a
    # close (1e9 magnitudes + 6 fraction digits + 2-digit exponents
    # cover realistic payloads; the bound is a compile artifact, not a
    # validation rule)
    int_part = _alt(
        _Lit(b"0"),
        _seq(_cls(_DIGITS19), _Rep(_cls(_DIGITS), 0, 9)),
    )
    head = _seq(_Rep(_Lit(b"-"), 0, 1), int_part)
    if integer:
        return head
    frac = _Rep(_seq(_Lit(b"."), _Rep(_cls(_DIGITS), 1, 6)), 0, 1)
    exp = _Rep(
        _seq(
            _cls(frozenset(b"eE")),
            _Rep(_cls(frozenset(b"+-")), 0, 1),
            _Rep(_cls(_DIGITS), 1, 2),
        ),
        0, 1,
    )
    return _seq(head, frac, exp)


def _json_literal(value: Any) -> _Lit:
    return _Lit(json.dumps(value, separators=(",", ":")).encode())


def _schema_ast(schema: Any, ws: bool, depth: int = 0) -> Any:
    """Lower one (sub)schema to a byte-regex AST. Raises JsonSchemaError
    on anything outside the supported subset — a silent fallback would
    emit output the caller's validator then rejects, which is exactly
    the failure mode constrained decoding exists to remove."""
    if depth > _MAX_DEPTH:
        raise JsonSchemaError(f"schema nesting exceeds {_MAX_DEPTH}")
    if not isinstance(schema, dict):
        raise JsonSchemaError(f"schema must be an object, got {type(schema).__name__}")
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise JsonSchemaError("enum must be a non-empty list")
        return _alt(*[_json_literal(v) for v in vals])
    if "const" in schema:
        return _json_literal(schema["const"])
    if "anyOf" in schema:
        opts = schema["anyOf"]
        if not isinstance(opts, list) or not opts:
            raise JsonSchemaError("anyOf must be a non-empty list")
        return _alt(*[_schema_ast(s, ws, depth + 1) for s in opts])
    t = schema.get("type")
    if isinstance(t, list):
        if not t:
            raise JsonSchemaError("empty type list")
        return _alt(*[
            _schema_ast({**schema, "type": one}, ws, depth + 1) for one in t
        ])
    if t == "string":
        return _string_ast(schema)
    if t == "integer":
        return _number_ast(integer=True)
    if t == "number":
        return _number_ast(integer=False)
    if t == "boolean":
        return _alt(_Lit(b"true"), _Lit(b"false"))
    if t == "null":
        return _Lit(b"null")
    if t == "array":
        item = _schema_ast(schema.get("items", {"type": "string"}), ws, depth + 1)
        lo = int(schema.get("minItems", 0) or 0)
        hi = schema.get("maxItems")
        hi = int(hi) if hi is not None else None
        if hi is not None and hi < lo:
            raise JsonSchemaError(f"maxItems {hi} < minItems {lo}")
        sep_item = _seq(_ws(ws), _Lit(b","), _ws(ws), item)
        if hi == 0:
            body = _EPS
        else:
            rest = _Rep(
                sep_item, max(0, lo - 1), None if hi is None else hi - 1
            )
            some = _seq(item, rest)
            body = some if lo > 0 else _Rep(some, 0, 1)
        return _seq(_Lit(b"["), _ws(ws), body, _ws(ws), _Lit(b"]"))
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise JsonSchemaError("properties must be an object")
        required = schema.get("required")
        if required is None:
            required = list(props)
        for name in required:
            if name not in props:
                raise JsonSchemaError(f"required property {name!r} not in properties")
        # fixed emission order = the properties' declared order,
        # filtered to the required set: every emitted object is valid
        # under the schema (required present, no additionals) and the
        # DFA stays linear in the property count instead of exploding
        # over orderings
        emit = [n for n in props if n in set(required)]
        parts: list[Any] = [_Lit(b"{"), _ws(ws)]
        for i, name in enumerate(emit):
            if i:
                parts += [_ws(ws), _Lit(b","), _ws(ws)]
            parts += [
                _json_literal(name), _ws(ws), _Lit(b":"), _ws(ws),
                _schema_ast(props[name], ws, depth + 1),
            ]
        parts += [_ws(ws), _Lit(b"}")]
        return _seq(*parts)
    if t is None:
        # no type, no enum/const/anyOf: any JSON *scalar* (a fully
        # recursive "any value" grammar needs a PDA, not a DFA)
        return _alt(
            _string_ast({}),
            _number_ast(integer=False),
            _Lit(b"true"), _Lit(b"false"), _Lit(b"null"),
        )
    raise JsonSchemaError(f"unsupported schema type {t!r}")


# ---------------------------------------------------------------------------
# regex pattern string -> regex AST
# ---------------------------------------------------------------------------

# `.` and negated classes range over printable ASCII: the same closed
# byte domain the schema front-end emits (_STR_CHARS rationale) — a DFA
# over "any byte" would admit output the tokenizer cannot round-trip
_ANY_CHARS = frozenset(range(0x20, 0x7F))
_REP_MAX = 4096  # {m,n} bound — a typo like {1,999999} must not explode the NFA

_ESC_CLASSES = {
    "d": _DIGITS,
    "D": _ANY_CHARS - _DIGITS,
    "w": frozenset(b"abcdefghijklmnopqrstuvwxyz"
                   b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"),
    "s": frozenset(b" \t\n\r\f\v"),
}
_ESC_CLASSES["W"] = _ANY_CHARS - _ESC_CLASSES["w"]
_ESC_CLASSES["S"] = _ANY_CHARS - _ESC_CLASSES["s"]
_ESC_LITERALS = {"n": 0x0A, "t": 0x09, "r": 0x0D, "f": 0x0C, "v": 0x0B,
                 "0": 0x00}


class _RegexParser:
    """Recursive-descent parser for the DFA-safe regex subset, lowering a
    pattern string to the SAME byte-level AST the JSON-schema front-end
    emits — so ``response_format={"type": "regex"}`` rides the existing
    NFA/DFA/token-table pipeline unchanged.

    Supported: literals, escapes (``\\d \\D \\w \\W \\s \\S \\n \\t`` +
    escaped metachars), ``.``, character classes ``[a-z]``/``[^...]``,
    grouping ``(...)`` / ``(?:...)``, alternation ``|``, quantifiers
    ``* + ? {m} {m,} {m,n}``, optional anchors ``^``/``$`` (whole-string
    match is implicit — the token DFA only ends a stream at EOS in an
    accepting state). NOT supported (would need more than a DFA, or make
    masks ambiguous): backreferences, lookaround, lazy quantifiers,
    named groups, unicode classes."""

    def __init__(self, pattern: str):
        try:
            self.data = pattern.encode("ascii")
        except UnicodeEncodeError as e:
            raise RegexError(
                "regex patterns are byte-level: non-ASCII literals are "
                "not supported"
            ) from e
        self.pos = 0

    def _peek(self) -> str:
        return chr(self.data[self.pos]) if self.pos < len(self.data) else ""

    def _next(self) -> str:
        ch = self._peek()
        self.pos += 1
        return ch

    def parse(self) -> Any:
        if self._peek() == "^":
            self.pos += 1  # whole-string match is implicit
        node = self._alternation()
        if self.pos < len(self.data):
            raise RegexError(
                f"unexpected {self._peek()!r} at position {self.pos}"
            )
        return node

    def _alternation(self) -> Any:
        opts = [self._sequence()]
        while self._peek() == "|":
            self.pos += 1
            opts.append(self._sequence())
        return _alt(*opts)

    def _sequence(self) -> Any:
        parts: list[Any] = []
        while True:
            ch = self._peek()
            if ch in ("", "|", ")"):
                break
            if ch == "$":
                # accept a trailing anchor; anywhere else it's an error
                # surfaced by parse()'s trailing-input check
                if self.pos == len(self.data) - 1:
                    self.pos += 1
                    break
                raise RegexError("'$' is only supported at the pattern end")
            parts.append(self._quantified())
        return _seq(*parts) if parts else _EPS

    def _quantified(self) -> Any:
        node = self._atom()
        ch = self._peek()
        if ch == "*":
            self.pos += 1
            node = _Rep(node, 0, None)
        elif ch == "+":
            self.pos += 1
            node = _Rep(node, 1, None)
        elif ch == "?":
            self.pos += 1
            node = _Rep(node, 0, 1)
        elif ch == "{":
            node = _Rep(node, *self._braces())
        if self._peek() in ("*", "+", "?"):
            raise RegexError(
                f"lazy/stacked quantifiers unsupported at position {self.pos}"
            )
        return node

    def _braces(self) -> tuple[int, int | None]:
        start = self.pos
        self.pos += 1  # consume '{'
        body = ""
        while self._peek() not in ("}", ""):
            body += self._next()
        if self._next() != "}":
            raise RegexError(f"unterminated {{...}} at position {start}")
        try:
            if "," not in body:
                lo = hi = int(body)
            else:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s) if lo_s else 0
                hi = int(hi_s) if hi_s.strip() else None
        except ValueError as e:
            raise RegexError(f"malformed repetition {{{body}}}") from e
        if lo < 0 or (hi is not None and (hi < lo or hi > _REP_MAX)) or lo > _REP_MAX:
            raise RegexError(f"repetition {{{body}}} out of range (max {_REP_MAX})")
        return lo, hi

    def _atom(self) -> Any:
        ch = self._next()
        if ch == "":
            raise RegexError("unexpected end of pattern")
        if ch == "(":
            if self._peek() == "?":
                self.pos += 1
                if self._next() != ":":
                    raise RegexError(
                        "only non-capturing (?:...) groups are supported "
                        "(no lookaround/named groups)"
                    )
            node = self._alternation()
            if self._next() != ")":
                raise RegexError("unbalanced '('")
            return node
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return _cls(_ANY_CHARS)
        if ch == "\\":
            return self._escape(in_class=False)
        if ch in "*+?{":
            raise RegexError(f"quantifier {ch!r} with nothing to repeat")
        if ch in ")]}":
            raise RegexError(f"unbalanced {ch!r}")
        return _Lit(ch.encode())

    def _escape(self, *, in_class: bool) -> Any:
        ch = self._next()
        if ch == "":
            raise RegexError("dangling backslash")
        if ch in _ESC_CLASSES:
            allowed = _ESC_CLASSES[ch]
            return frozenset(allowed) if in_class else _cls(allowed)
        if ch in _ESC_LITERALS:
            b = _ESC_LITERALS[ch]
        elif ch == "x":
            hexs = "".join(self._next() for _ in range(2))
            try:
                b = int(hexs, 16)
            except ValueError as e:
                raise RegexError(f"malformed \\x escape \\x{hexs}") from e
        elif not ch.isalnum():
            b = ord(ch)  # escaped metachar: \. \\ \[ \+ ...
        else:
            raise RegexError(f"unsupported escape \\{ch}")
        return frozenset([b]) if in_class else _Lit(bytes([b]))

    def _char_class(self) -> _Class:
        start = self.pos
        negate = self._peek() == "^"
        if negate:
            self.pos += 1
        allowed: set[int] = set()
        first = True
        while True:
            ch = self._next()
            if ch == "":
                raise RegexError(f"unterminated [...] at position {start}")
            if ch == "]" and not first:
                break
            first = False
            if ch == "\\":
                got = self._escape(in_class=True)
                allowed |= got
                continue
            lo = ord(ch)
            if self._peek() == "-" and self.pos + 1 < len(self.data) and \
                    chr(self.data[self.pos + 1]) != "]":
                self.pos += 1  # consume '-'
                hi_ch = self._next()
                if hi_ch == "\\":
                    got = self._escape(in_class=True)
                    if len(got) != 1:
                        raise RegexError("class range endpoint must be one char")
                    hi = next(iter(got))
                else:
                    hi = ord(hi_ch)
                if hi < lo:
                    raise RegexError(
                        f"reversed class range at position {self.pos}"
                    )
                allowed |= set(range(lo, hi + 1))
            else:
                allowed.add(lo)
        if negate:
            allowed = set(_ANY_CHARS) - allowed
        if not allowed:
            raise RegexError("character class admits nothing")
        return _cls(allowed)


def compile_regex(
    pattern: str,
    vocab: list[bytes | str],
    eos_id: int,
    *,
    max_states: int | None = None,
) -> TokenGrammar:
    """Compile a regex pattern string into a TokenGrammar for one
    vocabulary — the ``response_format={"type": "regex"}`` front-end.
    The pattern is a WHOLE-string match (anchors optional): the token
    DFA admits EOS only in accepting states, so the stream can only end
    on a complete match."""
    import os

    if not isinstance(pattern, str) or not pattern:
        raise RegexError("pattern must be a non-empty string")
    if max_states is None:
        max_states = int(
            os.environ.get("TPU_LLM_CONSTRAINED_MAX_STATES", "4096") or 4096
        )
    norm = [v.encode() if isinstance(v, str) else bytes(v) for v in vocab]
    ast = _RegexParser(pattern).parse()
    dfa, accepting = _RegexCompiler().compile(ast, max_states)
    table = compile_token_table(dfa, accepting, norm, eos_id)
    key = hashlib.sha256(
        b"re|" + pattern.encode() + b"|" + _vocab_key(norm).encode()
        + b"|" + str(eos_id).encode()
    ).hexdigest()
    return TokenGrammar(
        table, eos_id=eos_id, key=key, accepting_start=0 in accepting
    )


# ---------------------------------------------------------------------------
# regex -> byte DFA (Thompson NFA + subset construction + pruning)
# ---------------------------------------------------------------------------

class _RegexCompiler:
    def __init__(self) -> None:
        self.eps: list[list[int]] = []  # state -> eps successors
        self.trans: list[dict[int, int]] = []  # state -> {byte: succ}

    def _new(self) -> int:
        self.eps.append([])
        self.trans.append({})
        return len(self.eps) - 1

    def _build(self, node: Any) -> tuple[int, int]:
        """Thompson construction: returns (entry, exit) NFA states."""
        if isinstance(node, _Lit):
            entry = cur = self._new()
            for b in node.data:
                nxt = self._new()
                self.trans[cur][b] = nxt
                cur = nxt
            return entry, cur
        if isinstance(node, _Class):
            if not node.allowed:
                raise JsonSchemaError("empty character class")
            entry, exit_ = self._new(), self._new()
            for b in node.allowed:
                # one shared exit; per-byte transitions on the entry
                self.trans[entry][b] = exit_
            return entry, exit_
        if isinstance(node, _Seq):
            entry = cur = self._new()
            for part in node.parts:
                s, e = self._build(part)
                self.eps[cur].append(s)
                cur = e
            return entry, cur
        if isinstance(node, _Alt):
            entry, exit_ = self._new(), self._new()
            for opt in node.options:
                s, e = self._build(opt)
                self.eps[entry].append(s)
                self.eps[e].append(exit_)
            return entry, exit_
        if isinstance(node, _Rep):
            entry = cur = self._new()
            for _ in range(node.lo):
                s, e = self._build(node.node)
                self.eps[cur].append(s)
                cur = e
            if node.hi is None:
                s, e = self._build(node.node)
                loop = self._new()
                self.eps[cur].append(loop)
                self.eps[loop].append(s)
                self.eps[e].append(loop)
                return entry, loop
            exit_ = self._new()
            self.eps[cur].append(exit_)
            for _ in range(node.hi - node.lo):
                s, e = self._build(node.node)
                self.eps[cur].append(s)
                cur = e
                self.eps[cur].append(exit_)
            return entry, exit_
        raise JsonSchemaError(f"unknown regex node {node!r}")

    def compile(self, node: Any, max_states: int) -> tuple[list[dict[int, int]], set[int]]:
        """Byte-level DFA: (transitions per state, accepting set). State 0
        is the start; only productive states (an accepting state is
        byte-reachable) are kept."""
        start, accept = self._build(node)

        def closure(states: frozenset) -> frozenset:
            seen = set(states)
            stack = list(states)
            while stack:
                for e in self.eps[stack.pop()]:
                    if e not in seen:
                        seen.add(e)
                        stack.append(e)
            return frozenset(seen)

        start_c = closure(frozenset([start]))
        ids: dict[frozenset, int] = {start_c: 0}
        table: list[dict[int, int]] = [{}]
        accepting: set[int] = set()
        if accept in start_c:
            accepting.add(0)
        work = [start_c]
        while work:
            cur = work.pop()
            cid = ids[cur]
            by_byte: dict[int, set[int]] = {}
            for s in cur:
                for b, nxt in self.trans[s].items():
                    by_byte.setdefault(b, set()).add(nxt)
            for b, nxts in by_byte.items():
                nc = closure(frozenset(nxts))
                if nc not in ids:
                    if len(ids) >= max_states:
                        raise JsonSchemaError(
                            f"grammar exceeds {max_states} DFA states "
                            "(raise TPU_LLM_CONSTRAINED_MAX_STATES or "
                            "simplify the schema)"
                        )
                    ids[nc] = len(ids)
                    table.append({})
                    if accept in nc:
                        accepting.add(ids[nc])
                    work.append(nc)
                table[cid][b] = ids[nc]
        # prune states that cannot reach an accepting state (subset
        # construction can mint them; a masked sampler stuck in one
        # could never finish)
        good = set(accepting)
        changed = True
        while changed:
            changed = False
            for sid, row in enumerate(table):
                if sid not in good and any(n in good for n in row.values()):
                    good.add(sid)
                    changed = True
        if 0 not in good:
            raise JsonSchemaError("grammar accepts no string")
        remap = {old: new for new, old in enumerate(sorted(good))}
        out = [
            {b: remap[n] for b, n in table[old].items() if n in good}
            for old in sorted(good)
        ]
        acc = {remap[s] for s in accepting}
        return out, acc


# ---------------------------------------------------------------------------
# byte DFA -> token DFA
# ---------------------------------------------------------------------------

class TokenGrammar:
    """A compiled token-level DFA over one model vocabulary.

    ``table[s, t]`` is the state after emitting token ``t`` in state
    ``s`` — ``-1`` if the grammar does not admit the token there, and
    ``DONE`` (= -2 exactly once, remapped to the terminal row) after the
    EOS that closes a completed value. The engine ships this table to
    the device verbatim; ``advance``/``allowed``/``filter_draft`` are
    the host mirrors the drafter and the tests drive."""

    def __init__(self, table: np.ndarray, *, eos_id: int, key: str,
                 accepting_start: bool = False):
        self.table = np.ascontiguousarray(table, dtype=np.int32)
        self.n_states, self.vocab_size = self.table.shape
        self.eos_id = int(eos_id)
        self.key = key
        self.start = 0
        self.accepting_start = accepting_start

    def advance(self, state: int, token: int) -> int:
        """Host mirror of the device state advance: next state, or a
        negative id once the path leaves the grammar (dead) or the EOS
        closed it (done)."""
        if state < 0 or state >= self.n_states:
            return -1
        if token < 0 or token >= self.vocab_size:
            return -1
        return int(self.table[state, token])

    def advance_all(self, state: int, tokens: Iterable[int]) -> int:
        for t in tokens:
            if state < 0:
                return state
            state = self.advance(state, t)
        return state

    def allowed(self, state: int) -> np.ndarray:
        """Boolean mask of tokens admitted in ``state`` (all-False once
        dead/done)."""
        if state < 0 or state >= self.n_states:
            return np.zeros((self.vocab_size,), bool)
        return self.table[state] >= 0

    def filter_draft(self, state: int, draft: list[int]) -> list[int]:
        """Longest grammar-admissible prefix of a drafted continuation —
        the speculative drafter's pre-filter: proposing a token the mask
        will reject wastes exactly one verify position, so the draft is
        cut at the first inadmissible token."""
        out: list[int] = []
        for t in draft:
            nxt = self.advance(state, t)
            if nxt < 0:
                break
            out.append(t)
            state = nxt
        return out

    def __repr__(self) -> str:  # debug/stats readability
        return (
            f"TokenGrammar(states={self.n_states}, vocab={self.vocab_size}, "
            f"eos={self.eos_id}, key={self.key[:12]})"
        )


def _walk(dfa: list[dict[int, int]], state: int, data: bytes) -> int:
    for b in data:
        nxt = dfa[state].get(b, -1)
        if nxt < 0:
            return -1
        state = nxt
    return state


def compile_token_table(
    dfa: list[dict[int, int]],
    accepting: set[int],
    vocab: list[bytes],
    eos_id: int,
) -> np.ndarray:
    """Dense token transition table from a byte DFA. The final fixpoint
    removes transitions into token-level dead ends, so every reachable
    state admits at least one token (possibly EOS) — the device-side
    mask can never be empty mid-stream."""
    n = len(dfa)
    V = len(vocab)
    if not (0 <= eos_id < V):
        raise JsonSchemaError(f"eos_id {eos_id} outside vocab of {V}")
    done = n  # terminal row, appended below
    table = np.full((n + 1, V), -1, np.int32)
    for s in range(n):
        for t, data in enumerate(vocab):
            if t == eos_id or not data:
                continue
            nxt = _walk(dfa, s, data)
            if nxt >= 0:
                table[s, t] = nxt
        if s in accepting:
            table[s, eos_id] = done
    # token-level pruning: a state whose every outgoing edge died cannot
    # make progress; cut edges into it and iterate
    live = np.ones((n + 1,), bool)
    while True:
        out_deg = (table >= 0).sum(axis=1)
        bad = (out_deg == 0) & live
        bad[done] = False
        if not bad.any():
            break
        live &= ~bad
        dead_ids = np.where(bad)[0]
        table[np.isin(table, dead_ids)] = -1
    if not live[0]:
        raise JsonSchemaError(
            "vocabulary cannot realize this grammar (no token path from "
            "the start state to a completed value)"
        )
    return table


def _vocab_key(vocab: list[bytes]) -> str:
    h = hashlib.sha256()
    for data in vocab:
        h.update(len(data).to_bytes(4, "little"))
        h.update(data)
    return h.hexdigest()[:16]


def compile_json_schema(
    schema: Any,
    vocab: list[bytes | str],
    eos_id: int,
    *,
    max_states: int | None = None,
    whitespace: bool = True,
) -> TokenGrammar:
    """Compile a JSON schema into a TokenGrammar for one vocabulary.

    ``vocab[t]`` is the byte string token ``t`` contributes to the
    output text (b"" for specials — they are never admitted). With
    ``whitespace`` the grammar admits optional blanks at JSON's
    structural positions, which is what lets a model's natural
    formatting survive constraint."""
    import os

    if max_states is None:
        max_states = int(
            os.environ.get("TPU_LLM_CONSTRAINED_MAX_STATES", "4096") or 4096
        )
    norm = [v.encode() if isinstance(v, str) else bytes(v) for v in vocab]
    ast = _schema_ast(schema, whitespace)
    dfa, accepting = _RegexCompiler().compile(ast, max_states)
    table = compile_token_table(dfa, accepting, norm, eos_id)
    key = hashlib.sha256(
        json.dumps(schema, sort_keys=True, separators=(",", ":")).encode()
        + b"|" + _vocab_key(norm).encode() + b"|" + str(eos_id).encode()
        + b"|ws" + (b"1" if whitespace else b"0")
    ).hexdigest()
    return TokenGrammar(
        table, eos_id=eos_id, key=key, accepting_start=0 in accepting
    )


# ---------------------------------------------------------------------------
# vocabulary extraction + process-level grammar cache
# ---------------------------------------------------------------------------

_BYTE_TOKEN = ("<0x", ">")


def vocab_from_tokenizer(tok: Any) -> list[bytes]:
    """Best-effort id -> byte-string vocabulary from a tokenizer.

    Accepts any object exposing a ``vocab`` list (the port's
    ``models.tokenizer.ByteTokenizer``), an HF `tokenizers` wrapper or a
    raw HF tokenizer. SentencePiece/byte-BPE markers (▁, Ġ, Ċ, <0xNN>) are folded to
    their byte meaning; tokens that cannot be resolved map to b"" and
    are simply never admitted by a grammar."""
    if hasattr(tok, "vocab") and isinstance(getattr(tok, "vocab"), (list, tuple)):
        return [
            v.encode() if isinstance(v, str) else bytes(v) for v in tok.vocab
        ]
    inner = getattr(tok, "_tok", tok)
    if not hasattr(inner, "id_to_token") or not hasattr(inner, "get_vocab_size"):
        raise JsonSchemaError(
            "tokenizer exposes neither .vocab nor id_to_token(); cannot "
            "build a grammar vocabulary"
        )
    out: list[bytes] = []
    for i in range(int(inner.get_vocab_size())):
        piece = inner.id_to_token(i)
        if piece is None:
            out.append(b"")
            continue
        if piece.startswith(_BYTE_TOKEN[0]) and piece.endswith(_BYTE_TOKEN[1]):
            try:
                out.append(bytes([int(piece[3:-1], 16)]))
                continue
            except ValueError:
                pass
        piece = piece.replace("▁", " ").replace("Ġ", " ")
        piece = piece.replace("Ċ", "\n")
        if piece.startswith("<") and piece.endswith(">"):
            out.append(b"")  # special marker token
            continue
        out.append(piece.encode("utf-8", "ignore"))
    return out


class _GrammarCache:
    """Process-level LRU of compiled grammars keyed by (schema, vocab,
    eos): the serving edge compiles each distinct schema once, repeat
    requests reuse the table (compilation is milliseconds for realistic
    schemas but the edge should not pay it per request)."""

    def __init__(self, cap: int = 64):
        self.cap = cap
        self._lock = threading.Lock()
        self._items: dict[str, TokenGrammar] = {}

    def get(
        self, schema: Any, vocab: list[bytes], eos_id: int, **kw
    ) -> TokenGrammar:
        pre = hashlib.sha256(
            json.dumps(schema, sort_keys=True, separators=(",", ":")).encode()
            + b"|" + _vocab_key(vocab).encode() + b"|" + str(eos_id).encode()
            # compile options are part of the identity: a whitespace=False
            # grammar must not satisfy a default-options lookup
            + b"|" + json.dumps(kw, sort_keys=True).encode()
        ).hexdigest()
        with self._lock:
            g = self._items.pop(pre, None)
            if g is not None:
                self._items[pre] = g  # LRU bump
                return g
        g = compile_json_schema(schema, vocab, eos_id, **kw)
        return self._put(pre, g)

    def get_regex(
        self, pattern: str, vocab: list[bytes], eos_id: int, **kw
    ) -> TokenGrammar:
        """Regex twin of get(): same LRU, keyed under a 're|' prefix so a
        pattern that textually equals a schema dump cannot collide."""
        pre = hashlib.sha256(
            b"re|" + str(pattern).encode()
            + b"|" + _vocab_key(vocab).encode() + b"|" + str(eos_id).encode()
            + b"|" + json.dumps(kw, sort_keys=True).encode()
        ).hexdigest()
        with self._lock:
            g = self._items.pop(pre, None)
            if g is not None:
                self._items[pre] = g  # LRU bump
                return g
        g = compile_regex(pattern, vocab, eos_id, **kw)
        return self._put(pre, g)

    def _put(self, pre: str, g: TokenGrammar) -> TokenGrammar:
        with self._lock:
            self._items[pre] = g
            while len(self._items) > self.cap:
                self._items.pop(next(iter(self._items)))
        return g

    def clear(self) -> None:
        with self._lock:
            self._items.clear()


grammar_cache = _GrammarCache()
