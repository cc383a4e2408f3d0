"""Equal/atom-style variable expression engine (lidp_tpu/io/expr.py, an
own copy: numpy only, no change).

A real recursive-descent (precedence-climbing) parser + evaluator replacing
the reference's stack-machine `Variable::evaluate`
(src/variable.cpp:1168-2260).  No Python ``eval`` anywhere.

Same grammar and semantics as the reference:

- operators by precedence (variable.cpp:105-113): ``|| |^`` (1), ``&&`` (2),
  ``== !=`` (3), ``< <= > >=`` (4), ``+ -`` (5), ``* / %`` (6), ``^`` (7),
  unary ``- !`` (8).  All binary operators LEFT-associative (the reference
  pops while stack-top precedence >= new precedence, variable.cpp:2147), so
  ``2^3^2 == 64``; unary binds tighter than ``^`` so ``-2^2 == 4``.
- math functions (variable.cpp:3272-3668): sqrt exp ln log abs sin cos tan
  asin acos atan atan2 random normal ceil floor round, and the time-family
  ramp stagger logfreq logfreq2 stride stride2 vdisplace swiggle cwiggle.
- group functions (variable.cpp:3669-3911): count mass charge xcm vcm fcm
  bound gyration ke angmom torque inertia omega — delegated to the context.
- special functions (variable.cpp:3913-4400): sum min max ave trap slope
  over global vector refs, gmask/rmask/grmask, next, is_defined.
- thermo keywords, v_/c_/f_ references with ``[i]``/``[i][j]`` indices
  (indices may themselves be expressions, e.g. ``x[v_i]``), atom vectors
  (variable.cpp:4413-4430: id mass type mol x y z vx vy vz fx fy fz q),
  the PI constant, yes/no/on/off/true/false.

Atom-style evaluation returns a numpy array over all atoms.  Expressions
containing random()/normal() are evaluated per-atom in atom order so the
RanMars draw sequence matches the reference's per-atom tree walk
(variable.cpp eval_tree RANDOM; in.mc depends on this).

The boolean evaluator for the ``if`` command (variable.cpp:4629-4895) is
separate: numbers and bare strings only, string compare for ==/!=.
"""

from __future__ import annotations

import math

import numpy as np

BIGINT = float(2**63 - 1)

MATH_FUNCS = frozenset((
    "sqrt", "exp", "ln", "log", "abs", "sin", "cos", "tan", "asin",
    "acos", "atan", "atan2", "random", "normal", "ceil", "floor", "round",
    "ramp", "stagger", "logfreq", "logfreq2", "stride", "stride2",
    "vdisplace", "swiggle", "cwiggle"))
GROUP_FUNCS = frozenset((
    "count", "mass", "charge", "xcm", "vcm", "fcm", "bound", "gyration",
    "ke", "angmom", "torque", "inertia", "omega"))
SPECIAL_FUNCS = frozenset((
    "sum", "min", "max", "ave", "trap", "slope", "gmask", "rmask",
    "grmask", "next", "is_active", "is_defined", "is_available"))
ATOM_VECTORS = frozenset((
    "id", "mass", "type", "mol", "x", "y", "z",
    "vx", "vy", "vz", "fx", "fy", "fz", "q"))
CONSTANTS = {"PI": math.pi, "on": 1.0, "off": 0.0, "true": 1.0,
             "false": 0.0, "yes": 1.0, "no": 0.0}

# binary operator precedence (variable.cpp:105-113)
_PREC = {"||": 1, "|^": 1, "&&": 2, "==": 3, "!=": 3,
         "<": 4, "<=": 4, ">": 4, ">=": 4,
         "+": 5, "-": 5, "*": 6, "/": 6, "%": 6, "^": 7}
# two-char operators first so <= doesn't lex as < then =
_OPS2 = ("||", "|^", "&&", "==", "!=", "<=", ">=")


class ExprError(ValueError):
    pass


# ------------------------------- lexer --------------------------------

def _find_matching_paren(s: str, i: int) -> int:
    """s[i] == '('; return index of the matching ')'."""
    depth = 0
    for j in range(i, len(s)):
        if s[j] == "(":
            depth += 1
        elif s[j] == ")":
            depth -= 1
            if depth == 0:
                return j
    raise ExprError(f"mismatched parenthesis in {s!r}")


def _split_args(s: str) -> list:
    """Split on top-level commas (variable.cpp parse_args)."""
    args, depth, start = [], 0, 0
    for j, c in enumerate(s):
        if c in "([":
            depth += 1
        elif c in ")]":
            depth -= 1
        elif c == "," and depth == 0:
            args.append(s[start:j].strip())
            start = j + 1
    args.append(s[start:].strip())
    return args


# ------------------------------- parser -------------------------------
# AST nodes are tuples:
#   ("num", float)
#   ("bin", op, lhs, rhs)        ("un", op, child)
#   ("math", name, [arg_asts])
#   ("group", name, [raw_strings])
#   ("special", name, [raw_strings])
#   ("ref", kind, ident, idx1_ast|None, idx2_ast|None)  kind in v/c/f
#   ("atomvec", word, idx_ast|None)
#   ("thermo", word)             ("const", value)


def parse(text: str):
    p = _Parser(text)
    node = p.parse_expr(1)
    p.skip_ws()
    if p.i < len(p.s):
        raise ExprError(f"trailing input at {p.s[p.i:]!r} in {text!r}")
    return node


class _Parser:
    def __init__(self, s: str):
        self.s = s
        self.i = 0

    def skip_ws(self):
        while self.i < len(self.s) and self.s[self.i].isspace():
            self.i += 1

    def peek_op(self):
        self.skip_ws()
        s, i = self.s, self.i
        for op in _OPS2:
            if s.startswith(op, i):
                return op
        if i < len(s) and s[i] in "+-*/%^<>":
            return s[i]
        return None

    def parse_expr(self, min_prec: int):
        lhs = self.parse_unary()
        while True:
            op = self.peek_op()
            if op is None or _PREC[op] < min_prec:
                return lhs
            self.i += len(op)
            rhs = self.parse_expr(_PREC[op] + 1)   # left-assoc
            lhs = ("bin", op, lhs, rhs)

    def parse_unary(self):
        self.skip_ws()
        s = self.s
        if self.i < len(s) and s[self.i] == "-":
            self.i += 1
            return ("un", "-", self.parse_unary())
        if self.i < len(s) and s[self.i] == "!":
            self.i += 1
            return ("un", "!", self.parse_unary())
        return self.parse_atom()

    def parse_atom(self):
        self.skip_ws()
        s = self.s
        if self.i >= len(s):
            raise ExprError(f"unexpected end of expression in {s!r}")
        c = s[self.i]
        if c == "(":
            j = _find_matching_paren(s, self.i)
            inner = parse(s[self.i + 1:j])
            self.i = j + 1
            return inner
        if c.isdigit() or c == ".":
            return self._parse_number()
        if c.isalpha() or c == "_":
            return self._parse_word()
        raise ExprError(f"invalid syntax at {s[self.i:]!r} in {s!r}")

    def _parse_number(self):
        s, start = self.s, self.i
        i = self.i
        while i < len(s) and (s[i].isdigit() or s[i] == "."):
            i += 1
        if i < len(s) and s[i] in "eE":
            j = i + 1
            if j < len(s) and s[j] in "+-":
                j += 1
            if j < len(s) and s[j].isdigit():
                i = j
                while i < len(s) and s[i].isdigit():
                    i += 1
        self.i = i
        return ("num", float(s[start:i]))

    def _parse_index(self):
        """[expr] -> AST (LAMMPS int_between_brackets allows constants
        and v_name; we accept any expression)."""
        s = self.s
        depth, j = 0, self.i
        while j < len(s):
            if s[j] == "[":
                depth += 1
            elif s[j] == "]":
                depth -= 1
                if depth == 0:
                    break
            j += 1
        if depth != 0:
            raise ExprError(f"mismatched bracket in {s!r}")
        inner = parse(s[self.i + 1:j])
        self.i = j + 1
        return inner

    def _parse_word(self):
        s, start = self.s, self.i
        i = self.i
        while i < len(s) and (s[i].isalnum() or s[i] == "_"):
            i += 1
        word = s[start:i]
        self.i = i
        # function call?
        if self.i < len(s) and s[self.i] == "(":
            j = _find_matching_paren(s, self.i)
            contents = s[self.i + 1:j]
            self.i = j + 1
            raw = _split_args(contents)
            if word in MATH_FUNCS:
                return ("math", word, [parse(a) for a in raw])
            if word in GROUP_FUNCS:
                return ("group", word, raw)
            if word in SPECIAL_FUNCS:
                return ("special", word, raw)
            raise ExprError(f"unknown function {word!r}")
        # v_/c_/f_ reference?
        if len(word) > 2 and word[1] == "_" and word[0] in "vcf":
            kind, ident = word[0], word[2:]
            idx1 = idx2 = None
            if self.i < len(s) and s[self.i] == "[":
                idx1 = self._parse_index()
                if self.i < len(s) and s[self.i] == "[":
                    idx2 = self._parse_index()
            return ("ref", kind, ident, idx1, idx2)
        if word in ATOM_VECTORS:
            idx = None
            if self.i < len(s) and s[self.i] == "[":
                idx = self._parse_index()
            return ("atomvec", word, idx)
        if word in CONSTANTS:
            return ("const", CONSTANTS[word])
        return ("thermo", word)


# ------------------------------ evaluator -----------------------------

def _has_random(node) -> bool:
    if node[0] == "math" and node[1] in ("random", "normal"):
        return True
    return any(_has_random(ch) for ch in node[1:]
               if isinstance(ch, tuple))


def evaluate(ctx, text: str) -> float:
    """Equal-style evaluation -> scalar float."""
    v = _eval(parse(text), ctx, None)
    if isinstance(v, np.ndarray):
        raise ExprError(
            f"atom vector in equal-style variable formula: {text!r}")
    return float(v)


def evaluate_atom(ctx, text: str) -> np.ndarray:
    """Atom-style evaluation -> (natoms,) float array.  Expressions with
    random()/normal() evaluate per atom in atom order (reference tree-walk
    draw order)."""
    ast = parse(text)
    n = ctx.natoms
    if _has_random(ast):
        out = np.empty(n, float)
        for i in range(n):
            out[i] = _eval(ast, ctx, i)
        return out
    v = _eval(ast, ctx, "vec")
    if not isinstance(v, np.ndarray):
        v = np.full(n, float(v))
    return v.astype(float)


def _scalarize(v, mode):
    """Index a vectorized value when evaluating per atom."""
    if isinstance(mode, int) and isinstance(v, np.ndarray):
        return v[mode]
    return v


def _eval(node, ctx, mode):
    """mode: None = equal style, "vec" = vectorized atom style,
    int i = per-atom atom style."""
    kind = node[0]
    if kind == "num" or kind == "const":
        return node[1]
    if kind == "un":
        v = _eval(node[2], ctx, mode)
        if node[1] == "-":
            return -v
        return np.where(v == 0.0, 1.0, 0.0) if isinstance(v, np.ndarray) \
            else (1.0 if v == 0.0 else 0.0)
    if kind == "bin":
        op = node[1]
        a = _eval(node[2], ctx, mode)
        b = _eval(node[3], ctx, mode)
        return _apply_bin(op, a, b)
    if kind == "math":
        return _math_func(node[1], node[2], ctx, mode)
    if kind == "group":
        return ctx.group_func(node[1], node[2])
    if kind == "special":
        return _special_func(node[1], node[2], ctx, mode)
    if kind == "thermo":
        v = ctx.thermo(node[1])
        if v is None:
            raise ExprError(f"unknown keyword {node[1]!r} in variable "
                            f"formula")
        return v
    if kind == "atomvec":
        word, idx = node[1], node[2]
        vec = ctx.atom_vec(word)
        if idx is not None:
            i = int(round(_to_float(_eval(idx, ctx, mode), mode)))
            return float(vec[i - 1])       # 1-based atom ids
        if mode is None:
            raise ExprError(
                f"atom vector {word!r} in equal-style variable formula")
        return vec if mode == "vec" else float(vec[mode])
    if kind == "ref":
        return _ref(node, ctx, mode)
    raise ExprError(f"bad AST node {kind!r}")


def _to_float(v, mode):
    if isinstance(v, np.ndarray):
        raise ExprError("vector used where a scalar index is required")
    return float(v)


def _apply_bin(op, a, b):
    arr = isinstance(a, np.ndarray) or isinstance(b, np.ndarray)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "/":
        if not arr and b == 0.0:
            raise ExprError("divide by zero in variable formula")
        return a / b
    if op == "%":
        if not arr and b == 0.0:
            raise ExprError("modulo zero in variable formula")
        return np.fmod(a, b) if arr else math.fmod(a, b)
    if op == "^":
        if not arr and b == 0.0 and a == 0.0:
            return 1.0
        return a ** b
    if op == "==":
        r = (a == b)
    elif op == "!=":
        r = (a != b)
    elif op == "<":
        r = (a < b)
    elif op == "<=":
        r = (a <= b)
    elif op == ">":
        r = (a > b)
    elif op == ">=":
        r = (a >= b)
    elif op == "&&":
        r = (a != 0.0) & (b != 0.0) if arr else (a != 0.0 and b != 0.0)
    elif op == "||":
        r = (a != 0.0) | (b != 0.0) if arr else (a != 0.0 or b != 0.0)
    elif op == "|^":
        r = (a != 0.0) ^ (b != 0.0) if arr else \
            ((a == 0.0) != (b == 0.0))
    else:
        raise ExprError(f"unknown operator {op!r}")
    return r.astype(float) if isinstance(r, np.ndarray) else float(bool(r))


_UNARY_MATH = {
    "sqrt": np.sqrt, "exp": np.exp, "ln": np.log, "log": np.log10,
    "abs": np.abs, "sin": np.sin, "cos": np.cos, "tan": np.tan,
    "asin": np.arcsin, "acos": np.arccos, "atan": np.arctan,
    "ceil": np.ceil, "floor": np.floor,
}


def _math_func(name, args, ctx, mode):
    vals = [_eval(a, ctx, mode) for a in args]

    def need(n):
        if len(vals) != n:
            raise ExprError(
                f"invalid math function {name!r}: expected {n} args")

    if name in _UNARY_MATH:
        need(1)
        v = vals[0]
        if name == "sqrt" and not isinstance(v, np.ndarray) and v < 0.0:
            raise ExprError("sqrt of negative value in variable formula")
        if name in ("ln", "log") and not isinstance(v, np.ndarray) \
                and v <= 0.0:
            raise ExprError("log of <= 0 value in variable formula")
        out = _UNARY_MATH[name](v)
        return out if isinstance(out, np.ndarray) else float(out)
    if name == "round":
        need(1)
        v = vals[0]
        # MYROUND (variable.cpp:52): half away from floor
        if isinstance(v, np.ndarray):
            return np.where(v - np.floor(v) >= 0.5, np.ceil(v),
                            np.floor(v))
        return math.ceil(v) if (v - math.floor(v)) >= 0.5 else \
            math.floor(v)
    if name == "atan2":
        need(2)
        out = np.arctan2(vals[0], vals[1])
        return out if isinstance(out, np.ndarray) else float(out)
    if name == "random":
        need(3)
        lo, hi = _to_float(vals[0], mode), _to_float(vals[1], mode)
        rng = ctx.random_source(int(_to_float(vals[2], mode)),
                                atom=mode is not None)
        return rng.uniform() * (hi - lo) + lo
    if name == "normal":
        need(3)
        mu, sig = _to_float(vals[0], mode), _to_float(vals[1], mode)
        if sig < 0.0:
            raise ExprError("invalid normal() sigma in variable formula")
        rng = ctx.random_source(int(_to_float(vals[2], mode)),
                                atom=mode is not None)
        return mu + sig * rng.gaussian()

    # time-family functions: scalar-only semantics
    v = [_to_float(x, mode) for x in vals]
    step = ctx.step
    if name == "ramp":
        need(2)
        if not ctx.in_run:
            raise ExprError(
                "cannot use ramp in variable formula between runs")
        delta = step - ctx.run_begin
        if delta != 0.0:
            delta /= ctx.run_end - ctx.run_begin
        return v[0] + delta * (v[1] - v[0])
    if name == "stagger":
        need(2)
        i1, i2 = int(v[0]), int(v[1])
        if i1 <= 0 or i2 <= 0 or i1 <= i2:
            raise ExprError("invalid stagger() args")
        lower = step // i1 * i1
        delta = step - lower
        return float(lower + i2 if delta < i2 else lower + i1)
    if name == "logfreq":
        need(3)
        i1, i2, i3 = int(v[0]), int(v[1]), int(v[2])
        if i1 <= 0 or i2 <= 0 or i3 <= 0 or i2 >= i3:
            raise ExprError("invalid logfreq() args")
        if step < i1:
            return float(i1)
        lower = i1
        while step >= i3 * lower:
            lower *= i3
        multiple = step // lower
        return float((multiple + 1) * lower if multiple < i2
                     else lower * i3)
    if name == "logfreq2":
        need(3)
        i1, i2, i3 = int(v[0]), int(v[1]), int(v[2])
        if i1 <= 0 or i2 <= 0 or i3 <= 0:
            raise ExprError("invalid logfreq2() args")
        if step < i1:
            return float(i1)
        value = float(i1)
        delta = i1 * (i3 - 1.0) / i2
        count = 0
        while step >= value:
            value += delta
            count += 1
            if count % i2 == 0:
                delta *= i3
        return math.ceil(value)
    if name == "stride":
        need(3)
        i1, i2, i3 = int(v[0]), int(v[1]), int(v[2])
        if i1 < 0 or i2 < 0 or i3 <= 0 or i1 > i2:
            raise ExprError("invalid stride() args")
        if step < i1:
            return float(i1)
        if step < i2:
            offset = step - i1
            val = i1 + (offset // i3) * i3 + i3
            return BIGINT if val > i2 else float(val)
        return BIGINT
    if name == "stride2":
        need(6)
        i1, i2, i3 = int(v[0]), int(v[1]), int(v[2])
        i4, i5, i6 = int(v[3]), int(v[4]), int(v[5])
        if i1 < 0 or i2 < 0 or i3 <= 0 or i1 > i2 \
                or i4 < 0 or i5 < 0 or i6 <= 0 or i4 > i5 \
                or i4 < i1 or i5 > i2:
            raise ExprError("invalid stride2() args")
        if step < i1:
            return float(i1)
        if step >= i2:
            return BIGINT
        if step < i4 or step > i5:
            offset = step - i1
            istep = i1 + (offset // i3) * i3 + i3
            if step < i4 and istep > i4:
                istep = i4
        else:
            offset = step - i4
            istep = i4 + (offset // i6) * i6 + i6
            if istep > i5:
                offset = i5 - i1
                istep = i1 + (offset // i3) * i3 + i3
                if istep > i2:
                    return BIGINT
        return float(istep)
    if name in ("vdisplace", "swiggle", "cwiggle"):
        if not ctx.in_run:
            raise ExprError(f"cannot use {name} in variable formula "
                            "between runs")
        delta = step - ctx.run_begin
        if name == "vdisplace":
            need(2)
            return v[0] + v[1] * delta * ctx.dt
        need(3)
        if v[2] == 0.0:
            raise ExprError(f"invalid {name}() period")
        omega = 2.0 * math.pi / v[2]
        if name == "swiggle":
            return v[0] + v[1] * math.sin(omega * delta * ctx.dt)
        return v[0] + v[1] * (1.0 - math.cos(omega * delta * ctx.dt))
    raise ExprError(f"unhandled math function {name!r}")


def _special_func(name, raw, ctx, mode):
    if name in ("sum", "min", "max", "ave", "trap", "slope"):
        if len(raw) != 1:
            raise ExprError(f"invalid special function {name!r}")
        vec = np.asarray(ctx.special_vector(raw[0]), float)
        if name == "sum":
            return float(vec.sum())
        if name == "min":
            return float(vec.min())
        if name == "max":
            return float(vec.max())
        if name == "ave":
            return float(vec.mean())
        if name == "trap":
            # variable.cpp TRAP: sum with half-weight endpoints
            if len(vec) < 2:
                return float(vec.sum())
            return float(vec[1:-1].sum() + 0.5 * (vec[0] + vec[-1]))
        # slope: least-squares dy/dx with x = 0..n-1 (variable.cpp SLOPE)
        n = len(vec)
        if n < 2:
            raise ExprError("slope() needs at least 2 values")
        xs = np.arange(n, dtype=float)
        sx, sy = xs.mean(), vec.mean()
        sxx = ((xs - sx) ** 2).sum()
        sxy = ((xs - sx) * (vec - sy)).sum()
        if sxx == 0.0:
            return BIGINT
        return float(sxy / sxx)
    if name == "gmask":
        if mode is None:
            raise ExprError("gmask() in equal-style variable formula")
        m = ctx.group_mask(raw[0]).astype(float)
        return m if mode == "vec" else float(m[mode])
    if name == "rmask":
        if mode is None:
            raise ExprError("rmask() in equal-style variable formula")
        m = ctx.region_mask(raw[0]).astype(float)
        return m if mode == "vec" else float(m[mode])
    if name == "grmask":
        if mode is None:
            raise ExprError("grmask() in equal-style variable formula")
        m = (ctx.group_mask(raw[0]) & ctx.region_mask(raw[1])).astype(float)
        return m if mode == "vec" else float(m[mode])
    if name == "next":
        return ctx.var_next(raw)
    if name == "is_defined":
        return ctx.is_defined(raw)
    if name in ("is_active", "is_available"):
        return ctx.is_active(name, raw)
    raise ExprError(f"unhandled special function {name!r}")


def _ref(node, ctx, mode):
    _, kind, ident, idx1, idx2 = node
    i1 = i2 = None
    if idx1 is not None:
        i1 = int(round(_to_float(_eval(idx1, ctx, mode), mode)))
    if idx2 is not None:
        i2 = int(round(_to_float(_eval(idx2, ctx, mode), mode)))
    if kind == "v":
        v = ctx.var_ref(ident, mode)
        if i1 is not None:
            if not isinstance(v, np.ndarray):
                raise ExprError(f"indexing non-vector variable {ident!r}")
            return float(v[i1 - 1])
        return _scalarize(v, mode)
    if kind == "c":
        return _scalarize(ctx.compute_ref(ident, i1, i2, mode), mode)
    return _scalarize(ctx.fix_ref(ident, i1, i2, mode), mode)


# ------------------------- boolean evaluator ---------------------------

def evaluate_boolean(text: str) -> float:
    """The `if` command condition (variable.cpp:4629): numbers, bare
    strings (==/!= string compare), parens, comparison + logical ops.
    $-substitution has already happened."""
    val, i = _bool_expr(text, 0, 1)
    while i < len(text) and text[i].isspace():
        i += 1
    if i < len(text):
        raise ExprError(f"invalid Boolean syntax in if command: {text!r}")
    return val


def _bool_expr(s, i, min_prec):
    val, i = _bool_unary(s, i)
    while True:
        j = i
        while j < len(s) and s[j].isspace():
            j += 1
        op = None
        for cand in _OPS2:
            if s.startswith(cand, j):
                op = cand
                break
        if op is None and j < len(s) and s[j] in "<>":
            op = s[j]
        if op is None or op in ("+", "-", "*", "/", "%", "^") \
                or _PREC[op] < min_prec:
            return val, i
        i = j + len(op)
        rhs, i = _bool_expr(s, i, _PREC[op] + 1)
        # string compare only for ==/!= on two strings
        if isinstance(val, str) or isinstance(rhs, str):
            if op == "==":
                val = float(str(val) == str(rhs))
            elif op == "!=":
                val = float(str(val) != str(rhs))
            else:
                raise ExprError(
                    f"cannot {op!r} strings in if command: {s!r}")
        else:
            val = _apply_bin(op, val, rhs)


def _bool_unary(s, i):
    while i < len(s) and s[i].isspace():
        i += 1
    if i >= len(s):
        raise ExprError(f"invalid Boolean syntax in if command: {s!r}")
    c = s[i]
    if c == "!":
        v, i = _bool_unary(s, i + 1)
        if isinstance(v, str):
            raise ExprError("cannot negate a string in if command")
        return (1.0 if v == 0.0 else 0.0), i
    if c == "(":
        j = _find_matching_paren(s, i)
        v = evaluate_boolean(s[i + 1:j])
        return v, j + 1
    if c.isdigit() or c == "." or c == "-":
        j = i + 1
        while j < len(s) and (s[j].isdigit() or s[j] == "."):
            j += 1
        if j < len(s) and s[j] in "eE":
            k = j + 1
            if k < len(s) and s[k] in "+-":
                k += 1
            while k < len(s) and s[k].isdigit():
                k += 1
            j = k
        return float(s[i:j]), j
    if c.isalpha() or c == "_":
        j = i
        while j < len(s) and (s[j].isalnum() or s[j] == "_"):
            j += 1
        return s[i:j], j
    raise ExprError(f"invalid Boolean syntax in if command: {s!r}")
