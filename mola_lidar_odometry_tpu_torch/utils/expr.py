"""Runtime arithmetic-expression DSL for pipeline configs.

Port of ``mola_lidar_odometry_tpu/utils/expr.py``: expressions such as

    2.0*max(ADAPTIVE_THRESHOLD_SIGMA, 2.0*ADAPTIVE_THRESHOLD_SIGMA - ...)
    (0.1e-2 + sqrt(wx^2+wy^2+wz^2)*0.1)*ESTIMATED_SENSOR_MAX_RANGE

are parsed once at config-load time into a tiny AST, then evaluated per frame
on Python floats or torch tensors (a fleet evaluates on ``(B,)`` tensors, one
value per instance).  Host numbers are typed as the JAX package's ``jnp``
types them: Python (float64) arithmetic until a function call, whose result
is a numpy float32, as is all arithmetic that meets it.  Any tensor operand
makes the result a float32 tensor on that tensor's device.

Supported grammar (superset of what the reference pipelines use):
  expr    := term (('+'|'-') term)*
  term    := factor (('*'|'/'|'%') factor)*
  factor  := unary ('^' factor)?          # right-assoc power
  unary   := ('-'|'+')* atom
  atom    := NUMBER | NAME | NAME '(' args ')' | '(' expr ')'
Functions: max, min, sqrt, abs, sin, cos, tan, asin, acos, atan, atan2,
exp, log, floor, ceil, pow, saturate(x, lo, hi), deg2rad, rad2deg.
"""

from __future__ import annotations

import math
import operator
import re
from typing import Mapping, Union

import numpy as np
import torch

Scalar = Union[float, torch.Tensor]

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<op>\*\*|[-+*/%^(),]))"
)


def _lift(*vals):
    """Turn Python numbers into float32 tensors beside the first tensor
    operand; returns None when every operand is a Python number."""
    ref = next((v for v in vals if torch.is_tensor(v)), None)
    if ref is None:
        return None
    return [
        v if torch.is_tensor(v) else torch.full((), float(v), dtype=torch.float32, device=ref.device)
        for v in vals
    ]


def _fn(torch_fn, np_fn):
    """A function of the DSL. On host numbers it computes as the JAX
    package's ``jnp`` function does: in float32, to a float32 result."""

    def f(*vals):
        lifted = _lift(*vals)
        if lifted is None:
            return np.float32(np_fn(*(np.float32(v) for v in vals)))
        return torch_fn(*lifted)

    return f


def _binop(op, x, y):
    """``x op y`` with jnp's weak typing on host numbers: a Python number
    meeting a float32 value becomes float32 (numpy 1.x would widen it)."""
    if (isinstance(x, np.float32) or isinstance(y, np.float32)) and not (
        torch.is_tensor(x) or torch.is_tensor(y)
    ):
        x, y = np.float32(x), np.float32(y)
    return _OPS[op](x, y)


_OPS = {"+": operator.add, "-": operator.sub, "*": operator.mul, "/": operator.truediv,
        "%": operator.mod, "^": operator.pow}

_FUNCS_1 = {
    "sqrt": _fn(torch.sqrt, np.sqrt),
    "abs": _fn(torch.abs, np.abs),
    "sin": _fn(torch.sin, np.sin),
    "cos": _fn(torch.cos, np.cos),
    "tan": _fn(torch.tan, np.tan),
    "asin": _fn(torch.arcsin, np.arcsin),
    "acos": _fn(torch.arccos, np.arccos),
    "atan": _fn(torch.arctan, np.arctan),
    "exp": _fn(torch.exp, np.exp),
    "log": _fn(torch.log, np.log),
    "floor": _fn(torch.floor, np.floor),
    "ceil": _fn(torch.ceil, np.ceil),
    "deg2rad": lambda x: _binop("*", x, math.pi / 180.0),
    "rad2deg": lambda x: _binop("*", x, 180.0 / math.pi),
}
_FUNCS_2 = {
    "max": _fn(torch.maximum, np.maximum),
    "min": _fn(torch.minimum, np.minimum),
    "atan2": _fn(torch.atan2, np.arctan2),
    "pow": _fn(torch.pow, np.power),
}
_FUNCS_3 = {
    "saturate": _fn(lambda x, lo, hi: torch.clamp(x, lo, hi), np.clip),
}


class ExprError(ValueError):
    pass


def _tokenize(src: str):
    pos, out = 0, []
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m or m.end() == pos:
            if src[pos:].strip() == "":
                break
            raise ExprError(f"Bad token at {src[pos:]!r} in expression {src!r}")
        pos = m.end()
        if m.lastgroup == "num":
            out.append(("num", float(m.group("num"))))
        elif m.lastgroup == "name":
            out.append(("name", m.group("name")))
        else:
            op = m.group("op")
            out.append(("op", "^" if op == "**" else op))
    out.append(("end", None))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_op(self, op):
        k, v = self.next()
        if k != "op" or v != op:
            raise ExprError(f"Expected {op!r}, got {v!r}")

    # AST nodes are nested tuples:
    #   ("const", x) | ("var", name) | ("call", fname, [args]) |
    #   ("bin", op, a, b) | ("neg", a)
    def parse(self):
        node = self.expr()
        if self.peek()[0] != "end":
            raise ExprError(f"Trailing tokens: {self.toks[self.i:]}")
        return node

    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            op = self.next()[1]
            node = ("bin", op, node, self.term())
        return node

    def term(self):
        node = self.factor()
        while self.peek()[0] == "op" and self.peek()[1] in ("*", "/", "%"):
            op = self.next()[1]
            node = ("bin", op, node, self.factor())
        return node

    def factor(self):
        # unary minus binds looser than '^' (so -2^2 == -(2^2), as in exprtk)
        if self.peek()[0] == "op" and self.peek()[1] in ("-", "+"):
            op = self.next()[1]
            node = self.factor()
            return ("neg", node) if op == "-" else node
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek() == ("op", "^"):
            self.next()
            node = ("bin", "^", node, self.factor())  # right assoc
        return node

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return ("const", val)
        if kind == "name":
            if self.peek() == ("op", "("):
                self.next()
                args = [self.expr()]
                while self.peek() == ("op", ","):
                    self.next()
                    args.append(self.expr())
                self.expect_op(")")
                return ("call", val, args)
            # bool literals appear in some configs
            if val in ("true", "True"):
                return ("const", 1.0)
            if val in ("false", "False"):
                return ("const", 0.0)
            return ("var", val)
        if kind == "op" and val == "(":
            node = self.expr()
            self.expect_op(")")
            return node
        raise ExprError(f"Unexpected token {val!r}")


def _free_vars(node, acc):
    tag = node[0]
    if tag == "var":
        acc.add(node[1])
    elif tag == "call":
        for a in node[2]:
            _free_vars(a, acc)
    elif tag == "bin":
        _free_vars(node[2], acc)
        _free_vars(node[3], acc)
    elif tag == "neg":
        _free_vars(node[1], acc)
    return acc


def _eval(node, env: Mapping[str, Scalar]) -> Scalar:
    tag = node[0]
    if tag == "const":
        return node[1]
    if tag == "var":
        try:
            return env[node[1]]
        except KeyError:
            raise ExprError(f"Undefined variable {node[1]!r}; have {sorted(env)}")
    if tag == "neg":
        return -_eval(node[1], env)
    if tag == "bin":
        _, op, a, b = node
        x, y = _eval(a, env), _eval(b, env)
        if op == "^" and isinstance(y, float) and y == int(y) and 0 <= y <= 4:
            # integer powers unroll to multiplies (cheap + exact)
            r = 1.0
            for _ in range(int(y)):
                r = _binop("*", r, x)
            return r
        return _binop(op, x, y)
    if tag == "call":
        _, fname, args = node
        vals = [_eval(a, env) for a in args]
        if fname in _FUNCS_1 and len(vals) == 1:
            return _FUNCS_1[fname](vals[0])
        if fname in _FUNCS_2:
            if len(vals) == 2:
                return _FUNCS_2[fname](vals[0], vals[1])
            if fname in ("max", "min") and len(vals) > 2:  # variadic fold
                r = vals[0]
                for v in vals[1:]:
                    r = _FUNCS_2[fname](r, v)
                return r
        if fname in _FUNCS_3 and len(vals) == 3:
            return _FUNCS_3[fname](*vals)
        raise ExprError(f"Unknown function {fname}/{len(vals)}")
    raise ExprError(f"Bad AST node {node!r}")


class Expr:
    """A compiled expression: parse once, evaluate per frame on floats or
    tensors.

    ``Expr`` stands in for a DECLARE_PARAMETER_IN_REQ/OPT field of
    mp2p_icp::Parameterizable: the YAML string stays symbolic and is
    (re-)evaluated against the current dynamic-variable environment.
    """

    __slots__ = ("src", "ast", "vars")

    def __init__(self, src: Union[str, float, int, bool]):
        if isinstance(src, bool):
            src = 1.0 if src else 0.0
        if isinstance(src, (float, int)):
            self.src = repr(src)
            self.ast = ("const", float(src))
        else:
            self.src = src
            self.ast = _Parser(_tokenize(src)).parse()
        self.vars = frozenset(_free_vars(self.ast, set()))

    @property
    def is_const(self) -> bool:
        return not self.vars

    def const_value(self) -> float:
        if not self.is_const:
            raise ExprError(f"Expression {self.src!r} depends on {sorted(self.vars)}")
        return float(_eval(self.ast, {}))

    def __call__(self, env: Mapping[str, Scalar] | None = None) -> Scalar:
        return _eval(self.ast, env or {})

    def __repr__(self):
        return f"Expr({self.src!r})"


def as_expr(v) -> Expr:
    return v if isinstance(v, Expr) else Expr(v)


def const_or_expr(v) -> Union[float, Expr]:
    """Fold to a plain float when the expression has no free variables."""
    e = as_expr(v)
    return e.const_value() if e.is_const else e
