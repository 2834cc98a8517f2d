"""Infix -> postfix conversion and expression validation.

The port's own copy of :mod:`ieache_tpu.cli.convert`.

Counterpart of the reference Output CLI's `Stack`/`InfixConverter`
(``/root/reference/Output/output_dynamic.py:81-154``) and its
expression filters (``:1080-1085``): shunting-yard with the same
precedence table, plus the reference's rejection rules —

* one '+' mixed with one '*' is rejected;
* a double '*' is rejected;
* 2..3 operands with matching operator count (the CLI collects up to
  4 operands / 3 operators but the wire schema caps jobs at 3/2,
  SURVEY Appendix A — we enforce the *effective* capability and
  surface the reason).

Division maps to multiplication downstream (`:1121-1122`) — the
reference never implemented it; we keep the mapping and warn.
"""

from __future__ import annotations

import re

PRECEDENCE = {"+": 1, "-": 1, "*": 2, "/": 2, "^": 3}
OPERATORS = "+-*/"


class ExpressionError(ValueError):
    pass


def to_postfix(expr: str) -> str:
    """Shunting-yard (output_dynamic.py:125-148 semantics)."""
    expr = expr.replace(" ", "")
    stack = []
    out = []
    for c in expr:
        if c.isalpha() or c.isdigit():
            out.append(c)
        elif c == "(":
            stack.append(c)
        elif c == ")":
            while stack and stack[-1] != "(":
                out.append(stack.pop())
            if not stack:
                raise ExpressionError("unbalanced parentheses")
            stack.pop()
        elif c in OPERATORS or c == "^":
            while (
                stack
                and stack[-1] in PRECEDENCE
                and c in PRECEDENCE
                and PRECEDENCE[c] <= PRECEDENCE[stack[-1]]
            ):
                out.append(stack.pop())
            stack.append(c)
        else:
            raise ExpressionError(f"bad character {c!r}")
    while stack:
        top = stack.pop()
        if top == "(":
            raise ExpressionError("unbalanced parentheses")
        out.append(top)
    return "".join(out)


def validate(postfix: str) -> tuple:
    """Apply the reference's filters; returns (letters, ops)."""
    letters = re.findall("[a-zA-Z]", postfix)
    ops = re.findall(r"[-+*/]", postfix)

    if ops.count("+") == 1 and ops.count("*") == 1:
        raise ExpressionError(
            "This addition and multiplication operation cannot be "
            "processed"  # output_dynamic.py:1080-1082
        )
    if ops.count("*") == 2:
        raise ExpressionError(
            "This double multiplication operation cannot be processed"
        )  # output_dynamic.py:1083-1085
    if len(letters) < 2:
        raise ExpressionError(
            "Please enter at least 2 letters (A-Z) that represent "
            "clients, and 1 operator"
        )
    if len(letters) > 3:
        raise ExpressionError(
            "jobs are limited to 3 operands (the wire schema caps "
            "DataUserInput at 3 IPs / 2 operators, "
            "Cloud/declaration.asn:8-18)"
        )
    if len(ops) != len(letters) - 1:
        raise ExpressionError(
            f"{len(letters)} operands need {len(letters) - 1} "
            f"operators, got {len(ops)}"
        )
    if len(set(letters)) != len(letters):
        raise ExpressionError("operand letters must be distinct")
    return letters, ops


def validate_ipv4(addr: str) -> bool:
    """`validateIP` equivalent (output_dynamic.py:1096-1113)."""
    parts = addr.split(".")
    if len(parts) != 4:
        return False
    try:
        return all(0 <= int(p) <= 255 and p == str(int(p)) for p in parts)
    except ValueError:
        return False
