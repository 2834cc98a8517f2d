"""values.txt fixtures — the reference's `process` generator (C2).

The port's own copy of :mod:`ieache_tpu.cli.fixtures`.

Format (``/root/reference/Client1/process.c:70-211``), one 32-char
binary line each (MSB-first within a line):

    line 0: negativity code (0 = positive, 2 = negative)
    line 1: bit count (32/64/128/256)
    line 2+: value limbs, least-significant 32-bit word first
    last:   zero carry word

The canned fixture value is ``2^(width-2)`` (what `process.c` writes
for every width, e.g. 1073741824 at 32 bits).
"""

from __future__ import annotations


def _bin32(v: int) -> str:
    return format(v & 0xFFFFFFFF, "032b")


def write_values_txt(path: str, value: int, width: int) -> None:
    neg = 2 if value < 0 else 0
    mag = abs(int(value))
    if mag >= (1 << width):
        raise ValueError(f"magnitude needs more than {width} bits")
    lines = [_bin32(neg), _bin32(width)]
    for i in range(width // 32):
        lines.append(_bin32((mag >> (32 * i)) & 0xFFFFFFFF))
    lines.append(_bin32(0))  # carry word
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_values_txt(path: str):
    """-> (signed value, width)."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    neg = int(lines[0], 2)
    width = int(lines[1], 2)
    nlimbs = width // 32
    mag = 0
    for i, ln in enumerate(lines[2:2 + nlimbs]):
        mag |= int(ln, 2) << (32 * i)
    return (-mag if neg == 2 else mag), width


def canned_value(width: int, negative: bool = False) -> int:
    """`process.c`'s fixture: ±2^(width-2)."""
    v = 1 << (width - 2)
    return -v if negative else v
