"""Fused circuits: a whole arithmetic op as one function of raw bootstraps.

Counterpart of :mod:`ieache_tpu.circuits.fused`.  There each W-bit op is
one jitted program, a ``lax.scan`` over bit positions whose body holds
the batched gate bootstraps; PyTorch runs eagerly, so here the scans
are Python loops (their stacked outputs ``torch.stack`` in the scan's
order) and the functions differ from :mod:`.arith` in their circuits,
not in their dispatch: the pre-bootstrap linear combinations are built
by hand (wrapping int32 end to end) and fed to one bootstrap per wave.

Two adder circuits are available (IEACHE_ADDER, default ``maj2``):
``ref5`` replicates the reference's 5-gate/bit full adder (3 bootstrap
rounds/bit); ``maj2`` computes the same truth table in 2 bootstraps/bit
(majority-vote carry + parity fix-up).
"""

from __future__ import annotations

import os

import torch

from ieache_tpu_torch.boot import gates
from ieache_tpu_torch.boot.bootstrap import MU, DeviceCloudKey, bootstrap
from ieache_tpu_torch.circuits import arith


def _bootstrap_raw(pre: torch.Tensor, key: DeviceCloudKey) -> torch.Tensor:
    """One bootstrap wave over (B, n+1): modswitch, blind rotation,
    sample extraction, keyswitch."""
    return bootstrap(pre, key)


def _const(bits: torch.Tensor, key: DeviceCloudKey) -> torch.Tensor:
    return gates.CONSTANT(bits.to(torch.int32), key.params.n)


def _zeros(shape, ref: torch.Tensor, key: DeviceCloudKey) -> torch.Tensor:
    """Trivial encryptions of 0 of bit shape ``shape`` on ``ref``'s device."""
    return _const(torch.zeros(shape, dtype=torch.int32, device=ref.device),
                  key)


def _add_body(pre: torch.Tensor, n: int, beta) -> torch.Tensor:
    """``pre`` with ``beta`` (an int or a tensor) added to the body
    column, wrapping; ``pre`` is a fresh tensor and is updated in place."""
    pre[..., n] += beta
    return pre


def _adder_bit_step(key: DeviceCloudKey, carry, xs):
    """One full-adder bit: 5 gates in 3 bootstrap rounds (2B, 2B, B)."""
    xi, yi = xs
    b = xi.shape[0]
    n = key.params.n

    # round 1: axc = x^c, bxc = y^c
    pre = 2 * torch.cat([xi, yi], 0) + 2 * torch.cat([carry, carry], 0)
    both = _bootstrap_raw(_add_body(pre, n, 2 * MU), key)
    axc, bxc = both[:b], both[b:]

    # round 2: sum = x^bxc (XOR), g = axc&bxc (AND)
    pre2 = torch.cat([2 * xi, axc], 0) + torch.cat([2 * bxc, bxc], 0)
    beta = torch.cat([
        torch.full((b,), 2 * MU, dtype=torch.int32, device=xi.device),
        torch.full((b,), -MU, dtype=torch.int32, device=xi.device),
    ])
    mixed = _bootstrap_raw(_add_body(pre2, n, beta), key)
    sum_i, g = mixed[:b], mixed[b:]

    # round 3: c = c ^ g
    carry = _bootstrap_raw(_add_body(2 * carry + 2 * g, n, 2 * MU), key)
    return carry, sum_i


def _adder_bit_step_maj2(key: DeviceCloudKey, carry, xs):
    """One full-adder bit in TWO bootstraps (same truth table as the
    5-gate circuit, 2.5x fewer bootstraps):

        carry' = sign(x + y + c)                 (majority vote)
        sum    = sign(x + y + c - 2*carry')      (parity fix-up)

    Phases: x+y+c ∈ {±3μ, ±μ} so its sign IS the majority; subtracting
    2·(±μ) folds the four cases onto ±μ with the right parity.
    """
    xi, yi = xs
    pre = xi + yi + carry                  # {±3μ, ±μ}: sign = majority
    carry_new = _bootstrap_raw(pre, key)
    sum_i = _bootstrap_raw(pre - 2 * carry_new, key)
    return carry_new, sum_i


def _ripple_add_fused(x, y, carry_in, key: DeviceCloudKey,
                      mode: str = "maj2"):
    step = _adder_bit_step_maj2 if mode == "maj2" else _adder_bit_step
    carry, sums = carry_in, []
    for i in range(x.shape[1]):
        carry, sum_i = step(key, carry, (x[:, i], y[:, i]))
        sums.append(sum_i)
    return torch.stack(sums, dim=1), carry


#: bootstraps per adder bit, by mode (evaluator gate accounting)
ADDER_BOOTSTRAPS_PER_BIT = {"maj2": 2, "ref5": 5}


def adder_mode() -> str:
    """Fused adder circuit: IEACHE_ADDER=ref5 selects the reference's
    5-gate full adder; default maj2 (2 bootstraps/bit)."""
    mode = os.environ.get("IEACHE_ADDER", "maj2")
    if mode not in ADDER_BOOTSTRAPS_PER_BIT:
        raise ValueError(f"IEACHE_ADDER must be maj2|ref5, got {mode!r}")
    return mode


def ripple_add(x, y, carry_in, key: DeviceCloudKey, mode: str | None = None):
    """Drop-in fused replacement for arith.ripple_add."""
    return _ripple_add_fused(x, y, carry_in, key, mode or adder_mode())


def kogge_stone_add(x, y, key: DeviceCloudKey, carry_in):
    """arith.kogge_stone_add with its carry-in given (the JAX package
    wraps it in one jit; here the two are the same circuit)."""
    return arith.kogge_stone_add(x, y, key, carry_in=carry_in)


def _compress3(a, b, c, key: DeviceCloudKey):
    """3:2 compression of three (G, L, n+1) words in two bootstrap
    waves: (s, maj) with a + b + c = s + 2·maj per bit column; the XOR
    of the first wave is batched with the majority."""
    g, width, m = a.shape
    n = key.params.n
    pre_xor = _add_body(2 * a + 2 * b, n, 2 * MU)
    pre_maj = a + b + c
    both = _bootstrap_raw(
        torch.cat([pre_xor, pre_maj], 0).reshape(2 * g * width, m), key,
    ).reshape(2 * g, width, m)
    xab, maj = both[:g], both[g:]
    pre_s = _add_body(2 * xab + 2 * c, n, 2 * MU)
    s = _bootstrap_raw(pre_s.reshape(g * width, m), key).reshape(g, width, m)
    return s, maj


def csa3_add(a, b, c, u, v, key: DeviceCloudKey):
    """Fused three-term addition ``(a + b + c + k0 + 2·k1) mod 2^W``
    in 2 + depth(KS) bootstrap waves: ONE carry-free 3:2 compression +
    ONE parallel-prefix add.

    The compression is bit-parallel (no carry chain): per bit,
    ``a+b+c = s + 2·maj`` with s the 3-input parity (two XOR waves,
    the first batched with the majority wave) and maj the maj2 trick
    (``sign(a+b+c)``).  The cleartext carry constant K in {0..2} from
    the per-lane sign dataflow rides in as TWO unit carries u + v = K
    ((K>=1), (K>=2)): u in the final adder's carry-in, v in the freed
    (weight-1) bit-0 slot of the shifted majority word — both slots add
    1, so the sum gains exactly K.

    a, b, c: (B, W, n+1) bit words; u, v: (B,) cleartext 0/1.
    """
    w = a.shape[1]
    s, maj = _compress3(a, b, c, key)
    # maj << 1 (mod 2^W truncation), bit 0 = trivial enc of v
    mword = torch.cat([_const(v[:, None], key), maj[:, : w - 1, :]], dim=1)
    return kogge_stone_add(s, mword, key, carry_in=_const(u, key))


def _compress3_words(triples, key: DeviceCloudKey):
    """One Wallace layer: every (a, b, c) word triple compressed 3:2
    in TWO batched bootstrap waves (all triples share the waves).

    triples: list of (a, b, c), each (B, L, n+1).  Returns
    [sum_i, maj_i] flattened — exact per bit column: a+b+c = s +
    2*maj; the caller places maj one bit position up (support
    tracking owns the shift and the mod-2^L truncation).
    """
    bsz = triples[0][0].shape[0]
    s, maj = _compress3(*(torch.cat([t[i] for t in triples], 0)
                          for i in range(3)), key)
    out = []
    for i in range(len(triples)):
        out.append(s[i * bsz:(i + 1) * bsz])
        out.append(maj[i * bsz:(i + 1) * bsz])  # weight: column + 1
    return out


def _mul_wallace(partials, key: DeviceCloudKey):
    """Wallace-tree product from precomputed partials: log-depth 3:2
    compression (2 batched waves per layer) + ONE parallel-prefix add
    — the latency multiplier.  partials (Wy, B, Wx, n+1), row i
    weighted 2^i; returns (B, Wx+Wy, n+1), exact mod 2^(Wx+Wy).
    """
    wy, bsz, wx, _ = partials.shape
    L = wx + wy

    # Dadda-style support tracking: every word carries its absolute
    # bit offset `lo`; a layer compresses each triple only over the
    # triple's union span (padded to the layer max for wave batching)
    # instead of the full 2W — statically-known-zero columns cost no
    # bootstraps
    def zpad(word, left, right):
        return torch.cat([_zeros((bsz, left), word, key), word,
                          _zeros((bsz, right), word, key)], dim=1)

    words = [(partials[i], i) for i in range(wy)]  # (tensor, lo)
    while len(words) > 2:
        words.sort(key=lambda t: t[1])
        g = len(words) // 3
        triples_meta = []
        span_max = 0
        for j in range(g):
            grp = words[3 * j:3 * j + 3]
            lo_g = min(t[1] for t in grp)
            hi_g = max(t[1] + t[0].shape[1] for t in grp)
            triples_meta.append((grp, lo_g))
            span_max = max(span_max, hi_g - lo_g)
        triples = [
            tuple(zpad(t[0], t[1] - lo_g,
                       span_max - (t[1] - lo_g) - t[0].shape[1])
                  for t in grp)
            for grp, lo_g in triples_meta
        ]
        outs = _compress3_words(triples, key)
        nxt = []
        for j, (grp, lo_g) in enumerate(triples_meta):
            s_w, c_w = outs[2 * j], outs[2 * j + 1]
            # columns past L drop (mod 2^L) — padded-to-layer-max
            # words of high-offset groups can stick out
            keep_s = min(span_max, L - lo_g)
            nxt.append((s_w[:, :keep_s, :], lo_g))
            # carry covers [lo_g+1, lo_g+1+span); truncate mod 2^L
            keep = min(span_max, L - (lo_g + 1))
            if keep > 0:
                nxt.append((c_w[:, :keep, :], lo_g + 1))
        words = nxt + words[3 * g:]
    full = [zpad(t, lo, L - lo - t.shape[1]) for t, lo in words]
    if len(full) == 1:
        return full[0]
    out, _ = kogge_stone_add(full[0], full[1], key,
                             carry_in=_zeros((bsz,), full[0], key))
    return out


def _kogge_count_fz(w: int) -> int:
    count, we, dist = 3 * w, w + 1, 1
    while dist < we:
        count += 3 * (we - dist)
        dist *= 2
    return count


def _wallace_bootstraps(wx: int, wy: int) -> int:
    """Per-lane bootstrap count of the Wallace latency multiply
    (partials + support-trimmed 3:2 layers + one prefix add), as the
    JAX package counts it: its words sort by (lo, hi) where
    :func:`_mul_wallace` sorts stably by lo alone, which is kept so
    that the two packages' gate accounting agrees."""
    L = wx + wy
    count = wx * wy
    words = [(i, i + wx) for i in range(wy)]
    while len(words) > 2:
        words.sort()
        g = len(words) // 3
        metas = []
        span_max = 0
        for j in range(g):
            grp = words[3 * j:3 * j + 3]
            lo_g = min(lo for lo, _ in grp)
            hi_g = max(hi for _, hi in grp)
            metas.append(lo_g)
            span_max = max(span_max, hi_g - lo_g)
        nxt = []
        for lo_g in metas:
            count += 3 * span_max      # xor + maj + xor per column
            nxt.append((lo_g, min(lo_g + span_max, L)))
            keep = min(span_max, L - (lo_g + 1))
            if keep > 0:
                nxt.append((lo_g + 1, lo_g + 1 + keep))
        words = nxt + words[3 * g:]
    if len(words) == 2:
        count += _kogge_count_fz(L)
    return count


def _one_word(x: torch.Tensor, key: DeviceCloudKey) -> torch.Tensor:
    """The trivial word 1 of x's shape (bit 0 set)."""
    b, w, _ = x.shape
    bits = torch.zeros((b, w), dtype=torch.int32, device=x.device)
    bits[:, 0] = 1
    return _const(bits, key)


def twos_complement(x, key: DeviceCloudKey):
    """-x over W bits: NOT(x) + 1 through the fused adder."""
    s, _ = _ripple_add_fused(-x, _one_word(x, key),
                             _zeros((x.shape[0],), x, key), key, adder_mode())
    return s


def add_then_sub(a, b_, c, key: DeviceCloudKey):
    """(a + b) - c (the reference's A+B-C flow) through the fused adder."""
    batch = a.shape[0]
    one_c = _const(torch.ones((batch,), dtype=torch.int32, device=a.device),
                   key)
    mode = adder_mode()
    ab, _ = _ripple_add_fused(a, b_, _zeros((batch,), a, key), key, mode)
    s, _ = _ripple_add_fused(ab, -c, one_c, key, mode)
    return s


def _mul_shift_matrices(w: int, ow: int, device=None) -> torch.Tensor:
    """Shift one-hots: for round i, matrix (OW, W) with [i+k, k] = 1."""
    mats = torch.zeros((w, ow, w), dtype=torch.int32, device=device)
    ar = torch.arange(w, device=device)
    for i in range(w):
        mats[i, i + ar, ar] = 1
    return mats


def _and_partial(xf, yi, w, key: DeviceCloudKey):
    """All W partial products x_k AND y_i as ONE bootstrap wave."""
    pre = xf + yi.repeat_interleave(w, dim=0)
    return _bootstrap_raw(_add_body(pre, key.params.n, -MU), key)


def _place_partial(partial, shift_onehot, n):
    """Scatter W partial-product bits into a 2W word at the round's
    offset; uncovered rows become trivial encryptions of 0 (body =
    -MU).  ``shift_onehot`` (OW, W) has at most one 1 per row, so the
    JAX package's selection matmul is a row gather here (an int32
    einsum does not run on CUDA)."""
    covered = shift_onehot.sum(dim=1).to(torch.int32)          # (OW,)
    src = shift_onehot.argmax(dim=1)
    shifted = partial[:, src, :] * covered[None, :, None]
    return _add_body(shifted, n, (1 - covered)[None, :] * -MU)


def schoolbook_mul_csa(x, y, key: DeviceCloudKey, latency: bool = False):
    """W x W -> 2W bit product via a *windowed* carry-save accumulator.

    A ripple-add of each shifted partial product into the accumulator
    is W rounds x a 2W-bit serial carry chain.  Here the accumulator is
    a redundant (sum, carry) pair and each round folds its partial in
    with ONE 3:2 compressor (no carry chain):

        maj  = sign(s + c + p)             (majority = carry bit)
        sum' = sign(s + c + p - 2·maj)     (parity fix-up)

    — the maj2 full-adder trick (`_adder_bit_step_maj2`) applied
    bit-parallel.  Round i's partial covers absolute bits [i, i+W)
    only, so the redundant state is a **W+1-bit sliding window**: the
    window's bottom bit receives its last contribution in round i and
    pops out FINAL each round, the window slides up one bit, and
    partials always land at window offset 0.  One W-bit carry-propagate
    add at the end resolves the remaining window.

    Totals: W² AND + 2·W·(W+1) compress + pb·W final-add bootstraps.

    ``latency=True``: every partial product is independent of every
    round, so ALL Wy*Wx ANDs run as ONE upfront bootstrap wave (3 -> 2
    serial waves per round), capped at 64k lanes so a huge batch falls
    back to the per-round wave (same bootstrap COUNT either way); the
    final add is the parallel-prefix adder; and at ``b*(W+1) <= 64``
    lanes, the wave-bound regime, the Wallace tree's log depth takes
    over (:func:`_mul_wallace`).
    """
    b, w, m = x.shape
    wy = y.shape[1]

    zero_col = _zeros((b, 1), x, key)
    win0 = _zeros((b, w + 1), x, key)
    xf = x.reshape(b * w, m)
    ys = y.movedim(1, 0)                       # (Wy, B, n+1)

    pre_all = latency and (b * w * wy) <= 65536
    if pre_all:
        pre = xf[None, :, :] + ys.repeat_interleave(w, dim=1)
        partials = _bootstrap_raw(
            _add_body(pre, key.params.n, -MU).reshape(wy * b * w, m), key
        ).reshape(wy, b, w, m)
        if b * (w + 1) <= 64:
            return _mul_wallace(partials, key)

    sw = cw = win0                             # (B, W+1, m) each
    low_bits = []
    for i in range(wy):
        if pre_all:
            partial = partials[i]
        else:
            partial = _and_partial(xf, ys[i], w, key).reshape(b, w, m)
        p = torch.cat([partial, zero_col], dim=1)
        tot = (sw + cw + p).reshape(b * (w + 1), m)  # {±3μ, ±μ}
        maj = _bootstrap_raw(tot, key)
        sum_ = _bootstrap_raw(tot - 2 * maj, key).reshape(b, w + 1, m)
        low_bits.append(sum_[:, 0, :])         # absolute bit i: FINAL
        # slide the window: sum' moves down one slot (bit i+1 becomes
        # the new bottom), maj lands one bit up == the same new slots
        sw = torch.cat([sum_[:, 1:, :], zero_col], dim=1)
        cw = maj.reshape(b, w + 1, m)

    low = torch.stack(low_bits, dim=1)         # (B, Wy, m): bits 0..
    zero_bit = _zeros((b,), x, key)
    # resolve the remaining window = absolute bits Wy..Wy+Wx (top
    # drops mod 2^(Wx+Wy)); latency mode uses the parallel-prefix
    # adder (O(log W) waves vs the W-serial ripple)
    if latency:
        hi, _ = kogge_stone_add(sw[:, :w, :], cw[:, :w, :], key,
                                carry_in=zero_bit)
    else:
        hi, _ = _ripple_add_fused(sw[:, :w, :], cw[:, :w, :], zero_bit, key,
                                  adder_mode())
    return torch.cat([low, hi], dim=1)


def _csa_bootstraps_xy(wx: int, wy: int, pb: int) -> int:
    """Windowed-CSA bootstraps for an ASYMMETRIC Wx x Wy -> Wx+Wy
    multiply: Wy rounds x (Wx ANDs + 2*(Wx+1) compress) + a Wx-bit
    final carry-propagate.  The circuit is width-asymmetric (rounds
    walk y's bits; the window is sized by x), so a 32x16 product costs
    about half a 32x32 one."""
    return wx * wy + 2 * wy * (wx + 1) + pb * wx


#: bootstraps per multiply lane, by mode (evaluator accounting);
#: pb = adder bootstraps/bit.  Symmetric W x W form; csa's asymmetric
#: form is :func:`_csa_bootstraps_xy`.
MUL_BOOTSTRAPS = {
    "csa": lambda w, pb: _csa_bootstraps_xy(w, w, pb),
    "shift": lambda w, pb: (1 + 2 * pb) * w * w,
}


def mul_mode() -> str:
    """Fused multiplier circuit: IEACHE_MUL=shift selects the
    reference-style shift-and-add accumulator; default csa
    (carry-save, ~W x lower serial depth)."""
    mode = os.environ.get("IEACHE_MUL", "csa")
    if mode not in MUL_BOOTSTRAPS:
        raise ValueError(f"IEACHE_MUL must be csa|shift, got {mode!r}")
    return mode


def schoolbook_mul_fused(x, y, key: DeviceCloudKey):
    """W x W -> 2W bit product, shift-and-add.

    Round i: AND partials (one B*W bootstrap) + 2W-bit accumulate add
    (the reference's mul32 pattern).
    """
    b, w, m = x.shape
    n = key.params.n
    ow = 2 * w

    zero_bit = _zeros((b,), x, key)
    acc = _zeros((b, ow), x, key)
    xf = x.reshape(b * w, m)
    shift_mats = _mul_shift_matrices(w, ow, x.device)
    mode = adder_mode()
    for i in range(w):
        partial = _and_partial(xf, y[:, i], w, key).reshape(b, w, m)
        shifted = _place_partial(partial, shift_mats[i], n)
        acc, _ = _ripple_add_fused(acc, shifted, zero_bit, key, mode)
    return acc
