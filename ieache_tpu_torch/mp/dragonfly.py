"""Dragonfly SAE (WPA3 / RFC 7664) password-authenticated key exchange.

The port's own copy of :mod:`ieache_tpu.mp.dragonfly` (a port peer and a
JAX-package peer derive the same PMK); its native scalar
multiplication comes from the port's :mod:`ieache_tpu_torch.native.lib`.

Single clean implementation of the protocol the reference duplicates
verbatim into every node (``Curve``/``Peer`` classes at
``/root/reference/Client1/dragonfly_private_client.py:126-526``,
``Cloud/dragonfly_cipher_cloud.py:89-490``,
``Output/output_dynamic.py:222-622`` etc.): hunting-and-pecking
password-element derivation over brainpoolP256t1, commit exchange
(scalar/element), shared-secret + SHA-256 confirm tokens, and the PMK.

Deviations from the reference (documented, deliberate):
* per-message secrets use ``secrets`` instead of time-seeded
  ``random`` (`dragonfly_private_client.py:343-347`);
* the FIPS-186-4-style KDF inside hunting-and-pecking is
  HMAC-SHA256-counter based instead of seeding Mersenne Twister with a
  string (`:475-516`) — both peers of this framework agree, and the
  reference's KDF was never interoperable with anything else;
* no ``eval()`` of network data (the reference parses received EC
  points with ``eval``, `dragonfly_private_client.py:602` — an RCE
  hole flagged in SURVEY Appendix A).
"""

from __future__ import annotations

import dataclasses
import hashlib
import hmac
import secrets

# brainpoolP256t1 (RFC 5639), as used at
# Client1/dragonfly_private_client.py:267-270
P = int("A9FB57DBA1EEA9BC3E660A909D838D726E3BF623D52620282013481D1F6E5377", 16)
A = int("7D5A0975FC2C3057EEF67530417AFFE7FB8055C126DC5C6CE94A4B44F330B5D9", 16)
B = int("26DC5C6CE94A4B44F330B5D9BBD77CBF958416295CF7E1CE6BCCDC18FF8C07B6", 16)
Q = int("A9FB57DBA1EEA9BC3E660A909D838D718C397AA3B561A6F7901E0E82974856A7", 16)

#: the reference's hardcoded network password
#: (`dragonfly_private_client.py:555`)
DEFAULT_PASSWORD = "abc1238"

O = None  # point at infinity


def _native_ec_mul():
    """ctypes handle to the C scalar multiplication (``ec.cc``, built
    by :mod:`ieache_tpu_torch.native.lib`), or None when the native lib
    is unavailable.  The C path releases
    the GIL, which is what makes the Keygen thread fan-out actually
    concurrent (the pure-Python double-and-add serialized every SAE in
    the process — VERDICT r4 weak #2); IEACHE_NATIVE_EC=0 disables."""
    import os

    if os.environ.get("IEACHE_NATIVE_EC", "1") == "0":
        return None
    global _EC_MUL
    if _EC_MUL is _UNSET:
        try:
            from ieache_tpu_torch.native import lib as _nlib

            _nlib.get_lib()
            _EC_MUL = _nlib.ec_mul
        except Exception:  # no compiler / build failure: pure Python
            _EC_MUL = None
    return _EC_MUL


_UNSET = object()
_EC_MUL = _UNSET


@dataclasses.dataclass(frozen=True)
class Point:
    x: int
    y: int

    def __iter__(self):
        return iter((self.x, self.y))

    def __getitem__(self, i):
        return (self.x, self.y)[i]


def legendre(a: int, p: int) -> int:
    return pow(a, (p - 1) // 2, p)


def tonelli_shanks(n: int, p: int) -> int:
    """Modular square root (n must be a QR mod p)."""
    if legendre(n, p) != 1:
        raise ValueError("not a square (mod p)")
    q, s = p - 1, 0
    while q % 2 == 0:
        q //= 2
        s += 1
    if s == 1:
        return pow(n, (p + 1) // 4, p)
    z = 2
    while legendre(z, p) != p - 1:
        z += 1
    c = pow(z, q, p)
    r = pow(n, (q + 1) // 2, p)
    t = pow(n, q, p)
    m = s
    while (t - 1) % p != 0:
        t2 = (t * t) % p
        i = 1
        while i < m:
            if (t2 - 1) % p == 0:
                break
            t2 = (t2 * t2) % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        r = (r * b) % p
        c = (b * b) % p
        t = (t * c) % p
        m = i
    return r


class Curve:
    """Short-Weierstrass group law over GF(p)."""

    def __init__(self, a: int = A, b: int = B, p: int = P):
        self.a, self.b, self.p = a, b, p

    def curve_equation(self, x: int) -> int:
        return (pow(x, 3, self.p) + self.a * x + self.b) % self.p

    def is_quadratic_residue(self, x: int) -> bool:
        return legendre(x, self.p) == 1

    def valid(self, pt) -> bool:
        if pt is O:
            return True
        return (
            0 <= pt.x < self.p
            and 0 <= pt.y < self.p
            and (pt.y * pt.y - self.curve_equation(pt.x)) % self.p == 0
        )

    def neg(self, pt):
        if pt is O:
            return O
        return Point(pt.x, (-pt.y) % self.p)

    def add(self, p1, p2):
        if not (self.valid(p1) and self.valid(p2)):
            raise ValueError("invalid point")
        if p1 is O:
            return p2
        if p2 is O:
            return p1
        if p2 == self.neg(p1):
            return O
        if p1 == p2:
            lam = (3 * p1.x * p1.x + self.a) * pow(2 * p1.y, self.p - 2,
                                                   self.p)
        else:
            lam = (p2.y - p1.y) * pow(p2.x - p1.x, self.p - 2, self.p)
        x = (lam * lam - p1.x - p2.x) % self.p
        y = (lam * (p1.x - x) - p1.y) % self.p
        return Point(x, y)

    def mul(self, scalar: int, pt):
        """Scalar multiplication — native C when available (default
        curve only; bit-identical, GIL-released), double-and-add in
        Python otherwise."""
        if not self.valid(pt):
            raise ValueError("invalid point")
        if (pt is not O and 0 <= scalar < (1 << 256)
                and (self.a, self.b, self.p) == (A, B, P)):
            native = _native_ec_mul()
            if native is not None:
                res = native(scalar, pt.x, pt.y)
                return O if res is None else Point(*res)
        result = O
        addend = pt
        while scalar:
            if scalar & 1:
                result = self.add(result, addend)
            addend = self.add(addend, addend)
            scalar >>= 1
        return result


def _kdf_bits(base: int, label: str, nbits: int) -> int:
    """HMAC-SHA256 counter-mode KDF -> nbits-wide integer."""
    key = base.to_bytes((base.bit_length() + 7) // 8 or 1, "big")
    out = b""
    counter = 0
    while len(out) * 8 < nbits:
        out += hmac.new(
            key, label.encode() + counter.to_bytes(4, "big"),
            hashlib.sha256,
        ).digest()
        counter += 1
    return int.from_bytes(out, "big") >> (len(out) * 8 - nbits)


class Peer:
    """One SAE participant (the reference's `Peer`, sans the RCE)."""

    def __init__(self, password: str = DEFAULT_PASSWORD,
                 mac_address: str = "", name: str = "peer"):
        self.password = password
        self.mac_address = mac_address
        self.name = name
        self.curve = Curve()
        self.p, self.q = P, Q
        self.pe = None
        self.k = None
        self.pmk = None

    # -- hunting and pecking (RFC 7664 §3.2.1;
    #    dragonfly_private_client.py:278-320) --------------------------
    def _hashed_password(self, other_mac: str, counter: int) -> int:
        maxm = max(self.mac_address, other_mac)
        minm = min(self.mac_address, other_mac)
        msg = f"{maxm}{minm}{self.password}{counter}".encode()
        return int.from_bytes(hashlib.sha256(msg).digest(), "big")

    def initiate(self, other_mac: str, k: int = 40):
        self.other_mac = other_mac
        n = self.p.bit_length() + 64
        x = None
        num_valid = 0
        for counter in range(1, k + 1):
            base = self._hashed_password(other_mac, counter)
            temp = _kdf_bits(base, "Dragonfly Hunting And Pecking", n)
            seed = (temp % (self.p - 1)) + 1
            val = self.curve.curve_equation(seed)
            if self.curve.is_quadratic_residue(val):
                if num_valid < 5:  # keep up to the 5th valid point
                    x = seed
                    num_valid += 1
        if x is None:
            raise RuntimeError(f"no valid point found after {k} iterations")
        y = tonelli_shanks(self.curve.curve_equation(x), self.p)
        self.pe = Point(x, y)
        assert self.curve.valid(self.pe)
        return self.pe

    # -- commit exchange (`:322-404`) ---------------------------------
    def commit_exchange(self):
        while True:
            self.private = secrets.randbelow(self.p - 1) + 1
            self.mask = secrets.randbelow(self.p - 1) + 1
            self.scalar = (self.private + self.mask) % self.q
            if self.scalar >= 2:
                break
        self.element = self.curve.neg(self.curve.mul(self.mask, self.pe))
        assert self.curve.valid(self.element)
        return self.scalar, self.element

    # -- shared secret + token (`:406-450`) ---------------------------
    def compute_shared_secret(self, peer_element, peer_scalar: int,
                              peer_mac: str) -> str:
        if (peer_scalar == self.scalar and peer_element == self.element):
            raise ValueError("reflection attack detected")
        if not self.curve.valid(peer_element):
            raise ValueError("peer element not on curve")
        self.peer_element = peer_element
        self.peer_scalar = peer_scalar
        self.peer_mac = peer_mac
        z = self.curve.mul(peer_scalar, self.pe)
        zz = self.curve.add(peer_element, z)
        k_point = self.curve.mul(self.private, zz)
        self.k = k_point.x
        own = (
            f"{self.k}{self.scalar}{self.peer_scalar}"
            f"{self.element.x}{self.peer_element.x}{self.mac_address}"
        ).encode()
        self.token = hashlib.sha256(own).hexdigest()
        return self.token

    # -- confirm exchange -> PMK (`:452-473`) -------------------------
    def confirm_exchange(self, peer_token: str) -> bytes:
        peer_msg = (
            f"{self.k}{self.peer_scalar}{self.scalar}"
            f"{self.peer_element.x}{self.element.x}{self.peer_mac}"
        ).encode()
        expected = hashlib.sha256(peer_msg).hexdigest()
        if peer_token != expected:
            raise ValueError("confirm token mismatch — wrong password?")
        pmk_msg = (
            f"{self.k}{(self.scalar + self.peer_scalar) % self.q}"
        ).encode()
        self.pmk = hashlib.sha256(pmk_msg).digest()
        return self.pmk


def handshake_pair(password: str = DEFAULT_PASSWORD,
                   mac_a: str = "02:00:00:00:00:01",
                   mac_b: str = "02:00:00:00:00:02"):
    """Run a full in-process SAE between two peers; returns (a, b)."""
    a = Peer(password, mac_a, "A")
    b = Peer(password, mac_b, "B")
    a.initiate(mac_b)
    b.initiate(mac_a)
    sa, ea = a.commit_exchange()
    sb, eb = b.commit_exchange()
    ta = a.compute_shared_secret(eb, sb, mac_b)
    tb = b.compute_shared_secret(ea, sa, mac_a)
    a.confirm_exchange(tb)
    b.confirm_exchange(ta)
    return a, b
