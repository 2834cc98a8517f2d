"""Times of the kernels on the tensor-core tile, by batch.

``external_product`` and ``external_product_tr`` (ms per call with the
accumulator fused), the rotations ``rot_diff_decompose``,
``rot_diff_decompose_tr`` and ``rotate_sublane`` (ms per call),
``cmux_step`` and ``cmux_step_overlap`` (ms per step; each the median of
three CUDA-graph replays of 50 calls) and ``blind_rotate_scan`` (ms per
whole rotation of n steps: the median of three runs of 3 calls between
CUDA events; any batch, e.g. 8, 16, 256 and 272 either side of where
its launch stops splitting a tile's sum, and 1024) at
``IEACHE_110_FAST`` or ``IEACHE_110`` on random operands from seed 0,
each first held against its plain twin (the scan kernel at batches up
to 16 only: its twin takes half a second a rotation).  One JSON line
with the card's name, power limit and clocks.  It is the yardstick for
a change to ``csrc/mma_tile.cuh`` or to the step kernels: run it on two
copies of the package within one call, and on a copy with a part of
the kernel taken out (the build of the byte planes, the MMAs, the
atomic adds, ``decompose_tile``; the scan kernel's grid barrier or its
decomposition) to see that part's share; such a copy computes garbage,
so ``TB_CHECK=0`` skips the comparison.  Beside the policies' picks it
also times the launch shapes they did not pick, through the uncounted
entry the wrappers launch by: at each step batch ``rot_diff_decompose``
at both run lengths (``rot_diff_decompose_launch_ms``, "run R"; the
policy's pick is ``ops/kernels.py:rot_launch``) and ``rotate_sublane``
by its slab and by its gather (``rotate_sublane_route_ms``; the pick is
``rot_tr_route``); at each scan batch the scan kernel at every other
split of a tile's sum and run of tiles a work item
(``blind_rotate_scan_launch_ms``, "split S, per_item P"; the pick is
``scan_launch``); at each product batch ``external_product`` in every form
and batch tile ``product_launch`` picks from, at its default split
(``external_product_launch_ms``, "mma" and "wgmma BN x T"; the pick is
``product_launch``); at each step batch ``cmux_step`` in every form, tile
and cluster ``step_launch`` picks from (``cmux_step_launch_ms``, "mma" and
"wgmma BN x T, cluster c"), and at each scan batch the scan kernel in the
other form too ("mma", "wgmma BN x T, cluster c"); and at each
keyswitch batch the keyswitch kernel (``csrc/keyswitch.cu``,
``keyswitch_ms``) and every other tile of ``keyswitch_launch_shapes`` at
its default split (``keyswitch_launch_ms``, "L lanes"; the pick is
``keyswitch_launch``); each held against its twin first.  Run from the root
of a checkout, on a CUDA device:

    python -m ieache_tpu_torch.tools.tile_bench

Env: TB_PRODUCT_B (comma list, default ``8,16,1024``), TB_STEP_B (the
two fused steps, the tr pair and the two rotations, ``8,16,1024``),
TB_SCAN_B (``8,1024``), TB_KS_B (the keyswitch, ``1,33,1024``),
TB_PARAMS (ieache_110_l2, ieache_110, or ieache_110_tfhe_compat: the
two-limb gadget, which only split's pair takes, so at it the step
batches time ``rot_diff_decompose`` alone and no scan runs),
TB_CHECK (1).
"""

from __future__ import annotations

import json
import os
import statistics
import sys

import numpy as np
import torch

from ieache_tpu_torch.ops import kernels, tile_models
from ieache_tpu_torch.ops import keyswitch as ksw
from ieache_tpu_torch.tools._common import (
    PARAMS,
    card_line,
    card_state,
    events_ms,
    graph_ms,
    require_cuda,
)

#: the largest batch at which the scan kernel is held against its twin
SCAN_CHECK_MAX_B = 16

def _rand(rng, shape, lo, hi, dtype, device):
    return torch.from_numpy(rng.randint(lo, hi, shape, dtype=np.int64)
                            .astype(dtype)).to(device)


def product_inputs(p, b: int, device, rng):
    """d (rows, B, N) int8, bk_i (rows, k+1, N), acc (k+1, B, N), rows
    the split kernels' ``kernels.digit_rows`` (a two-limb digit's high
    limb in [-2, 2], its key row ``kernels.limb_key``'s)."""
    rows = kernels.digit_rows(p)
    d = _rand(rng, (rows, b, p.N), -128, 128, np.int8, device)
    if p.digit_limbs != 1:
        d[1::2] = _rand(rng, (rows // 2, b, p.N), -2, 3, np.int8, device)
    bk_i = _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                 device)
    return (d, kernels.limb_key(bk_i, p),
            _rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device))


def scan_inputs(p, b: int, device, rng):
    """acc (k+1, B, N), bara (B, n), bk (n, rows, k+1, N)."""
    return (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device),
            _rand(rng, (b, p.n), 0, 2 * p.N, np.int32, device),
            _rand(rng, (p.n, p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31,
                  np.int32, device))


def step_inputs(p, b: int, device, rng):
    """acc (k+1, B, N), bara (B,), bk_i (rows, k+1, N)."""
    return (_rand(rng, (p.k + 1, b, p.N), -2**31, 2**31, np.int32, device),
            _rand(rng, (b,), 0, 2 * p.N, np.int32, device),
            _rand(rng, (p.trgsw_rows, p.k + 1, p.N), -2**31, 2**31, np.int32,
                  device))


def rotation_variants(p, acc, bara, acc_tr) -> dict:
    """The launch shapes :func:`run` times beside the policies' picks:
    name -> (kernel call, twin call), ``rot_diff_decompose`` by "run R"
    and ``rotate_sublane`` by "slab, splits s" and "gather".  On
    CUDA tensors each is an uncounted launch of the C entry point; on CPU
    tensors the plain model of that launch (``rot_diff_decompose_run_model``,
    ``rot_tr_slab_model``)."""
    kp1, b, n = acc.shape
    cuda = acc.is_cuda
    split = kernels.rot_diff_decompose_plain(acc, bara, p)
    sub = kernels.rotate_sublane_plain(acc_tr, bara)
    calls = {}
    for run in tile_models.ROT_RUNS:
        calls[f"rot_diff_decompose run {run}"] = (
            (lambda run=run: kernels._rot_diff_decompose_entry(
                "ieache_rot_diff_decompose", acc, bara, p, False, (run,)))
            if cuda else
            (lambda run=run: tile_models.rot_diff_decompose_run_model(
                acc, bara, p, run=run)),
            lambda: split)
    splits = kernels.rot_tr_splits(-(-b // kernels.TR_SLAB_LANES) * kp1, n)
    routes = {"gather": 0}
    if kernels.rot_tr_slab_bytes(n) <= kernels.SMEM_BLOCK_BYTES:
        routes[f"slab, splits {splits}"] = splits
    for name, route in routes.items():
        calls[f"rotate_sublane {name}"] = (
            (lambda route=route: kernels._rotate_entry(
                "ieache_rotate_sublane", acc_tr, bara, n, (route,)))
            if cuda else
            (lambda route=route: tile_models.rot_tr_slab_model(
                acc_tr, bara, splits=route)),
            lambda: sub)
    return calls


def product_launch_variants(p, b: int, sms: int = 132) -> dict:
    """The product's launch shapes :func:`run` times beside the policy's
    pick (``kernels.product_launch``) at batch ``b``: every shape of
    ``tile_models.product_launch_shapes`` but the pick's."""
    args = (b, p.k + 1, p.N, kernels.digit_rows(p), sms)
    pick = kernels.product_launch(*args)
    shapes = tile_models.product_launch_shapes(*args)
    return {name: launch for name, launch in shapes.items() if launch != pick}


def step_launch_variants(p, b: int, sms: int = 132, per_sm: int = 2,
                         resident=None) -> dict:
    """The fused step's launch shapes :func:`run` times beside the
    policy's pick (``kernels.step_launch`` on ``resident``, the occupancy
    query's clusters on the card) at batch ``b``: every shape of
    ``tile_models.step_launch_shapes`` but the pick's ("mma", "wgmma BN x T,
    cluster c")."""
    args = (b, p.k + 1, p.N, p.trgsw_rows, sms, per_sm)
    pick = kernels.step_launch(*args, resident)
    return {name: launch
            for name, launch in tile_models.step_launch_shapes(*args).items()
            if launch != pick}


def scan_launch_variants(p, b: int, sms: int = 132, per_sm: int = 2,
                         resident=None) -> dict:
    """The scan kernel's launch shapes :func:`run` times beside the
    policy's pick (``kernels.scan_launch``) at batch ``b``: every shape of
    ``tile_models.scan_launch_shapes`` but the pick ("mma", the mma.sync
    form's own, and "wgmma BN x T, cluster c"), and "split S, per_item P"
    -> ``kernels.scan_shape`` for every split S that divides a tile's (p,
    chunk) pairs and every run of P tiles, P a power of two up to the
    tiles of a row group, but the mma.sync form's own pick.  ``resident``
    is the wgmma form's (cluster, clusters held at once) pairs (the
    occupancy query's on the card)."""
    t = min(p.N, kernels.MMA_TILE_COLS)
    nchunks, group = p.trgsw_rows * (p.N // t), p.N // t * (p.k + 1)
    args = (b, p.k + 1, p.N, p.trgsw_rows, sms, per_sm)
    pick = kernels.scan_launch(*args, resident)
    forms = tile_models.scan_launch_shapes(*args, resident)
    shapes = {name: launch for name, launch in forms.items()
              if launch != pick}
    pick = forms["mma"]
    for split in (s for s in range(1, nchunks + 1) if nchunks % s == 0):
        per_item = 1
        while per_item <= group:
            launch = kernels.scan_shape(b, p.k + 1, p.N, split, per_item,
                                        sms * per_sm)
            if launch != pick:
                shapes[f"split {split}, per_item {per_item}"] = launch
            per_item *= 2
    return shapes


def keyswitch_inputs(p, b: int, device, rng):
    """A wave's sample-extracted ciphertexts (B, kN+1) int32 and a random
    key's packed limbs (4, kN·t, M) int8."""
    x = _rand(rng, (b, p.kN + 1), -2**31, 2**31, np.int32, device)
    ks = rng.randint(-2**31, 2**31, (p.kN * p.ks_t, p.n + 1),
                     dtype=np.int64).astype(np.int32)
    return x, ksw.pack_ks_limbs(ks, device)


def keyswitch_launch_variants(p, b: int, sms: int = 132) -> dict:
    """The keyswitch's launch shapes :func:`run` times beside the policy's
    pick (``kernels.keyswitch_launch``) at batch ``b``: every tile of
    ``tile_models.keyswitch_launch_shapes`` but the pick's."""
    pick = kernels.keyswitch_launch(b, p, sms)
    return {name: launch
            for name, launch in tile_models.keyswitch_launch_shapes(
                b, p, sms).items() if launch != pick}


def run(p, product_b, scan_b, device, check: bool = True,
        timed: bool = True, step_b=(), ks_b=()) -> dict:
    """The record: ``external_product_ms`` and its launch variants
    (:func:`product_launch_variants`, ``external_product_launch_ms``;
    on CPU tensors through each form's plain model),
    ``cmux_step_ms`` and its launch variants
    (:func:`step_launch_variants`, ``cmux_step_launch_ms``),
    ``cmux_step_overlap_ms``, ``blind_rotate_scan_ms``,
    ``rot_diff_decompose_ms``, ``rot_diff_decompose_tr_ms``,
    ``external_product_tr_ms`` and ``rotate_sublane_ms`` by batch, and
    the launch variants of :func:`rotation_variants`
    (``rot_diff_decompose_launch_ms``, ``rotate_sublane_route_ms``) and
    of :func:`scan_launch_variants` (``blind_rotate_scan_launch_ms``;
    on CPU tensors their schedule models are checked), and the keyswitch
    at ``ks_b`` (``keyswitch_ms``) and its launch variants
    (:func:`keyswitch_launch_variants`, ``keyswitch_launch_ms``; on CPU
    tensors its plain model).
    ``check`` holds each kernel against its twin first and raises where
    they differ; ``timed=False`` (the CPU rehearsal) only checks.  Where
    ``p``'s digits take two limbs, only split's pair runs:
    ``rot_diff_decompose`` at the step batches, no scan."""
    rng = np.random.RandomState(0)
    rec = {"params": p.name, "external_product_ms": {}, "cmux_step_ms": {},
           "cmux_step_launch_ms": {},
           "cmux_step_overlap_ms": {}, "blind_rotate_scan_ms": {},
           "rot_diff_decompose_ms": {}, "rot_diff_decompose_tr_ms": {},
           "external_product_tr_ms": {}, "rotate_sublane_ms": {},
           "rot_diff_decompose_launch_ms": {}, "rotate_sublane_route_ms": {},
           "blind_rotate_scan_launch_ms": {}, "external_product_launch_ms": {},
           "keyswitch_ms": {}, "keyswitch_launch_ms": {}}
    for b in product_b:
        d, bk_i, acc = product_inputs(p, b, device, rng)
        if check and not torch.equal(
                kernels.external_product(d, bk_i, p, acc=acc),
                kernels.external_product_plain(d, bk_i, p, acc)):
            raise AssertionError(f"external_product differs from its twin "
                                 f"at B={b}")
        if timed:
            rec["external_product_ms"][b] = statistics.median(
                graph_ms(lambda: kernels.external_product(d, bk_i, p,
                                                          acc=acc), 50)
                for _ in range(3))
        sms = kernels._sm_count(device) if device.type == "cuda" else 132
        want = kernels.external_product_plain(d, bk_i, p, acc)
        for name, launch in product_launch_variants(p, b, sms).items():
            call = (lambda launch=launch: tile_models.external_product_as(
                d, bk_i, p, acc, launch))
            if check and not torch.equal(call(), want):
                raise AssertionError(f"external_product ({name}) differs "
                                     f"from its twin at B={b}")
            if timed:
                rec["external_product_launch_ms"].setdefault(b, {})[name] = \
                    statistics.median(graph_ms(call, 50) for _ in range(3))
    single = p.digit_limbs == 1
    for b in step_b:
        acc, bara, bk_i = step_inputs(p, b, device, rng)
        if not single:
            kern = (lambda: kernels.rot_diff_decompose(acc, bara, p))
            if check and not torch.equal(
                    kern(), kernels.rot_diff_decompose_plain(acc, bara, p)):
                raise AssertionError(f"rot_diff_decompose differs from its "
                                     f"twin at B={b}")
            if timed:
                rec["rot_diff_decompose_ms"][b] = statistics.median(
                    graph_ms(kern, 50) for _ in range(3))
            continue
        acc_tr = acc.transpose(1, 2).contiguous()            # (k+1, N, B)
        d_tr = kernels.rot_diff_decompose_tr_plain(acc_tr, bara, p)
        calls = {
            "rot_diff_decompose": (
                lambda: kernels.rot_diff_decompose(acc, bara, p),
                lambda: kernels.rot_diff_decompose_plain(acc, bara, p)),
            "cmux_step": (lambda: kernels.cmux_step(acc, bara, bk_i, p),
                          lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
            "cmux_step_overlap": (
                lambda: kernels.cmux_step_overlap(acc, bara, bk_i, p),
                lambda: kernels.cmux_step_plain(acc, bara, bk_i, p)),
            "rot_diff_decompose_tr": (
                lambda: kernels.rot_diff_decompose_tr(acc_tr, bara, p),
                lambda: d_tr),
            "external_product_tr": (
                lambda: kernels.external_product_tr(d_tr, bk_i, p,
                                                    acc=acc_tr),
                lambda: kernels.external_product_tr_plain(d_tr, bk_i, p,
                                                          acc_tr)),
            "rotate_sublane": (
                lambda: kernels.rotate_sublane(acc_tr, bara),
                lambda: kernels.rotate_sublane_plain(acc_tr, bara))}
        variants = rotation_variants(p, acc, bara, acc_tr)
        sms, per_sm, resident = (
            (kernels._sm_count(device),
             kernels._step_per_sm(device, p.trgsw_rows, p.N),
             kernels._wgmma_resident(device, "cmux_step", p.trgsw_rows,
                                     p.k + 1, p.N))
            if device.type == "cuda" else (132, 2, None))
        for name, launch in step_launch_variants(p, b, sms, per_sm,
                                                 resident).items():
            variants[f"cmux_step {name}"] = (
                lambda launch=launch: tile_models.cmux_step_as(
                    acc, bara, bk_i, p, launch),
                calls["cmux_step"][1])
        for name, (kern, plain) in {**calls, **variants}.items():
            if check and not torch.equal(kern(), plain()):
                raise AssertionError(f"{name} differs from its twin at "
                                     f"B={b}")
            if not timed:
                continue
            ms = statistics.median(graph_ms(kern, 50) for _ in range(3))
            if name in calls:
                rec[name + "_ms"][b] = ms
            else:
                kernel, shape = name.split(" ", 1)
                key = {"rot_diff_decompose": "rot_diff_decompose_launch_ms",
                       "cmux_step": "cmux_step_launch_ms",
                       "rotate_sublane": "rotate_sublane_route_ms"}[kernel]
                rec[key].setdefault(b, {})[shape] = ms
    for b in scan_b if single else ():
        acc, bara, bk = scan_inputs(p, b, device, rng)
        calls = {None: lambda: kernels.blind_rotate_scan(acc, bara, bk, p)}
        cuda = device.type == "cuda"
        sms, per_sm = ((kernels._sm_count(device),
                        kernels._scan_per_sm(device, p.trgsw_rows, p.N))
                       if cuda else (132, 2))
        resident = (kernels._wgmma_resident(
            device, "blind_rotate_scan", p.trgsw_rows, p.k + 1, p.N)
            if cuda else None)
        for name, launch in scan_launch_variants(p, b, sms, per_sm,
                                                 resident).items():
            calls[name] = (
                lambda launch=launch: tile_models.blind_rotate_scan_as(
                    acc, bara, bk, p, launch))
        want = (kernels.blind_rotate_scan_plain(acc, bara, bk, p)
                if check and b <= SCAN_CHECK_MAX_B else None)
        for name, call in calls.items():
            if want is not None and not torch.equal(call(), want):
                raise AssertionError(f"blind_rotate_scan ({name or 'policy'})"
                                     f" differs from its twin at B={b}")
            if not timed:
                continue
            ms = statistics.median(events_ms(call, 3) for _ in range(3))
            if name is None:
                rec["blind_rotate_scan_ms"][b] = ms
            else:
                rec["blind_rotate_scan_launch_ms"].setdefault(b, {})[name] = ms
    for b in ks_b:
        x, limbs = keyswitch_inputs(p, b, device, rng)
        sms = kernels._sm_count(device) if device.type == "cuda" else 132
        want = ksw.keyswitch_plain(x, limbs, p) if check else None
        calls = {None: lambda: ksw.keyswitch(x, limbs, p)}
        for name, launch in keyswitch_launch_variants(p, b, sms).items():
            calls[name] = (lambda launch=launch: tile_models.keyswitch_as(
                x, limbs, p, launch))
        for name, call in calls.items():
            if check and not torch.equal(call(), want):
                raise AssertionError(f"keyswitch ({name or 'policy'}) "
                                     f"differs from its twin at B={b}")
            if not timed:
                continue
            ms = statistics.median(graph_ms(call, 50) for _ in range(3))
            if name is None:
                rec["keyswitch_ms"][b] = ms
            else:
                rec["keyswitch_launch_ms"].setdefault(b, {})[name] = ms
    return rec


def main() -> int:
    device = require_cuda("tile_bench")

    def env(name, default):
        return os.environ.get("TB_" + name, default)

    def batches(name, default):
        return [int(x) for x in env(name, default).split(",") if x.strip()]

    rec = run(PARAMS[env("PARAMS", "ieache_110_l2")],
              batches("PRODUCT_B", "8,16,1024"), batches("SCAN_B", "8,1024"),
              device, check=env("CHECK", "1") != "0",
              step_b=batches("STEP_B", "8,16,1024"),
              ks_b=batches("KS_B", "1,33,1024"))
    print(json.dumps({**rec, "device": torch.cuda.get_device_name(device),
                      "card": card_line(), "card_state": card_state()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
