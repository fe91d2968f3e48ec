"""Host-precomputed structure for the GENERALIZED explicit time-sharded
layout: graded dyadic grids, arbitrary device counts, N_t not divisible
by P (SURVEY.md §4 "halo exchange / wavelet comm correctness under odd
rank counts and non-divisible N_t").

Layout. P devices, R = ceil(N/P). Device d stores trial slots 0..R =
global rows d*R .. d*R+R; rows past N are zero padding (masks keep them
exactly zero through every operator, so they never influence results).
Row d*R is duplicated on devices d-1 (slot R) and d (slot 0) — the same
permanently-valid ghost row as the aligned layout (parallel/explicit.py
module docstring), with the same bitwise twin invariant.

Wavelet transform. Each level's nodes are classified once on the host:

- LOCAL: the node's support triple (pl, mid, pr) lies inside one shard's
  closed slot range. Applied with per-device padded index/weight arrays
  (scatter ``mode='drop'`` on the padding entries); contributions that
  target the duplicated slots 0/R are routed through the same
  single-row boundary-increment ppermute exchange as the aligned path,
  accumulated in (left, right) order on both owners so twin rows stay
  bitwise identical. A local mid is always strictly interior
  (pl ≥ d*R < mid < pr ≤ d*R+R), so sets never touch a twin.
- GATHERED: the triple crosses a shard boundary (this includes every
  coarse level whose parents sit many shards away on graded grids, and
  the boundary-straddling fine nodes of unaligned uniform grids). Per
  level, each device all_gathers a small padded buffer of the triple
  rows it owns (plus the input-coefficient rows of owned mids for the
  synthesis direction); every device then computes the SAME updates
  redundantly and scatters them back to whichever of its slots hold
  copies — both copies of a duplicated row receive identical values in
  identical order, preserving the twin invariant without any further
  communication.

Ordering within a level matches the serial transform's semantics: all
reads (interpolation / old parent values) use the pre-level state — the
gathered send happens before any local update — and sets target level-j
mids while adds target strictly coarser rows, so the phases commute.
Float accumulation order differs from the serial np.add.at order by the
local/gathered grouping (reduction-order rounding, covered by the
rtol 1e-9 test budget, like the aligned path's psum dots).

Everything here is padded to device-uniform shapes so it can ride the
params pytree as sharded leaves ((P, k) arrays split over the 'time'
mesh axis) — shard_map requires one program for all devices.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class GeneralLevel:
    """One wavelet level's device-uniform arrays (see module docstring).

    Per-device arrays have leading axis P (sharded over 'time'); the
    g_* arrays are replicated. ``drop`` = R+1 (out of bounds for the
    (R+1)-slot local array → scatter mode='drop' ignores it).
    """

    # local phase
    lmid: np.ndarray  # (P, nl) scatter slot of created node (pad drop)
    lpl: np.ndarray  # (P, nl) gather slot of left parent (pad 0)
    lpr: np.ndarray  # (P, nl) right parent (pad 0)
    lwl: np.ndarray  # (P, nl) weights (pad 0)
    lwr: np.ndarray  # (P, nl)
    ls: np.ndarray  # (P, nl) L2 scales (pad 0)
    lpl_tgt: np.ndarray  # (P, nl) = lpl, but drop where slot in {0, R} / pad
    lpr_tgt: np.ndarray  # (P, nl)
    lpl_i0: np.ndarray  # (P, nl) 1 where lpl == 0 (increment masks)
    lpl_iR: np.ndarray  # (P, nl)
    lpr_i0: np.ndarray  # (P, nl)
    lpr_iR: np.ndarray  # (P, nl)
    # gathered phase
    send_v: np.ndarray  # (P, ns) slots of owned triple rows (pad 0)
    send_c: np.ndarray  # (P, nc) slots of owned mids, input-coeff rows
    g_mid: np.ndarray  # (ng,) position of mid value in the (P*ns) v-buffer
    g_pl: np.ndarray  # (ng,)
    g_pr: np.ndarray  # (ng,)
    g_c: np.ndarray  # (ng,) position of mid coeff in the (P*nc) c-buffer
    g_wl: np.ndarray  # (ng,)
    g_wr: np.ndarray  # (ng,)
    g_s: np.ndarray  # (ng,)
    set_slot: np.ndarray  # (P, nset) copies of gathered mids (pad drop)
    set_src: np.ndarray  # (P, nset) row in the new-mid block (pad 0)
    add_slot: np.ndarray  # (P, nadd) copies of gathered parents (pad drop)
    add_src: np.ndarray  # (P, nadd) row in concat([addL, addR]) (pad 0)

    @property
    def n_local(self) -> int:
        return self.lmid.shape[1]

    @property
    def n_gathered(self) -> int:
        return self.g_mid.shape[0]


@dataclasses.dataclass(frozen=True)
class GeneralLayout:
    P: int
    R: int
    N: int
    levels: tuple[GeneralLevel, ...]
    root_slot: np.ndarray  # (P, 2) slots holding copies of rows {0, N} (pad drop)
    root_scale: np.ndarray  # (P, 2)
    kx_lvl: tuple[np.ndarray, ...]  # per level 0..J: (P, cj) slots (pad drop)
    w_dot: np.ndarray  # (P*(R+1),) dot weights: every valid row once
    m_trial: np.ndarray  # (P*(R+1),) 1 iff the slot holds a real row
    mask_test: np.ndarray  # (P*R,) 1 iff the test row index is < N
    h_pad: np.ndarray  # (P*R,) time steps, padding = 1.0 (keeps 1/h finite)


def _owner(g: int, P: int, R: int) -> tuple[int, int]:
    """Designated (device, slot) providing row g's value (the left copy,
    except for the aligned final row which only exists as slot R)."""
    d = min(g // R, P - 1)
    return d, g - d * R


def _pad2(rows: list[list], width: int, fill) -> np.ndarray:
    out = np.full((len(rows), width), fill)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r
    return out


def build_general_layout(wt, P: int) -> GeneralLayout:
    """Precompute the generalized layout for WaveletTransform ``wt`` over
    ``P`` devices."""
    N = wt.grid.num_intervals
    R = -(-N // P)  # ceil
    drop = R + 1

    levels = []
    for lev in wt.levels:
        loc = [[] for _ in range(P)]  # per-device (mid, pl, pr, wl, wr, s)
        gath = []  # (mid, pl, pr, wl, wr, s)
        for k in range(lev.idx.size):
            mid, pl, pr = int(lev.idx[k]), int(lev.pl[k]), int(lev.pr[k])
            d = pl // R
            if d < P and pr - d * R <= R:
                loc[d].append(
                    (mid - d * R, pl - d * R, pr - d * R,
                     lev.wl[k], lev.wr[k], lev.s[k])
                )
            else:
                gath.append((mid, pl, pr, lev.wl[k], lev.wr[k], lev.s[k]))

        nl = max((len(r) for r in loc), default=0)
        lmid = _pad2([[e[0] for e in r] for r in loc], nl, drop)
        lpl = _pad2([[e[1] for e in r] for r in loc], nl, drop)
        lpr = _pad2([[e[2] for e in r] for r in loc], nl, drop)
        lwl = _pad2([[e[3] for e in r] for r in loc], nl, 0.0)
        lwr = _pad2([[e[4] for e in r] for r in loc], nl, 0.0)
        ls = _pad2([[e[5] for e in r] for r in loc], nl, 0.0)
        is_pad = lmid == drop
        bnd = lambda a: (a == 0) | (a == R)
        flt = lambda a: a.astype(float)
        lev_args = dict(
            lmid=lmid,
            lpl=np.where(is_pad, 0, lpl),
            lpr=np.where(is_pad, 0, lpr),
            lwl=flt(lwl), lwr=flt(lwr), ls=flt(ls),
            lpl_tgt=np.where(bnd(lpl) | is_pad, drop, lpl),
            lpr_tgt=np.where(bnd(lpr) | is_pad, drop, lpr),
            lpl_i0=flt((lpl == 0) & ~is_pad),
            lpl_iR=flt((lpl == R) & ~is_pad),
            lpr_i0=flt((lpr == 0) & ~is_pad),
            lpr_iR=flt((lpr == R) & ~is_pad),
        )

        # Gathered phase. v-buffer: every triple row once, provided by its
        # designated owner; c-buffer: each mid's input-coefficient row.
        v_rows = sorted({g for t in gath for g in t[:3]})
        c_rows = sorted({t[0] for t in gath})
        send_v_l = [[] for _ in range(P)]
        send_c_l = [[] for _ in range(P)]
        v_pos, c_pos = {}, {}
        for g in v_rows:
            d, slot = _owner(g, P, R)
            v_pos[g] = (d, len(send_v_l[d]))
            send_v_l[d].append(slot)
        for g in c_rows:
            d, slot = _owner(g, P, R)
            c_pos[g] = (d, len(send_c_l[d]))
            send_c_l[d].append(slot)
        ns = max((len(r) for r in send_v_l), default=0)
        nc = max((len(r) for r in send_c_l), default=0)
        vp = lambda g: v_pos[g][0] * ns + v_pos[g][1]
        cp = lambda g: c_pos[g][0] * nc + c_pos[g][1]

        ng = len(gath)
        g_mid = np.array([vp(t[0]) for t in gath], dtype=np.int64)
        g_pl = np.array([vp(t[1]) for t in gath], dtype=np.int64)
        g_pr = np.array([vp(t[2]) for t in gath], dtype=np.int64)
        g_c = np.array([cp(t[0]) for t in gath], dtype=np.int64)
        g_wl = np.array([t[3] for t in gath])
        g_wr = np.array([t[4] for t in gath])
        g_s = np.array([t[5] for t in gath])

        # Receive lists: every device slot holding a copy of an affected
        # row. Built in deterministic (node, side) order so twin copies
        # apply identical scatter sequences.
        set_l = [[] for _ in range(P)]  # (slot, src)
        add_l = [[] for _ in range(P)]
        for n, (mid, pl, pr, *_rest) in enumerate(gath):
            for d, slot in _copies(mid, P, R, N):
                set_l[d].append((slot, n))
            for d, slot in _copies(pl, P, R, N):
                add_l[d].append((slot, n))  # addL block: rows [0, ng)
            for d, slot in _copies(pr, P, R, N):
                add_l[d].append((slot, ng + n))  # addR block
        nset = max((len(r) for r in set_l), default=0)
        nadd = max((len(r) for r in add_l), default=0)
        levels.append(
            GeneralLevel(
                **lev_args,
                send_v=_pad2(send_v_l, ns, 0),
                send_c=_pad2(send_c_l, nc, 0),
                g_mid=g_mid, g_pl=g_pl, g_pr=g_pr, g_c=g_c,
                g_wl=g_wl, g_wr=g_wr, g_s=g_s,
                set_slot=_pad2([[e[0] for e in r] for r in set_l], nset, drop),
                set_src=_pad2([[e[1] for e in r] for r in set_l], nset, 0),
                add_slot=_pad2([[e[0] for e in r] for r in add_l], nadd, drop),
                add_src=_pad2([[e[1] for e in r] for r in add_l], nadd, 0),
            )
        )

    # Roots (the two level-0 nodes, rows 0 and N): scaled in place on
    # every copy.
    root_l = [[] for _ in range(P)]
    for g, sc in zip(wt.root_idx, wt.root_s):
        for d, slot in _copies(int(g), P, R, N):
            root_l[d].append((slot, float(sc)))
    root_slot = _pad2([[e[0] for e in r] for r in root_l], 2, drop)
    root_scale = _pad2([[e[1] for e in r] for r in root_l], 2, 0.0)

    # K_X levelwise selection: every valid slot (twins included — both
    # copies processed identically, no exchange needed) grouped by its
    # node's wavelet level.
    n_lvl = wt.num_levels + 1
    kx_l = [[[] for _ in range(P)] for _ in range(n_lvl)]
    for g in range(N + 1):
        j = int(wt.node_level[g])
        for d, slot in _copies(g, P, R, N):
            kx_l[j][d].append(slot)
    kx_lvl = tuple(
        _pad2(rows, max((len(r) for r in rows), default=0), drop)
        for rows in kx_l
    )

    # Dot weights: every valid row counted exactly once — at its slot
    # i < R owner, except the aligned final row N == P*R (slot R of the
    # last device only).
    w = np.zeros((P, R + 1))
    for d in range(P):
        for i in range(R):
            if d * R + i <= N:
                w[d, i] = 1.0
    if N == P * R:
        w[P - 1, R] = 1.0
    m_trial = np.zeros(P * (R + 1))
    for d in range(P):
        for i in range(R + 1):
            if d * R + i <= N:
                m_trial[d * (R + 1) + i] = 1.0
    mask_test = (np.arange(P * R) < N).astype(float)
    h_pad = np.ones(P * R)
    h_pad[:N] = wt.grid.h

    return GeneralLayout(
        P=P, R=R, N=N,
        levels=tuple(levels),
        root_slot=root_slot, root_scale=root_scale,
        kx_lvl=kx_lvl,
        w_dot=w.reshape(-1), m_trial=m_trial, mask_test=mask_test,
        h_pad=h_pad,
    )


def _copies(g: int, P: int, R: int, N: int):
    """All (device, slot) pairs holding a VALID copy of global row g
    (one, or two when g is a shard boundary with a real right shard)."""
    out = []
    d = g // R
    if d < P:
        out.append((d, g - d * R))
    if g % R == 0 and 0 < d <= P:  # d == P covers g == P*R: slot-R copy only
        out.append((d - 1, R))
    return out
