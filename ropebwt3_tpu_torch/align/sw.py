"""sw on the card: the BWA-SW scoring DP over each read's prefix DAWG, many
reads a launch.

Port of ropebwt3_tpu/align/sw_jax.py.  For W reads, each given as its DAWG
(node_c (W, NC) edge symbols, pre (W, NC, P) predecessor ids with -1 after
the last, n_node (W,)), the DP of sw_core (bwa-sw.c:329-526) gives every
node's top-n_best row as archive words (sw_jax.py `_pack_arch`), best_sc and
best_pos (the first row cell of the best score, bwa-sw.c:489-490), and a
`bad` flag for the reads whose DP leaves what this formulation represents
exactly: a khashl table that would resize, a stack or fpar overflow, the
E-type H_from_pos corner, a score past 12 bits, a length past 9, closure
cells left after 1024 rounds (sw_jax.py's module note and hapdiv_jax.py's
say why each is exact otherwise).  One more flag is the port's own: an F
offset past 31 (n_best > 32), which the 5-bit field of the archive word
cannot hold.  A flagged read's best_sc and best_pos are 0.

The archive of the W reads is flat: read w's rows are rows
arch_rows(n_node)[w] .. [w + 1] of (T, n_best) arrays arch_lo, arch_hi,
arch_rc (uint32 bits as int32) and arch_w (int64), one row a node, the
root's first.

`sw_plain` is the plain PyTorch version: sw_device transliterated,
lock-step over the W reads as hapdiv_plain is (align/hapdiv.py, whose
khashl hash, geometry and gather it shares), every clamp explicit.  It is
the CPU path and the reference the kernel is held against.  `sw_cuda` wraps
the kernel of csrc/sw.cu (one warp a read).  `SwDeviceEngine` is the CLI's
engine: the native staging, the kernel, the native finish, and the reads
the card does not take or flags rerun on the native engine.
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..ops.rank import OccIndex, extend
from .bwasw import (RB3_SWF_HAPDIV, SwOpt, _attach_positions_multi, flat_reads, rb3_sw_batch, sw_finish,
                    sw_stage)
from .hapdiv import (BIG, FCAP, FROM_E, FROM_EXT, FROM_F, FROM_H, FROM_OPEN, KEY_EMPTY, KEY_HUGE, N_BEST, PNONE,
                     ROUND_CAP, SCAP, U32, UNSET, _gather, _home_bucket, _shr, nb_params)

P_MAX = 6  # the largest DAWG in-degree the card takes (sw_jax.py:68)
NC_MAX = 384  # the most DAWG nodes the card takes (sw_jax.py:652, the largest NC bucket)
MAX_SCORE, MAX_LEN = 4095, 510  # the 12-bit score and 9-bit length fields (sw_jax.py:261)
LANES = 4096  # reads a launch: the archive and the carried rows take ~48 B a cell
# sw_plain's bucket table: one int64 row of these fields a bucket, and the
# row of an empty bucket
T_KEY, T_H, T_E, T_F, T_Q, T_RL, T_HF, T_EF, T_FF, T_HPOS, T_EPOS, T_FOFF, T_LORC = range(13)
_EMPTY = [KEY_EMPTY, 0, 0, 0, 0, 0, 0, 0, 0, PNONE, PNONE, UNSET, 0]


def pack_arch(valid, H, Hf, Ef, Ff, Fos, Foffr, Hpos, Epos) -> torch.Tensor:
    """The archive word (sw_jax.py `_pack_arch`): valid(1) H(12) Hf(2) Ef(1)
    Ff(1) Fos(1) Foffr(5) Hpos(16) Epos(16), int64."""
    return (valid.long() | H << 1 | Hf << 13 | Ef << 15 | Ff << 16 | Fos << 17 | Foffr << 18 | (Hpos & 0xFFFF) << 23
            | (Epos & 0xFFFF) << 39)


def arch_rows(n_node: torch.Tensor) -> torch.Tensor:
    """(W + 1,) int64: read w's archive rows are [out[w], out[w + 1])."""
    out = torch.zeros(n_node.numel() + 1, dtype=torch.int64, device=n_node.device)
    torch.cumsum(n_node.long(), 0, out=out[1:])
    return out


def _before(m: torch.Tensor) -> torch.Tensor:
    """How many of m's entries before each are set, along dim 1."""
    m = m.long()
    return m.cumsum(1) - m


def _check(idx: OccIndex, node_c: torch.Tensor, pre: torch.Tensor, n_node: torch.Tensor, n_best: int) -> None:
    W, NC = node_c.shape if node_c.dim() == 2 else (-1, -1)
    if not (pre.dim() == 3 and pre.shape[:2] == (W, NC) and n_node.shape == (W,)
            and node_c.dtype == pre.dtype == n_node.dtype == torch.int32):
        raise ValueError("sw takes node_c (W, NC), pre (W, NC, P) and n_node (W,), int32")
    if not (node_c.device == pre.device == n_node.device == idx.device):
        raise ValueError("sw: the DAWGs must be on the index's device")
    if not (2 <= n_best <= SCAP and idx.n < (1 << 32) and 1 <= pre.shape[2] <= P_MAX and NC <= NC_MAX):
        raise ValueError(f"sw: n_best {n_best} (2..{SCAP}), P {pre.shape[2]} (1..{P_MAX}), NC {NC} (..{NC_MAX}) and "
                         f"n {idx.n} (< 2^32) out of range")
    if W and not (int(n_node.min()) >= 1 and int(n_node.max()) <= NC
                  and bool(((pre >= -1) & (pre < torch.arange(NC, device=pre.device)[None, :, None])).all())
                  and bool(((node_c >= 0) & (node_c <= 5)).all())):
        raise ValueError("sw: n_node outside 1..NC, a predecessor not before its node, or a symbol outside 0..5")


def sw_plain(idx: OccIndex, node_c: torch.Tensor, pre: torch.Tensor, n_node: torch.Tensor, n_best: int = N_BEST,
             min_sc: int = 30, end_len: int = 11, match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2,
             trips: bool = False):
    """sw_device (sw_jax.py:122-606) in plain PyTorch, lock-step over the
    reads' DAWGs on the index's device.  Returns (arch_lo, arch_hi, arch_rc
    (T, n_best) int32, arch_w (T, n_best) int64, best_sc, best_pos (W,)
    int32, bad (W,) bool); an invalid cell's words are 0.  min_sc is not
    read (the finish applies it), as in sw_device.  With `trips` also each
    read's dependent extend rounds (W,) int32: one a node and one a closure
    pop, as the kernel counts them on every read not flagged."""
    _check(idx, node_c, pre, n_node, n_best)
    dev = node_c.device
    W, NC = node_c.shape
    P, N = pre.shape[2], n_best
    PN, S = pre.shape[2] * n_best, 6 * pre.shape[2] * n_best
    nb_bits, NB_, MAXC_ = nb_params(N)
    maxpen = max(gap_open + gap_ext, mis)
    acc = idx.acc.long()
    i64 = dict(dtype=torch.int64, device=dev)
    iota_n = torch.arange(N, **i64)[None, :]
    iota_nb = torch.arange(NB_, **i64)[None, :]
    iota_sc = torch.arange(SCAP, **i64)[None, :]
    iota_pn = torch.arange(PN, **i64)[None, :]
    wrow = torch.arange(W, **i64)
    nn = n_node.long()
    pre_l = pre.long()
    cn_all = node_c.long()

    # the carried rows of every node; the root row is one cell, the whole BWT
    rows = {f: torch.zeros((W, NC, N), **i64) for f in ("lo", "hi", "lorc", "H", "E", "rlen", "qlen")}
    rows["hi"][:, 0, 0] = acc[6]
    rvalid = torch.zeros((W, NC, N), dtype=torch.bool, device=dev)
    rvalid[:, 0, 0] = True
    arch = {f: torch.zeros((W, NC, N), **i64) for f in ("lo", "hi", "rc", "w")}
    arch["hi"][:, 0, 0] = acc[6]
    zero = torch.zeros((), **i64)
    arch["w"][:, 0, 0] = pack_arch(torch.ones((), dtype=torch.bool), zero, zero, zero, zero, zero, zero + 31, zero,
                                   zero + PNONE)
    lastp_q = torch.zeros(W, **i64)  # w.last_p dangles across nodes
    best_sc = torch.zeros(W, **i64)
    best_pos = torch.zeros(W, **i64)
    bad = torch.zeros(W, dtype=torch.bool, device=dev)
    n_trips = torch.zeros(W, **i64)
    ones_w = torch.ones(W, dtype=torch.bool, device=dev)
    slot6 = torch.arange(6, **i64)  # candidate slot of a cell: H-cands c = 1..5, then the E slot
    is_e = (slot6 == 5)[None, None, :]
    sym_c = (slot6 + 1).clamp(max=5)[None, None, :]

    for node in range(1, NC):
        live = node < nn
        if not bool(live.any()):
            break
        c_node = cn_all[:, node]
        n_trips += live & ~bad

        # ---- the predecessor cells, slot order pre x cell ------------------
        pres = pre_l[:, node]  # (W, P)
        pre_ok = pres >= 0
        pid = pres.clamp(min=0)
        p = {f: v[wrow[:, None], pid].reshape(W, PN) for f, v in rows.items()}
        pvalid = (rvalid[wrow[:, None], pid] & pre_ok[..., None] & live[:, None, None]).reshape(W, PN)

        # ---- w.last_p: the last visited cell, visited even when pruned ------
        lp = torch.where(pvalid, iota_pn, -1).amax(1)
        lastp_q = torch.where(lp >= 0, _gather(p["qlen"], lp.clamp(min=0)), lastp_q)
        gate_f = lastp_q >= end_len

        # ---- ks_ksmall prune (bwa-sw.c:366-376) ------------------------------
        n_pre = pre_ok.sum(1)
        n_cell = pvalid.sum(1)
        if PN > N:
            kth = torch.sort(torch.where(pvalid, p["H"], -1), dim=1, descending=True)[0][:, N]
        else:
            kth = torch.zeros(W, **i64)
        mms = torch.where((n_pre > 1) & (n_cell > N), kth, 0)
        mms = torch.where(n_pre > 1, (mms - maxpen).clamp(min=0), 0)
        clive = pvalid & (p["H"] + match >= mms[:, None])

        # ---- one extend of every predecessor cell ---------------------------
        ik = torch.stack([p["lo"], p["lorc"], torch.where(pvalid, p["hi"] - p["lo"], 0)], -1)
        ok = extend(idx, ik.reshape(W * PN, 3), torch.ones(W * PN, dtype=torch.bool, device=dev)).reshape(W, PN, 6, 3)
        ok16 = torch.cat([ok[:, :, 1:6], ok[:, :, 5:6]], 2)  # slots: c = 1..5, then the E slot (c = 5's, unused)
        e_lo, e_rc, e_sz = ok16[..., 0], ok16[..., 1], ok16[..., 2]

        # ---- candidate slots (insert order: pre slot, cell, c = 1..5, E) ---
        pH, pE, pq, prl = (p[f][..., None] for f in ("H", "E", "qlen", "rlen"))
        cl = clive[..., None]
        mm = mms[:, None, None]
        c_n = c_node[:, None, None]
        sc = torch.where((sym_c == c_n) & (sym_c != 5), match, -mis)
        h_pass = cl & ~is_e & (e_sz > 0) & (pH + sc > 0) & (pH + sc >= mm) & ((sym_c == c_n) | (pq >= end_len))
        # the E slot's stale lo_rc: that of the cell's last passing H-cand
        # (bwa-sw.c:418 sets only lo/hi on the E path), 0 if none
        last_c = torch.where(h_pass[..., :5], slot6[:5] + 1, 0).amax(2)
        stale_rc = torch.where(last_c > 0, ok[:, :, 1:6, 1].gather(2, (last_c - 1).clamp(min=0)[..., None])[..., 0], 0)
        e_open = pH - gap_open > pE
        e_val = torch.where(e_open, pH - gap_open, pE) - gap_ext
        e_pass = cl & is_e & (e_val > 0) & (e_val >= mm) & (pq >= end_len)
        cvalid = (h_pass | e_pass).reshape(W, S)
        lo_s = torch.where(is_e, p["lo"][..., None], e_lo)
        hi_s = torch.where(is_e, p["hi"][..., None], e_lo + e_sz)
        gpos = (pid[..., None] * N + iota_n[:, None, :]).reshape(W, PN)[..., None]  # bwa-sw.c:393
        cand = {
            "key": torch.where(cvalid, ((lo_s << 32) | hi_s).reshape(W, S), KEY_HUGE),
            "lorc": torch.where(is_e, stale_rc[..., None], e_rc),
            "H": torch.where(is_e, e_val, pH + sc),
            "E": torch.where(is_e, e_val, 0),
            "qlen": (pq + 1).expand(W, PN, 6),
            "rlen": torch.where(is_e, prl, prl + 1),
            "Hf": torch.where(is_e, FROM_E, FROM_H).expand(W, PN, 6),
            "Ef": torch.where(is_e, torch.where(e_open, FROM_OPEN, FROM_EXT), 0),
            "Hpos": torch.where(is_e, PNONE, gpos),
            "Epos": torch.where(is_e, gpos, PNONE),
        }
        cand = {k: v.reshape(W, S) for k, v in cand.items()}
        # the packed words' fields: 12-bit scores, 9-bit lengths
        bad = bad | (cvalid & ((cand["H"] > MAX_SCORE) | (cand["rlen"] > MAX_LEN) | (cand["qlen"] > MAX_LEN))).any(1)

        # ---- sorted-segment merge (sw_update_candset's running maxes) ------
        key_s, slot_s = torch.sort(cand["key"], dim=1, stable=True)
        cs = {k: v.gather(1, slot_s) for k, v in cand.items() if k != "key"}
        valid_s = key_s != KEY_HUGE
        head = torch.ones_like(valid_s)
        head[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        seg = (torch.cumsum(head.long(), 1) - 1 + wrow[:, None] * S).reshape(-1)
        spos = torch.arange(S, **i64).expand(W, S).reshape(-1)

        def seg_reduce(v, how):
            out = torch.full((W * S,), BIG if how == "amin" else -BIG, **i64)
            return out.scatter_reduce(0, seg, v.reshape(-1), how)[seg].reshape(W, S)

        def first_max(v):
            """Per element: its segment's max of v and the position of its
            first attainment (ties keep the earlier slot, as the strict `<`
            merges of sw_update_candset do)."""
            m = seg_reduce(v, "amax")
            at = seg_reduce(torch.where(v.reshape(-1) == m.reshape(-1), spos, BIG), "amin")
            return m, at

        mH, aH = first_max(cs["H"])
        mE, aE = first_max(cs["E"])
        hstart = aH == seg_reduce(spos, "amin")
        hf = cs["Hf"].gather(1, aH)
        # first attainment past the head by an E-type candidate: the host's
        # H_from_pos would need the event chain (flagged)
        bad = bad | (head & valid_s & ~hstart & (hf == FROM_E)).any(1)
        gHpos = torch.where(hstart, cs["Hpos"], cs["Hpos"].gather(1, aH))  # read at the head below

        # unique keys in first-occurrence (khashl insert) order
        usrc = torch.where(head & valid_s, slot_s, BIG)
        usrc, uorder = torch.sort(usrc, dim=1, stable=True)
        u_valid = usrc != BIG
        u = {"key": key_s, "H": mH, "E": mE, "qlen": seg_reduce(cs["qlen"], "amax"),
             "rlen": seg_reduce(cs["rlen"], "amax"), "Hf": hf, "Ef": cs["Ef"].gather(1, aE), "Hpos": gHpos,
             "Epos": cs["Epos"].gather(1, aE), "lorc": cs["lorc"]}
        u = {k: v.gather(1, uorder) for k, v in u.items()}
        u_count = u_valid.sum(1)
        bad = bad | (u_count >= MAXC_)

        # ---- khashl bucket of each unique key, in insert order -------------
        home = _home_bucket(u["key"], nb_bits)
        used = torch.zeros((W, NB_), dtype=torch.bool, device=dev)
        u_bucket = torch.zeros((W, S), **i64)
        for j in range(min(S, MAXC_ - 1)):
            act = (j < u_count) & ~bad
            if not bool(act.any()):
                break
            d = (iota_nb - home[:, j : j + 1]) & (NB_ - 1)
            b = torch.where(used, BIG, d).argmin(1)
            used |= act[:, None] & (iota_nb == b[:, None])
            u_bucket[:, j] = b

        # ---- the bucket table: one row of the T_* fields a bucket ---------
        tab = torch.tensor(_EMPTY, **i64).repeat(W, NB_, 1)
        put = u_valid & ~bad[:, None]
        w_put, j_put = put.nonzero(as_tuple=True)
        zero_u, unset = torch.zeros_like(u["key"]), torch.full_like(u["key"], UNSET)
        urow = torch.stack([u["key"], u["H"], u["E"], zero_u, u["qlen"], u["rlen"], u["Hf"], u["Ef"], zero_u,
                            u["Hpos"], u["Epos"], unset, u["lorc"]], -1)
        tab[w_put, u_bucket[w_put, j_put]] = urow[w_put, j_put]
        count = torch.where(bad, 0, u_count)

        def topn():
            """The N best occupied buckets by (H << 32 | bucket), descending."""
            x = torch.where(tab[..., T_KEY] != KEY_EMPTY, (tab[..., T_H] << 32) | iota_nb, -1)
            return torch.sort(x, dim=1, descending=True)[0][:, :N]

        row_x = topn()

        # ---- F-closure (bwa-sw.c:445-483) -----------------------------------
        heap = row_x.flip(1)  # the bounded min-heap's values, ascending; -1 = empty
        hlen = (row_x >= 0).sum(1)
        # the stack starts with the row's cells, the best on top; an entry
        # is (lo, hi, lorc, H, F, qlen, rlen)
        elig = (row_x >= 0) & ((row_x >> 32) > gap_open + gap_ext) & gate_f[:, None] & ~bad[:, None]
        slot_of = elig.flip(1).long().cumsum(1).flip(1) - elig.long()
        stack = torch.zeros((W, SCAP, 7), **i64)
        w_el, j_el = elig.nonzero(as_tuple=True)
        te = tab[w_el, row_x[w_el, j_el] & U32]
        stack[w_el, slot_of[w_el, j_el]] = torch.stack(
            [_shr(te[:, T_KEY], 32), te[:, T_KEY] & U32, te[:, T_LORC], te[:, T_H], te[:, T_F], te[:, T_Q],
             te[:, T_RL]], -1)
        sp = elig.sum(1)
        fpar = torch.full((W, FCAP), KEY_EMPTY, **i64)
        nfp = torch.zeros(W, **i64)
        for _ in range(ROUND_CAP):
            if not bool(((sp > 0) & ~bad).any()):
                break
            # every entry above the topmost one that beats the heap's min
            # goes at once: each would have been popped against this same min
            minv = torch.where(hlen < N, 0, heap[:, 0] >> 32)
            livs = (iota_sc < sp[:, None]) & ~bad[:, None]
            f_open = stack[..., 3] - gap_open > stack[..., 4]
            F2 = torch.where(f_open, stack[..., 3] - gap_open, stack[..., 4]) - gap_ext
            chosen = torch.where(livs & (F2 > minv[:, None]), iota_sc, -1).amax(1)
            pend = chosen >= 0
            n_trips += pend
            sp = torch.where(bad, sp, chosen.clamp(min=0))
            at = chosen.clamp(min=0)
            z = stack[wrow, at]
            rH = _gather(F2, at)
            pFfrom = torch.where(_gather(f_open, at), FROM_OPEN, FROM_EXT)
            okz = extend(idx, torch.stack([z[:, 0], z[:, 2], torch.where(pend, z[:, 1] - z[:, 0], 0)], -1), ones_w)
            zkey = (z[:, 0] << 32) | z[:, 1]
            # the five children c = 1..5 at once, as the reference adds them
            # one by one: their keys differ, so each probe sees only the
            # buckets the earlier children took (a key already in the table
            # has no empty bucket on its probe path)
            lo5, sz5 = okz[:, 1:, 0], okz[:, 1:, 2]
            key5 = (lo5 << 32) | (lo5 + sz5)
            d5 = (iota_nb[:, None, :] - _home_bucket(key5, nb_bits)[..., None]) & (NB_ - 1)
            putm = pend[:, None] & (sz5 > 0)
            empty = (tab[..., T_KEY] == KEY_EMPTY)[:, None, :]
            hitk = tab[..., T_KEY][:, None, :] == key5[..., None]
            b5 = torch.where(empty | hitk, d5, BIG).argmin(2)
            for _ in range(4):  # after t rounds the first t children's buckets are final
                oh = (b5[..., None] == iota_nb[:, None, :]) & (putm & empty[:, 0].gather(1, b5))[..., None]
                taken = _before(oh) > 0
                nb5 = torch.where((empty & ~taken) | hitk, d5, BIG).argmin(2)
                if torch.equal(nb5, b5):
                    break
                b5 = nb5
            t = tab.gather(1, b5[..., None].expand(W, 5, len(_EMPTY)))
            absent = t[..., T_KEY] == KEY_EMPTY
            add = putm & absent
            bad = bad | (putm & (count[:, None] + _before(add) >= MAXC_)).any(1)
            count = count + add.sum(1)
            # sw_update_candset of an F candidate (its H and F are rH)
            rH5 = rH[:, None]
            chF = absent | (t[..., T_F] < rH5)
            nrl = torch.where(absent, z[:, 6:7] + 1, torch.maximum(t[..., T_RL], z[:, 6:7] + 1))
            bad = bad | (putm & (nrl > MAX_LEN)).any(1)
            do_f = putm & chF & ~bad[:, None]
            nfp5 = nfp[:, None] + _before(do_f)  # each one's node-local fpar index
            bad = bad | (do_f & (nfp5 >= FCAP)).any(1)
            do_f = do_f & ~bad[:, None]
            new = torch.stack([
                key5,
                torch.where(absent, rH5, torch.maximum(t[..., T_H], rH5)),
                torch.where(absent, 0, t[..., T_E]),
                torch.where(chF, rH5, t[..., T_F]),
                torch.where(absent, z[:, 5:6], torch.maximum(t[..., T_Q], z[:, 5:6])),
                nrl,
                torch.where(absent | (t[..., T_H] < rH5), FROM_F, t[..., T_HF]),
                torch.where(absent, 0, t[..., T_EF]),
                torch.where(chF, pFfrom[:, None], t[..., T_FF]),
                torch.where(absent, PNONE, t[..., T_HPOS]),
                torch.where(absent, PNONE, t[..., T_EPOS]),
                torch.where(chF, nfp5, t[..., T_FOFF]),
                torch.where(absent, okz[:, 1:, 1], t[..., T_LORC]),
            ], -1)
            wf, cf = do_f.nonzero(as_tuple=True)
            fpar[wf, nfp5[wf, cf]] = zkey[wf]
            k = do_f.sum(1)
            nfp = nfp + k
            # k heap inserts of (rH << 32 | UINT32_MAX), each replacing the
            # min (an empty -1 while the heap grows) when above it: the heap
            # keeps the N largest of its values and the k new ones
            xs = torch.where(torch.arange(5, device=dev)[None, :] < k[:, None], ((rH << 32) | U32)[:, None], -1)
            heap = torch.sort(torch.cat([heap, xs], 1), dim=1)[0][:, 5:]
            hlen = (hlen + k).clamp(max=N)
            push = do_f & (rH5 - gap_ext > minv[:, None])
            sp5 = sp[:, None] + _before(push)
            bad = bad | (push & (sp5 >= SCAP)).any(1)
            push = push & ~bad[:, None]
            wp, cp = push.nonzero(as_tuple=True)
            stack[wp, sp5[wp, cp]] = torch.stack([lo5, lo5 + sz5, new[..., T_LORC], new[..., T_H], new[..., T_F],
                                                  new[..., T_Q], new[..., T_RL]], -1)[wp, cp]
            sp = sp + push.sum(1)
            wb, cb = (putm & ~bad[:, None]).nonzero(as_tuple=True)
            tab[wb, b5[wb, cb]] = new[wb, cb]
        bad = bad | (sp > 0)  # cells left after the round cap

        # ---- the new row: the N best cells ---------------------------------
        row_x = topn()
        r_valid = (row_x >= 0) & live[:, None] & ~bad[:, None]
        r = torch.where(r_valid[..., None], tab[wrow[:, None], torch.where(r_valid, row_x & U32, 0)], 0)
        # sw_track_F: the fpar index becomes the column of that key in the row
        need = r_valid & (r[..., T_F] > 0) & (r[..., T_FOFF] != UNSET)
        fkey = fpar.gather(1, torch.where(need, r[..., T_FOFF].clamp(max=FCAP - 1), 0))
        mt = (r[..., T_KEY][:, None, :] == fkey[:, :, None]) & r_valid[:, None, :]
        found = need & mt.any(2)
        foff = torch.where(found, mt.long().argmax(2), 31)
        bad = bad | (found & (foff > 31)).any(1)  # the archive's 5-bit F offset (n_best > 32)
        for f, t_ in (("lo", _shr(r[..., T_KEY], 32)), ("hi", r[..., T_KEY] & U32), ("lorc", r[..., T_LORC]),
                      ("H", r[..., T_H]), ("E", r[..., T_E]), ("rlen", r[..., T_RL]), ("qlen", r[..., T_Q])):
            rows[f][:, node] = t_
        rvalid[:, node] = r_valid
        upd = r_valid[:, 0] & (r[:, 0, T_H] > best_sc)
        best_sc = torch.where(upd, r[:, 0, T_H], best_sc)
        best_pos = torch.where(upd, node * N, best_pos)
        # ---- archive words for the backtrack --------------------------------
        arch["lo"][:, node] = rows["lo"][:, node]
        arch["hi"][:, node] = rows["hi"][:, node]
        arch["rc"][:, node] = r[..., T_LORC] & U32
        arch["w"][:, node] = torch.where(r_valid, pack_arch(r_valid, r[..., T_H], r[..., T_HF], r[..., T_EF],
                                                            r[..., T_FF], found.long(), foff.clamp(max=31),
                                                            r[..., T_HPOS], r[..., T_EPOS]), 0)

    # a flagged read's rows are left as they were; its best is 0
    best_sc = torch.where(bad, 0, best_sc).int()
    best_pos = torch.where(bad, 0, best_pos).int()
    keep = torch.arange(NC, device=dev)[None, :] < nn[:, None]
    lo, hi, rc = ((a[keep] - ((a[keep] >> 31) << 32)).int() for a in (arch["lo"], arch["hi"], arch["rc"]))
    out = (lo, hi, rc, arch["w"][keep], best_sc, best_pos, bad)
    return (*out, n_trips.int()) if trips else out


def sw_cuda(idx: OccIndex, node_c: torch.Tensor, pre: torch.Tensor, n_node: torch.Tensor, n_best: int = N_BEST,
            min_sc: int = 30, end_len: int = 11, match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2,
            trips: bool = False, scratch: torch.Tensor | None = None):
    """The sw DP of the DAWGs (node_c, pre, n_node) through the kernel of
    csrc/sw.cu in the index's layout (dense32 or dense64), one warp a read:
    the arrays of sw_plain.  `scratch` goes to launch_sw.  A CPU tensor
    takes the plain version."""
    _check(idx, node_c, pre, n_node, n_best)
    opt = (n_best, min_sc, end_len, match, mis, gap_open, gap_ext, trips)
    if node_c.device.type == "cpu":
        return sw_plain(idx, node_c, pre, n_node, *opt)
    return launch_sw(idx, node_c, pre, n_node, *opt, scratch=scratch)


def launch_sw(idx: OccIndex, node_c: torch.Tensor, pre: torch.Tensor, n_node: torch.Tensor, n_best: int = N_BEST,
              min_sc: int = 30, end_len: int = 11, match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2,
              trips: bool = False, rows: torch.Tensor | None = None, scratch: torch.Tensor | None = None):
    """One launch of the kernel, no checks (sw_cuda checks first): the
    arrays of sw_cuda.  `rows` is arch_rows(n_node) and `scratch` the
    carried rows (T, n_best, 4) int64; each is made when None (give both to
    time the launch alone)."""
    W, dev = node_c.shape[0], node_c.device
    node_c, pre, n_node = node_c.contiguous(), pre.contiguous(), n_node.contiguous()
    if rows is None:
        rows = arch_rows(n_node)
    T = int(rows[-1])
    if scratch is None:
        scratch = torch.empty((T, n_best, 4), dtype=torch.int64, device=dev)
    lo, hi, rc = (torch.empty((T, n_best), dtype=torch.int32, device=dev) for _ in range(3))
    w = torch.empty((T, n_best), dtype=torch.int64, device=dev)
    best_sc, best_pos = (torch.empty(W, dtype=torch.int32, device=dev) for _ in range(2))
    bad = torch.empty(W, dtype=torch.bool, device=dev)
    n_trips = torch.empty(W, dtype=torch.int32, device=dev) if trips else None
    if W:
        kernels.launch(f"rb3c_sw_{idx.layout}", dev, *idx.kernel_tables(), node_c.data_ptr(), pre.data_ptr(),
                       n_node.data_ptr(), rows.data_ptr(), W, node_c.shape[1], pre.shape[2], n_best, end_len, match,
                       mis, gap_open, gap_ext, scratch.data_ptr(), lo.data_ptr(), hi.data_ptr(), rc.data_ptr(),
                       w.data_ptr(), best_sc.data_ptr(), best_pos.data_ptr(), bad.data_ptr(),
                       n_trips.data_ptr() if trips else None)
        kernels.count(sw_cuda.launches, idx.layout)
    out = (lo, hi, rc, w, best_sc, best_pos, bad)
    return (*out, n_trips) if trips else out


sw_cuda.launches = Counter()


class SwDeviceEngine:
    """The CLI's device engine for `sw`: the reads' DAWGs staged natively
    (`sw_stage`: the -j prefilter, the DAWG, its shape), the reads the card
    takes (n_node <= NC_MAX, in-degree <= P_MAX) through sw_cuda (the kernel
    on a CUDA device, the plain version on the CPU) LANES a call, their hits
    from the archive (`sw_finish`: the rows rebuilt, the dedup and the
    backtrack, natively); the flagged and the other reads rerun on the
    native engine (rb3_sw_batch); then every hit's positions in one locate
    (sw_jax.py:702-766).  Options the card does not take send every read to
    the native engine.  `seconds` sums each piece's wall time over the runs
    (PIECES): stage, the card's upload, alloc (the carried rows' scratch),
    kernel (with the archive's allocation) and download, finish, native,
    positions."""

    PIECES = ("stage", "upload", "alloc", "kernel", "download", "finish", "native", "positions")

    def __init__(self, f, opt: SwOpt, device="cuda", idx: OccIndex | None = None):
        self.f, self.opt, self.device = f, opt, torch.device(device)
        self.idx = idx  # f's rows on the device, or None: built on first use (they cost seconds)
        self.n_reads = self.n_card = self.n_bad = self.n_shape = 0
        self.seconds = Counter()
        self.supported = f.n < (1 << 32) and 2 <= opt.n_best <= SCAP and not (opt.flag & RB3_SWF_HAPDIV)
        if idx is None and self.supported:  # the rows come at first use: their bytes are checked now
            from ..cli import check_card

            check_card(48 * len(f.occ_block), self.device, "the occ rows of 1 index(es)", "dense")

    def _lap(self, piece: str, t0: float) -> float:
        t = time.perf_counter()
        self.seconds[piece] += t - t0
        return t

    def run(self, seqs: list[np.ndarray]) -> list[list]:
        o = self.opt
        self.n_reads += len(seqs)
        if not (self.supported and seqs):
            return rb3_sw_batch(o, self.f, seqs)
        if self.idx is None:
            self.idx = OccIndex.from_dense(self.f, self.device)
        t = time.perf_counter()
        flat, seq_off = flat_reads(seqs)
        ok, n_node, max_pre, node_c, pre = sw_stage(o, self.f, flat, seq_off, NC_MAX, P_MAX)
        t = self._lap("stage", t)
        card = np.flatnonzero(ok & (n_node <= NC_MAX) & (max_pre <= P_MAX))
        host = list(np.flatnonzero(ok & ((n_node > NC_MAX) | (max_pre > P_MAX))))
        self.n_shape += len(host)
        out: list = [[] for _ in seqs]
        for c0 in range(0, len(card), LANES):
            sel = card[c0 : c0 + LANES]
            NC, P = int(n_node[sel].max()), max(1, int(max_pre[sel].max()))
            dawg = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in (node_c[sel, :NC], pre[sel, :NC, :P], n_node[sel])]
            t = self._lap("upload", t)
            scratch = torch.empty((int(n_node[sel].sum()), o.n_best, 4), dtype=torch.int64, device=self.device)
            t = self._lap("alloc", t)
            got = sw_cuda(self.idx, *dawg, o.n_best, o.min_sc, o.end_len, o.match, o.mis, o.gap_open, o.gap_ext,
                          scratch=scratch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t = self._lap("kernel", t)
            lo, hi, rc, w, best_sc, best_pos, bad = (a.cpu().numpy() for a in got)
            del scratch
            t = self._lap("download", t)
            rows = np.zeros(len(sel) + 1, np.int64)
            np.cumsum(n_node[sel], out=rows[1:])
            done = np.flatnonzero(~bad)
            self.n_card += len(sel)
            self.n_bad += len(sel) - len(done)
            host += list(sel[bad])
            hits = sw_finish(o, self.f, flat, seq_off, sel[done], (lo, hi, rc, w), rows[done], best_sc[done],
                             best_pos[done])
            for i, h in zip(sel[done], hits):
                out[i] = h
            t = self._lap("finish", t)
        if host:
            host.sort()
            for i, h in zip(host, rb3_sw_batch(o, self.f, [seqs[i] for i in host], attach=False)):
                out[i] = h
            t = self._lap("native", t)
        _attach_positions_multi(o, self.f, out)
        self._lap("positions", t)
        return out
