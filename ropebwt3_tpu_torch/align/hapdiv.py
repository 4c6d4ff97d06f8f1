"""hapdiv on the card: the anno BWA-SW DP over linear DAWGs, many windows a
launch.

Port of ropebwt3_tpu/align/hapdiv_jax.py.  For W windows of K nt6 symbols,
the DP of sw_core (bwa-sw.c:329-526) in anno/e2e mode gives per window
n_al, max_ed and n_hap[0..6] (rb3_hapdiv, bwa-sw.c:562-568), and a `bad`
flag for the windows whose DP leaves what this formulation represents
exactly: a khashl table that would resize, a stack or fpar overflow, the
E-type H_from_pos corner, a score above 4095, closure cells left after 1024
rounds or walkers left after 4K + 64 steps (hapdiv_jax.py's module note
says why each is exact otherwise).  `HapdivDeviceEngine` reruns the `bad`
windows on the native DP (align/bwasw.py), so its answers are the host's.

`hapdiv_plain` is the plain PyTorch version: hapdiv_device transliterated,
lock-step over the W windows (torch.sort for lax.sort, segment reductions
for the associative scans, Python loops for the scans and while loops), the
CPU path and the reference the kernel is held against.  `hapdiv_cuda` wraps
the kernel of csrc/hapdiv.cu (one warp a window).  Both take the dense occ
rows of ops/rank.py `OccIndex`; every extend is the port's `extend`
(ops/rank.py), backward, as hapdiv_device's rank_extend calls.

The cells' rlen, which hapdiv_device carries, is left out here and in the
kernel: it reaches no count and no flag (only sw's hits read it).
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import torch

from .. import kernels
from ..ops.rank import OccIndex, extend
from .bwasw import RB3_SWF_E2E, RB3_SWF_HAPDIV, HapDiv, SwOpt, rb3_hapdiv_multi

N_BEST = 25  # opt.n_best default
NB = 128  # khashl buckets after kh_resize(n_best * 4) at the default n_best
MAXC = 96  # khashl max_count(128): a node at this many unique cells would resize
SCAP = 48  # F-closure stack slots per window
FCAP = 64  # fpar entries per node per window
UNSET = 0x3FFFFFF  # SW_F_UNSET
FROM_H, FROM_E, FROM_F = 0, 1, 2
FROM_OPEN, FROM_EXT = 0, 1
PNONE = 0xFFFF  # a H_from_pos / E_from_pos of UINT32_MAX, as the archive holds it
MAX_K = 509  # window length limit of the packed words (hapdiv_jax.py:351)
ROUND_CAP = 1024  # F-closure rounds a node (hapdiv_jax.py:756)
KEY_EMPTY = -1
KEY_HUGE = (1 << 63) - 1
BIG = 1 << 62
U32 = 0xFFFFFFFF
LANES = 16384  # windows a launch: the archive takes K x N x 8 B each (~20 KB at K 101)
# hapdiv_plain's bucket table: one int64 row of these fields a bucket, and
# the row of an empty bucket
T_KEY, T_H, T_E, T_F, T_Q, T_HF, T_EF, T_FF, T_HPOS, T_EPOS, T_FOFF, T_LORC = range(12)
_EMPTY = [KEY_EMPTY, 0, 0, 0, 0, 0, 0, 0, PNONE, PNONE, UNSET, 0]


def _wrap(c: int) -> int:
    """A uint64 constant as the int64 of the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_SM1, _SM2 = _wrap(0xBF58476D1CE4E5B9), _wrap(0x94D049BB133111EB)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix(x: torch.Tensor) -> torch.Tensor:
    """kh_hash_uint64 (khashl-km.h): the splitmix64 finalizer cut to 32 bits,
    on int64 tensors whose products wrap as uint64's do."""
    x = x ^ _shr(x, 30)
    x = x * _SM1
    x = x ^ _shr(x, 27)
    x = x * _SM2
    x = x ^ _shr(x, 31)
    return x & U32


def _home_bucket(key: torch.Tensor, nb_bits: int = 7) -> torch.Tensor:
    """Fibonacci bucket __kh_h2b(hash, nb_bits) of sw_cell_hash for keys
    lo << 32 | hi (int64, lo and hi below 2^32)."""
    h = (_splitmix(_shr(key, 32)) + _splitmix(key & U32)) & U32
    return ((h * 2654435769) & U32) >> (32 - nb_bits)


def nb_params(n_best: int) -> tuple[int, int, int]:
    """(nb_bits, nb, maxc) of kh_resize(n_best * 4): the bucket count is the
    power of two >= 4 n_best, max_count a 75% load (khashl-km.h:77-78)."""
    nb_bits = max(2, (4 * int(n_best) - 1).bit_length())
    nb = 1 << nb_bits
    return nb_bits, nb, (nb >> 1) + (nb >> 2)


def _check(idx: OccIndex, seqs: torch.Tensor, K: int, n_best: int) -> None:
    if seqs.dim() != 2 or seqs.shape[1] != K or seqs.dtype != torch.int32:
        raise ValueError(f"hapdiv takes windows (W, {K}) int32")
    if seqs.device != idx.device:
        raise ValueError("hapdiv: the windows must be on the index's device")
    if not (1 <= K <= MAX_K and 2 <= n_best <= SCAP and idx.n < (1 << 32)):
        raise ValueError(f"hapdiv: K {K} (1..{MAX_K}), n_best {n_best} (2..{SCAP}) and n {idx.n} (< 2^32) out of range")


def _gather(t: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """t[w, col[w]] for t (W, X) and col (W,)."""
    return t.gather(1, col[:, None])[:, 0]


def hapdiv_plain(idx: OccIndex, seqs: torch.Tensor, K: int, n_best: int = N_BEST, min_sc: int = 30, end_len: int = 1,
                 match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2, trips: bool = False):
    """hapdiv_device (hapdiv_jax.py:401-1026) in plain PyTorch, lock-step
    over the windows seqs (W, K) int32 nt6 on the index's device.  Returns
    (n_al (W,) int32, max_ed (W,) int32, n_hap (W, 7) int64, bad (W,) bool),
    and with `trips` each window's dependent extend rounds (W,) int32: one a
    node and one a closure pop, as the kernel counts them on every window
    not flagged."""
    _check(idx, seqs, K, n_best)
    dev = seqs.device
    W, N = seqs.shape[0], n_best
    S = 6 * N
    nb_bits, NB_, MAXC_ = nb_params(N)
    acc = idx.acc.long()
    i64 = dict(dtype=torch.int64, device=dev)
    iota_n = torch.arange(N, **i64)[None, :]
    iota_nb = torch.arange(NB_, **i64)[None, :]
    iota_sc = torch.arange(SCAP, **i64)[None, :]
    wrow = torch.arange(W, **i64)
    syms = seqs.long().flip(1)  # node i consumes syms[:, i - 1] (dawg.c:230-250)

    def zeros(cols):
        return torch.zeros((W, cols), **i64)

    # the root row: one cell, the whole BWT
    row = {f: zeros(N) for f in ("lo", "hi", "lorc", "H", "E", "qlen", "Hf")}
    row["hi"][:, 0] = acc[6]
    row["valid"] = (iota_n == 0).expand(W, N).clone()
    bad = torch.zeros(W, dtype=torch.bool, device=dev)
    n_trips = torch.zeros(W, **i64)
    arch0 = torch.zeros((K, W, N), **i64)
    arch1 = torch.zeros((K, W, N), **i64)
    ones_wn = torch.ones(W * N, dtype=torch.bool, device=dev)
    ones_w = torch.ones(W, dtype=torch.bool, device=dev)
    slot6 = torch.arange(6, **i64)  # candidate slot of a cell: H-cands c = 1..5, then the E slot
    is_e = (slot6 == 5)[None, None, :]
    sym_c = (slot6 + 1).clamp(max=5)[None, None, :]

    for node in range(1, K + 1):
        c_node = syms[:, node - 1]
        n_trips += ~bad
        pos_base = (node - 1) * N  # H_from_pos of a cell of the previous row
        valid = row["valid"]
        n_prev = valid.sum(1)
        # w.last_p: the last visited previous cell gates the F-closure (bwa-sw.c)
        gate_f = (_gather(row["qlen"], (n_prev - 1).clamp(min=0)) >= end_len) & (n_prev > 0)

        # ---- one extend of every previous cell -----------------------------
        ik = torch.stack([row["lo"], row["lorc"], torch.where(valid, row["hi"] - row["lo"], 0)], -1)
        ok = extend(idx, ik.reshape(W * N, 3), ones_wn).reshape(W, N, 6, 3)
        ok16 = torch.cat([ok[:, :, 1:6], ok[:, :, 5:6]], 2)  # slots: c = 1..5, then the E slot (c = 5's, unused)
        e_lo, e_rc, e_sz = ok16[..., 0], ok16[..., 1], ok16[..., 2]

        # ---- candidate slots (insert order: cell k, c = 1..5, E) -------------
        pH, pE, pq = row["H"][..., None], row["E"][..., None], row["qlen"][..., None]
        pv = valid[..., None]
        c_n = c_node[:, None, None]
        sc = torch.where((sym_c == c_n) & (sym_c != 5), match, -mis)
        h_pass = pv & ~is_e & (e_sz > 0) & (pH + sc > 0) & ((sym_c == c_n) | (pq >= end_len))
        # the E slot's stale lo_rc: that of the cell's last passing H-cand
        # (bwa-sw.c:418 sets only lo/hi on the E path), 0 if none
        last_c = torch.where(h_pass[..., :5], slot6[:5] + 1, 0).amax(2)
        stale_rc = torch.where(last_c > 0, ok[:, :, 1:6, 1].gather(2, (last_c - 1).clamp(min=0)[..., None])[..., 0], 0)
        e_open = pH - gap_open > pE
        e_val = torch.where(e_open, pH - gap_open, pE) - gap_ext
        e_pass = pv & is_e & (e_val > 0) & (pq >= end_len)
        cvalid = (h_pass | e_pass).reshape(W, S)
        lo_s = torch.where(is_e, row["lo"][..., None], e_lo)
        hi_s = torch.where(is_e, row["hi"][..., None], e_lo + e_sz)
        kcol = torch.arange(N, **i64)[None, :, None] + pos_base
        cand = {
            "key": torch.where(cvalid, ((lo_s << 32) | hi_s).reshape(W, S), KEY_HUGE),
            "lorc": torch.where(is_e, stale_rc[..., None], e_rc),
            "H": torch.where(is_e, e_val, pH + sc),
            "E": torch.where(is_e, e_val, 0),
            "qlen": (pq + 1).expand(W, N, 6),
            "Hf": torch.where(is_e, FROM_E, FROM_H).expand(W, N, 6),
            "Ef": torch.where(is_e, torch.where(e_open, FROM_OPEN, FROM_EXT), 0),
            "Hpos": torch.where(is_e, PNONE, kcol).expand(W, N, 6),
            "Epos": torch.where(is_e, kcol, PNONE).expand(W, N, 6),
        }
        cand = {k: v.reshape(W, S) for k, v in cand.items()}
        bad = bad | (cvalid & (cand["H"] > 4095)).any(1)  # the 12-bit score field

        # ---- sorted-segment merge (sw_update_candset's running maxes) ------
        key_s, slot_s = torch.sort(cand["key"], dim=1, stable=True)
        cs = {k: v.gather(1, slot_s) for k, v in cand.items() if k != "key"}
        valid_s = key_s != KEY_HUGE
        head = torch.ones_like(valid_s)
        head[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
        seg = (torch.cumsum(head.long(), 1) - 1 + wrow[:, None] * S).reshape(-1)  # global segment of each element
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

        hpos_head = seg_reduce(spos, "amin")  # position of the segment's head
        mH, aH = first_max(cs["H"])
        mE, aE = first_max(cs["E"])
        mql = seg_reduce(cs["qlen"], "amax")
        hstart = aH == hpos_head
        hf = cs["Hf"].gather(1, aH)
        # first attainment past the head by an E-type candidate: the host's
        # H_from_pos would need the event chain (flagged)
        bad = bad | (head & valid_s & ~hstart & (hf == FROM_E)).any(1)
        gHpos = torch.where(hstart, cs["Hpos"], cs["Hpos"].gather(1, aH))  # read at the head below

        # unique keys in first-occurrence (khashl insert) order
        usrc = torch.where(head & valid_s, slot_s, BIG)
        usrc, uorder = torch.sort(usrc, dim=1, stable=True)
        u_valid = usrc != BIG
        u = {"key": key_s, "H": mH, "E": mE, "qlen": mql, "Hf": hf, "Ef": cs["Ef"].gather(1, aE),
             "Hpos": gHpos, "Epos": cs["Epos"].gather(1, aE), "lorc": cs["lorc"]}
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
        zero, unset = torch.zeros_like(u["key"]), torch.full_like(u["key"], UNSET)
        urow = torch.stack([u["key"], u["H"], u["E"], zero, u["qlen"], u["Hf"], u["Ef"], zero, u["Hpos"], u["Epos"],
                            unset, u["lorc"]], -1)
        tab[w_put, u_bucket[w_put, j_put]] = urow[w_put, j_put]
        count = torch.where(bad, 0, u_count)

        def topn():
            """The N best occupied buckets by (H << 32 | bucket), descending
            (klib's bounded heap keeps the N largest keys)."""
            x = torch.where(tab[..., T_KEY] != KEY_EMPTY, (tab[..., T_H] << 32) | iota_nb, -1)
            return torch.sort(x, dim=1, descending=True)[0][:, :N]

        row_x = topn()

        # ---- F-closure (bwa-sw.c:445-483) -----------------------------------
        heap = row_x.flip(1)  # the bounded min-heap's values, ascending; -1 = empty
        hlen = (row_x >= 0).sum(1)
        # the stack starts with the row's cells, the best on top; an entry
        # is (lo, hi, lorc, H, F, qlen)
        elig = (row_x >= 0) & ((row_x >> 32) > gap_open + gap_ext) & gate_f[:, None] & ~bad[:, None]
        slot_of = elig.flip(1).long().cumsum(1).flip(1) - elig.long()
        stack = torch.zeros((W, SCAP, 6), **i64)
        w_el, j_el = elig.nonzero(as_tuple=True)
        te = tab[w_el, row_x[w_el, j_el] & U32]
        stack[w_el, slot_of[w_el, j_el]] = torch.stack(
            [_shr(te[:, T_KEY], 32), te[:, T_KEY] & U32, te[:, T_LORC], te[:, T_H], te[:, T_F], te[:, T_Q]], -1)
        sp = elig.sum(1)
        fpar = torch.full((W, FCAP), KEY_EMPTY, **i64)
        nfp = torch.zeros(W, **i64)
        for _ in range(ROUND_CAP):
            if not bool(((sp > 0) & ~bad).any()):
                break
            # every entry above the topmost one that beats the heap's min
            # goes at once: each would have been popped against this same min
            minv = torch.where(hlen < N, 0, heap[:, 0] >> 32)
            live = (iota_sc < sp[:, None]) & ~bad[:, None]
            f_open = stack[..., 3] - gap_open > stack[..., 4]
            F2 = torch.where(f_open, stack[..., 3] - gap_open, stack[..., 4]) - gap_ext
            chosen = torch.where(live & (F2 > minv[:, None]), iota_sc, -1).amax(1)
            pend = chosen >= 0
            n_trips += pend
            sp = torch.where(bad, sp, chosen.clamp(min=0))
            at = chosen.clamp(min=0)
            z = stack[wrow, at]
            rH = _gather(F2, at)
            pFfrom = torch.where(_gather(f_open, at), FROM_OPEN, FROM_EXT)
            okz = extend(idx, torch.stack([z[:, 0], z[:, 2], torch.where(pend, z[:, 1] - z[:, 0], 0)], -1), ones_w)
            zkey = (z[:, 0] << 32) | z[:, 1]
            # the children c = 1..5: their keys and each bucket's distance
            # from their home buckets (the probe order)
            lo5, sz5 = okz[:, 1:, 0], okz[:, 1:, 2]
            key5 = (lo5 << 32) | (lo5 + sz5)
            d5 = (iota_nb[:, None, :] - _home_bucket(key5, nb_bits)[..., None]) & (NB_ - 1)
            for c in range(1, 6):
                csz, lo_c, key_c, d = sz5[:, c - 1], lo5[:, c - 1], key5[:, c - 1], d5[:, c - 1]
                putm = pend & (csz > 0)
                hi_c = lo_c + csz
                # linear probe from the home bucket to the key or an empty bucket
                hit = (tab[..., T_KEY] == KEY_EMPTY) | (tab[..., T_KEY] == key_c[:, None])
                b = torch.where(hit, d, BIG).argmin(1)
                t = tab[wrow, b]
                absent = t[:, T_KEY] == KEY_EMPTY
                bad = bad | (putm & (count >= MAXC_))
                putm = putm & ~bad
                count = count + (putm & absent)
                # sw_update_candset of an F candidate (its H and F are rH)
                chF = absent | (t[:, T_F] < rH)
                new = torch.stack([
                    key_c,
                    torch.where(absent, rH, torch.maximum(t[:, T_H], rH)),
                    torch.where(absent, 0, t[:, T_E]),
                    torch.where(chF, rH, t[:, T_F]),
                    torch.where(absent, z[:, 5], torch.maximum(t[:, T_Q], z[:, 5])),
                    torch.where(absent | (t[:, T_H] < rH), FROM_F, t[:, T_HF]),
                    torch.where(absent, 0, t[:, T_EF]),
                    torch.where(chF, pFfrom, t[:, T_FF]),
                    torch.where(absent, PNONE, t[:, T_HPOS]),
                    torch.where(absent, PNONE, t[:, T_EPOS]),
                    torch.where(chF, nfp, t[:, T_FOFF]),  # the node-local fpar index
                    torch.where(absent, okz[:, c, 1], t[:, T_LORC]),
                ], -1)
                do_f = putm & chF
                bad = bad | (do_f & (nfp >= FCAP))
                do_f = do_f & ~bad
                wf = do_f.nonzero(as_tuple=True)[0]
                fpar[wf, nfp[wf]] = zkey[wf]
                nfp = nfp + do_f
                # heap insert of (rH << 32 | UINT32_MAX): replace the min
                # (an empty -1 while the heap grows), keep it sorted
                x = (rH << 32) | U32
                grow = do_f & (hlen < N)
                ins = grow | (do_f & (hlen >= N) & (x > heap[:, 0]))
                p = (heap < x[:, None]).sum(1)[:, None]
                shifted = torch.cat([heap[:, 1:], heap[:, -1:]], 1)
                cand_h = torch.where(iota_n < p - 1, shifted, torch.where(iota_n == p - 1, x[:, None], heap))
                heap = torch.where(ins[:, None], cand_h, heap)
                hlen = hlen + grow
                push = do_f & (rH - gap_ext > minv)
                bad = bad | (push & (sp >= SCAP))
                push = push & ~bad
                wp = push.nonzero(as_tuple=True)[0]
                stack[wp, sp[wp]] = torch.stack([lo_c, hi_c, new[:, T_LORC], new[:, T_H], new[:, T_F], new[:, T_Q]],
                                                -1)[wp]
                sp = sp + push
                # the five children's keys differ, so their buckets do: a
                # write here changes no later child's probe or merge
                wb = putm.nonzero(as_tuple=True)[0]
                tab[wb, b[wb]] = new[wb]
        bad = bad | (sp > 0)  # cells left after the round cap

        # ---- the new row: the N best cells ---------------------------------
        row_x = topn()
        r_valid = row_x >= 0
        r = torch.where(r_valid[..., None], tab[wrow[:, None], torch.where(r_valid, row_x & U32, 0)], 0)
        # sw_track_F: the fpar index becomes the column of that key in the row
        need = r_valid & (r[..., T_F] > 0) & (r[..., T_FOFF] != UNSET)
        fkey = fpar.gather(1, torch.where(need, r[..., T_FOFF].clamp(max=FCAP - 1), 0))
        mt = (r[..., T_KEY][:, None, :] == fkey[:, :, None]) & r_valid[:, None, :]
        found = need & mt.any(2)
        foff = torch.where(found, mt.long().argmax(2), UNSET)
        row = {
            "lo": _shr(r[..., T_KEY], 32), "hi": r[..., T_KEY] & U32, "lorc": r[..., T_LORC], "H": r[..., T_H],
            "E": r[..., T_E], "qlen": r[..., T_Q], "Hf": r[..., T_HF], "valid": r_valid,
        }
        # ---- archive words for the backtrack --------------------------------
        refc = (acc[1:7][None, None, :] <= row["lo"][..., None]).sum(2)
        arch0[node - 1] = (r[..., T_HF] | r[..., T_EF] << 2 | r[..., T_FF] << 3 | found.long() << 4 | refc << 5
                           | torch.where(found, foff.clamp(max=31), 31) << 8)
        arch1[node - 1] = (torch.where(r_valid, r[..., T_HPOS], PNONE)
                           | torch.where(r_valid, r[..., T_EPOS], PNONE) << 16)

    # ---- final row: containment dedup (sw_cell_dedup, bwa-sw.c:197-216) ----
    lo, hi, lorc, valid = row["lo"], row["hi"], row["lorc"], row["valid"]
    sz = hi - lo
    kept = torch.zeros((W, N), dtype=torch.bool, device=dev)
    kept[:, 0] = valid[:, 0]
    flt = torch.zeros_like(kept)
    for i in range(1, N):
        cont_rc = (lorc <= lorc[:, i : i + 1]) & (lorc + sz >= lorc[:, i : i + 1] + sz[:, i : i + 1])
        cont_fw = (lo <= lo[:, i : i + 1]) & (hi >= hi[:, i : i + 1])
        flt[:, i] = (kept & (cont_rc | cont_fw)).any(1) & valid[:, i]
        kept[:, i] = valid[:, i] & ~flt[:, i]
    sel = valid & ~flt & (row["Hf"] == FROM_H) & (row["H"] >= min_sc)  # e2e_drop < 0: no drop filter
    n_al = sel.sum(1).int()

    # ---- anno backtrack: the edit distance of each selected cell ------------
    af0 = arch0.permute(1, 0, 2).reshape(W, K * N)
    af1 = arch1.permute(1, 0, 2).reshape(W, K * N)
    pos = torch.where(sel, K * N + iota_n, 0)  # global position r N + col; the root is 0
    last = zeros(N)
    ed = zeros(N)
    for _ in range(4 * K + 64):
        act = pos > 0
        if not bool(act.any()):
            break
        r_, col = pos // N, pos % N
        ai = ((r_ - 1) * N + col).clamp(0, K * N - 1)
        w0, w1 = af0.gather(1, ai), af1.gather(1, ai)
        x = w0 & 0xF
        state = torch.where(last == 0, x & 3, last)
        gap = (state == FROM_E) | (state == FROM_F)
        ext = torch.where(gap, (x >> (state + 1)) & 1, 0)
        node_c = syms.gather(1, (r_ - 1).clamp(0, K - 1))
        d_ed = torch.where(state == FROM_H, (((w0 >> 5) & 7) != node_c).long(), 1)
        npos = torch.where(state == FROM_H, w1 & 0xFFFF,
                           torch.where(state == FROM_E, (w1 >> 16) & 0xFFFF, r_ * N + ((w0 >> 8) & 0x1F)))
        pos = torch.where(act, npos, pos)
        ed = ed + torch.where(act, d_ed, 0)
        last = torch.where(act, torch.where(gap & (ext == 1), state, 0), last)
    bad = bad | (sel & (pos > 0)).any(1)  # walkers left after the step cap

    max_ed = torch.where(sel, ed, 0).amax(1).int()
    edc = ed.clamp(max=6)
    n_hap = torch.stack([torch.where(sel & (edc == e), sz, 0).sum(1) for e in range(7)], 1)
    return (n_al, max_ed, n_hap, bad, n_trips.int()) if trips else (n_al, max_ed, n_hap, bad)


def hapdiv_cuda(idx: OccIndex, seqs: torch.Tensor, K: int, n_best: int = N_BEST, min_sc: int = 30, end_len: int = 1,
                match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2, trips: bool = False):
    """The hapdiv DP of windows seqs (W, K) int32 through the kernel of
    csrc/hapdiv.cu in the index's layout (dense32 or dense64), one warp a
    window: the same arrays as hapdiv_plain.  A CPU tensor takes the plain
    version."""
    _check(idx, seqs, K, n_best)
    if seqs.device.type == "cpu":
        return hapdiv_plain(idx, seqs, K, n_best, min_sc, end_len, match, mis, gap_open, gap_ext, trips)
    return launch_hapdiv(idx, seqs, K, n_best, min_sc, end_len, match, mis, gap_open, gap_ext, trips)


def launch_hapdiv(idx: OccIndex, seqs: torch.Tensor, K: int, n_best: int = N_BEST, min_sc: int = 30, end_len: int = 1,
                  match: int = 1, mis: int = 3, gap_open: int = 5, gap_ext: int = 2, trips: bool = False,
                  arch: torch.Tensor | None = None):
    """One launch of the kernel, no checks (hapdiv_cuda checks first): the
    arrays of hapdiv_cuda.  `arch` is the (W, K, n_best, 2) int32 archive,
    allocated when None (give one to time the launch alone)."""
    W, dev = seqs.shape[0], seqs.device
    seqs = seqs.contiguous()
    n_al = torch.empty(W, dtype=torch.int32, device=dev)
    max_ed = torch.empty(W, dtype=torch.int32, device=dev)
    n_hap = torch.empty((W, 7), dtype=torch.int64, device=dev)
    bad = torch.empty(W, dtype=torch.bool, device=dev)
    n_trips = torch.empty(W, dtype=torch.int32, device=dev) if trips else None
    if arch is None:
        arch = torch.empty((W, K, n_best, 2), dtype=torch.int32, device=dev)
    opt = (n_best, min_sc, end_len, match, mis, gap_open, gap_ext)
    if W:
        kernels.launch(f"rb3c_hapdiv_{idx.layout}", dev, *idx.kernel_tables(), seqs.data_ptr(), W, K, *opt,
                       arch.data_ptr(), n_al.data_ptr(), max_ed.data_ptr(), n_hap.data_ptr(), bad.data_ptr(),
                       n_trips.data_ptr() if trips else None)
        kernels.count(hapdiv_cuda.launches, idx.layout)
    return (n_al, max_ed, n_hap, bad, n_trips) if trips else (n_al, max_ed, n_hap, bad)


hapdiv_cuda.launches = Counter()


class HapdivDeviceEngine:
    """The CLI's device engine: windows of one length through hapdiv_cuda
    (the kernel on a CUDA device, the plain version on the CPU), LANES a
    call, with the windows it flags `bad` rerun on the native DP; the
    options and lengths the packed words cannot hold go to the native DP
    whole (hapdiv_jax.py:303-398).  `seconds` sums each piece's wall time
    over the runs (PIECES): the rows' build and upload, the windows' cut
    (the CLI's staging and the stack here), their upload, the kernel, the
    download, the results' unpacking, the native rerun and the CLI's write."""

    PIECES = ("rows", "cut", "upload", "kernel", "download", "unpack", "native", "write")

    def __init__(self, f, opt: SwOpt, device="cuda", idx: OccIndex | None = None):
        self.f, self.opt, self.device = f, opt, torch.device(device)
        self.idx = idx  # f's rows on the device, or None: built on first use (they cost seconds)
        self.n_bad = 0
        self.seconds = Counter()
        self.supported = (
            f.n < (1 << 32)
            and 2 <= opt.n_best <= SCAP
            and opt.e2e_drop < 0
            and (opt.flag & (RB3_SWF_E2E | RB3_SWF_HAPDIV)) == (RB3_SWF_E2E | RB3_SWF_HAPDIV)
        )
        if idx is None and self.supported:  # the rows come at first use: their bytes are checked now
            from ..cli import check_card

            check_card(48 * len(f.occ_block), self.device, "the occ rows of 1 index(es)", "dense")

    def _lap(self, piece: str, t0: float) -> float:
        t = time.perf_counter()
        self.seconds[piece] += t - t0
        return t

    def run(self, wins: list[np.ndarray]) -> list[HapDiv]:
        """One HapDiv a window (a window with no alignment gives the
        all-zero HapDiv, which is written as the host's None is)."""
        if not wins:
            return []
        K = len(wins[0])
        if not (self.supported and 1 <= K <= MAX_K and all(len(w) == K for w in wins)):
            return [r if r is not None else HapDiv() for r in rb3_hapdiv_multi(self.opt, self.f, wins)]
        t = time.perf_counter()
        if self.idx is None:
            self.idx = OccIndex.from_dense(self.f, self.device)
            t = self._lap("rows", t)
        o = self.opt
        arr = torch.from_numpy(np.stack(wins).astype(np.int32))
        t = self._lap("cut", t)
        out: list = [None] * len(wins)
        bad_idx: list[int] = []
        for c0 in range(0, len(wins), LANES):
            chunk = arr[c0 : c0 + LANES].to(self.device)
            t = self._lap("upload", t)
            got = hapdiv_cuda(self.idx, chunk, K, o.n_best, o.min_sc, o.end_len, o.match, o.mis, o.gap_open, o.gap_ext)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t = self._lap("kernel", t)
            n_al, max_ed, n_hap, bad = (a.cpu().tolist() for a in got)
            t = self._lap("download", t)
            for i in range(len(chunk)):
                if bad[i]:
                    bad_idx.append(c0 + i)
                else:
                    out[c0 + i] = HapDiv(n_al[i], max_ed[i], n_hap[i])
            t = self._lap("unpack", t)
        if bad_idx:
            self.n_bad += len(bad_idx)
            redo = rb3_hapdiv_multi(self.opt, self.f, [wins[i] for i in bad_idx])
            for i, r in zip(bad_idx, redo):
                out[i] = r if r is not None else HapDiv()
            self._lap("native", t)
        return out
