"""`python -m ropebwt3_tpu_torch`: ropebwt3's command line with `mem` on the
port's engine.

`mem [--device=cuda|cpu] [--occ=auto|dense|rb] [options] idx.fmd reads...`
loads the index with ropebwt3_tpu.cli.load_index, builds `BatchedSmemTG` on
the device with the occ rows `--occ` names (auto: dense unless they would
pass 75% of the card's memory, ops/smem.py `resolve_occ`) and hands
both to the unchanged ropebwt3_tpu.cli.main_search, which writes the BED
(and `-c`, `--gap`, `--cov`, `-p`) exactly as the JAX package does.  With
the default `--device=cuda` and no CUDA it exits non-zero; it never goes on
on the CPU unasked.  Every other command is ropebwt3_tpu.cli.main.
"""

from __future__ import annotations

import getopt
import sys

from ropebwt3_tpu import log
from ropebwt3_tpu.cli import REF_VERSION, IndexLoadError, _LONG_OPTS, _err, atoi, ketopt, load_index, main_search, parse_num
from ropebwt3_tpu.cli import main as rb3_main

# main_search's short options (ropebwt3_tpu/cli.py:1029)
_SEARCH_OPTS = "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:"


def _split_device(argv: list[str]) -> tuple[str, list[str]]:
    """Take `--device=X` / `--device X` out of argv (main_search's option
    parser rejects unknown options)."""
    device, rest, it = "cuda", [], iter(argv)
    for a in it:
        if a == "--":
            rest.append(a)
            rest.extend(it)
        elif a == "--device":
            device = next(it, "")
        elif a.startswith("--device="):
            device = a[len("--device=") :]
        else:
            rest.append(a)
    return device, rest


def main_mem(argv: list[str], device: str) -> int:
    from .ops.smem import BatchedSmemTG, smem_tg_cuda

    opts, args = ketopt(argv, _SEARCH_OPTS, _LONG_OPTS)
    if len(args) < 2 or any(o in ("-d", "-a", "-w", "--old-mem") for o, _ in opts):
        return main_search(argv, "mem")  # usage, or an algorithm the engine does not run
    min_len, min_occ, max_pos, min_gap_len, occ = 19, 1, 0, 0, "auto"
    for o, a in opts:
        if o == "--occ":
            if a not in ("auto", "dense", "rb"):
                raise getopt.GetoptError(f"invalid --occ value '{a}' (auto|dense|rb)")
            occ = a
        elif o == "-l":
            min_len = atoi(a)
        elif o == "-c":
            min_occ = atoi(a)
        elif o == "-p":
            max_pos = atoi(a)
        elif o == "--gap":
            min_gap_len = parse_num(a)
    # -p needs the SSA and sequence names; main_search skips its own loading
    # logic for a preloaded index (cli.py:1141-1145, 1184)
    locate = max_pos > 0 and min_gap_len == 0
    f = load_index(args[0], load_ssa=locate, load_sid=locate)
    eng = BatchedSmemTG(f, min_occ, min_len, device=device, occ=occ)
    # --engine=jax: with a preloaded engine, main_search's auto would split
    # reads between it and the native engine (cli.py:1214-1221)
    ret = main_search(["--engine=jax"] + argv, "mem", _preloaded=(args[0], f, eng))
    log.info("%d smem_tg launches (%s); %d reads rerun on the host engine", sum(smem_tg_cuda.launches.values()),
             eng.idx.layout, eng.n_rerun, func="mem")
    return ret


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] != "mem":
        return rb3_main(argv)
    device, rest = _split_device(argv[1:])
    if device not in ("cuda", "cpu"):
        return _err(f"invalid --device '{device}' (cuda|cpu)")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return _err("CUDA is not available; pass --device=cpu to run the plain PyTorch engine")
    try:
        ret = main_mem(rest, device)
    except IndexLoadError as e:
        ret = _err(str(e))
    except getopt.GetoptError as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    if ret == 0:
        log.footer(argv, REF_VERSION)
    return ret
