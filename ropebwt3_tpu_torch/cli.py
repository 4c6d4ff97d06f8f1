"""`python -m ropebwt3_tpu_torch`: ropebwt3's command line with `mem` and
`ssa` on the port's engines.

`mem [--device=cuda|cpu] [--occ=auto|dense|rb] [options] idx.fmd reads...`
loads the index with ropebwt3_tpu.cli.load_index, builds `BatchedSmemTG` on
the device with the occ rows `--occ` names (auto: dense unless they would
pass 75% of the card's memory, ops/smem.py `resolve_occ`) and hands
both to the unchanged ropebwt3_tpu.cli.main_search, which writes the BED
(and `-c`, `--gap`, `--cov`, `-p`) exactly as the JAX package does.

`ssa [--device=cuda|cpu] [-s INT] [-o FILE] [-t INT] idx.fmd` walks every
sequence on the device's dense occ rows (ssa_ops.py) and writes the SSA
file byte-equal to `python -m ropebwt3_tpu ssa`; `-t` is accepted and
unused, as the JAX package's own walk ignores it.

With the default `--device=cuda` and no CUDA both exit non-zero; they never
go on on the CPU unasked.  Every other command is ropebwt3_tpu.cli.main,
except the options that would hand work to the JAX package's device code:
those are refused (`refusal`) until the port has them.
"""

from __future__ import annotations

import getopt
import os
import sys

from ropebwt3_tpu import log
from ropebwt3_tpu.cli import REF_VERSION, IndexLoadError, _LONG_OPTS, _err, _usage, atoi, ketopt, load_index, main_search, parse_num
from ropebwt3_tpu.cli import main as rb3_main

# main_search's short options (ropebwt3_tpu/cli.py:1029)
_SEARCH_OPTS = "Ll:c:t:K:MdN:A:B:O:E:C:m:k:uj:ey:a:w:p:bg:"
PORTED = ("mem", "ssa")
# the ROADMAP queue 1 item that ports each device engine `--engine` selects
_ENGINE_ITEM = {"sw": "item 11 (sw scoring DP)", "hapdiv": "item 10 (hapdiv DP)",
                "search": "items 4, 10 and 11 (use `mem`, `sw` or `hapdiv`)"}


def refusal(argv: list[str]) -> str | None:
    """Why the port refuses `argv`, or None.  These reach the JAX package's
    device code (jax is not on the card's machine): `serve`, `--mesh` on any
    command, `sw` / `hapdiv` / `search` with `--engine=jax|hybrid|server`, and
    a multi-host run (JAX_COORDINATOR_ADDRESS brings up jax.distributed)."""
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return "serve (the resident JAX engine server) is not ported: ROADMAP queue 1 item 13"
    # parsed as the commands parse them: ketopt takes `--name X`, `--name=X`
    # and unambiguous prefixes (no other long option of any command starts
    # with `m` or `e`); the last value wins
    given = dict(ketopt(rest, "", ["mesh=", "engine="])[0])
    if "--mesh" in given:
        return f"{cmd} --mesh is not ported (multi-GPU): ROADMAP queue 1 item 12"
    engine = given.get("--engine", "auto")
    if cmd in _ENGINE_ITEM and engine in ("jax", "hybrid", "server"):
        return f"{cmd} --engine={engine} runs the JAX package's device engine, not ported: ROADMAP queue 1 {_ENGINE_ITEM[cmd]}"
    if cmd not in PORTED and os.environ.get("JAX_COORDINATOR_ADDRESS"):
        return f"{cmd} with JAX_COORDINATOR_ADDRESS set (a multi-host JAX run) is not ported: ROADMAP queue 1 item 12"
    return None


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


def main_ssa(argv: list[str], device: str) -> int:
    from ropebwt3_tpu.formats.ssa import write_ssa

    from .ops.rank import OccIndex
    from .ssa_ops import ssa_gen, ssa_gen_cuda

    opts, args = ketopt(argv, "t:s:o:")
    ssa_shift, out_fn = 8, None
    for o, a in opts:
        if o == "-s":
            ssa_shift = atoi(a)
        elif o == "-o":
            out_fn = a
    if not args:
        return _usage("ssa")
    f = load_index(args[0])
    idx = OccIndex.from_dense(f, device)
    write_ssa(out_fn if out_fn else "-", ssa_gen(f, ssa_shift, occ=idx))
    log.info("%d ssa_gen launches (%s)", sum(ssa_gen_cuda.launches.values()), idx.layout, func="ssa")
    return 0


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and (why := refusal(argv)):
        return _err(why)
    if not argv or argv[0] not in PORTED:
        return rb3_main(argv)
    device, rest = _split_device(argv[1:])
    if device not in ("cuda", "cpu"):
        return _err(f"invalid --device '{device}' (cuda|cpu)")
    if device == "cuda":
        import torch

        if not torch.cuda.is_available():
            return _err("CUDA is not available; pass --device=cpu to run the plain PyTorch engine")
    try:
        ret = (main_mem if argv[0] == "mem" else main_ssa)(rest, device)
    except IndexLoadError as e:
        ret = _err(str(e))
    except getopt.GetoptError as e:
        ret = _err(str(e))
    except BrokenPipeError:
        ret = 0
    if ret == 0:
        log.footer(argv, REF_VERSION)
    return ret
