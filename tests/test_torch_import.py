"""The port never imports jax, and imports nothing of the JAX package: not
when its modules are imported, not while its CLI runs `build`, `merge`,
`plain2fmd`, `mem`, `ssa`, `hapdiv`, `sw`, `search`, `stat`, `get`, `suffix`,
`kount`, `fa2line` and `fa2kmer`, and not in its sources or chip_smoke.py;
a request for a server imports no torch.  Also read from the sources: each C entry point's ctypes
argument list (kernels.py) matches its signature in csrc/."""

import os
import re
import subprocess
import sys

from .test_torch_cli import corpus_fmd  # noqa: F401  (fixture reuse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ropebwt3_tpu_torch")
FORBIDDEN = "sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ropebwt3_tpu'))"


def port_modules() -> list[str]:
    """Every module of the port by dotted name, but `__main__` (the CLI)."""
    out = []
    for d, _, files in os.walk(PORT):
        for fn in sorted(files):
            if fn.endswith(".py") and fn != "__main__.py":
                rel = os.path.relpath(os.path.join(d, fn), ROOT)[: -len(".py")].replace(os.sep, ".")
                out.append(rel[: -len(".__init__")] if rel.endswith(".__init__") else rel)
    return sorted(out)


def test_port_imports_no_jax():
    mods = port_modules()
    assert "ropebwt3_tpu_torch.native" in mods and "ropebwt3_tpu_torch.index.sidecar" in mods
    # the host code of --old-mem and of the Python BWA-SW DP
    assert {"ropebwt3_tpu_torch.ops.smem_ref", "ropebwt3_tpu_torch.align.bwtl",
            "ropebwt3_tpu_torch.align.khashl_compat"} <= set(mods)
    code = "import importlib, sys\n" + "".join(f"importlib.import_module({m!r})\n" for m in mods) + f"print({FORBIDDEN})\n"
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert r.stdout.strip() == "[]", r.stdout


def test_cli_commands_import_no_jax_package(corpus, corpus_fmd, tmp_path):
    """`build` (-d, and plain text with two batches), `merge`, `plain2fmd`,
    `mem` (with -p: the native locate), `ssa`, `hapdiv` (the plain DP, the
    native DP for flagged windows), `sw` (the native staging; -j151 leaves
    no read to score), `search` (running mem) and `stat` through the port's
    CLI on the CPU leave no jax and no ropebwt3_tpu module loaded."""
    fmd, reads, fa = str(corpus_fmd), str(corpus / "reads.fa"), str(corpus / "genomes.fa")
    built, plain = str(tmp_path / "b.fmd"), str(tmp_path / "b.txt")
    code = (
        "import contextlib, io, sys\n"
        "from ropebwt3_tpu_torch.cli import main\n"
        "rcs = []\n"
        "with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):\n"
        f"    rcs.append(main(['build', '--device=cpu', '-do', {built!r}, {fa!r}]))\n"
        f"    rcs.append(main(['build', '--device=cpu', '-m', '70000', '-o', {plain!r}, {fa!r}]))\n"
        f"    rcs.append(main(['merge', '--device=cpu', '-o', {str(tmp_path / 'm.fmr')!r}, {built!r}, {fmd!r}]))\n"
        f"    rcs.append(main(['plain2fmd', '-o', {str(tmp_path / 'p.fmd')!r}, {plain!r}]))\n"
        f"    rcs.append(main(['mem', '--device=cpu', '-l21', '-p3', {fmd!r}, {reads!r}]))\n"
        f"    rcs.append(main(['ssa', '--device=cpu', '-o', {str(tmp_path / 'x.ssa')!r}, {fmd!r}]))\n"
        f"    rcs.append(main(['hapdiv', '--device=cpu', '-a31', '-w60', {fmd!r}, {reads!r}]))\n"
        f"    rcs.append(main(['sw', '--device=cpu', '-j151', {fmd!r}, {reads!r}]))\n"
        f"    rcs.append(main(['search', '--device=cpu', '-l21', {fmd!r}, {reads!r}]))\n"
        f"    rcs.append(main(['stat', {fmd!r}]))\n"
        f"print(rcs, {FORBIDDEN})\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert r.returncode == 0 and r.stdout.strip() == "[0, 0, 0, 0, 0, 0, 0, 0, 0, 0] []", r.stdout + r.stderr
    assert open(built, "rb").read() == open(fmd, "rb").read()  # the port's FMD is the JAX package's


def test_utils_import_no_jax_package(corpus, corpus_fmd):
    """`get`, `suffix`, `kount` (on the CPU), `fa2line`, `fa2kmer` and a
    `mem --engine=server` with no server through the port's CLI leave no jax
    and no ropebwt3_tpu module loaded; the last imports no torch either."""
    fmd, reads = str(corpus_fmd), str(corpus / "reads.fa")
    code = (
        "import contextlib, io, sys\n"
        "from ropebwt3_tpu_torch.cli import main\n"
        "rcs = []\n"
        "out = io.TextIOWrapper(io.BytesIO())\n"
        "with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):\n"
        f"    rcs.append(main(['mem', '--engine=server', {fmd!r}, {reads!r}]))\n"
        "    rcs.append('torch' in sys.modules)\n"
        f"    rcs.append(main(['get', '--device=cpu', {fmd!r}, '7']))\n"
        f"    rcs.append(main(['suffix', '--device=cpu', {fmd!r}, {reads!r}]))\n"
        f"    rcs.append(main(['kount', '--device=cpu', '-k4', '-m2', {fmd!r}]))\n"
        f"    rcs.append(main(['fa2line', {reads!r}]))\n"
        f"    rcs.append(main(['fa2kmer', {reads!r}]))\n"
        f"print(rcs, {FORBIDDEN})\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       env=dict(os.environ, RB3TPU_STRICT_EXIT="1"))  # the commands' own codes: `mem`'s error is 1
    assert r.returncode == 0 and r.stdout.strip() == "[1, False, 0, 0, 0, 0, 0] []", r.stdout + r.stderr


def test_sources_import_no_jax_package():
    """No `import ropebwt3_tpu` / `from ropebwt3_tpu` (other than the port
    itself) and no jax import in the port's files or chip_smoke.py."""
    bad = re.compile(r"^\s*(import|from)\s+(ropebwt3_tpu(?!_torch)\b|jax\b|jaxlib\b)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, fn) for d, _, fns in os.walk(PORT) for fn in fns if fn.endswith(".py")]
    assert len(files) > 15
    hits = [f"{os.path.relpath(p, ROOT)}: {m.group(0).strip()}" for p in files for m in bad.finditer(open(p).read())]
    assert hits == []


def test_kernel_argtypes_match_the_c_signatures():
    """Without argtypes of the right length ctypes passes a pointer or an
    int64 as a 32-bit int: every `int rb3c_*(...)` of csrc/*.cu (the
    `##name` ones for each layout kernels.py lists, after the fixed part
    of the name) takes as many arguments as kernels.py declares, stream
    included where it takes one."""
    from ropebwt3_tpu_torch import kernels

    seen = set()
    for fn in sorted(os.listdir(kernels.CSRC)):
        if not fn.endswith(".cu"):
            continue
        text = open(os.path.join(kernels.CSRC, fn)).read().replace("\\\n", " ")
        for name, macro, params in re.findall(r"\bint (rb3c_\w+?)(##name)?\(([^)]*)\)\s*\{", text):
            names = [k for k in kernels._ENTRIES if k.startswith(name) and k[len(name):] in kernels.LAYOUTS] if macro else [name]
            assert names, name
            for k in names:
                assert len(kernels._ENTRIES[k]) == params.count(",") + 1, (k, params)
                seen.add(k)
    assert seen == set(kernels._ENTRIES)
