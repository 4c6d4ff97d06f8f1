"""The port never imports jax."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import ropebwt3_tpu_torch, ropebwt3_tpu_torch.ops.rank, ropebwt3_tpu_torch.ops.runblock, ropebwt3_tpu_torch.ops.smem, ropebwt3_tpu_torch.cli\n"
        "import ropebwt3_tpu_torch.ssa_ops, ropebwt3_tpu_torch.probe\n"
        "print(sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')))\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    assert r.stdout.strip() == "[]", r.stdout
