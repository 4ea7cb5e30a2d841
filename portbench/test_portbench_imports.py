"""A tiny CPU rehearsal of each cell's loop, in a fresh process, loads no
module whose top-level name is ``jax``, ``jaxlib``, ``flax`` or the JAX
package's (compared whole: the port's own name begins with it)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]

SCRIPT = """
import json, sys
from portbench import harness
from portbench.conftest import tiny
for trace in (False, True):
    harness.run({cell!r}, 2**31 + 9, 0.5, trace, device="cpu", patch=tiny)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_loop_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(cell=cell)], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch_m3gnet_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "torch_m3gnet_tpu"}
