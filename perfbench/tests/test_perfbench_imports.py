"""What the benchmark loads: no module it imports has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``atdn_vslam_tpu``, and the reference
loads nothing of the program (``atdn_vslam_torch``). Names are compared
whole, up to the first dot: the program's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
JAX_NAMES = {"jax", "jaxlib", "flax", "atdn_vslam_tpu"}


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.', 1)[0] "
                                      "for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, check=True,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _modules(under: Path) -> list[str]:
    return sorted(".".join(p.relative_to(ROOT).with_suffix("").parts) for p in under.rglob("*.py")
                  if "tests" not in p.parts and p.name != "__init__.py" and "metrics" not in p.parts)


def test_the_harness_loads_no_jax():
    imports = "\n".join(f"import {m}" for m in _modules(BENCH))
    readers = ("from perfbench.core import spec\n"
               "bench = json.loads((spec.ROOT / 'BENCHMARK.json').read_text())\n"
               "[spec.reader(m['name']) for m in bench['end_to_end'] + bench['per_layer']]")
    loaded = _loaded_after(f"import json\n{imports}\n{readers}\n"
                           "from perfbench.runners import stream, odometry_train, flow_train\n"
                           "import atdn_vslam_torch.slam, atdn_vslam_torch.training.flow, "
                           "atdn_vslam_torch.training.odometry")
    assert "atdn_vslam_torch" in loaded
    assert not loaded & JAX_NAMES


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("\n".join(f"import {m}" for m in _modules(BENCH / "reference")))
    assert not loaded & (JAX_NAMES | {"atdn_vslam_torch"})
    for path in (BENCH / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                top = name.split(".", 1)[0]
                assert top in {"__future__", "contextlib", "math", "torch", "perfbench"}, (path, name)
                assert top != "perfbench" or name.startswith("perfbench.reference"), (path, name)
