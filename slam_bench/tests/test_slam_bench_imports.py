"""What the benchmark loads: nothing of JAX or the JAX package anywhere in
it, and nothing of the program in its reference. Top-level module names
(the part before the first dot) are compared whole, so the port
``fastliosam_tpu_torch`` is never taken for the JAX package
``fastliosam_tpu``."""
from __future__ import annotations

import json
import subprocess
import sys

from slam_bench import run

JAX = {"jax", "jaxlib", "flax", "fastliosam_tpu"}


def _top_level_after(code: str) -> set[str]:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=run.ROOT, capture_output=True, text=True, check=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_and_every_file_of_it_load_no_jax():
    files = sorted(p for p in run.BENCH_DIR.rglob("*.py") if "tests" not in p.parts)
    mods = [".".join(p.relative_to(run.ROOT).with_suffix("").parts) for p in files]
    code = "import importlib\n" + "".join(
        f"importlib.import_module({m.removesuffix('.__init__')!r})\n" for m in mods)
    # the program's step as the window drives it, its kernels' modules with it
    code += "import fastliosam_tpu_torch.odom.pipeline, fastliosam_tpu_torch.ops\n"
    names = _top_level_after(code)
    assert "slam_bench" in names and "fastliosam_tpu_torch" in names
    assert not names & JAX, names & JAX


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level_after("import slam_bench.check, slam_bench.feed, "
                             "slam_bench.reference.odometry")
    assert "fastliosam_tpu_torch" not in names
    assert not names & JAX
