"""What the benchmark may load: nothing that it runs on the card imports JAX
or the JAX package, and the plain reference imports nothing of the port.
Top-level module names are compared whole: the port's package name only
begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "port_bench"
JAX_SIDE = {"jax", "jaxlib", "flax", "mola_lidar_odometry_tpu"}
PORT = "mola_lidar_odometry_tpu_torch"


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def sources(*parts):
    return sorted(p for p in BENCH.joinpath(*parts).rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def test_nothing_the_card_runs_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(ROOT)): top_level_imports(p) & JAX_SIDE for p in sources()}
    assert len(found) > 10
    assert not {k: v for k, v in found.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    ref = sources("reference")
    assert {p.name for p in ref} >= {"oracle.py", "pipeline.py"}
    assert not {str(p): top_level_imports(p) & (JAX_SIDE | {PORT}) for p in ref if top_level_imports(p) & (JAX_SIDE | {PORT})}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The modules a run loads (the harness, every metric reader, the port's
    step and sizing) leave no JAX module in ``sys.modules``; a reference
    worker's modules load nothing of the port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import port_bench.run as run\n"
        "from port_bench.harness import accuracy, check, program, readings, trace, work\n"
        "import mola_lidar_odometry_tpu_torch.parallel.batch, mola_lidar_odometry_tpu_torch.models.spec\n"
        "import mola_lidar_odometry_tpu_torch.utils.capacity, mola_lidar_odometry_tpu_torch.ops.pallas_capture\n"
        "import mola_lidar_odometry_tpu_torch.ops.pallas_icp, mola_lidar_odometry_tpu_torch.ops.pallas_match\n"
        "for p in sorted((run.BENCH / 'metrics').glob('*.py')): run.reader(p.stem)\n"
        "print(','.join(run.forbidden_modules()))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.oracle\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))\n" % (str(ROOT), JAX_SIDE | {PORT}))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
