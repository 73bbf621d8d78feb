"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their whole top-level name: the port's name begins with the JAX
package's, so a prefix match would be wrong."""

import ast
import subprocess
import sys

from portbench import harness

PB = harness.ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "scheduler_plugins_tpu"}
PORT = "scheduler_plugins_tpu_torch"


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PB.rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (PB / "reference").rglob("*.py"):
        assert PORT not in top_level_imports(path), path
        assert not top_level_imports(path) & FORBIDDEN, path


def test_whole_name_comparison():
    assert PORT.split(".")[0] not in FORBIDDEN
    assert PORT.startswith("scheduler_plugins_tpu")


def test_a_run_loads_no_jax():
    """A cut run in a fresh process, then its loaded modules."""
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(harness.ROOT)!r}, {str(PB / 'tests')!r}]\n"
        "from pbhelpers import cpu_run\n"
        "cpu_run('spread_5k.burst', 1, 0.2)\n"
        "cpu_run('basic_5k.churn', 1, 0.2)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & FORBIDDEN
