"""The port's tests remove what they write under pytest's base temp
(``torch_parity.tmp_path``, and the module fixtures over
``tmp_path_factory``).

Before they did, a whole run of the port's tests left 6.1 GB there (full
runs on an 8-core CPU host), against 0.7 GB for the tests before the port.
pytest keeps the trees of the last three runs and removes the oldest only
when a run ends, so a fourth run in a row wrote beside about 18 GB of
earlier trees and ran out of space near its end: the trainer parity tests
that were writing then failed with ``OSError: [Errno 28]``, and passed
again on their own.  Here: every port test module that writes under
``tmp_path`` takes the removing fixture and every module fixture over
``tmp_path_factory`` removes its tree (read from the sources), and a test
run in a child pytest leaves no file under its base temp."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

from torch_parity import tmp_path  # noqa: F401  (each test's outputs removed when it ends)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
# Imports no JAX, so not torch_parity either; it runs only where a GPU is.
JAX_FREE = {"test_torch_cuda.py"}


def _offences(path):
    """What in the test module at ``path`` leaves files behind."""
    tree = ast.parse(open(path).read())
    out = []
    takes_tmp_path = any(isinstance(n, ast.arg) and n.arg == "tmp_path" for n in ast.walk(tree))
    imported = {a.name for n in tree.body if isinstance(n, ast.ImportFrom)
                and n.module == "torch_parity" for a in n.names}
    if takes_tmp_path and "tmp_path" not in imported:
        out.append("takes tmp_path without torch_parity's")
    for fn in (n for n in tree.body if isinstance(n, ast.FunctionDef)):
        calls = {ast.unparse(n.func) for n in ast.walk(fn) if isinstance(n, ast.Call)}
        if "tmp_path_factory.mktemp" in calls and not (
                "shutil.rmtree" in calls and any(isinstance(n, ast.Yield) for n in ast.walk(fn))):
            out.append(f"{fn.name} keeps its tmp_path_factory tree")
    return out


def test_every_port_module_removes_what_its_tests_write():
    offences = {os.path.basename(p): _offences(p)
                for p in sorted(glob.glob(os.path.join(TESTS, "test_torch_*.py")))
                if os.path.basename(p) not in JAX_FREE}
    assert len(offences) > 50
    assert not {k: v for k, v in offences.items() if v}


def test_a_run_leaves_no_file_under_its_base_temp(tmp_path):
    """A child pytest runs a module whose test writes 1 MB through
    ``torch_parity.tmp_path``: it passes and its base temp holds no file."""
    child = tmp_path / "child"
    child.mkdir()
    (child / "test_writes.py").write_text(textwrap.dedent('''\
        from torch_parity import tmp_path  # noqa: F401


        def test_writes(tmp_path):
            (tmp_path / "out").mkdir()
            (tmp_path / "out" / "blob.bin").write_bytes(bytes(1 << 20))
            assert (tmp_path / "out" / "blob.bin").stat().st_size == 1 << 20
        '''))
    base = tmp_path / "base"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "--basetemp", str(base),
         str(child)], cwd=child, env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "1 passed" in run.stdout, run.stdout[-2000:] + run.stderr[-2000:]
    assert base.is_dir() and not [p for p in base.rglob("*") if p.is_file()]
