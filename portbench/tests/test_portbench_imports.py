"""Nothing the benchmark runs loads JAX or the JAX package, judged by the
whole top-level module name, and the reference loads nothing of the
program."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from portbench.tests.conftest import REPO

BLOCKER = textwrap.dedent('''
    import importlib.abc, sys

    class Block(importlib.abc.MetaPathFinder):
        def __init__(self, names):
            self.names = set(names)

        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in self.names:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block(BLOCKED))
''')

HARNESS = ["portbench.run", "portbench.common", "portbench.generator",
           "portbench.weights", "portbench.trace", "portbench.counts",
           "portbench.serve", "portbench.train", "portbench.calibrate",
           "portbench.sweep", "portbench.reference.model"]


def _python(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=600)


def test_harness_imports_without_jax():
    code = ("BLOCKED = ['jax', 'jaxlib', 'flax', 'tpu_bootstrap']\n" + BLOCKER
            + "import importlib, pathlib\n"
            + "".join(f"importlib.import_module({m!r})\n" for m in HARNESS)
            + "from portbench import common\n"
            + "for p in sorted(pathlib.Path('portbench/metrics').glob('*.py')):\n"
            + "    common.load_reader(p.stem)\n"
            + "import tpu_bootstrap_torch.workload.serving\n"
            + "import tpu_bootstrap_torch.workload.train\n"
            + "print(common.forbidden_loaded())\n")
    done = _python(code)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[]"


def test_blocker_compares_whole_top_level_names():
    code = ("BLOCKED = ['tpu_bootstrap']\n" + BLOCKER
            + "import tpu_bootstrap_torch\n"
            + "try:\n    import tpu_bootstrap\nexcept ImportError:\n"
            + "    print('blocked')\n")
    done = _python(code)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "blocked"


def test_reference_imports_nothing_of_the_program():
    code = ("BLOCKED = ['jax', 'jaxlib', 'flax', 'tpu_bootstrap', "
            "'tpu_bootstrap_torch']\n" + BLOCKER
            + "import portbench.reference.model, sys\n"
            + "print(sorted(m for m in sys.modules if m.startswith('tpu_')))\n")
    done = _python(code)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[]"


def test_a_whole_cpu_run_loads_no_jax(tmp_path):
    from portbench.tests.conftest import make_tiny_root

    root = make_tiny_root(tmp_path)
    code = ("BLOCKED = ['jax', 'jaxlib', 'flax', 'tpu_bootstrap']\n" + BLOCKER
            + f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            + "import torch\nfrom portbench import run\n"
            + "sys.exit(run.main(['--workload', 'olmo2-1b.chat', '--seed',"
            + " '3', '--seconds', '1', '--trace', '0'],"
            + " device=torch.device('cpu')))\n")
    done = _python(code, cwd=root)
    assert done.returncode == 0, done.stderr
    assert '"correct": true' in done.stdout.strip().splitlines()[-1]


def test_a_checkout_without_the_program_gives_no_result(tmp_path):
    import shutil

    shutil.copytree(REPO / "portbench", tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    done = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "olmo2-1b.chat",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert done.returncode != 0
    assert '"correct"' not in done.stdout
