"""`jax` is an optional dependency: the package must import and run the
exact C path on a host without jax (pyproject: jax lives in the `jax`
extra)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_and_run_without_jax():
    probe = (
        "import sys\n"
        "class _Block:\n"
        "    def find_module(self, name, path=None):\n"
        "        if name == 'jax' or name.startswith('jax.'):\n"
        "            raise ImportError('jax blocked for test')\n"
        "sys.meta_path.insert(0, _Block())\n"
        "sys.modules.pop('jax', None)\n"
        "import pyrodigal_tpu\n"
        "g = pyrodigal_tpu.GeneFinder(meta=True).find_genes("
        "'AATGTAGGAAAAACAGCATTTTCATTTCGCCATTTT' * 30)\n"
        "print(len(g))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="",
               PYTHONNOUSERSITE="1")
    r = subprocess.run([sys.executable, "-c", probe], env=env,
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "1"
