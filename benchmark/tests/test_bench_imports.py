"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (dsptpu_torch begins with dsptpu); the
references load nothing of the program."""

import json
import subprocess
import sys

from benchmark.tests.helpers import CELLS, ROOT

FORBIDDEN = ["jax", "jaxlib", "flax", "dsptpu"]


def _loaded_after(code):
    script = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
              "import json\n"
              "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=600, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_harness_configs_and_references_load_no_jax():
    code = ("from benchmark import harness, readings\n"
            "from dsptpu_torch import kernels\n"
            "for w in %r:\n"
            "    c = harness.Cell(%r, w)\n"
            "    c.config.build(c.cfg, 8192, 2, 'cpu')\n"
            "kernels.launch_counts()\n" % (list(CELLS), str(ROOT)))
    loaded = _loaded_after(code)
    assert "dsptpu_torch" in loaded
    assert not loaded & set(FORBIDDEN), sorted(loaded & set(FORBIDDEN))


def test_references_load_nothing_of_the_program():
    code = ("from benchmark import harness\n"
            "for name in ('array64_chain', 'speech16k_filtfilt_lpc16'):\n"
            "    harness._load(harness.Path(%r) / 'benchmark' / 'reference'"
            " / (name + '.py'), 'reference')\n" % str(ROOT))
    loaded = _loaded_after(code)
    assert not loaded & set(FORBIDDEN + ["dsptpu_torch"])
