"""Nothing the benchmark runs loads JAX, the JAX package or its benchmark,
and the reference loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from podbench import harness, run

RUN_TINY = """
import json, sys
from podbench import tiny
for name in ("qwen2-1.5b-train", "qwen2-1.5b-prefill"):
    tiny.run_tiny(tiny.tiny_cell(name), trace=True)
from podbench import run
print(json.dumps(run.forbidden_modules()))
"""

REFERENCE_ONLY = """
import json, sys
import podbench.reference.model, podbench.reference.dense, podbench.reference.adamw
import podbench.reference.ssm
print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))
"""


def _python(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_a_run_loads_no_jax_nor_the_jax_package():
    assert _python(RUN_TINY) == []


def test_the_reference_loads_nothing_of_the_program():
    top = set(_python(REFERENCE_ONLY))
    assert not top & {"repro_torch", *run.FORBIDDEN}
