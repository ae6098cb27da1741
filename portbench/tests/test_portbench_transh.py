"""TransH in the benchmark: a planted fault fails a tiny ``transh-fb15k.train``
run, and its plain reference loads nothing of the port."""

import subprocess
import sys

import pytest

from conftest import REPO
from portbench import cell, faults, spec


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_a_planted_fault_fails_the_transh_check(tiny, fault):
    c = spec.load("transh-fb15k.train", tiny)
    with faults.plant(fault):
        out = cell.run(c, 2**31 + 21, 0.2, False, device="cpu")
    assert not out["correct"], out["checks"]
    assert cell.run(c, 2**31 + 21, 0.2, False, device="cpu")["correct"]  # the patch is gone again


def test_the_transh_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path.insert(0, {repo!r}); import portbench.reference.transh;"
            "print(sorted({{n.split('.')[0] for n in sys.modules}} & {{'kb2e_tpu_torch', 'kb2e_tpu', 'jax', 'jaxlib',"
            " 'flax'}}))").format(repo=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
