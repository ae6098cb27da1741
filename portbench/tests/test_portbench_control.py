"""The control, the program a precision below the configuration's, fails the check.

Each cell's control is named in its limits file; its readings at the cells'
own size are in PERF.md.  Here it runs on a smaller graph at the
configurations' widths: on the CPU where the control is a bfloat16 one, on
the card where it is TF32 (which the CPU does not have).
"""

import pytest

from conftest import SMALL_GRAPH, tiny_root
from portbench import cell, spec

CELLS = ["transe-fb15k.train", "transr-fb15k.train", "transe-fb15k.eval", "transr-fb15k.eval"]


def _control_run(tmp_path, name, device):
    c = spec.load(name, tiny_root(tmp_path, k=None, num_batches=20, graph=SMALL_GRAPH))
    sound = cell.run(c, 2**31 + 31, 0, False, device=device)
    control = cell.run(c, 2**31 + 31, 0, False, device=device, control=c.limits["control"])
    return c, sound, control


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_where_the_program_passes(tmp_path, name):
    if spec.load(name).limits["control"] == "tf32":
        pytest.skip("a TF32 control: the CPU has no TF32 (run on the card by the test below)")
    _, sound, control = _control_run(tmp_path, name, "cpu")
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_on_the_card(cuda, tmp_path, name):
    _, sound, control = _control_run(tmp_path, name, cuda)
    assert sound["correct"], sound["checks"]
    assert not control["correct"], control["checks"]
