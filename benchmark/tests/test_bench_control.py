"""The controls, one precision below the configuration's float32 with TF32
off, must come out not correct: the program with TF32 matmuls on (needs a
CUDA card; decides inside the test), and the plain reference put in the
program's place with every product's operands rounded to TF32 (on the CPU,
at a size a test run holds)."""

import pytest
import torch

from benchmark import core

REGULAR = "regular_n160.eigsh_k20"


@pytest.mark.cuda
def test_tf32_control_is_not_correct(tiny_root):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sound, code = core.run(REGULAR, 41, 0.5, False, root=tiny_root, device="cuda")
    assert code == 0 and sound["correct"]
    control, code = core.run(REGULAR, 41, 0.5, False, root=tiny_root, device="cuda", tf32=True)
    assert code == 0 and not control["correct"]


@pytest.mark.parametrize("seed", [43, 2**32 + 7])
def test_tf32_reference_control_fails_its_limits(tiny_root, seed):
    from benchmark import manifest, readings

    limits = manifest.Cell(manifest.load(tiny_root), REGULAR, tiny_root).limits
    got = readings.reference_control(REGULAR, seed, "cpu", root=tiny_root)
    assert any(got[name] > limits[name] for name in limits), (got, limits)
    assert got["op_err"] > limits["op_err"]
