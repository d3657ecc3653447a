"""The control: the reference in a lower precision, put in the program's
place, comes out not correct (bf16 on the CPU here; TF32, the step below
the configurations' fp32, on the card), while fp32 passes."""
import pytest
import torch

from joinbench import check, control


@pytest.mark.parametrize("workload", ["tiny.count", "tiny.pairs"])
def test_bf16_control_fails_and_fp32_passes(tiny, workload):
    root, here = tiny
    low = control.control_numbers(root, workload, 2 ** 32 + 9, 2, "bf16", "cpu", here=here)
    same = control.control_numbers(root, workload, 2 ** 32 + 9, 2, "fp32", "cpu", here=here)
    assert not check.passed(low), low
    assert check.passed(same), same


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny.count", "tiny.pairs"])
def test_tf32_control_fails_on_the_card(tiny, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: TF32 runs on its tensor cores")
    root, here = tiny
    low = control.control_numbers(root, workload, 2 ** 32 + 9, 2, "tf32", "cuda", here=here)
    assert not check.passed(low), low
