"""``PT_FLAGS_default_matmul_precision`` in the port: each value of the
JAX package's flag maps onto torch's float32 matmul precision and cuDNN's
TF32 switch, it is applied when ``paddle_tpu_torch`` is imported, and an
invalid value raises ``ValueError`` as the JAX package's import does."""

import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import flags

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def torch_precision():
    saved = (torch.get_float32_matmul_precision(),
             torch.backends.cudnn.allow_tf32)
    yield
    torch.set_float32_matmul_precision(saved[0])
    torch.backends.cudnn.allow_tf32 = saved[1]


@pytest.mark.parametrize("value, mode, tf32", [
    ("float32", "highest", False), ("highest", "highest", False),
    ("tensorfloat32", "high", True), ("bfloat16", "medium", True)])
def test_matmul_precision_mapping(torch_precision, value, mode, tf32):
    torch.set_float32_matmul_precision("medium" if mode == "highest"
                                       else "highest")
    torch.backends.cudnn.allow_tf32 = not tf32
    flags.apply_matmul_precision(value)
    assert torch.get_float32_matmul_precision() == mode
    assert torch.backends.cuda.matmul.allow_tf32 == tf32
    assert torch.backends.cudnn.allow_tf32 == tf32


def test_empty_value_leaves_torch_as_it_is(torch_precision):
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = False
    assert flags.flag("default_matmul_precision") == ""
    flags.apply_matmul_precision()
    flags.apply_matmul_precision("")
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cudnn.allow_tf32 is False
    with pytest.raises(ValueError, match="not a valid matmul precision"):
        flags.apply_matmul_precision("fp8")


def _import_with(value):
    code = ("import torch, paddle_tpu_torch\n"
            "print(torch.get_float32_matmul_precision(),"
            " torch.backends.cudnn.allow_tf32)\n")
    env = dict(os.environ, PT_FLAGS_default_matmul_precision=value)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_applied_at_import_and_invalid_value_raises():
    res = _import_with("tensorfloat32")
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["high", "True"]
    res = _import_with("float16")
    assert res.returncode != 0
    assert "ValueError: PT_FLAGS_default_matmul_precision='float16' is not " \
        "a valid matmul precision" in res.stderr
