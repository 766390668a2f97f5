"""Kernel #9, the layout pin, on the CPU: its plain version against the JAX
package's pin (an identity), bit for bit on the strided inputs the UNet can
hand it, the autograd Function's identity gradient, the switch (off by
default, a no-op for CPU tensors, as the JAX gate is off the TPU), and the
wrapper's refusals. The kernel itself is held to `layout_pin_ref` on the card
(`tests/test_torch_kernel_cuda.py`, `chip_smoke.py`)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from sliders_tpu.ops import basic as jbasic
from sliders_tpu_torch.ops import basic as tbasic
from sliders_tpu_torch.ops import layout_pin as tlp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def pin_switch():
    jbasic.set_layout_pin(False)
    tbasic.set_layout_pin(False)
    yield
    jbasic.set_layout_pin(False)
    tbasic.set_layout_pin(False)


def _view(kind: str, dtype, shape=(2, 48, 40)):
    """A (B, L, C) tensor laid out as the UNet or a caller may pass it:
    contiguous, the (B, H, W, C) view of an NCHW buffer flattened to L
    (channel-major), a slice of a wider buffer, a batch-expanded row, and a
    transposed copy."""
    B, L, C = shape
    g = torch.Generator().manual_seed(0)
    full = torch.randn((B, L, C + 8), generator=g).to(dtype)
    if kind == "contiguous":
        return full[..., :C].contiguous()
    if kind == "channel_major":
        return torch.randn((B, C, L), generator=g).to(dtype).transpose(1, 2)
    if kind == "sliced":
        return full[..., 4:C + 4]
    if kind == "expanded":
        return full[:1, :, :C].expand(B, L, C)
    if kind == "strided_rows":
        return torch.randn((B, 2 * L, C), generator=g).to(dtype)[:, ::2]
    raise ValueError(kind)


KINDS = ["contiguous", "channel_major", "sliced", "expanded", "strided_rows"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kind", KINDS)
def test_ref_is_a_bit_exact_contiguous_copy(kind, dtype):
    x = _view(kind, dtype)
    y = tlp.layout_pin_ref(x)
    assert y.is_contiguous() and y.dtype == x.dtype and y.shape == x.shape
    assert y.data_ptr() != x.data_ptr()
    assert torch.equal(y.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       x.contiguous().view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_ref_equals_the_jax_pin(kind, pin_switch):
    """The JAX package's pin is the identity wherever it does not run its
    Pallas copy (off the TPU, even when enabled); the port's plain copy holds
    the same values."""
    x = _view(kind, torch.float32)
    jbasic.set_layout_pin(True)
    ref = np.asarray(jbasic.layout_pin(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(tlp.layout_pin_ref(x).numpy(), ref)


def test_wrapper_on_cpu_runs_the_plain_version():
    x = _view("channel_major", torch.bfloat16)
    before = tlp.layout_pin_copy.launches
    y = tlp.layout_pin_copy(x)
    assert torch.equal(y, x) and y.is_contiguous()
    assert tlp.layout_pin_copy.launches == before  # CPU calls are not counted


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match=r"\(B, L, C\)"):
        tlp.layout_pin_copy(torch.zeros(2, 3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tlp.layout_pin_copy(torch.zeros(2, 3, 4, device="meta"))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_function_gradient_is_the_identity(dtype):
    """`LayoutPin`'s backward pins the cotangent: the gradient reaching x is
    the upstream gradient, bit for bit, and the Function saves nothing."""
    x = _view("sliced", dtype).detach().requires_grad_()
    y = tlp.LayoutPin.apply(x)
    assert y.grad_fn is not None and torch.equal(y, x.detach())
    assert not y.grad_fn.saved_tensors
    g = torch.randn(y.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    (gx,) = torch.autograd.grad(y, x, g)
    assert torch.equal(gx, g)


def test_function_under_checkpoint_and_inference_mode():
    """Serving calls the pin under inference_mode; training may recompute it
    under a non-reentrant checkpoint."""
    with torch.inference_mode():
        x = _view("channel_major", torch.float32)
        assert torch.equal(tlp.LayoutPin.apply(x), x)
    w = torch.randn(40, 40, requires_grad=True)
    x = _view("contiguous", torch.float32)

    def f(w):
        return (tlp.LayoutPin.apply(x @ w) ** 2).sum()

    (g_ckpt,) = torch.autograd.grad(checkpoint(f, w, use_reentrant=False), w)
    (g_plain,) = torch.autograd.grad(((x @ w) ** 2).sum(), w)
    assert torch.equal(g_ckpt, g_plain)


def test_switch_is_off_by_default():
    code = ("from sliders_tpu_torch.ops import basic\n"
            "assert basic._layout_pin is False\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    assert subprocess.run([sys.executable, "-c", code], env=env, timeout=120).returncode == 0


def test_switch_is_a_noop_on_the_cpu(pin_switch):
    x = _view("channel_major", torch.bfloat16)
    assert tbasic.layout_pin(x) is x
    tbasic.set_layout_pin(True)
    assert tbasic._layout_pin
    assert tbasic.layout_pin(x) is x  # a CPU tensor: the gate returns x
    flat = torch.zeros(2, 3)
    assert tbasic.layout_pin(flat) is flat  # not (B, L, C)
