"""The TF32 split of the f32 conv kernels' Hopper mainloop, on the CPU.

`ops/conv3x3.tf32_split_ref` is the plain version of the `tf32_split`
kernel (`csrc/conv3x3.cu`), and `tf32_rna` is the rounding the mainloop
applies to the halo in registers (`conv_sm90::tf32_rna`, `cvt.rna.tf32.f32`
with the low 13 bits cleared). Held here: the parts are TF32 values, hi +
lo gives w back to 2^-22, ties round away from zero, and the error argument
of the three-product scheme (3xTF32): a_lo w_hi + a_hi w_lo + a_hi w_hi,
summed exactly, stays within the kernels' f32 tolerance (1e-5 of the
largest output) at 9 x 512 = 4608 terms, where one TF32 product does not.
That argument bounds the split's error only: the sums here are exact, so
it does not model the tensor cores' own accumulation, which over a whole
K = 9 C misses the tolerance at C = 512. The mainloop's answer to that
(each 32-channel chunk's products summed on their own, then added into a
second f32 accumulator) is held by the card tests of
`tests/test_torch_kernel_cuda.py` and by `chip_smoke.py`.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sliders_tpu_torch.ops import conv3x3 as tc

TOL = 1e-5  # chip_smoke.py's F32_TOL, of max(1, the largest output)


def _weight(rng, n, c, scale=None):
    w = rng.standard_normal((n, c, 3, 3)).astype(np.float32) * (scale or (9 * c) ** -0.5)
    return torch.from_numpy(w).contiguous(memory_format=torch.channels_last)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("seed", [0, 1])
def test_split_parts_are_tf32_values(seed):
    """hi and lo keep 10 mantissa bits: their low 13 bits are zero."""
    split = tc.tf32_split_ref(_weight(np.random.default_rng(seed), 64, 96))
    assert split.shape == (2, 64, 3, 3, 96) and split.dtype == torch.float32
    assert split.is_contiguous()
    assert (_bits(split) & 0x1FFF).eq(0).all()
    # lo is the remainder: at most half a TF32 ulp of hi, so it is nonzero
    # only where w has bits below hi's
    assert split[1].abs().max() <= split[0].abs().max() * 2.0**-11


@pytest.mark.parametrize("scale", [1.0, 2.0**-60, 2.0**60])
def test_hi_plus_lo_reproduces_w(scale):
    rng = np.random.default_rng(2)
    w = _weight(rng, 32, 64, scale=scale)
    hi, lo = tc.tf32_split_ref(w)
    v = w.permute(0, 2, 3, 1).double()
    err = (hi.double() + lo.double() - v).abs()
    assert (err <= v.abs() * 2.0**-22).all()
    # the order of the split's output is (N, 3, 3, C): the weight's memory order
    assert torch.equal(hi.flatten(), tc.tf32_rna(w.permute(0, 2, 3, 1)).flatten())


def _rna_exact(v: float) -> float:
    """v rounded to 11 significant bits, to nearest with ties away from zero,
    in exact rational arithmetic (normal floats)."""
    q = Fraction(v)
    if q == 0:
        return 0.0
    sign, q = (-1 if q < 0 else 1), abs(q)
    e = 0
    while q >= 2:
        q, e = q / 2, e + 1
    while q < 1:
        q, e = q * 2, e - 1
    m = q * 2**10  # 11 significant bits: m in [1024, 2048)
    r = int(m) + (1 if m - int(m) >= Fraction(1, 2) else 0)
    return sign * float(Fraction(r, 2**10) * Fraction(2) ** e)


def test_rounding_is_to_nearest_ties_away():
    # exact ties: the 13 dropped bits are 0x1000. Round-to-even would send
    # 1 + 2^-11 down to 1; RNA sends it (and its negative) away from zero.
    ties = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 3 * 2.0**-11, (1 + 2.0**-11) * 2.0**-9,
                         -(2.0**-100) * (1 + 2.0**-11)], dtype=torch.float32)
    want = torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10), 1 + 2 * 2.0**-10, (1 + 2.0**-10) * 2.0**-9,
                         -(2.0**-100) * (1 + 2.0**-10)], dtype=torch.float32)
    assert torch.equal(tc.tf32_rna(ties), want)
    # below and above a tie by one f32 ulp
    below = torch.tensor([1 + 2.0**-11 - 2.0**-23], dtype=torch.float32)
    above = torch.tensor([1 + 2.0**-11 + 2.0**-23], dtype=torch.float32)
    assert tc.tf32_rna(below).item() == 1.0
    assert tc.tf32_rna(above).item() == 1 + 2.0**-10
    # random normal floats against exact rational rounding
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(2000).astype(np.float32)
                         * np.float32(1e3))
    got = tc.tf32_rna(v).tolist()
    assert got == [_rna_exact(x) for x in v.tolist()]


def test_rounding_keeps_nan_and_inf():
    """A NaN stays a NaN, whatever its sign and payload (the integer add alone
    would turn 0x7f800001 into inf and -NaN into +0); inf stays inf."""
    bits = torch.tensor([0x7F800001, 0x7FC00000, -0x800000 + 1, 0x7F800000, -0x800000],
                        dtype=torch.int32)  # NaN, NaN, -NaN, inf, -inf
    got = tc.tf32_rna(bits.view(torch.float32))
    assert torch.isnan(got[:3]).all()
    assert got[3].item() == float("inf") and got[4].item() == float("-inf")
    hi, lo = tc.tf32_split_ref(torch.full((1, 1, 3, 3), float("nan")))
    assert torch.isnan(hi).all() and torch.isnan(lo).all()


def test_split_of_a_cuda_weight_needs_the_card_only():
    """On the CPU the wrapper is the plain version and counts no launch."""
    w = _weight(np.random.default_rng(4), 8, 16)
    before = tc.tf32_split.launches
    assert torch.equal(tc.tf32_split(w), tc.tf32_split_ref(w))
    assert tc.tf32_split.launches == before
    with pytest.raises(ValueError, match="on cpu or cuda"):
        tc.tf32_split(torch.empty((8, 16, 3, 3), device="meta"))


def _emulate(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """The mainloop's arithmetic in f64 on the TF32 parts (no rounding of the
    sums): '3x' = a_lo w_hi + a_hi w_lo + a_hi w_hi, '1x' = a_hi w_hi."""
    x_hi = tc.tf32_rna(x)
    x_lo = tc.tf32_rna(x - x_hi)
    w_hi, w_lo = tc.tf32_split_ref(w)  # (N, 3, 3, C)

    def conv(xp, wp):
        return F.conv2d(xp.double().permute(0, 3, 1, 2), wp.double().permute(0, 3, 1, 2),
                        padding=1)

    y = conv(x_hi, w_hi)
    if products == "3x":
        y = y + conv(x_lo, w_hi) + conv(x_hi, w_lo)
    return (y + b.double()[None, :, None, None]).permute(0, 2, 3, 1)


@pytest.mark.parametrize("x_scale", [1.0, 30.0])
def test_three_products_meet_the_f32_tolerance_and_one_does_not(x_scale):
    """At 9 x C = 4608 terms a sum (C = 512, the SD VAE decoder's width) the
    three-product scheme lands about 1e-6 of the largest output from the
    exact-f32 plain version, well inside 1e-5; one TF32 product misses by
    more than tenfold."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((1, 8, 8, 512)).astype(np.float32) * x_scale)
    w = _weight(rng, 64, 512)
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32) * 0.1)
    ref = tc.conv3x3_ref(x, w, b).double()
    tol = TOL * max(1.0, ref.abs().max().item())
    err3 = (_emulate(x, w, b, "3x") - ref).abs().max().item()
    err1 = (_emulate(x, w, b, "1x") - ref).abs().max().item()
    assert err3 <= tol / 3, (err3, tol)
    assert err1 > 10 * tol, (err1, tol)
