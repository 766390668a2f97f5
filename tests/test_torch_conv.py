"""The port's conv kernels (#5-#7, `ops/conv3x3.py`) and their routing on the
CPU, against the JAX package.

On CPU tensors the port's wrappers run the kernels' plain versions; the JAX
side runs its Pallas kernels in interpret mode (`pallas_conv.set_interpret`,
the `*_interpret` conv impls), as its own tests do. The same seeded numpy
inputs go to both; weights cross in JAX layouts through
`models.convert.from_jax_params`. Tolerances, each relative to the largest
magnitude of the JAX result: f32 1e-5 for one conv (sums in another order),
1e-4 through a resnet block's gradient or a UNet; bf16 two bf16 ulps (both
accumulate in f32 and round once, so a rounding may flip).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sliders_tpu.models import unet2d as junet
from sliders_tpu.ops import basic as jb
from sliders_tpu.ops import pallas_conv as pc
from sliders_tpu_torch.models import unet2d as tunet
from sliders_tpu_torch.models.convert import from_jax_params
from sliders_tpu_torch.ops import basic as tb
from sliders_tpu_torch.ops import conv3x3 as tc

B, H, W, C, N = 2, 8, 32, 64, 128  # H*W = 256: every JAX gate admits it
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def conv_impls():
    """Both packages' conv switches start and end at 'xla' (xdist runs other
    files in the same worker)."""
    jb.set_conv_impl("xla")
    pc.set_interpret(False)
    tb.set_conv_impl("xla")
    yield
    jb.set_conv_impl("xla")
    pc.set_interpret(False)
    tb.set_conv_impl("xla")


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts the port's conv-kernel wrapper calls by kernel name (CPU
    calls, which run the plain versions, are never counted as launches)."""
    calls = {}
    launch = tc._launch

    def spy(fn, *args):
        calls[fn.__name__] = calls.get(fn.__name__, 0) + 1
        return launch(fn, *args)

    monkeypatch.setattr(tc, "_launch", spy)
    return calls


def _close(out: torch.Tensor, ref, rel: float):
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(out.detach().float().numpy(), ref, rtol=0, atol=rel * scale)


def _bf16_ulps(ref, n: int) -> float:
    m = float(np.abs(np.asarray(jnp.asarray(ref, jnp.float32))).max())
    return n * 2.0 ** (np.floor(np.log2(m)) - 7)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel,mode", [
    ("conv3x3", "none"),
    ("epi", "none"), ("epi", "temb"), ("epi", "residual"),
    ("fused", "none"), ("fused", "temb"), ("fused", "residual"),
])
def test_plain_versions_match_jax_kernels(kernel, mode, dtype, kernel_calls):
    rng = np.random.default_rng(0)
    x = _normal(rng, B, H, W, C, scale=2.0) + 0.5
    w = _normal(rng, 3, 3, C, N, scale=(9 * C) ** -0.5)
    b = _normal(rng, N, scale=0.1)
    a = 1.0 + _normal(rng, B, C, scale=0.1)
    s = _normal(rng, B, C, scale=0.3)
    extra = {"none": None, "temb": _normal(rng, B, N),
             "residual": _normal(rng, B, H, W, N)}[mode]
    jd, td = DTYPES[dtype]
    tp = from_jax_params({"conv": {"weight": w, "bias": b}})["conv"]
    jx, jw, jbias = (jnp.asarray(v, jd) for v in (x, w, b))
    je = None if extra is None else jnp.asarray(extra, jd)
    tx = torch.from_numpy(x).to(td)
    tw, tbias = tp["weight"].to(td), tp["bias"].to(td)
    te = None if extra is None else torch.from_numpy(extra).to(td)
    if kernel == "conv3x3":
        ref = pc.conv3x3(jx, jw, jbias, interpret=True)
        out = tc.conv3x3(tx, tw, tbias)
    elif kernel == "epi":
        ref = pc.epi_conv3x3(jx, jw, jbias, je, mode=mode, interpret=True)
        out = tc.epi_conv3x3(tx, tw, tbias, te, mode)
    else:
        ref = pc.fused_conv3x3(jx, jnp.asarray(a), jnp.asarray(s), jw, jbias, je, mode=mode,
                               interpret=True)
        out = tc.fused_conv3x3(tx, torch.from_numpy(a), torch.from_numpy(s), tw, tbias, te, mode)
    name = {"conv3x3": "conv3x3", "epi": "epi_conv3x3", "fused": "fused_conv3x3"}[kernel]
    assert kernel_calls == {name: 1}
    assert out.dtype == td and tuple(out.shape) == (B, H, W, N)
    if dtype == "float32":
        _close(out, ref, 1e-5)
    else:
        ref32 = np.asarray(ref.astype(jnp.float32))
        assert np.abs(out.float().numpy() - ref32).max() <= _bf16_ulps(ref32, 2)


def test_fused_padding_lies_in_the_normalised_space():
    """A border tap of kernel #6 reads 0, not silu(s): with a = 0 every
    in-image input becomes silu(s) and the border pixels see fewer taps."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_normal(rng, 1, 16, 16, 64))
    s = torch.full((1, 64), 2.0)
    w = torch.ones((128, 64, 3, 3))
    y = tc.fused_conv3x3(x, torch.zeros((1, 64)), s, w, torch.zeros(128))
    inner = 9 * 64 * 2.0 * torch.sigmoid(torch.tensor(2.0))
    assert torch.allclose(y[0, 5, 5], inner.expand(128), rtol=1e-5)
    assert torch.allclose(y[0, 0, 0], (inner * 4 / 9).expand(128), rtol=1e-5)


def test_wrapper_refuses_bad_arguments():
    x = torch.zeros((1, 16, 16, 64))
    w, b = torch.zeros((128, 64, 3, 3)), torch.zeros(128)
    with pytest.raises(ValueError, match="mode"):
        tc.epi_conv3x3(x, w, b, torch.zeros((1, 128)), "bias")
    with pytest.raises(ValueError, match="extra of shape"):
        tc.epi_conv3x3(x, w, b, torch.zeros((1, 16, 16, 128)), "temb")
    with pytest.raises(ValueError, match="extra of shape"):
        tc.epi_conv3x3(x, w, b, None, "residual")
    with pytest.raises(ValueError, match="matching channels"):
        tc.conv3x3(torch.zeros((1, 16, 16, 32)), w, b)
    with pytest.raises(ValueError, match="a and s"):
        tc.fused_conv3x3(x, torch.zeros((1, 64)), torch.zeros((2, 64)), w, b)


# ---------------------------------------------------------------------------
# gates and the switch
# ---------------------------------------------------------------------------

# (x NHWC, w HWIO) as the JAX gates take them
GATE_SHAPES = [
    ((16, 64, 64, 320), (3, 3, 320, 320)),    # SD1.5 level 0
    ((16, 64, 64, 640), (3, 3, 640, 320)),
    ((16, 64, 64, 640), (3, 3, 640, 640)),    # upsampler
    ((16, 32, 32, 1920), (3, 3, 1920, 640)),
    ((16, 16, 16, 2560), (3, 3, 2560, 1280)),
    ((2, 16, 16, 1280), (3, 3, 1280, 1280)),
    ((1, 8, 32, 64), (3, 3, 64, 128)),
    ((16, 8, 8, 1280), (3, 3, 1280, 1280)),   # 8x8 bottleneck: H*W < 256
    ((16, 8, 8, 2560), (3, 3, 2560, 1280)),
    ((1, 8, 16, 128), (3, 3, 128, 128)),       # H*W = 128
    ((1, 17, 17, 128), (3, 3, 128, 128)),      # H*W not a multiple of 8
    ((2, 64, 64, 4), (3, 3, 4, 320)),          # conv_in: C < 64
    ((2, 64, 64, 320), (3, 3, 320, 4)),        # conv_out: N < 128
    ((2, 64, 64, 320), (1, 1, 320, 320)),      # 1x1
    ((2, 64, 64, 320), (3, 3, 640, 320)),      # channels disagree
    ((2, 128, 128, 320), (3, 3, 320, 320)),    # 1024 px level 0: past the VMEM plan
    ((16, 64, 64, 960), (3, 3, 960, 320)),     # SD1.5 up level 0: past the fused plans
]


def _oihw(w_shape):
    kh, kw, c, n = w_shape
    return (n, c, kh, kw)


def _gate_pairs(x_shape, w_shape, itemsize):
    """(JAX gate, port gate, whether the JAX VMEM plan refuses the shape) for
    each of the three gates."""
    _, h, w, c = x_shape
    n = w_shape[-1]
    return [
        (pc.routed(x_shape, w_shape, 1, itemsize), tc.routed(x_shape, _oihw(w_shape), 1),
         pc._pick_tn(h, w, c, n, itemsize) == 0),
        *[(pc.epi_supports(x_shape, w_shape, itemsize, mode), tc.epi_supports(x_shape, _oihw(w_shape)),
           pc._pick_tn_epi(h, w, c, n, itemsize, mode) == 0) for mode in ("temb", "residual")],
        *[(pc.fused_supports(x_shape, w_shape, itemsize, mode),
           tc.fused_supports(x_shape, _oihw(w_shape)),
           pc._pick_tn_fused(h, w, c, n, itemsize, mode) == 0) for mode in ("temb", "residual")],
    ]


@pytest.mark.parametrize("x_shape,w_shape", GATE_SHAPES)
def test_gates_match_jax_but_for_the_vmem_plan(x_shape, w_shape):
    """Where the JAX VMEM plan admits a shape the gates agree; where it
    refuses one that passes every other condition, the port routes it (its
    kernel streams tiles through shared memory)."""
    for itemsize in (2, 4):
        for jax_gate, port_gate, plan_refuses in _gate_pairs(x_shape, w_shape, itemsize):
            if jax_gate or not plan_refuses:
                assert port_gate == jax_gate
            else:
                assert not jax_gate
    assert not tc.routed((2, 64, 64, 320), (320, 320, 3, 3), stride=2)
    assert not pc.routed((2, 64, 64, 320), (3, 3, 320, 320), stride=2)


def test_gates_differ_where_the_vmem_plan_refuses():
    for x_shape, w_shape in GATE_SHAPES[-2:]:
        assert tc.routed(x_shape, _oihw(w_shape)) and tc.epi_supports(x_shape, _oihw(w_shape))
        assert tc.fused_supports(x_shape, _oihw(w_shape))
        assert not pc.epi_supports(x_shape, w_shape, 2, "temb")
        assert not pc.fused_supports(x_shape, w_shape, 2, "temb")
    assert not pc.routed((2, 128, 128, 320), (3, 3, 320, 320))


def test_set_conv_impl_names_and_errors():
    assert tb.CONV_IMPLS == ("auto", "xla", "interpret", "fused", "fused_interpret",
                             "fused_ep", "fused_ep_interpret")
    assert tb.conv_impl() == "xla"
    for impl in tb.CONV_IMPLS:
        jb.set_conv_impl(impl)  # the JAX package takes each name too
        tb.set_conv_impl(impl)
        assert tb.conv_impl() == impl == jb.conv_impl()
    with pytest.raises(ValueError, match="conv impl"):
        tb.set_conv_impl("pallas")
    with pytest.raises(AssertionError):  # the JAX package asserts
        jb.set_conv_impl("pallas")
    assert tb.conv_impl() == "fused_ep_interpret"


# ---------------------------------------------------------------------------
# routing: conv2d, resnet blocks, the UNet
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_bias", [True, False])
def test_auto_conv2d_with_lora_tail_matches_jax_interpret(with_bias, kernel_calls):
    """The 'auto' branch of conv2d (kernel #5, zero bias when the conv has
    none, then the LoRA tail), value and LoRA grads, against the JAX
    package's 'interpret' branch (mirrors its
    test_conv2d_routing_integration_interpret)."""
    rng = np.random.default_rng(2)
    x = _normal(rng, 1, 16, 16, 128)
    p = {"weight": _normal(rng, 3, 3, 128, 128, scale=0.05)}
    if with_bias:
        p["bias"] = _normal(rng, 128)
    lw = {"conv": {"down": _normal(rng, 3, 3, 128, 2, scale=0.05),
                   "up": _normal(rng, 1, 1, 2, 128, scale=0.05), "alpha": np.float32(1.0)}}

    def jrun(jp, jl):
        lora = jb.SliderLora(weights=jl, multiplier=jnp.asarray(1.0))
        return jb.conv2d(jp, jnp.asarray(x), padding=1, lora=lora, name="conv")

    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jl = {"conv": {k: jnp.asarray(v) for k, v in lw["conv"].items()}}
    jb.set_conv_impl("interpret")
    pc.set_interpret(True)
    assert pc.routed(x.shape, p["weight"].shape, 1, 4)
    ref = jrun(jp, jl)
    ref_g = jax.grad(lambda jl: jnp.sum(jrun(jp, jl) ** 2))(jl)

    tb.set_conv_impl("auto")
    tp = from_jax_params({"conv": p})["conv"]
    tl = from_jax_params(lw)
    for k in ("down", "up"):
        tl["conv"][k].requires_grad_()
    out = tb.conv2d(tp, torch.from_numpy(x), padding=1,
                    lora=tb.SliderLora(tl, torch.tensor(1.0)), name="conv")
    (out ** 2).sum().backward()
    assert kernel_calls == {"conv3x3": 1}
    _close(out, ref, 1e-5)
    want = from_jax_params({"conv": {k: np.asarray(v) for k, v in ref_g["conv"].items()}})
    for k in ("down", "up"):
        _close(tl["conv"][k].grad, want["conv"][k].numpy(), 1e-4)


def _block(rng, c, n, temb_dim=16):
    """A ResnetBlock2D's parameters in JAX layouts (HWIO convs)."""
    def conv(kh, ci, co):
        return {"weight": _normal(rng, kh, kh, ci, co, scale=(ci * kh * kh) ** -0.5),
                "bias": _normal(rng, co, scale=0.1)}

    return {
        "norm1": {"weight": 1.0 + _normal(rng, c, scale=0.1), "bias": _normal(rng, c, scale=0.1)},
        "conv1": conv(3, c, n),
        "time_emb_proj": {"weight": _normal(rng, temb_dim, n, scale=0.25), "bias": np.zeros(n, np.float32)},
        "norm2": {"weight": 1.0 + _normal(rng, n, scale=0.1), "bias": _normal(rng, n, scale=0.1)},
        "conv2": conv(3, n, n),
        "conv_shortcut": conv(1, c, n),
    }


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


@pytest.mark.parametrize("impl,kernel", [("fused", "fused_conv3x3"), ("fused_ep", "epi_conv3x3")])
def test_resnet_block_matches_jax(impl, kernel, kernel_calls):
    """One ResnetBlock2D under 'fused' (two kernel #6 calls) or 'fused_ep'
    (two kernel #7 calls), value and input gradient, against the JAX
    `_resnet` under the matching '*_interpret' impl. The gradient of x
    includes the part through the GroupNorm statistics, which reaches x
    through kernel #6's a and s."""
    rng = np.random.default_rng(3)
    p = _block(rng, C, N)
    x = _normal(rng, B, H, W, C, scale=2.0) + 0.3
    emb = _normal(rng, B, 16)
    jcfg = dataclasses.replace(junet.TINY, norm_num_groups=8)
    tcfg = dataclasses.replace(tunet.TINY, norm_num_groups=8)
    jp = _jax_tree(p)

    def jrun(xx):
        return junet._resnet(jp, xx, jnp.asarray(emb), jcfg, None, "blk")

    jb.set_conv_impl(f"{impl}_interpret")
    ref = jrun(jnp.asarray(x))
    ref_g = jax.grad(lambda xx: (jrun(xx) ** 2).sum())(jnp.asarray(x))

    tb.set_conv_impl(impl)
    tx = torch.from_numpy(x).requires_grad_()
    out = tunet._resnet(from_jax_params(p), tx, torch.from_numpy(emb), tcfg, None, "blk")
    (out ** 2).sum().backward()
    assert kernel_calls == {kernel: 2}
    _close(out, ref, 1e-5)
    _close(tx.grad, ref_g, 1e-4)


def test_resnet_block_with_lora_on_conv1_falls_back(kernel_calls):
    """LoRA on a block conv keeps the block on the plain path under 'fused'
    and 'fused_ep' (c3lier image sliders), in both packages."""
    rng = np.random.default_rng(4)
    p = _block(rng, C, N)
    x = _normal(rng, 1, H, W, C)
    emb = _normal(rng, 1, 16)
    lw = {"blk.conv1": {"down": _normal(rng, 3, 3, C, 2, scale=0.05),
                        "up": _normal(rng, 1, 1, 2, N, scale=0.05), "alpha": np.float32(1.0)}}
    tcfg = dataclasses.replace(tunet.TINY, norm_num_groups=8)
    tp, tl = from_jax_params(p), tb.SliderLora(from_jax_params(lw), 1.0)
    plain = tunet._resnet(tp, torch.from_numpy(x), torch.from_numpy(emb), tcfg, tl, "blk")
    jl = jb.SliderLora(weights=_jax_tree(lw), multiplier=jnp.asarray(1.0))
    for impl in ("fused", "fused_ep"):
        jb.set_conv_impl(f"{impl}_interpret")
        tb.set_conv_impl(impl)
        assert not junet._fused_resnet_eligible(_jax_tree(p), jnp.asarray(x), jl, "blk")
        assert not tunet._fused_resnet_eligible(tp, torch.from_numpy(x), tl, "blk")
        assert tunet._fused_resnet_eligible(tp, torch.from_numpy(x), None, "blk") == (impl == "fused")
        out = tunet._resnet(tp, torch.from_numpy(x), torch.from_numpy(emb), tcfg, tl, "blk")
        assert torch.equal(out, plain)
    assert kernel_calls == {}


SMALL_UNET = {"block_out_channels": (128, 128)}  # TINY's structure, every resnet at 16x16 routes
ROUTED_SMALL = {"auto": {"conv3x3": 7}, "fused_ep": {"epi_conv3x3": 6},
                "fused": {"fused_conv3x3": 6}, "xla": {}}
JAX_IMPL = {"xla": "xla", "auto": "interpret", "fused_ep": "fused_ep_interpret",
            "fused": "fused_interpret"}


@pytest.fixture(scope="module")
def small_unet():
    jcfg = dataclasses.replace(junet.TINY, **SMALL_UNET)
    jparams = junet.init_params(jax.random.key(0), jcfg)
    return jcfg, jparams, from_jax_params(jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("impl", ["xla", "auto", "fused_ep", "fused"])
def test_small_unet_matches_jax_under_each_impl(impl, small_unet, kernel_calls):
    """A small UNet (TINY with 128 channels: three resnets and one upsampler
    at 16x16 route; the 8x8 level does not) at latents 16x16, batch 2, f32,
    under each impl against the JAX UNet under the matching '*_interpret'
    impl. Launch sites per forward: 7 x #5 (six resnet convs and the
    upsampler), 6 x #7, 6 x #6."""
    rng = np.random.default_rng(5)
    jcfg, jparams, tparams = small_unet
    tcfg = dataclasses.replace(tunet.TINY, **SMALL_UNET)
    x = _normal(rng, 2, 16, 16, 4)
    t = np.array([999.0, 20.0], np.float32)
    ctx = _normal(rng, 2, 7, 32)
    jb.set_conv_impl(JAX_IMPL[impl])
    pc.set_interpret(impl == "auto")  # the fused routers set it themselves
    ref = junet.apply(jparams, jcfg, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    tb.set_conv_impl(impl)
    out = tunet.apply(tparams, tcfg, torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
    assert kernel_calls == ROUTED_SMALL[impl]
    _close(out, ref, 1e-4)
