"""The conv kernels' tile plan (`ops/conv3x3.plan`) on the CPU: which of the
two kernels of `csrc/conv3x3.cu` a call takes, and the Hopper tile plan.

Every conv the SD1.5 UNet routes at 512 px and the SDXL UNet at 1024 px
(found by running each UNet on the meta device under 'auto', 'fused_ep' and
'fused' with the launch recorded instead of made) takes the Hopper mainloop
at the serving batch and the training batches, with tiles inside one image
and shared memory within the H100's 232,448 bytes a block; so does every
f32 conv of the SD VAE decoder under 'auto' and #6 in f32 (the 3xTF32
mainloop: 32-channel chunks, hi and lo weight boxes a stage); C or strides
off 16 bytes, addresses TMA cannot take and W < 8 stay on the generic
kernel. The shape lists `chip_smoke.py` drives on the card are held to the
same routed sets.
"""

from collections import Counter

import pytest
import torch

import chip_smoke
from sliders_tpu_torch.models import unet2d
from sliders_tpu_torch.ops import attention as ta
from sliders_tpu_torch.ops import basic
from sliders_tpu_torch.ops import conv3x3 as tc

IMPLS = ("auto", "fused_ep", "fused")
MODELS = {"sd15": (unet2d.SD15, 512), "sdxl": (unet2d.SDXL, 1024)}


def _routed(cfg, px: int, impl: str, batch: int = 2) -> list:
    """(kernel, H, C, N, mode) of every conv-kernel call of one UNet forward
    under `impl`, on the meta device (no weights, no arithmetic)."""
    seen = []

    def record(fn, x, a, s, w, b, extra, mode):
        seen.append((fn.__name__, x.shape[1], x.shape[3], w.shape[0], mode))
        return torch.empty((*x.shape[:3], w.shape[0]), dtype=x.dtype, device=x.device)

    launch, dt, hw = tc._launch, torch.bfloat16, px // 8
    tc._launch = record
    basic.set_conv_impl(impl)
    ta.set_attention_impl("xla")  # the meta device has no attention kernel
    try:
        params = unet2d.init_params(None, cfg, dtype=dt, device="meta")
        x = torch.empty((batch, hw, hw, 4), dtype=dt, device="meta")
        ctx = torch.empty((batch, 77, cfg.cross_attention_dim), dtype=dt, device="meta")
        added = None
        if cfg.addition_embed_type == "text_time":
            added = {"text_embeds": torch.empty((batch, 1280), dtype=dt, device="meta"),
                     "time_ids": torch.empty((batch, 6), device="meta")}
        with torch.inference_mode():
            unet2d.apply(params, cfg, x, torch.tensor(1.0, device="meta"), ctx, added_cond=added)
    finally:
        tc._launch = launch
        basic.set_conv_impl("xla")
        ta.set_attention_impl("auto")
    return seen


@pytest.fixture(scope="module")
def routed():
    return {(model, impl): _routed(cfg, px, impl)
            for model, (cfg, px) in MODELS.items() for impl in IMPLS}


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("batch", [1, 2, 3, 16])
def test_every_routed_conv_takes_the_hopper_mainloop(routed, model, batch):
    for impl in IMPLS:
        for _, H, C, N, _ in routed[(model, impl)]:
            plan = tc.plan((batch, H, H, C), N, torch.bfloat16, prologue=impl == "fused")
            assert plan.variant == "hopper", (impl, H, C, N, plan)
            assert plan.tr * plan.tc == 128 and plan.tc <= H  # TR rows x TC columns of one image
            assert plan.bn in (tc.PRO_BN if impl == "fused" else tc.SM90_BN)
            assert 2 <= plan.stages <= tc.MAX_STAGES
            assert plan.smem == tc.plan_smem(plan.tr, plan.tc, plan.bn, plan.stages)
            assert plan.smem <= tc.SMEM_MAX == 232_448


@pytest.mark.parametrize("model", MODELS)
def test_chip_smoke_drives_every_routed_shape(routed, model):
    """chip_smoke.py's shape lists and launch counts are the UNets' own."""
    shapes = {"sd15": chip_smoke.CONV_SHAPES, "sdxl": chip_smoke.SDXL_CONV_SHAPES}[model]
    per_forward = {"sd15": chip_smoke.CONV_PER_FORWARD,
                   "sdxl": chip_smoke.SDXL_CONV_PER_FORWARD}[model]
    resnets = [(H, C, N, mode) for _, H, C, N, mode in routed[(model, "fused_ep")]]
    # 'auto' routes the resnets' convs and the upsamplers' (mode 'none')
    upsamplers = (Counter((H, C, N) for _, H, C, N, _ in routed[(model, "auto")])
                  - Counter((H, C, N) for H, C, N, _ in resnets))
    assert sorted(shapes) == sorted(set(resnets) | {(*u, "none") for u in upsamplers})
    assert len(shapes) == len(set(shapes))
    for impl in IMPLS:
        calls = routed[(model, impl)]
        assert per_forward[impl] == {calls[0][0]: len(calls)}
        assert {fn for fn, *_ in calls} == {calls[0][0]}


@pytest.mark.parametrize("shape,n,dtype,strides,aligned", [
    ((2, 16, 16, 100), 128, torch.bfloat16, None, True),  # C % 8 != 0
    ((2, 16, 16, 102), 128, torch.float32, None, True),  # f32 with C % 4 != 0
    ((2, 16, 16, 128), 128, torch.bfloat16, (16 * 16 * 132, 16 * 132, 132), True),  # strides
    ((2, 16, 16, 128), 128, torch.bfloat16, None, False),  # an address off 16 bytes
    ((2, 64, 4, 128), 128, torch.bfloat16, None, True),  # W < 8
])
def test_shapes_tma_cannot_take_stay_generic(shape, n, dtype, strides, aligned):
    assert tc.plan(shape, n, dtype, strides, aligned=aligned) == tc.Plan("generic")


@pytest.mark.parametrize("shape,n", [((2, 16, 16, 128), 130), ((1, 17, 24, 64), 200),
                                     ((3, 128, 128, 320), 320), ((2, 40, 8, 64), 128),
                                     ((1, 4, 64, 128), 129)])
def test_plan_covers_ragged_shapes(shape, n):
    """Ragged H, W and N keep the Hopper mainloop: a tile past the image's
    edge or N is masked at the store, never straddles two images, and the
    plan takes the fewest tiles."""
    B, H, W, C = shape
    plan = tc.plan(shape, n, torch.bfloat16)
    assert plan.variant == "hopper" and plan.tc <= W
    fewest = min(-(-H // (128 // t)) * -(-W // t) for t in tc.SM90_TC if t <= W)
    assert -(-H // plan.tr) * -(-W // plan.tc) == fewest
    assert plan.smem <= tc.SMEM_MAX


def test_bn_fills_the_waves():
    """BN is picked per N so that no column tile is mostly empty and the last
    wave of 132 blocks is as full as the widths allow: 160 at N = 320 and at
    SD1.5's 16 x 16 level, 256 where whole waves of 256 are as few, but not
    for #6, whose kernel has no BN = 256."""
    assert tc.plan((16, 64, 64, 320), 320, torch.bfloat16).bn == 160
    assert tc.plan((16, 16, 16, 1280), 1280, torch.bfloat16).bn == 160
    assert tc.plan((16, 32, 32, 1280), 1280, torch.bfloat16).bn == 256
    assert tc.plan((16, 32, 32, 1280), 1280, torch.bfloat16, prologue=True).bn == 160
    assert tc.plan((16, 64, 64, 320), 320, torch.bfloat16, sms=66).bn == 160


@pytest.mark.parametrize("h,c,n", chip_smoke.VAE_CONV_SHAPES)
@pytest.mark.parametrize("batch", [1, chip_smoke.VAE_DECODE_BATCH])
def test_vae_decoder_f32_convs_take_the_hopper_mainloop(h, c, n, batch):
    """Every f32 conv the SD VAE decoder routes under 'auto' takes the 3xTF32
    Hopper plan: 8 x 16 tiles, an f32 width, two or more stages of hi and lo
    weight boxes within the block's shared memory."""
    plan = tc.plan((batch, h, h, c), n, torch.float32)
    assert plan.variant == "hopper" and (plan.tr, plan.tc) == (8, 16)
    assert plan.bn in tc.F32_BN and 2 <= plan.stages <= tc.MAX_STAGES
    assert plan.smem == tc.plan_smem(plan.tr, plan.tc, plan.bn, plan.stages, f32=True)
    assert plan.smem <= tc.SMEM_MAX == 232_448
    # a stage holds the tap's hi box and its lo box, 128 bytes x BN each
    assert (tc.plan_smem(8, 16, plan.bn, plan.stages + 1, f32=True) - plan.smem
            == 2 * plan.bn * tc.PIX)


@pytest.mark.parametrize("shape,n", [((2, 32, 32, 320), 640), ((3, 16, 16, 128), 128),
                                     ((1, 13, 40, 96), 136), ((2, 1, 128, 64), 256)])
def test_f32_prologue_and_ragged_shapes_take_the_hopper_mainloop(shape, n):
    """#6 in f32 (chip_smoke's f32 CONV_EXTRA case, the tiny 'fused' training
    UNet's levels) takes F32_BN as #5 does; ragged and 1 x 128 tiles keep
    two stages."""
    for prologue in (False, True):
        plan = tc.plan(shape, n, torch.float32, prologue=prologue)
        assert plan.variant == "hopper" and plan.tc <= shape[2]
        assert plan.bn in tc.F32_BN
        assert plan.stages >= 2 and plan.smem <= tc.SMEM_MAX
        assert plan.smem == tc.plan_smem(plan.tr, plan.tc, plan.bn, plan.stages, f32=True)


@pytest.mark.parametrize("shape,strides,aligned", [
    ((2, 16, 16, 130), None, True),  # C % 4 != 0
    ((2, 16, 16, 128), (16 * 16 * 130, 16 * 130, 130), True),  # strides off 16 bytes
    ((2, 16, 16, 128), (16 * 16 * 128 + 2, 16 * 128, 128), True),  # an odd batch stride
    ((2, 16, 16, 128), None, False),  # an address off 16 bytes
    ((2, 64, 7, 128), None, True),  # W < 8
])
def test_f32_shapes_tma_cannot_take_stay_generic(shape, strides, aligned):
    assert tc.plan(shape, 128, torch.float32, strides, aligned=aligned) == tc.Plan("generic")
    assert tc.plan(shape, 128, torch.float16) == tc.Plan("generic")  # no fp16 kernel
