#!/usr/bin/env python3
"""Which operations of the port's SD1.5 path give a batch row other bits
when the row sits at another position of its batch, on a CUDA card?

The continuous serving engine (`serving/server.py`) places a joining
request's rows in whatever slots are free, where the batch-boundary engine
puts the same request at slots 0..k-1, and decodes a request's done rows at
their power-of-two row count where the boundary engine decodes its whole
bucket. This script rolls a batch of 16 rows by 5 and compares each row's
output bits, op by op at SD1.5's shapes (bf16 linears with and without
bias, the UNet's 3x3 convs under conv impls 'xla' (cuDNN; also with
cudnn.deterministic and cudnn.benchmark) and 'auto' (kernel #5 where it
routes), GroupNorm, LayerNorm, kernel #1 and the plain cross-attention, the
LoRA branch solo against stacked per row), then the whole UNet, and the
f32 VAE decode of 4 rows against the same rows inside an 8-row decode.

    python3 experiments/batch_position_torch.py    # from the repository root

Each line lists the rows whose bits moved ([] = none). Random weights;
needs one CUDA device.
"""

import os
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sliders_tpu_torch.models import unet2d, vae  # noqa: E402
from sliders_tpu_torch.ops import basic  # noqa: E402
from sliders_tpu_torch.ops import sd_attention as sa  # noqa: E402
from sliders_tpu_torch.pipelines import text2image as t2i  # noqa: E402

B, ROLL = 16, 5


def main() -> int:
    if not torch.cuda.is_available():
        print("batch_position_torch: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True  # as the serving engine runs
    g = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    def moved(fn, *xs):
        a = fn(*xs)
        b = fn(*[x.roll(ROLL, 0) for x in xs]).roll(-ROLL, 0)
        return [i for i in range(a.shape[0]) if not torch.equal(a[i], b[i])]

    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, cuDNN {torch.backends.cudnn.version()}", flush=True)
    with torch.inference_mode():
        for L, C, N in [(4096, 320, 320), (4096, 320, 2560), (1024, 640, 640),
                        (256, 1280, 1280), (64, 1280, 1280), (77, 768, 320)]:
            h, w, b = rnd(B, L, C), rnd(N, C) * 0.05, rnd(N)
            print(f"linear ({B}, {L}, {C}) -> {N}: with bias {moved(lambda h: F.linear(h, w, b), h)}"
                  f", without {moved(lambda h: F.linear(h, w), h)}", flush=True)
        convs = [(H, C, N, {"weight": (rnd(N, C, 3, 3) * 0.05).contiguous(
            memory_format=torch.channels_last), "bias": rnd(N)}, rnd(B, H, H, C))
            for H, C, N in [(64, 320, 320), (32, 640, 640), (32, 1920, 640), (16, 1280, 1280),
                            (16, 2560, 1280), (8, 1280, 1280), (8, 2560, 1280)]]
        for name, flags, impl in (("cuDNN", {}, "xla"),
                                  ("cuDNN deterministic", {"deterministic": True}, "xla"),
                                  ("cuDNN benchmark", {"benchmark": True}, "xla"),
                                  ("conv impl 'auto'", {}, "auto")):
            old = {k: getattr(torch.backends.cudnn, k) for k in flags}
            for k, v in flags.items():
                setattr(torch.backends.cudnn, k, v)
            basic.set_conv_impl(impl)
            try:
                print(f"3x3 conv, {name}: " + "; ".join(
                    f"{H}^2 {C}->{N} {moved(lambda x, p=p: basic.conv2d(p, x, padding=1), x)}"
                    for H, C, N, p, x in convs), flush=True)
            finally:
                for k, v in old.items():
                    setattr(torch.backends.cudnn, k, v)
                basic.set_conv_impl("xla")
        for H, C in [(64, 320), (32, 640), (16, 1280), (8, 1280)]:
            p, x = {"weight": rnd(C), "bias": rnd(C)}, rnd(B, H, H, C)
            print(f"GroupNorm + SiLU {H}^2 x {C}: "
                  f"{moved(lambda x: basic.group_norm(p, x, 32, silu=True), x)}; LayerNorm "
                  f"{moved(lambda x: basic.layer_norm(p, x.reshape(B, H * H, C)), x)}", flush=True)
        for shape in [(B, 8, 4096, 40), (B, 8, 1024, 80)]:
            q, k, v = rnd(*shape), rnd(*shape), rnd(*shape)
            kc, vc = rnd(B, 8, 77, shape[3]), rnd(B, 8, 77, shape[3])
            print(f"#1 {shape}: {moved(sa.sd_attention, q, k, v)}; plain cross-attention "
                  f"(77 keys): {moved(sa.sd_attention_ref, q, kc, vc)}", flush=True)
        for L, C, N in [(4096, 320, 320), (1024, 640, 640), (64, 1280, 1280)]:
            x, down, up = rnd(B, L, C), rnd(4, C) * 0.1, rnd(N, 4) * 0.1
            dn, un = down.expand(B, 4, C).contiguous(), up.expand(B, N, 4).contiguous()

            def stacked(x):
                h = torch.einsum("b...i,bri->b...r", x, dn)
                return torch.einsum("b...r,bor->b...o", h, un)

            solo = F.linear(F.linear(x, down), up)
            st = stacked(x)
            print(f"LoRA rank 4 ({B}, {L}, {C}) -> {N}: solo against stacked rows "
                  f"{[i for i in range(B) if not torch.equal(solo[i], st[i])]}; stacked under a "
                  f"roll {moved(stacked, x)}", flush=True)
        params = unet2d.init_params(g, unet2d.SD15, dtype=torch.bfloat16, device="cuda")
        x, ehs = rnd(B, 64, 64, 4), rnd(B, 77, 768)
        t = torch.rand(B, generator=g, device="cuda") * 999

        def unet(x, t, e):
            return unet2d.apply(params, unet2d.SD15, x, t, e)

        a, b = unet(x, t, ehs), unet(x, t, ehs)
        print(f"SD1.5 UNet, 16 rows at 512 px: the same call twice "
              f"{[i for i in range(B) if not torch.equal(a[i], b[i])]}; under a roll "
              f"{moved(unet, x, t, ehs)}", flush=True)
        vp = vae.init_params(g, vae.SD_VAE, dtype=torch.bfloat16, device="cuda")
        lat = rnd(8, 64, 64, 4)
        d8, d4 = (t2i.decode_images(vp, vae.SD_VAE, lat[:n]) for n in (8, 4))
        rows = [i for i in range(4) if not torch.equal(d8[i], d4[i])]
        print(f"f32 VAE decode: rows 0-3 of an 8-row decode against a 4-row decode differ at "
              f"rows {rows}, by at most {(d8[:4].int() - d4.int()).abs().max().item()} levels",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
