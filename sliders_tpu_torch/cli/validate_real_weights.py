"""Real-weight validation runbook: one command to run the moment real model
snapshots appear (port of sliders_tpu/cli/validate_real_weights.py).

    python -m sliders_tpu_torch.cli.validate_real_weights \\
        --sd15 /path/sd15 \\
        [--ckpt /path/sd15.safetensors] \\
        [--clip /path/clip-vit-base-patch32] \\
        [--alexnet /path/alexnet.pth --lpips_lins /path/lpips_alex_lins.pth] \\
        [--slider out/age_last.safetensors] \\
        [--device 0 | cpu] --out OUT_DIR

Steps (each prints PASS / RECORDED / MATCHED / SKIP / FAIL; the script exits
nonzero on any failure):
  1. load the snapshot; report the UNet's parameter count
  2. eps golden: record on the first run, compare on later runs
     (utils/goldens.py; default tests/goldens/torch_sd15_eps_golden.npz,
     torch_sdxl_eps_golden.npz with --xl)
  3. single-file checkpoint against the snapshot (--ckpt): the UNet's eps on
     the golden probe within atol 1e-4. The single file's tokenizer is the
     snapshot's tokenizer/ folder
  4. CLIP scorer red / blue sanity on real ViT-B/32 (--clip)
  5. LPIPS monotone-perturbation sanity on real weights (--alexnet/...)
  6. a DDIM sampling sweep (scales -2..2 with --slider, else scale 0) saved
     as PNGs under --out: eyeball these, then run the reference protocol
     (cli/generate_images + cli/clip_score + cli/lpips_score).

Every step's status and detail go to OUT_DIR/validation.json; the last line
of stdout is {"failed": [...], "out": OUT_DIR}. `--device` takes a CUDA
ordinal (default 0), cuda[:N] or cpu; asking for CUDA with no CUDA device
is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sd15", required=True, help="diffusers-layout SD snapshot dir")
    p.add_argument("--xl", action="store_true", help="snapshot is SDXL")
    p.add_argument("--ckpt", default=None, help="single-file .ckpt/.safetensors of the same model")
    p.add_argument("--clip", default=None, help="openai/clip-vit-base-patch32 snapshot dir")
    p.add_argument("--alexnet", default=None, help="torchvision alexnet state_dict .pth")
    p.add_argument("--lpips_lins", default=None, help="lpips package alex.pth lin weights")
    p.add_argument("--slider", default=None, help="trained slider checkpoint for the sweep")
    p.add_argument("--golden", default=None,
                   help="eps golden path (default tests/goldens/torch_*_eps_golden.npz)")
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "realweight_validation"))
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--image_size", type=int, default=512)
    p.add_argument("--precision", default="float32")
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    return p


def main(args) -> int:
    import numpy as np
    import torch

    from sliders_tpu_torch.cli.generate_images import write_png
    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.utils.goldens import (
        fixed_unet_probe,
        record_or_compare_eps_golden,
        unet_on_probe,
    )
    from sliders_tpu_torch.utils.pytree import flatten

    os.makedirs(args.out, exist_ok=True)
    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.precision in ("bf16", "bfloat16") else torch.float32
    results = {}
    failed = []

    def report(step, status, detail=""):
        results[step] = {"status": status, "detail": detail}
        print(f"[{step}] {status} {detail}".rstrip(), flush=True)
        if status == "FAIL":
            failed.append(step)

    # 1. load + structural pin ------------------------------------------------
    try:
        load = loader.load_sdxl if args.xl else loader.load_sd
        m = load(args.sd15, device=device, dtype=dtype, load_vae=True)
        n_params = sum(t.numel() for t in flatten(m.unet_params).values())
        report("load", "PASS", f"unet params: {n_params:,}")
    except Exception as e:
        report("load", "FAIL", repr(e))
        print(json.dumps(results))
        return 1

    # 2. eps golden -----------------------------------------------------------
    golden = args.golden or os.path.join(
        REPO, "tests", "goldens",
        "torch_sdxl_eps_golden.npz" if args.xl else "torch_sd15_eps_golden.npz")
    try:
        status = record_or_compare_eps_golden(m, golden)
        report("eps_golden", status.upper(), golden)
    except Exception as e:
        report("eps_golden", "FAIL", repr(e))

    # 3. single-file cross-check ----------------------------------------------
    if args.ckpt:
        try:
            m2 = loader.load_sd(args.ckpt, device=device, dtype=dtype,
                                tokenizer_dir=os.path.join(args.sd15, "tokenizer"))
            probe = fixed_unet_probe(m.unet_config)
            a = unet_on_probe(m.unet_params, m.unet_config, probe).float().cpu().numpy()
            b = unet_on_probe(m2.unet_params, m2.unet_config, probe).float().cpu().numpy()
            del m2
            np.testing.assert_allclose(a, b, atol=1e-4)
            report("single_file", "PASS")
        except Exception as e:
            report("single_file", "FAIL", repr(e))
    else:
        report("single_file", "SKIP", "no --ckpt")

    # 4. CLIP sanity ------------------------------------------------------------
    if args.clip:
        try:
            from sliders_tpu_torch.models.clip_vision import (
                clip_logits_per_image,
                load_clip_model,
                preprocess_images,
            )

            params, vcfg, tcfg, tok = load_clip_model(args.clip, device=device)
            probe = np.zeros((2, 224, 224, 3), np.float32)
            probe[0, ..., 0] = 255.0
            probe[1, ..., 2] = 255.0
            with torch.inference_mode():
                logits = clip_logits_per_image(
                    params, preprocess_images(torch.from_numpy(probe).to(device)),
                    torch.as_tensor(tok(["a red photo"]), dtype=torch.long, device=device),
                    vcfg, tcfg,
                ).cpu().numpy()
            assert logits[0, 0] > logits[1, 0], logits
            report("clip", "PASS", f"red {logits[0, 0]:.2f} > blue {logits[1, 0]:.2f}")
        except Exception as e:
            report("clip", "FAIL", repr(e))
    else:
        report("clip", "SKIP", "no --clip")

    # 5. LPIPS sanity -----------------------------------------------------------
    if args.alexnet and args.lpips_lins:
        try:
            from sliders_tpu_torch.evals.lpips import load_torch_weights, lpips_distance

            lp = load_torch_weights(args.alexnet, args.lpips_lins, device=device)
            rng = np.random.default_rng(0)
            x = rng.uniform(-1, 1, (1, 64, 64, 3)).astype(np.float32)

            def dist(y) -> float:
                with torch.inference_mode():
                    return float(lpips_distance(lp, torch.from_numpy(x).to(device),
                                                torch.from_numpy(y).to(device))[0])

            d0 = dist(x)
            d1 = dist(np.clip(x + 0.1 * rng.normal(size=x.shape), -1, 1).astype(np.float32))
            d2 = dist(np.clip(x + 0.5 * rng.normal(size=x.shape), -1, 1).astype(np.float32))
            assert d0 < 1e-5 and d0 < d1 < d2, (d0, d1, d2)
            report("lpips", "PASS", f"0 < {d1:.4f} < {d2:.4f}")
        except Exception as e:
            report("lpips", "FAIL", repr(e))
    else:
        report("lpips", "SKIP", "no --alexnet/--lpips_lins")

    # 6. sampling sweep ----------------------------------------------------------
    try:
        from sliders_tpu_torch.diffusion import make_sampler, make_schedule
        from sliders_tpu_torch.models.params import tree_to
        from sliders_tpu_torch.pipelines import text2image as t2i

        sampler = make_sampler(make_schedule(), "ddim", args.steps)
        fn = t2i.make_sampling_fn(m.unet_config, sampler, compute_dtype=dtype,
                                  guidance_rescale=0.7 if args.xl else 0.0)
        weights, scales = None, [0.0]
        if args.slider:
            from sliders_tpu_torch.lora import io as lora_io

            weights = tree_to(lora_io.load_slider(args.slider, m.unet_params), device)
            scales = [-2.0, -1.0, 0.0, 1.0, 2.0]
        cond, uncond, added = t2i.encode_conditioning(m, "photo of a person", "",
                                                      args.image_size)
        B = len(scales)
        cond, uncond, added = t2i.tile_conditioning(cond, uncond, added, B)
        lats = t2i.initial_latents(torch.Generator().manual_seed(42), B, args.image_size,
                                   args.image_size, sampler.init_noise_sigma)
        t0 = time.time()
        x = fn(m.unet_params, lats.to(device), cond, uncond, weights,
               torch.tensor(scales, dtype=torch.float32), 750.0, 7.5, added)
        imgs = t2i.decode_images(m.vae_params, m.vae_config, x).cpu().numpy()
        dt = time.time() - t0
        for s, img in zip(scales, imgs):
            write_png(os.path.join(args.out, f"sweep_{s:+.1f}.png"), img)
        report("sweep", "PASS", f"{B} images in {dt:.1f}s -> {args.out}")
    except Exception as e:
        report("sweep", "FAIL", repr(e))

    with open(os.path.join(args.out, "validation.json"), "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps({"failed": failed, "out": args.out}))
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main(build_parser().parse_args()))
