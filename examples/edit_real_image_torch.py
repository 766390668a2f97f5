"""Real-image slider editing with the PyTorch port: demo_image_editing.ipynb
as a script. Null-text inversion of a real photo, then slider-guided
re-sampling of the whole sweep at start_noise 500 as one batched denoise
(notebook cells 3-10), in f32.

Usage:
  python examples/edit_real_image_torch.py --base /path/sd15 --image face.png \
      --prompt 'photo of a person' --slider age_last.safetensors --scales '0,2,4'
  (--device cpu runs on the CPU; the default is CUDA device 0)

The image is read by the port's own reader (`data/native_loader`: PNG, or
JPEG where libjpeg is present), resized bicubically to --size and mapped to
[-1, 1], as the JAX example's `preprocess_image` does; the sweep is saved
side by side as one PNG (`serving.server.encode_png`). Neither needs
Pillow.
"""

import argparse

import numpy as np


def load_image(path: str, size: int) -> np.ndarray:
    """An image file -> (size, size, 3) float32 in [-1, 1]."""
    from sliders_tpu_torch.data.native_loader import decode_file, resize_bicubic

    return resize_bicubic(decode_file(path), size)


def main(args):
    import torch

    from sliders_tpu_torch.cli.train_text_slider import resolve_device
    from sliders_tpu_torch.lora import io as lora_io
    from sliders_tpu_torch.models import loader
    from sliders_tpu_torch.models.params import tree_to
    from sliders_tpu_torch.pipelines.inversion import edit_image
    from sliders_tpu_torch.serving.server import encode_png

    device = resolve_device(args.device)
    models = loader.load_sd(args.base, device=device, dtype=torch.float32, load_vae=True)
    weights = None
    if args.slider:
        weights = tree_to(lora_io.load_slider(args.slider, models.unet_params), device)
    scales = [float(s) for s in args.scales.split(",")]
    outs = edit_image(
        models, load_image(args.image, args.size), args.prompt, weights, scales,
        num_steps=args.steps, start_noise=args.start_noise, guidance_scale=args.guidance,
        num_inner_steps=args.inner_steps,
        on_step=lambda i, losses: print(f"null-text step {i}: {len(losses)} updates, "
                                        f"loss {losses[-1]:.3e}"))
    with open(args.out, "wb") as f:
        f.write(encode_png(np.concatenate([outs[s] for s in scales], axis=1)))
    print(f"saved {args.out}")


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--base", required=True)
    p.add_argument("--image", required=True)
    p.add_argument("--prompt", required=True)
    p.add_argument("--slider", default=None)
    p.add_argument("--scales", default="0,2,4")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--start_noise", type=int, default=500)
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--inner_steps", type=int, default=10)
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--device", default="0", help="a CUDA ordinal (default 0), cuda[:N] or cpu")
    p.add_argument("--out", default="edited_sweep.png")
    main(p.parse_args())
