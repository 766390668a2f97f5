"""sliders_tpu_torch: the PyTorch + CUDA port of sliders_tpu for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference. Today it covers
two SD1.5 paths: slider serving (HTTP /generate -> CLIP-L prompt encode ->
batched DDIM CFG denoise of the UNet with per-row slider scales and the
start-noise gate -> VAE decode -> PNG) and text-slider training
(cli/train_text_slider.py -> training/driver.py -> training/text_slider.py).
Its hand-written kernels are the SD self-attention forward and backward
(csrc/sd_attention.cu and csrc/sd_attention_bwd.cu, wrapped by
ops/sd_attention.py).

Layouts at the public functions follow the JAX package (NHWC latents,
(B, L, D) tokens, (B, H, L, d) attention); parameters are nested dicts of
torch tensors in torch layouts ((out, in) linears, OIHW convs) keyed by the
diffusers state-dict paths.

Nothing here imports jax, pydantic, PyYAML, safetensors or the JAX package.
"""
