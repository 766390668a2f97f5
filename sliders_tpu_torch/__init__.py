"""sliders_tpu_torch: the PyTorch + CUDA port of sliders_tpu for NVIDIA Hopper.

It grows beside the JAX package, which stays the reference. Today it covers
the SD1.5 slider-serving path: HTTP /generate -> CLIP-L prompt encode ->
batched DDIM CFG denoise of the UNet with per-row slider scales and the
start-noise gate -> VAE decode -> PNG. Its one hand-written kernel is the SD
self-attention forward (csrc/sd_attention.cu, wrapped by ops/sd_attention.py).

Layouts at the public functions follow the JAX package (NHWC latents,
(B, L, D) tokens, (B, H, L, d) attention); parameters are nested dicts of
torch tensors in torch layouts ((out, in) linears, OIHW convs) keyed by the
diffusers state-dict paths.

Nothing here imports jax; `sliders_tpu.text.tokenizer` (re, json, numpy) is
the one shared module.
"""
